"""Time the PyTorch/CUDA port's kernels of two checkouts on one card.

    python3 tools/kernel_ab.py OLD NEW

OLD and NEW are checkouts of the repository (unpack one with
``git archive <commit> | tar -x -C <dir>`` into a directory that
.gitignore lists).  Each checkout's ``chip_smoke.py`` phases 0-2 (its own
package and kernels, built into its own ``build/``) run in a process of
their own, in the order OLD NEW NEW OLD, all timed with NEW's
``chip_smoke.cuda_ms``.  Then each checkout's K2 kernel is timed through
its bare C entry, without the Python wrapper, at 1,048,576 rows of W = 60
and 110.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path


def timing(new_root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", Path(new_root) / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root: str, new_root: str, what: str) -> None:
    """In this process: ``root``'s kernel phases (``what`` = phases) or its
    bare K2 entry (``what`` = k2)."""
    cuda_ms = timing(new_root).cuda_ms
    sys.path.insert(0, root)
    if what == "phases":
        import chip_smoke as c
        c.cuda_ms = cuda_ms
        c.phase0()
        r = {}
        c.phase1(r)
        c.phase2(r)
        return
    import torch
    from raft_tla_tpu_torch.ops import build, fingerprint as fpr, pallas_fp
    fn = build.library(pallas_fp.SOURCE).rt_fingerprint_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    B = 1 << 20
    for W in (60, 110):
        gen = torch.Generator(device="cuda").manual_seed(W)
        rows = torch.randint(-2**31, 2**31 - 1, (B, W), dtype=torch.int32,
                             device="cuda", generator=gen)
        c = torch.as_tensor(fpr.lane_constants(W).astype("uint32")
                            .view("int32"), device="cuda")
        hi = torch.empty(B, dtype=torch.int32, device="cuda")
        lo = torch.empty_like(hi)
        args = (rows.data_ptr(), B, W, c[0].data_ptr(), c[1].data_ptr(),
                hi.data_ptr(), lo.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        ms, spread = cuda_ms(lambda: fn(*args), 50)
        print(f"K2 bare entry of {root}: {B} rows x W={W}: {ms:.4f} ms "
              f"(spread {spread:.4f}), {(B * W * 4 + 8 * B) / ms / 1e6:.1f} "
              f"GB/s", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        one(*argv[1:4])
        return 0
    old, new = (str(Path(p).resolve()) for p in argv)
    rc = 0
    for what in ("phases", "k2"):
        for root in (old, new, new, old):
            print(f"== {what} of {root}", flush=True)
            rc |= subprocess.run([sys.executable, __file__, "--one", root,
                                  new, what]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
