"""Run the port's CUDA kernels on the CPU, in a host emulation, against
their plain PyTorch versions.

    python3 tools/cuda_emu/emulate.py [--sanitize] [k1] [k2]

Compiles ``raft_tla_tpu_torch/csrc/step.cu`` (K1, one binary per layout)
and ``csrc/fingerprint.cu`` (K2) with g++ against ``cuda_runtime.h`` here,
which runs every CUDA thread as a host thread, and holds their outputs to
``ops/kernels.build_step`` and ``ops/fingerprint.fingerprint`` under the
kernels' contract (K1: ``valid`` on every lane, the rest where ``valid``
is set; K2: every key), bit-exact.  ``--sanitize`` builds with
``-fsanitize=undefined,address``.  It rehearses a kernel's logic before a
run on the card; it says nothing of speed, and cannot catch what only the
GPU compiler does.  Work files go to ``build/cuda_emu/``.  Exits 1 on a
mismatch.
"""

from __future__ import annotations

import hashlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from raft_tla_tpu_torch.config import Bounds, CheckConfig  # noqa: E402
from raft_tla_tpu_torch.device_engine import (  # noqa: E402
    Capacities, DeviceEngine)
from raft_tla_tpu_torch.models import spec as SP, views  # noqa: E402
from raft_tla_tpu_torch.ops import fingerprint as fpr  # noqa: E402
from raft_tla_tpu_torch.ops import kernels, pallas_step, predprog  # noqa: E402
from raft_tla_tpu_torch.ops import state as st, symmetry as sym  # noqa: E402

HERE = Path(__file__).resolve().parent
CSRC = ROOT / "raft_tla_tpu_torch" / "csrc"
WORK = ROOT / "build" / "cuda_emu"
FLAGS = ["-O1"]
SANITIZE = ["-O1", "-g", "-fsanitize=undefined,address",
            "-fno-sanitize-recover=undefined"]
OUTPUTS = ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok")
FULL5 = ("NoTwoLeaders", "LogMatching", "CommittedWithinLog",
         "LeaderCompleteness", "NaiveNoTwoLeaders")
INV7 = ("NoTwoLeaders", "LogMatching", "CommittedWithinLog",
        "LeaderCompleteness", "ElectionSafetyHist", "LeaderCompletenessHist",
        "AllLogsPrefixClosed")
# Expression invariants that cover every operator and reducer, an index
# that wraps (votedFor - 1 is -1 for Nil), one that clamps, int32
# wrap-around; with FULL5 and the registry twin of the first, 12 in all.
EXPRS = ("count(role = 2) <= 1", "commitIndex <= logLen",
         "term[votedFor - 1] >= 1 \\/ votedFor = 0",
         "logTerm[logLen] <= max(term) /\\ min(logVal) >= 0",
         "term * 1073741824 * 4 = 0 => ~any(msgCount > 1)",
         "-term[0] - count(TRUE) < nextIndex[matchIndex + 7]",
         "logVal[term] /= 3")


def binary(source: str, main: str, defines: dict, flags: list) -> Path:
    """The emulation binary of ``csrc/<source>`` with ``defines``."""
    gen = (CSRC / source).read_text()
    gen = gen.replace("extern __shared__", "extern")
    gen = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.+?), (\w+), \w+,\s*"
                 r"(?:static_cast<cudaStream_t>\(stream\)|st)>>>\(",
                 r"emu::launch(\1, \2, \3)(", gen, flags=re.S)
    key = hashlib.sha256((gen + (CSRC / "fp.cuh").read_text()
                          + (HERE / main).read_text()
                          + (HERE / "cuda_runtime.h").read_text()
                          + repr(sorted(defines.items())) + repr(flags)
                          ).encode()).hexdigest()[:12]
    exe = WORK / f"{Path(source).stem}-{key}"
    if not exe.exists():
        WORK.mkdir(parents=True, exist_ok=True)
        (WORK / "kernel_gen.cu").write_text(gen)
        cmd = ["g++", "-std=c++20", *flags, "-pthread", "-fno-strict-aliasing",
               f"-I{HERE}", f"-I{CSRC}", f"-I{WORK}",
               *(f"-D{k}={v}" for k, v in sorted(defines.items())),
               "-o", str(exe), str(HERE / main)]
        subprocess.run(cmd, check=True)
    return exe


def reachable_rows(b: Bounds, spec: str, invs: tuple, n: int,
                   chunks: int = 30) -> torch.Tensor:
    """``n`` rows the port's engine (on the CPU) reaches in ``chunks``
    chunks of 256 rows, evenly spaced."""
    eng = DeviceEngine(CheckConfig(bounds=b, spec=spec, invariants=invs,
                                   chunk=256),
                       Capacities(n_states=1 << 16, levels=64), device="cpu")
    res = eng.check(max_chunks=chunks)
    idx = torch.linspace(0, res.n_states - 1, min(n, res.n_states)).long()
    return eng.carry["store"][idx].clone()


def k1_case(name, b, spec, invs, axes, view, rows, flags) -> bool:
    ref = kernels.build_step(b, spec, invs, axes, view)(rows)
    B, W = rows.shape
    table = np.asarray(SP.lane_table(b, spec), np.int32).reshape(-1)
    A = table.size // 5
    P, Q = sym.group_sizes(b, axes)
    nv = b.n_values if "Value" in axes else 0
    d = WORK / "case"
    d.mkdir(parents=True, exist_ok=True)
    np.array([B, A, W, P, Q, nv, views.KERNEL_CODES[view], len(invs),
              b.max_term, b.max_log, b.max_msgs, b.max_dup],
             np.int32).tofile(d / "meta.i32")
    codes, prog = predprog.kernel_tables(invs, b)
    (codes if codes.size else np.zeros(1, np.int32)).tofile(d / "inv.i32")
    prog.tofile(d / "prog.i32")
    rows.numpy().astype(np.int32).tofile(d / "vecs.i32")
    table.tofile(d / "table.i32")
    c = fpr.lane_constants(W).astype(np.uint32)
    c[0].tofile(d / "c1.u32")
    c[1].tofile(d / "c2.u32")
    np.asarray(sym.kernel_tables(b, axes), np.int8).tofile(d / "group.i8")
    np.asarray(sym.kernel_rank_maps(b, axes), np.int16).tofile(
        d / "rmaps.i16")
    exe = binary("step.cu", "step_main.cpp", pallas_step.layout_defines(b),
                 flags)
    if subprocess.run([str(exe), str(d)]).returncode:
        print(f"K1 {name}: the emulation failed")
        return False
    val = ref["valid"].numpy()
    got_valid = np.fromfile(d / "o_valid.u8", np.uint8).reshape(B, A)
    bad = {"valid": int((got_valid != val).sum())}
    for k in OUTPUTS:
        want = ref[k].numpy()
        got = np.fromfile(d / f"o_{k}.{'i32' if want.dtype == np.int32 else 'u8'}",
                          np.int32 if want.dtype == np.int32 else np.uint8)
        diff = got.reshape(want.shape).astype(np.int64) != want.astype(np.int64)
        if diff.ndim > 2:
            diff = diff.reshape(B, A, -1).any(-1)
        bad[k] = int((diff & val).sum())
    n_bad = sum(bad.values())
    print(f"K1 {name}: rows {B}, A {A}, W {W}, |G| {P * Q}, valid "
          f"{int(val.sum())}: mismatches {bad if n_bad else 0}", flush=True)
    return n_bad == 0


def k1(flags) -> bool:
    flag = Bounds(3, 2, 2, 1, 2)
    fflag = Bounds(3, 2, 2, 1, 2, history=True, max_elections=6)
    five = Bounds(5, 2, 2, 0, 2)
    ffive = Bounds(5, 2, 2, 0, 2, history=True, max_elections=6)
    ok = True
    rows = reachable_rows(flag, "full", FULL5, 8191)
    ok &= k1_case("flagship, Server, 8,191 rows", flag, "full", FULL5,
                  ("Server",), None, rows, flags)
    small = rows[::41].contiguous()
    for axes, view in (((), None), (("Server", "Value"), "deadvotes")):
        ok &= k1_case(f"flagship {axes} {view}", flag, "full", FULL5, axes,
                      view, small, flags)
    ok &= k1_case("flagship, expressions", flag, "full",
                  FULL5 + EXPRS, (), None, small, flags)
    rows = reachable_rows(fflag, "full", INV7, 600)
    for axes, view in (((), None), (("Server",), None),
                       (("Server", "Value"), None), (("Server",), "deadvotes")):
        ok &= k1_case(f"faithful {axes} {view}", fflag, "full", INV7, axes,
                      view, rows, flags)
    ok &= k1_case("faithful, expressions", fflag, "full", INV7 + EXPRS[:3],
                  (), None, rows[::3].contiguous(), flags)
    for b, invs in ((five, ("NoTwoLeaders",)), (ffive, INV7)):
        rows = reachable_rows(b, "election", invs, 40)
        ok &= k1_case(f"election {b.n_servers}s/2v{' faithful' * b.history}"
                      ", Server", b, "election", invs, ("Server",), None,
                      rows, flags)
    # Faithful rows from every level of a complete run (deep history).
    b = Bounds(2, 2, 2, 1, 2, history=True, max_elections=4)
    eng = DeviceEngine(CheckConfig(bounds=b, spec="full", invariants=INV7,
                                   chunk=4096),
                       Capacities(n_states=1 << 18, levels=64), device="cpu")
    res = eng.check()
    idx, start = [], 0
    for cnt in res.levels:
        idx += np.linspace(start, start + cnt - 1, min(40, cnt)).astype(
            int).tolist()
        start += cnt
    rows = eng.carry["store"][torch.tensor(idx)].clone()
    for axes in ((), ("Server",), ("Server", "Value"), ("Value",)):
        ok &= k1_case(f"faithful 2s/2v, all {len(res.levels)} levels, "
                      f"{axes}", b, "full", INV7, axes, "deadvotes", rows,
                      flags)
    return ok


def k2(flags) -> bool:
    exe = binary("fingerprint.cu", "fp_main.cpp", {}, flags)
    rng = np.random.default_rng(1)
    ok = True
    WORK.mkdir(parents=True, exist_ok=True)
    for n, W, off in ((3001, 60, 0), (3001, 60, 1), (2999, 113, 0),
                      (2000, 110, 0), (1500, 57, 0), (100, 1, 0),
                      (777, 256, 1), (50, 520, 0)):
        rows = rng.integers(-2**31, 2**31, size=(n, W),
                            dtype=np.int64).astype(np.int32)
        rows.tofile(WORK / "fp_rows")
        fpr.lane_constants(W).astype(np.uint32).tofile(WORK / "fp_consts")
        rc = subprocess.run([str(exe), str(n), str(W), str(off),
                             str(WORK / "fp_rows"), str(WORK / "fp_consts"),
                             str(WORK / "fp_out")]).returncode
        got = np.fromfile(WORK / "fp_out", np.int32).reshape(2, n)
        hi, lo = fpr.fingerprint(torch.as_tensor(rows),
                                 fpr.torch_constants(W, "cpu"))
        bad = int(((got[0] != hi.numpy()) | (got[1] != lo.numpy())).sum())
        print(f"K2 rows {n}, W {W}, offset {off} words: rc {rc}, "
              f"mismatches {bad}", flush=True)
        ok &= rc == 0 and bad == 0
    return ok


def main(argv) -> int:
    flags = SANITIZE if "--sanitize" in argv else FLAGS
    which = [a for a in argv if a in ("k1", "k2")] or ["k1", "k2"]
    ok = True
    if "k2" in which:
        ok &= k2(flags)
    if "k1" in which:
        ok &= k1(flags)
    print("all bit-exact" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
