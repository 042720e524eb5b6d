"""Build and load the port's CUDA kernels — the role of the reference's
``raft_tla_tpu/ops/pallas_compat.py``.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/torch_kernels/`` at the root of
the checkout, named by a hash of the sources, the ``-D`` macros and the
flags, and are built at first use; :func:`prebuild` starts several builds
at once (one ``nvcc`` per library, all in parallel).  ``nvcc -Xptxas -v``
output (registers, spills, shared memory) is kept beside each library and
returned by :func:`ptxas_report`.

There is no interpreter mode and no fallback: a missing ``nvcc``, a failed
build or a failed launch raises.  The wrappers (ops/pallas_fp.py,
ops/pallas_step.py) run the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}
_building: dict = {}       # library key -> its build lock


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit on "
                       "PATH); the port's kernels build only where it is")


def _key(source: str, defines: dict) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(source.encode())
    h.update(repr(sorted(defines.items())).encode())
    h.update(repr(FLAGS).encode())
    return h.hexdigest()[:16]


def _paths(source: str, defines: dict) -> tuple:
    tag = "-".join(f"{k}{v}" for k, v in sorted(defines.items()))
    stem = f"{Path(source).stem}{'-' + tag if tag else ''}-{_key(source, defines)}"
    return BUILD_DIR / f"lib{stem}.so", BUILD_DIR / f"lib{stem}.ptxas.txt"


def _start(source: str, defines: dict):
    """Start one nvcc build; returns (process, tmp, so, log) or None when
    the library already exists."""
    so, log = _paths(source, defines)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *FLAGS, *(f"-D{k}={v}" for k, v in sorted(defines.items())),
           "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, log


def _finish(job) -> None:
    proc, tmp, so, log = job
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{so.name}:\n{out}")
    os.replace(tmp, so)


def prebuild(jobs) -> None:
    """Build every ``(source, defines)`` pair, all nvcc runs in parallel."""
    started = [_start(src, dict(d)) for src, d in jobs]
    errors = []
    for job in started:
        if job is not None:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def library(source: str, defines: dict | None = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>`` built with ``defines``
    (the sources are hashed once per process and library, not per call).
    Threads asking for the same library wait for one build; different
    libraries build side by side (the serve scheduler's bin builds)."""
    defines = dict(defines or {})
    key = (source, tuple(sorted(defines.items())), str(BUILD_DIR))
    with _lock:
        if key in _loaded:
            return _loaded[key]
        gate = _building.setdefault(key, threading.Lock())
    with gate:
        with _lock:
            lib = _loaded.get(key)
        if lib is None:
            so, _ = _paths(source, defines)
            job = _start(source, defines)
            if job is not None:
                _finish(job)
            lib = ctypes.CDLL(str(so))
            with _lock:
                _loaded[key] = lib
    return lib


def ptxas_report(source: str, defines: dict | None = None) -> str:
    """The ``-Xptxas -v`` lines of a built library (registers, spills)."""
    _, log = _paths(source, dict(defines or {}))
    if not log.exists():
        return ""
    return "\n".join(ln.strip() for ln in log.read_text().splitlines()
                     if "ptxas info" in ln or "spill" in ln)


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
