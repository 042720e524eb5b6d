"""The fingerprint of stored rows as a CUDA kernel — the port of
``raft_tla_tpu/ops/pallas_fp.py`` (kernel K2, ``csrc/fingerprint.cu``).

:func:`fingerprint_rows` launches the kernel for a CUDA tensor and runs the
plain torch version (ops/fingerprint.fingerprint) for a CPU tensor; nothing
else chooses between them.  Both return ``(hi, lo)`` as int32 tensors that
hold the uint32 bits, bit-identical to the reference's NumPy, jnp, Pallas
and C++ fingerprints.  The engine keys its initial row with it, and
``chip_smoke.py`` audits a finished store with it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raft_tla_tpu_torch.ops import build
from raft_tla_tpu_torch.ops import fingerprint as fpr

SOURCE = "fingerprint.cu"

# Kernel launches so far (chip_smoke.py reads and resets it).
launches = 0

_consts: dict = {}


def _lib():
    lib = build.library(SOURCE)
    fn = lib.rt_fingerprint_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _device_constants(W: int, device) -> torch.Tensor:
    """The (2, W) lane constants as int32 bit patterns on ``device``."""
    key = (W, str(device))
    if key not in _consts:
        c = fpr.lane_constants(W).astype(np.uint32).view(np.int32)
        _consts[key] = torch.as_tensor(np.ascontiguousarray(c), device=device)
    return _consts[key]


def fingerprint_rows(rows: torch.Tensor) -> tuple:
    """``int32[B, W] -> (hi, lo)`` int32[B] holding the uint32 key bits."""
    global launches
    if rows.dim() != 2 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32[B, W], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    B, W = rows.shape
    if rows.device.type == "cpu":
        return fpr.fingerprint(rows, fpr.torch_constants(W, rows.device))
    if rows.device.type != "cuda":
        raise ValueError(f"no fingerprint kernel for device {rows.device}")
    rows = rows.contiguous()
    c = _device_constants(W, rows.device)
    hi = torch.empty((B,), dtype=torch.int32, device=rows.device)
    lo = torch.empty((B,), dtype=torch.int32, device=rows.device)
    err = _lib()(rows.data_ptr(), B, W, c[0].data_ptr(), c[1].data_ptr(),
                 hi.data_ptr(), lo.data_ptr(), build.stream_ptr(rows.device))
    build.check(err, "fingerprint kernel launch")
    launches += 1
    return hi, lo
