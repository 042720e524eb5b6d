"""64-bit state fingerprints — the port of ``raft_tla_tpu/ops/fingerprint.py``.

Two-lane multilinear hash plus the murmur3 finalizer: lane k computes
``fmix32(seed_k + sum_w c_k[w] * state[w] mod 2^32)`` with per-position odd
constants ``c_k`` drawn from a fixed PCG64 seed.  Bit-identical across every
implementation — the NumPy form here, the plain torch form here, the CUDA
kernel (``csrc/fingerprint.cu``, shared with ``csrc/step.cu``), the JAX
reference and its C++ host store — because checkpoints carry the keys.

torch has almost no unsigned 32-bit arithmetic, so the torch form works in
int64 holding values in ``[0, 2^32)``: every product is split into 16-bit
halves of one factor so that it stays below 2^49, and sums are masked back
to 32 bits before they could pass 2^63.  Keys cross the torch boundary as int32 tensors that hold the uint32
bit pattern (``u32_bits`` / ``as_uint32``); the cast to ``uint32`` happens
only at the numpy edge.
"""

from __future__ import annotations

import numpy as np
import torch

_SEED = 0x5AF7_0001
_LANE_SEEDS = (np.uint32(0x9E3779B9), np.uint32(0x85EBCA77))
FMIX_C1 = 0x85EBCA6B
FMIX_C2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF

# Calls of the plain torch fingerprint (chip_smoke.py checks that the
# schema step on the card never makes one).
calls = 0


def lane_constants(width: int) -> np.ndarray:
    """Per-position odd uint32 multipliers, shape (2, width). Deterministic."""
    rng = np.random.Generator(np.random.PCG64(_SEED))
    c = rng.integers(0, 2**32, size=(2, width), dtype=np.uint32)
    return c | np.uint32(1)  # odd => multiplication is invertible mod 2^32


def _fmix32_np(h):
    u = np.uint32
    h = h ^ (h >> u(16))
    h = h * u(FMIX_C1)
    h = h ^ (h >> u(13))
    h = h * u(FMIX_C2)
    h = h ^ (h >> u(16))
    return h


def fingerprint_np(vec: np.ndarray, consts: np.ndarray) -> tuple:
    """Canonical int32[..., W] -> (hi, lo) uint32 lanes, NumPy."""
    with np.errstate(over="ignore"):
        w = np.asarray(vec).astype(np.uint32)
        c1 = consts[0].astype(np.uint32)
        c2 = consts[1].astype(np.uint32)
        s1 = np.sum(w * c1, axis=-1, dtype=np.uint32)
        s2 = np.sum(w * c2, axis=-1, dtype=np.uint32)
        return (_fmix32_np(s1 + _LANE_SEEDS[0]),
                _fmix32_np(s2 + _LANE_SEEDS[1]))


# -- torch: int64 holding uint32 values ------------------------------------

def _mul32(a: torch.Tensor, c) -> torch.Tensor:
    """``a * c mod 2^32`` for int64 ``a`` in [0, 2^32) and ``c`` (an int or
    an int64 tensor) in [0, 2^32), without leaving int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32_t(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, FMIX_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, FMIX_C2)
    return h ^ (h >> 16)


def u32_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def order_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 per key of int32 words holding uint32 bits, ordered as
    the unsigned pairs (hi, lo) are: ``(hi - 2^31) * 2^32 + lo``.  Sorts
    of keys go through it (torch has no lexsort)."""
    return (((hi.long() & _M32) - (1 << 31)) << 32) | (lo.long() & _M32)


def as_uint32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32 (the edge cast)."""
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def fingerprint(vec: torch.Tensor, consts: torch.Tensor) -> tuple:
    """Plain torch fingerprint: int32[..., W] -> (hi, lo) int32 bit patterns.

    ``consts`` is the int64 tensor of :func:`lane_constants` (shape
    ``(2, W)``) on the same device as ``vec``.  Each product is taken in
    16-bit halves of the constant (terms below 2^49), and the row sum is
    reduced mod 2^32 once, which is exact for any W below 2^14.
    """
    global calls
    calls += 1
    w = vec.to(torch.int64) & _M32
    keys = []
    for c, seed in zip(consts, _LANE_SEEDS):
        prod = w * (c & 0xFFFF) + (((w * (c >> 16)) & 0xFFFF) << 16)
        s = (prod.sum(-1) + int(seed)) & _M32
        keys.append(u32_bits(_fmix32_t(s)))
    return keys[0], keys[1]


def torch_constants(width: int, device) -> torch.Tensor:
    """:func:`lane_constants` as an int64 tensor on ``device``."""
    return torch.as_tensor(lane_constants(width).astype(np.int64),
                           device=device)
