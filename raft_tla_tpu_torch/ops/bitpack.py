"""Bit-packed state rows — the port of ``raft_tla_tpu/ops/bitpack.py``.

The flat ``int32[W]`` state vector (ops/state.py) spends a full 32-bit word
on every field element, though no field needs more than 29 bits (the
allLogs mask words excepted) and most need 2-6.  The DDD engine keeps its
host store, its level files and its snapshots bit-packed and unpacks only
the block being expanded.

The packing is a static bitstream: field element ``w`` occupies bits
``[start[w], start[w] + bits[w])`` of the row, where ``bits[w]`` follows
from the :class:`~raft_tla_tpu_torch.config.Bounds` capacities and
``start`` is the running sum.  It is bit-identical to the reference's, so
the rows of a snapshot move between the two packages.

Two backends behind one interface: numpy (``xp = np``: the host store,
snapshots, traces) and torch (``xp = torch``: the card unpacks an uploaded
block and packs the streamed successors).  torch has no unsigned 32-bit
arithmetic, so the torch form works in int64 holding ``[0, 2^32)`` and
reinterprets the words as int32 at the end (ops/fingerprint.u32_bits); it
never shifts a negative int32.  It gathers all W fields at once with index
tensors (a handful of kernels, not one per field).
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops.fingerprint import u32_bits
from raft_tla_tpu_torch.ops.msgbits import _HI_FIELDS, _LO_FIELDS

_M32 = 0xFFFFFFFF


def _bits(max_value: int) -> int:
    """Bits to represent values 0..max_value."""
    return max(1, int(max_value).bit_length())


def field_bits(bounds: Bounds) -> dict:
    """Per-element bit width for every Layout field (pack() order)."""
    n = bounds.n_servers
    hi_bits = max(sh + w for sh, w in _HI_FIELDS.values())
    # Parity mode never sets the mlog field 'g' (always 0): pack only the
    # bits below it, so parity rows don't widen with the faithful schema.
    lo_fields = _LO_FIELDS if bounds.history else \
        {k: v for k, v in _LO_FIELDS.items() if k != "g"}
    lo_bits = max(sh + w for sh, w in lo_fields.values())
    out = {
        "role": _bits(2),
        "term": _bits(bounds.term_cap),
        "votedFor": _bits(n),                    # 0 = Nil, else id+1
        "commitIndex": _bits(bounds.log_cap),
        "logLen": _bits(bounds.log_cap),
        "logTerm": _bits(bounds.term_cap),
        "logVal": _bits(bounds.n_values),
        "vResp": n,                              # bitmask over servers
        "vGrant": n,
        "nextIndex": _bits(bounds.log_cap + 1),  # 1..Len(log)+1
        "matchIndex": _bits(bounds.log_cap),
        "msgHi": hi_bits,                        # the packed record word
        "msgLo": lo_bits,
        "msgCount": _bits(bounds.dup_cap),
    }
    if bounds.history:
        from raft_tla_tpu_torch.ops.loguniv import LogUniverse
        id_bits = max(1, int(LogUniverse.of(bounds).size).bit_length())
        out.update({
            "allLogs": 32,                       # raw bitmask words
            "vLog": id_bits,                     # rank+1, 0 = absent
            "eTerm": _bits(bounds.term_cap),
            "eLeader": _bits(max(n - 1, 1)),
            "eLog": id_bits,
            "eVotes": n,                         # evotes server bitmask
            "eVLog": id_bits,                    # rank+1, 0 = absent
        })
    return out


class BitSchema:
    """Static pack plan: per-position widths, offsets, packed width."""

    def __init__(self, bounds: Bounds):
        lay = st.Layout.of(bounds)
        fb = field_bits(bounds)
        bits = []
        for f in lay.fields:
            bits += [fb[f]] * int(np.prod(lay.shapes[f]))
        self.bits = np.asarray(bits, np.int64)          # [W]
        self.start = np.concatenate(([0], np.cumsum(self.bits)[:-1]))
        self.total_bits = int(self.bits.sum())
        self.W = lay.width
        self.P = (self.total_bits + 31) // 32           # packed words
        self._plans = {}

    def pack(self, vec, xp):
        """``int32[..., W] -> int32[..., P]`` (uint32 bitstream in int32)."""
        if xp is torch:
            return self._pack_torch(vec)
        u = vec.astype(xp.uint32)
        words = [None] * self.P
        for w in range(self.W):
            b, s = int(self.bits[w]), int(self.start[w])
            v = u[..., w] & xp.uint32((1 << b) - 1)
            o, sh = s // 32, s % 32
            lowpart = (v << xp.uint32(sh)) if sh else v
            words[o] = lowpart if words[o] is None else words[o] | lowpart
            if sh + b > 32:                      # straddles two words
                spill = v >> xp.uint32(32 - sh)
                words[o + 1] = spill if words[o + 1] is None \
                    else words[o + 1] | spill
        zero = xp.zeros_like(u[..., 0])
        cols = [zero if c is None else c for c in words]
        return xp.stack(cols, axis=-1).astype(xp.int32)

    def unpack(self, packed, xp):
        """``int32[..., P] -> int32[..., W]``."""
        if xp is torch:
            return self._unpack_torch(packed)
        u = packed.astype(xp.uint32)
        cols = []
        for w in range(self.W):
            b, s = int(self.bits[w]), int(self.start[w])
            o, sh = s // 32, s % 32
            v = u[..., o] >> xp.uint32(sh) if sh else u[..., o]
            if sh + b > 32:
                v = v | (u[..., o + 1] << xp.uint32(32 - sh))
            cols.append(v & xp.uint32((1 << b) - 1))
        return xp.stack(cols, axis=-1).astype(xp.int32)

    # -- torch: int64 holding uint32 values ---------------------------------

    def _plan(self, device) -> dict:
        """Index tensors of the plan on ``device``: each position's word,
        shift and mask, and the spill shift (0 where it does not straddle)."""
        key = str(device)
        if key not in self._plans:
            o = self.start // 32
            sh = self.start % 32
            spill = np.where(sh + self.bits > 32, 32 - sh, 0)
            mask = (np.int64(1) << self.bits) - 1

            def t(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)

            self._plans[key] = dict(
                o=t(o), o1=t(np.minimum(o + 1, self.P - 1)), sh=t(sh),
                spill=t(spill), straddle=t(spill > 0), mask=t(mask))
        return self._plans[key]

    def _pack_torch(self, vec: torch.Tensor) -> torch.Tensor:
        p = self._plan(vec.device)
        lead = vec.shape[:-1]
        v = (vec.reshape(-1, self.W).to(torch.int64) & _M32) & p["mask"]
        shifted = v << p["sh"]                   # < 2^63: sh < 32, bits <= 32
        words = torch.zeros((v.shape[0], self.P + 1), dtype=torch.int64,
                            device=vec.device)
        # the fields' bits are disjoint, so adding them is or-ing them
        words.index_add_(1, p["o"], shifted & _M32)
        words.index_add_(1, p["o"] + 1, shifted >> 32)
        return u32_bits(words[:, :self.P]).reshape(*lead, self.P)

    def _unpack_torch(self, packed: torch.Tensor) -> torch.Tensor:
        p = self._plan(packed.device)
        lead = packed.shape[:-1]
        u = packed.reshape(-1, self.P).to(torch.int64) & _M32
        lo = u[:, p["o"]] >> p["sh"]
        hi = (u[:, p["o1"]] << p["spill"]) * p["straddle"]
        return u32_bits((lo | hi) & p["mask"]).reshape(*lead, self.W)
