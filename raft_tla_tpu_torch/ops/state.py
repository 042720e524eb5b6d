"""Fixed-width tensor state schema — the port of ``raft_tla_tpu/ops/state.py``.

The spec's 13 non-history variables (``raft.tla:50-86`` plus ``messages``,
``raft.tla:32``) map to a struct of small int32 arrays; a whole state also
round-trips to a flat ``int32[W]`` vector (the store and fingerprint form).
In faithful mode (``Bounds.history``) the proof-only history variables are
carried too, as the fields of :data:`HISTORY_FIELDS` after the parity ones.

Struct fields (n = servers, L = log capacity, S = message slots):

==============  ========  =====================================================
field           shape     spec variable
==============  ========  =====================================================
role            (n,)      ``state``        (raft.tla:52)  0/1/2 = F/C/L
term            (n,)      ``currentTerm``  (raft.tla:50)
votedFor        (n,)      ``votedFor``     (raft.tla:55)  0 = Nil, else id+1
commitIndex     (n,)      ``commitIndex``  (raft.tla:63)
logLen          (n,)      ``Len(log[i])``  (raft.tla:61)
logTerm         (n, L)    ``log[i][k].term``  (1-based k -> column k-1)
logVal          (n, L)    ``log[i][k].value``  (values 1..V; 0 = no entry)
vResp           (n,)      ``votesResponded`` (raft.tla:69) as bitmask
vGrant          (n,)      ``votesGranted``   (raft.tla:72) as bitmask
nextIndex       (n, n)    ``nextIndex``    (raft.tla:82)
matchIndex      (n, n)    ``matchIndex``   (raft.tla:85)
msgHi/Lo/Count  (S,)      the ``messages`` bag (raft.tla:32), ops/msgbits.py
==============  ========  =====================================================

Canonical form (required before fingerprinting): message slots sorted by
(occupied-first, hi, lo) with empty slots all-zero; log columns >= logLen[i]
zero; in faithful mode the election slots sorted by (occupied-first, eTerm,
eLeader, eLog, eVotes, eVLog columns).  Every function here takes numpy arrays or torch tensors with any
leading batch dimensions; the numpy form serves the host interpreter, the
torch form the plain step (ops/kernels.py).  ``csrc/step.cu`` repeats the
layout as compile-time offsets.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models.spec import FOLLOWER, NIL

# Also the reference's RAFT_SCHEMA (frontend/raft_schema.py), name for name
# and, in Layout.shapes, shape for shape: the fields an INVARIANT
# expression may read (models/invariants._expression).
STATE_FIELDS = ("role", "term", "votedFor", "commitIndex", "logLen",
                "logTerm", "logVal", "vResp", "vGrant",
                "nextIndex", "matchIndex", "msgHi", "msgLo", "msgCount")

# Faithful-mode extras, appended after the parity fields so parity-mode
# vectors are untouched.  Log-valued data is stored as ranks in the bounded
# log universe (ops/loguniv.py):
#   allLogs  (Wa,)   U-bit bitmask of log ranks           (raft.tla:44)
#   vLog     (n, n)  voterLog[i][j] as rank+1, 0 = absent (raft.tla:77)
#   eTerm    (E,)    elections slots (raft.tla:39); 0 = empty slot
#   eLeader  (E,)    eleader (server id; 0 when the slot is empty)
#   eLog     (E,)    elog as rank
#   eVotes   (E,)    evotes as a server bitmask
#   eVLog    (E, n)  evoterLog[j] as rank+1, 0 = absent
HISTORY_FIELDS = ("allLogs", "vLog", "eTerm", "eLeader", "eLog",
                  "eVotes", "eVLog")
_MATRIX_FIELDS = ("logTerm", "logVal", "nextIndex", "matchIndex", "vLog",
                  "eVLog")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Shapes and flat-vector offsets for a bounds instance."""

    n: int
    L: int
    S: int
    E: int = 0       # election slots (faithful mode; 0 = parity mode)
    Wa: int = 0      # allLogs bitmask words

    @classmethod
    def of(cls, bounds: Bounds) -> "Layout":
        if not bounds.history:
            return cls(n=bounds.n_servers, L=bounds.log_cap,
                       S=bounds.msg_cap)
        from raft_tla_tpu_torch.ops.loguniv import LogUniverse
        return cls(n=bounds.n_servers, L=bounds.log_cap, S=bounds.msg_cap,
                   E=bounds.max_elections,
                   Wa=LogUniverse.of(bounds).mask_words)

    @property
    def history(self) -> bool:
        return self.E > 0

    @property
    def fields(self) -> tuple:
        return STATE_FIELDS + (HISTORY_FIELDS if self.history else ())

    @property
    def shapes(self) -> dict:
        n, L, S, E = self.n, self.L, self.S, self.E
        out = {
            "role": (n,), "term": (n,), "votedFor": (n,),
            "commitIndex": (n,), "logLen": (n,),
            "logTerm": (n, L), "logVal": (n, L),
            "vResp": (n,), "vGrant": (n,),
            "nextIndex": (n, n), "matchIndex": (n, n),
            "msgHi": (S,), "msgLo": (S,), "msgCount": (S,),
        }
        if self.history:
            out.update({
                "allLogs": (self.Wa,), "vLog": (n, n),
                "eTerm": (E,), "eLeader": (E,), "eLog": (E,),
                "eVotes": (E,), "eVLog": (E, n),
            })
        return out

    @property
    def width(self) -> int:
        return sum(int(np.prod(s)) for s in self.shapes.values())


def init_struct(bounds: Bounds) -> dict:
    """The unique initial state (``Init``, ``raft.tla:155-160``), numpy."""
    lay = Layout.of(bounds)
    n, L, S = lay.n, lay.L, lay.S
    i32 = np.int32
    out = {
        "role": np.full((n,), FOLLOWER, dtype=i32),
        "term": np.ones((n,), dtype=i32),
        "votedFor": np.full((n,), NIL, dtype=i32),
        "commitIndex": np.zeros((n,), dtype=i32),
        "logLen": np.zeros((n,), dtype=i32),
        "logTerm": np.zeros((n, L), dtype=i32),
        "logVal": np.zeros((n, L), dtype=i32),
        "vResp": np.zeros((n,), dtype=i32),
        "vGrant": np.zeros((n,), dtype=i32),
        "nextIndex": np.ones((n, n), dtype=i32),
        "matchIndex": np.zeros((n, n), dtype=i32),
        "msgHi": np.zeros((S,), dtype=i32),
        "msgLo": np.zeros((S,), dtype=i32),
        "msgCount": np.zeros((S,), dtype=i32),
    }
    if lay.history:
        # InitHistoryVars (raft.tla:140-142): elections = {}, allLogs = {},
        # voterLog = per-server empty map.
        out.update({f: np.zeros(shape, dtype=i32)
                    for f, shape in lay.shapes.items()
                    if f in HISTORY_FIELDS})
    return out


def _field_ndim(f: str) -> int:
    return 2 if f in _MATRIX_FIELDS else 1


def pack(struct) -> np.ndarray | torch.Tensor:
    """Struct -> flat int32[..., W] vector(s): the parity fields in
    STATE_FIELDS order, then (faithful mode) HISTORY_FIELDS."""
    parts = []
    fields = STATE_FIELDS + (HISTORY_FIELDS if "allLogs" in struct else ())
    for f in fields:
        a = struct[f]
        batch = tuple(a.shape[:a.ndim - _field_ndim(f)])
        parts.append(a.reshape(batch + (-1,)))
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def unpack(vec, lay: Layout) -> dict:
    """int32[..., W] vector(s) -> struct; leading batch dims pass through."""
    out, off = {}, 0
    batch = tuple(vec.shape[:-1])
    for f, shape in lay.shapes.items():
        size = int(np.prod(shape))
        out[f] = vec[..., off:off + size].reshape(batch + tuple(shape))
        off += size
    return out


def _where(c, a, b):
    if isinstance(c, torch.Tensor):
        return torch.where(c, a, b)
    return np.where(c, a, b)


def _oddeven_pairs(m: int) -> tuple:
    """Odd-even transposition sorting-network comparator pairs for ``m``
    slots — a data-independent sort: m rounds of adjacent compare-swaps."""
    return tuple((i, i + 1) for r in range(m)
                 for i in range(r % 2, m - 1, 2))


def _network_sort(keys: list, vals: list, m: int) -> list:
    """Sort ``m`` slots by the lexicographic key tuple with a branchless
    comparator network; returns the reordered ``vals``.

    The reference swaps whole arrays with ``.at[].set``; here each array
    is split into its ``m`` slot columns once, the comparators swap
    columns with ``where``, and the columns are stacked back.  Keys and
    values may be the same array (hi/lo are both), so each distinct array
    is swapped once per comparator.
    """
    arrs, pos = [], {}
    for a in list(keys) + list(vals):
        if id(a) not in pos:
            pos[id(a)] = len(arrs)
            arrs.append(a)
    cols = [[a[..., k] for k in range(m)] for a in arrs]
    key_ix = [pos[id(k)] for k in keys]
    for i, j in _oddeven_pairs(m):
        le = None       # key[i] <= key[j], built least-significant first
        for kx in reversed(key_ix):
            ki, kj = cols[kx][i], cols[kx][j]
            le = (ki <= kj) if le is None else (ki < kj) | ((ki == kj) & le)
        for c in cols:
            ci, cj = c[i], c[j]
            c[i], c[j] = _where(le, ci, cj), _where(le, cj, ci)
    stack = torch.stack if isinstance(arrs[0], torch.Tensor) else np.stack
    return [stack(cols[pos[id(v)]], -1) for v in vals]


def canonicalize(struct: dict) -> dict:
    """Sort message slots into canonical order: occupied first, then (hi, lo).

    Empty slots are forced all-zero first (a count decremented to 0 may
    leave stale content words behind).  Distinct occupied slots always
    differ in (hi, lo) — the bag merges equal messages — so the sort is a
    total order and canonicalization is unique.
    """
    occupied = struct["msgCount"] > 0
    hi = _where(occupied, struct["msgHi"], 0)
    lo = _where(occupied, struct["msgLo"], 0)
    ct = _where(occupied, struct["msgCount"], 0)
    if isinstance(occupied, torch.Tensor):
        occ_key = (~occupied).to(torch.int32)
    else:
        occ_key = (~occupied).astype(np.int32)
    out = dict(struct)
    out["msgHi"], out["msgLo"], out["msgCount"] = _network_sort(
        [occ_key, hi, lo], [hi, lo, ct], int(struct["msgHi"].shape[-1]))
    if "eTerm" in struct:
        # elections is a set (raft.tla:39): slot order is an encoding
        # artifact, sorted like the bag.  eTerm > 0 marks occupancy.
        eocc = struct["eTerm"] > 0
        if isinstance(eocc, torch.Tensor):
            eocc_key = (~eocc).to(torch.int32)
        else:
            eocc_key = (~eocc).astype(np.int32)
        evl = [struct["eVLog"][..., c]
               for c in range(struct["eVLog"].shape[-1])]
        base = [struct[f] for f in ("eTerm", "eLeader", "eLog", "eVotes")]
        vals = _network_sort([eocc_key] + base + evl, base + evl,
                             int(struct["eTerm"].shape[-1]))
        out["eTerm"], out["eLeader"], out["eLog"], out["eVotes"] = vals[:4]
        stack = torch.stack if isinstance(eocc, torch.Tensor) else np.stack
        out["eVLog"] = stack(vals[4:], -1)
    return out


def constraint_ok(struct: dict, bounds: Bounds):
    """The StateConstraint, one bool per state (leading dims kept).

    ``/\\ \\A i : currentTerm[i] <= MaxTerm /\\ Len(log[i]) <= MaxLogLen
    /\\ Cardinality(DOMAIN messages) <= MaxMsgs /\\ \\A m : messages[m] <= MaxDup``
    """
    return ((struct["term"] <= bounds.max_term).all(-1)
            & (struct["logLen"] <= bounds.max_log).all(-1)
            & ((struct["msgCount"] > 0).sum(-1) <= bounds.max_msgs)
            & (struct["msgCount"] <= bounds.max_dup).all(-1))
