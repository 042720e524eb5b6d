"""GPU-resident BFS engine — the port of ``raft_tla_tpu/device_engine.py``.

All search state that grows with the state space stays on the device: the
state store, the fingerprint table, parent links, action lanes, constraint
flags and coverage counters.  The host keeps only the scalar part of the
carry (counts, the level window, the chunk cursor, the violation and fail
words) and drives the chunk loop.

Per chunk, in the reference's order (``device_engine.py:333-399``):

1. the fused step (ops/pallas_step.build_step: the K1 kernel on the card,
   the plain torch step on the CPU; under SYMMETRY or a VIEW its keys are
   the viewed, orbit-minimal dedup keys) over ``chunk`` rows of the current
   level, read from the clamped window ``gstart = min(start, Ncap - B)``;
2. the fingerprint-set insert :func:`dedup_insert` — first discoverer wins;
3. the store append of the new states in discovery order, with parent,
   lane, constraint flag and coverage;
4. the first-violation (and, with ``check_deadlock``, deadlock) scan.

The carry keeps the reference's arrays and layouts — a ``[Ncap, W]`` int32
store; ``parent``/``lane``/``conflag``; ``tbl_hi``/``tbl_lo`` of shape
``[Tcap/8, 8]`` holding the uint32 key bits (here as int32), sentinel
all-ones, bucket ``lo & (TB - 1)``; the ``levels`` and ``cov`` counters; the
fail bits — so :meth:`DeviceEngine.carry_to_numpy` and
:meth:`DeviceEngine.carry_from_jax` move a search between the two packages,
and checkpoints are written in the reference's ``.npz`` format with the same
``config_digest``.  Device buffers carry one extra "sink" row or slot where
the reference scatters with ``mode="drop"``.

Host syncs: the dedup probe loop reads ``any(unresolved)`` once per
iteration, the append reads the new-state count, and the chunk's scan reads
one small stats vector; :attr:`DeviceEngine.stats` counts them, with the
chunks and (on the card) the device time of the steps (``step_s``) and of
the dedup inserts (``dedup_s``).

With an ``on_progress`` callback (the CLI's ``--stats``) or a run-event log
(``--events``) the chunks run in segments paced as the reference's are
(utils/pacing.py, about 8 s each), and each segment ends with one
:class:`~raft_tla_tpu_torch.obs.events.ProgressRecord` (one more host read,
the coverage counters).  The phase timers (``--phase-timers``) time each
chunk as ``expand`` (a chunk ends in a host sync, so no extra wait), the
coverage read as ``export`` and checkpoints as ``snapshot``.

Results do not depend on ``chunk``: a key's winner is the smallest flat
index, and chunks walk rows in order.

In faithful mode (``Bounds.history``) the rows are the faithful layout's
(the history fields after the parity ones, ops/state.py), and a successor
that finds the election slots full is the step's overflow: the search
stops with ``FAIL_WIDTH``, as the reference's does, never a clamp.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter

import numpy as np
import torch

from raft_tla_tpu_torch.config import CheckConfig
from raft_tla_tpu_torch.engine import DEADLOCK, EngineResult, Violation
from raft_tla_tpu_torch.models import interp, invariants as inv_mod, spec as S
from raft_tla_tpu_torch.obs.events import RunTelemetry
from raft_tla_tpu_torch.obs.phases import PhaseTimers
from raft_tla_tpu_torch.ops import pallas_fp, pallas_step
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym
from raft_tla_tpu_torch.utils import ckpt, pacing

_NO_PHASES = PhaseTimers()           # disabled: the shared null handle

I32, I64 = torch.int32, torch.int64
EMPTY = -1                  # table sentinel: both words all-ones
_MAX_PROBE = 64             # probe-iteration safety cap -> fail flag
BUCKET = 8                  # fingerprint-table slots per bucket row
BIG = np.iinfo(np.int32).max

CARRY_FIELDS = ("store", "parent", "lane", "conflag", "tbl_hi", "tbl_lo",
                "n_states", "lvl_start", "lvl_end", "viol_g", "viol_i",
                "n_trans", "cov", "fail", "levels", "lvl", "c")


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Sizes of one search (the reference's ``Capacities``)."""

    n_states: int = 1 << 20      # store rows (Ncap)
    levels: int = 256            # max BFS depth (Lcap)

    @property
    def table(self) -> int:      # hash slots, load factor <= 0.5
        return 1 << (2 * self.n_states - 1).bit_length()


# Failure bitmask (the reference's FAIL_* values).
FAIL_WIDTH = 1      # a successor exceeded a tensor-encoding capacity
FAIL_PROBE = 2      # linear probe exceeded _MAX_PROBE (table too full)
FAIL_STORE = 4      # more distinct states than Capacities.n_states
FAIL_LEVEL = 8      # BFS deeper than Capacities.levels
FAIL_RING = 16      # paged engine: live BFS window outgrew the ring
FAIL_ROUTE = 32     # DDD engine: the routed step's slots overflowed
FAIL_INDEX = 64     # DDD and paged engines: a discovery index past its
                    # ceiling

_FAIL_TEXT = {
    FAIL_WIDTH: "state-width overflow (encoding capacity exceeded)",
    FAIL_PROBE: "fingerprint-table probe overflow (table too full)",
    FAIL_STORE: "state-store capacity exceeded",
    FAIL_LEVEL: "BFS level capacity exceeded",
    FAIL_RING: "live BFS window exceeded the HBM ring",
    FAIL_ROUTE: "routing budget exceeded (all_to_all halo or EP "
                "route_rows too small)",
    FAIL_INDEX: "discovery index past the engine ceiling",
}


def decode_fail(fail_bits: int) -> str:
    return "; ".join(txt for bit, txt in _FAIL_TEXT.items()
                     if fail_bits & bit) or "unknown"


def aggregate_coverage(table, cov) -> Counter:
    """Per-action-family new-state counts from the per-lane counters."""
    cov = np.asarray(cov).reshape(-1, len(table)).sum(axis=0)
    out: Counter = Counter()
    for a, inst in enumerate(table):
        if cov[a]:
            out[inst.family] += int(cov[a])
    return out


_ROWS = {"store": np.int32, "parent": np.int32, "lane": np.int32,
         "conflag": bool}


def carry_arrays(c: dict, rows: int, A: int,
                 fields: tuple = CARRY_FIELDS) -> list:
    """A carry dict as the reference's ``fields`` arrays (``Carry``'s
    ``c0..c16`` by default, or the streamed engine's ``SCarry``): the first
    ``rows`` rows of the store (or ring) and its links, the table without
    its sink row, the counters as the reference's dtypes."""
    out = []
    for f in fields:
        x = c[f]
        if f in _ROWS:
            out.append(x[:rows].cpu().numpy())  # lint: jit-ok checkpoint snapshot, one copy a carry array
        elif f in ("tbl_hi", "tbl_lo"):
            out.append(x[:-1].cpu().numpy().view(np.uint32))  # lint: jit-ok checkpoint snapshot, one copy a carry array
        elif f == "n_trans":
            out.append(np.array([x & 0xFFFFFFFF, x >> 32], np.uint32))
        elif f == "cov":
            out.append(x[:A].cpu().numpy().astype(np.int32))  # lint: jit-ok checkpoint snapshot, one copy a carry array
        elif f == "levels":
            out.append(x.astype(np.int32).copy())
        else:
            out.append(np.int32(x))
    return out


def load_carry(c: dict, arrays: list, rows: int, A: int,
               fields: tuple = CARRY_FIELDS) -> dict:
    """Fill the freshly allocated carry dict ``c`` from the reference's
    ``fields`` arrays (shapes checked by the caller); returns it."""
    dev = c["store"].device
    for f, x in zip(fields, arrays):
        x = np.asarray(x)
        if f in _ROWS:
            c[f][:rows] = torch.as_tensor(x.astype(_ROWS[f]), device=dev)
        elif f in ("tbl_hi", "tbl_lo"):
            c[f][:x.shape[0]] = torch.as_tensor(
                x.astype(np.uint32).view(np.int32), device=dev)
        elif f == "n_trans":
            c[f] = n_trans_of(x)
        elif f == "cov":
            c[f][:A] = torch.as_tensor(x.astype(np.int64), device=dev)
        elif f == "levels":
            c[f] = x.astype(np.int32).copy()
        else:
            c[f] = int(x)
    return c


def n_trans_of(a) -> int:
    """The transition count of a checkpoint's ``n_trans``: the reference's
    two uint32 limbs (low, high), or one legacy int32."""
    nt = np.asarray(a).astype(np.uint64).reshape(-1)
    return int(nt[0]) if nt.size == 1 else int(nt[0]) | int(nt[1]) << 32


class SyncCounter:
    """Counts host syncs (device -> host reads) on the engine's hot path."""

    def __init__(self):
        self.n = 0

    def read(self, t: torch.Tensor):
        self.n += 1
        return t.tolist()

    def wait(self, ev: torch.cuda.Event) -> None:
        """Block the host until ``ev`` has completed."""
        self.n += 1
        ev.synchronize()


class DedupInsert:
    """Batched insert-if-absent of fingerprint pairs into ``shards`` hash
    sets at once, one probe round at a time: :func:`dedup_insert` drives
    one set, the shard engine every set of a device together (each shard's
    keys go to its own table, exactly as if it ran alone).

    ``tbl_hi``/``tbl_lo`` are ``[shards * (TB + 1), BUCKET]`` int32, each
    shard's ``TB`` buckets followed by its drop-sink row, and are updated
    in place; ``key_hi``/``key_lo``/``active`` are ``[shards * BA]``,
    shard-major.  After the last round ``is_new[c]`` iff candidate c's key
    was absent from its shard's table and c is the first active candidate
    (smallest index within the shard) with that key; ``unres[c]`` iff lane
    c was still unresolved.

    The reference's two stages (``device_engine._dedup_insert``):

    1. batch-first occurrences by a stable sort — one sort a shard on the
       64-bit key ``hi * 2^32 + (lo mod 2^32)``, a bijection of the pair
       (only key equality and id order matter), with inactive lanes on the
       all-ones key;
    2. a bucketized linear probe in which contenders for a bucket
       scatter-min their index into a hashed claim array of their shard
       (one extra sink slot stands in for ``mode="drop"``), so the smallest
       index wins — the oracle's first-discoverer-is-parent rule.
    """

    def __init__(self, tbl_hi, tbl_lo, key_hi, key_lo, active,
                 shards: int = 1, lanes: int | None = None):
        S, N = shards, key_hi.shape[0]
        BA = N // S
        self.S, self.BA = S, BA
        self.tbl_hi, self.tbl_lo = tbl_hi, tbl_lo
        self.key_hi, self.key_lo = key_hi, key_lo
        self.TB = TB = tbl_hi.shape[0] // S - 1
        dev = key_hi.device
        ids = torch.arange(N, dtype=I64, device=dev)
        kh64, kl64 = key_hi.to(I64), key_lo.to(I64)
        self.h0 = kl64 & (TB - 1)       # lo lane is already avalanche-mixed
        # the claim domain follows the batch's lanes, or ``lanes``: a
        # caller that left the inactive lanes of a batch out (keeping the
        # rest in order) passes its full size, and the claims, so the
        # table, are the full batch's
        L = BA if lanes is None else lanes
        self.CA = CA = max(1024, 1 << (4 * L - 1).bit_length())
        if S == 1:
            self.local, self.base, self.cbase, self.gid0 = ids, 0, 0, 0
        else:
            shard = ids // BA
            self.local = ids - shard * BA
            self.base, self.cbase, self.gid0 = (shard * (TB + 1),
                                                shard * CA, shard * BA)

        skey = (torch.where(active, kh64, -1) * (1 << 32)
                + (torch.where(active, kl64, -1) & 0xFFFFFFFF)).view(S, BA)
        perm = torch.sort(skey, dim=1, stable=True).indices
        if S > 1:
            perm = perm + torch.arange(0, N, BA, device=dev)[:, None]
        perm = perm.reshape(N)
        ph, pl = key_hi[perm].view(S, BA), key_lo[perm].view(S, BA)
        pa = active[perm].view(S, BA)
        same_as_prev = torch.zeros((S, BA), dtype=torch.bool, device=dev)
        same_as_prev[:, 1:] = (ph[:, 1:] == ph[:, :-1]) \
            & (pl[:, 1:] == pl[:, :-1]) & pa[:, 1:] & pa[:, :-1]
        first_of_key = torch.empty(N, dtype=torch.bool, device=dev)
        first_of_key[perm] = ~same_as_prev.reshape(N)
        self.unres = active & first_of_key
        self.is_new = torch.zeros(N, dtype=torch.bool, device=dev)
        self.dist = torch.zeros(N, dtype=I64, device=dev)
        self.rounds = 0

    def pending(self) -> torch.Tensor:
        """Whether each shard still has an unresolved lane (bool ``[S]``
        on the device)."""
        return self.unres.view(self.S, self.BA).any(1)

    def round(self) -> None:
        """One probe round of every shard (a no-op on a resolved one)."""
        tbl_hi, tbl_lo, key_hi, key_lo = (self.tbl_hi, self.tbl_lo,
                                          self.key_hi, self.key_lo)
        local, unres, CA, TB = self.local, self.unres, self.CA, self.TB
        S, BA = self.S, self.BA
        bidx = (self.h0 + self.dist) & (TB - 1)
        gb = bidx + self.base
        row_hi, row_lo = tbl_hi[gb], tbl_lo[gb]              # [N, BUCKET]
        slot_empty = (row_hi == EMPTY) & (row_lo == EMPTY)
        slot_match = (row_hi == key_hi[:, None]) & (row_lo == key_lo[:, None])
        dup_old = unres & slot_match.any(1)
        has_empty = slot_empty.any(1)
        contend = unres & ~dup_old & has_empty
        cidx = (bidx & (CA - 1)) + self.cbase
        claim = torch.full((S * CA + 1,), BA, dtype=I64, device=gb.device)
        claim.scatter_reduce_(0, torch.where(contend, cidx, S * CA),
                              torch.where(contend, local, BA), reduce="amin")
        cwin = claim[cidx]
        won = contend & (cwin == local)
        # first empty slot of the bucket
        wslot = (slot_empty & (torch.cumsum(slot_empty.to(I32), 1) == 1)
                 ).to(I32).argmax(1)
        wb = torch.where(won, gb, self.base + TB)
        tbl_hi[wb, wslot] = key_hi
        tbl_lo[wb, wslot] = key_lo
        # Losers consult the winner: if it put MY key in MY bucket I am a
        # duplicate; otherwise retry the same bucket (left only when full).
        wid = cwin.clamp(0, BA - 1) + self.gid0
        dup_batch = contend & ~won & (bidx[wid] == bidx) \
            & (key_hi[wid] == key_hi) & (key_lo[wid] == key_lo)
        self.unres = unres & ~(dup_old | won | dup_batch)
        self.dist = self.dist + (self.unres & ~has_empty).to(I64)
        self.is_new |= won
        self.rounds += 1


def dedup_insert(tbl_hi, tbl_lo, key_hi, key_lo, active, syncs: SyncCounter):
    """One table's :class:`DedupInsert` to the end: ``(is_new, unres)``.
    The loop runs on the host: one sync per probe round."""
    ins = DedupInsert(tbl_hi, tbl_lo, key_hi, key_lo, active)
    while ins.rounds < _MAX_PROBE and syncs.read(ins.unres.any()):
        ins.round()
    return ins.is_new, ins.unres


class DeviceEngine:
    """One exhaustive checker on one device; reusable across runs."""

    # Segment pacing under on_progress (the reference's values).
    SEG_TARGET_S = 8.0
    SEG_CLAMP_S = 25.0
    SEG_MIN, SEG_MAX = 16, 1 << 16

    def __init__(self, config: CheckConfig, caps: Capacities | None = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no "
                               "GPU; pass device='cpu' to run on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.config = config
        self.bounds = config.bounds
        self.lay = st.Layout.of(self.bounds)
        self.table = S.action_table(self.bounds, config.spec)
        self.A = len(self.table)
        self.W = self.lay.width
        self.caps = caps or Capacities()
        if self.caps.n_states < config.chunk:
            raise ValueError("Capacities.n_states must be >= config.chunk")
        self.step = pallas_step.build_step(
            self.bounds, config.spec, tuple(config.invariants), self.device,
            symmetry=tuple(config.symmetry), view=config.view)
        self.stats = {}
        self.carry = None
        self.seg_chunks = 64        # initial segment budget; then paced

    # -- carry ----------------------------------------------------------------

    def _alloc(self):
        Ncap, dev = self.caps.n_states, self.device
        TB = self.caps.table // BUCKET
        return {
            "store": torch.zeros((Ncap + 1, self.W), dtype=I32, device=dev),
            "parent": torch.full((Ncap + 1,), -1, dtype=I32, device=dev),
            "lane": torch.full((Ncap + 1,), -1, dtype=I32, device=dev),
            "conflag": torch.zeros((Ncap + 1,), dtype=torch.bool, device=dev),
            "tbl_hi": torch.full((TB + 1, BUCKET), EMPTY, dtype=I32,
                                 device=dev),
            "tbl_lo": torch.full((TB + 1, BUCKET), EMPTY, dtype=I32,
                                 device=dev),
            "cov": torch.zeros((self.A + 1,), dtype=I64, device=dev),
        }

    def init_carry(self, init_vec: np.ndarray, init_con: bool,
                   key: tuple | None = None) -> tuple:
        """Init in the store, its dedup key in the table; returns the key as
        a pair of uint32 ints.  ``key`` is the host key of a run with
        SYMMETRY or a VIEW (ops/symmetry.init_fingerprint); without one the
        key is the row's fingerprint (K2 on the card)."""
        c = self._alloc()
        row = torch.as_tensor(init_vec, dtype=I32, device=self.device)
        c["store"][0] = row
        c["conflag"][0] = bool(init_con)
        if key is None:
            hi, lo = pallas_fp.fingerprint_rows(row.reshape(1, -1))
        else:
            hi, lo = (torch.tensor(np.array([x], np.uint32).view(np.int32),  # lint: jit-ok Init key, once a run
                                   device=self.device) for x in key)
        TB = c["tbl_hi"].shape[0] - 1
        b0 = lo.to(I64) & (TB - 1)
        c["tbl_hi"][b0, 0] = hi
        c["tbl_lo"][b0, 0] = lo
        c.update(n_states=1, lvl_start=0, lvl_end=1, viol_g=-1, viol_i=0,
                 n_trans=0, fail=0, lvl=1, c=0,
                 levels=np.zeros((self.caps.levels,), np.int32))
        self.carry = c
        key = hi.to(I64).item() & 0xFFFFFFFF, lo.to(I64).item() & 0xFFFFFFFF  # lint: jit-ok Init key, once a run
        return key

    def carry_to_numpy(self) -> list:
        """The carry as the reference's ``Carry`` arrays ``c0..c16``."""
        return carry_arrays(self.carry, self.caps.n_states, self.A)

    def carry_from_jax(self, arrays) -> None:
        """Adopt a carry given as the reference's ``Carry`` arrays."""
        a = [np.asarray(x) for x in arrays]
        if len(a) != len(CARRY_FIELDS):
            raise ValueError(f"expected {len(CARRY_FIELDS)} carry arrays")
        Ncap, TB = self.caps.n_states, self.caps.table // BUCKET
        if a[0].shape != (Ncap, self.W) or a[4].shape != (TB, BUCKET) \
                or a[12].shape != (self.A,) \
                or a[14].shape != (self.caps.levels,):
            raise ValueError("carry shapes do not match this engine's "
                             "capacities and layout")
        self.carry = load_carry(self._alloc(), a, Ncap, self.A)

    def save_checkpoint(self, path: str, init_key: tuple) -> None:
        """Snapshot the carry in the reference's format (digest-pinned)."""
        ckpt.atomic_savez(
            path,
            **{f"c{i}": x for i, x in enumerate(self.carry_to_numpy())},
            config_digest=np.uint64(
                ckpt.config_digest(self.config, self.caps, init_key)),
            width=np.int64(self.W))

    def load_checkpoint(self, path: str, init_key: tuple) -> None:
        """Load a checkpoint written by either package (digest-checked)."""
        with ckpt.load_npz_checked(
                path, ckpt.config_digest(self.config, self.caps,
                                         init_key)) as z:
            arrs = [z[f"c{i}"] for i in range(len(CARRY_FIELDS))]
        self.carry_from_jax(arrs)

    # -- the search -------------------------------------------------------------

    def _done(self) -> bool:
        c = self.carry
        return (c["lvl_end"] <= c["lvl_start"] or c["viol_g"] >= 0
                or c["fail"] != 0)

    def _chunk(self) -> None:
        """One chunk of the current level (``chunk_body``)."""
        c, B, A = self.carry, self.config.chunk, self.A
        Ncap, dev = self.caps.n_states, self.device
        n_inv = len(self.config.invariants)
        start = c["lvl_start"] + c["c"] * B
        gstart = min(start, Ncap - B)          # clamped window
        rows_g = gstart + torch.arange(B, device=dev)
        row_act = (rows_g >= start) & (rows_g < c["lvl_end"])
        live = row_act & c["conflag"][gstart:gstart + B]
        ev = self._events
        if ev is not None:
            ev.append([torch.cuda.Event(enable_timing=True)
                       for _ in range(4)])
            ev[-1][0].record()
        out = self.step(c["store"][gstart:gstart + B])
        if ev is not None:
            ev[-1][1].record()
        valid = out["valid"] & live[:, None]
        fvalid = valid.reshape(-1)

        if ev is not None:
            ev[-1][2].record()
        is_new, unres = dedup_insert(
            c["tbl_hi"], c["tbl_lo"], out["fp_hi"].reshape(-1),
            out["fp_lo"].reshape(-1), fvalid, self._syncs)
        if ev is not None:
            ev[-1][3].record()

        # Append the new states in discovery order.
        new_idx = is_new.nonzero().squeeze(1)
        self._syncs.n += 1                     # nonzero reads its size
        n_new = new_idx.numel()
        n0 = c["n_states"]
        k = max(0, min(n_new, Ncap - n0))
        if k:
            idx = new_idx[:k]
            c["store"][n0:n0 + k] = out["svecs"].reshape(B * A, -1)[idx]
            c["parent"][n0:n0 + k] = (gstart + idx // A).to(I32)
            c["lane"][n0:n0 + k] = (idx % A).to(I32)
            c["conflag"][n0:n0 + k] = out["con_ok"].reshape(-1)[idx]
            c["cov"].index_add_(0, idx % A, torch.ones_like(idx))

        # First invariant violation among the new states, in discovery
        # order; with check_deadlock, the first expanded row without an
        # enabled action (flat priority b * A), whichever comes first.
        big = torch.tensor(BIG, dtype=I64, device=dev)  # lint: jit-ok hidden sync, ROADMAP queue B (d) 1
        if n_inv and n_new:
            bad = ~out["inv_ok"].reshape(B * A, n_inv)[new_idx]
            bad_any = bad.any(1)
            kfirst = torch.where(bad_any.any(), bad_any.to(I32).argmax(), -1)
            kc = kfirst.clamp(min=0)
            first = torch.where(kfirst >= 0, new_idx[kc], big)
            bad_inv = bad[kc].to(I32).argmax()
        else:
            kfirst = torch.tensor(-1, device=dev)  # lint: jit-ok hidden sync, ROADMAP queue B (d) 1
            first, bad_inv = big, torch.tensor(0, device=dev)  # lint: jit-ok hidden sync, ROADMAP queue B (d) 1
        if self.config.check_deadlock:
            dead = live & ~out["valid"].any(1)
            drow = torch.where(dead.any(), dead.to(I32).argmax(), -1)
        else:
            drow = torch.tensor(-1, device=dev)  # lint: jit-ok hidden sync, ROADMAP queue B (d) 1
        stats = torch.stack([t.to(I64) for t in (
            valid.sum(), (valid & out["overflow"]).any(), unres.any(),
            kfirst, first, bad_inv, drow)])
        n_valid, ovf, punres, kfirst, first, bad_inv, drow = \
            self._syncs.read(stats)

        c["n_trans"] += n_valid
        c["fail"] |= (FAIL_WIDTH if ovf else 0) | (FAIL_PROBE if punres else 0)
        if n0 + n_new > Ncap:
            c["fail"] |= FAIL_STORE
        c["n_states"] = min(n0 + n_new, Ncap)
        g_target = n0 + kfirst
        if drow >= 0 and drow * A < first:
            first, g_target, bad_inv = drow * A, gstart + drow, n_inv
        if first < BIG and c["viol_g"] < 0:
            c["viol_g"], c["viol_i"] = g_target, bad_inv
        c["c"] += 1

    def _advance(self) -> None:
        """Close the level once its chunks are done (``outer_body``)."""
        c, Lcap = self.carry, self.caps.levels
        n_chunks = -(-(c["lvl_end"] - c["lvl_start"]) // self.config.chunk)
        if c["c"] < n_chunks or c["viol_g"] >= 0 or c["fail"]:
            return
        n_new = c["n_states"] - c["lvl_end"]
        c["levels"][min(c["lvl"], Lcap - 1)] = n_new
        if c["lvl"] >= Lcap - 1 and n_new > 0:
            c["fail"] |= FAIL_LEVEL
        c["lvl_start"], c["lvl_end"] = c["lvl_end"], c["n_states"]
        c["lvl"] += 1
        c["c"] = 0

    def _run(self, max_chunks: int | None = None, checkpoint=None,
             checkpoint_every_s: float = 600.0, init_key=None,
             tel=None) -> bool:
        """Advance the search by at most ``max_chunks`` chunks (None: to
        the end); returns whether it is done.  With an active ``tel`` the
        chunks run in paced segments, each closed by a progress record."""
        steps, last = 0, time.monotonic()
        phases = tel.phases if tel is not None else _NO_PHASES
        pacer = None
        if tel is not None and tel.active:
            pacer = pacing.SegmentPacer(self.seg_chunks, self.SEG_MIN,
                                        self.SEG_MAX, self.SEG_TARGET_S,
                                        self.SEG_CLAMP_S)
            seg, t_seg = 0, time.monotonic()
        while not self._done():
            n_chunks = -(-(self.carry["lvl_end"] - self.carry["lvl_start"])
                         // self.config.chunk)
            if self.carry["c"] < n_chunks:
                if max_chunks is not None and steps >= max_chunks:
                    if pacer is not None and seg:
                        self._progress(tel)
                    return False
                with phases.phase("expand"):   # the chunk ends in a sync
                    self._chunk()
                self.stats["chunks"] = self.stats.get("chunks", 0) + 1
                steps += 1
                if pacer is not None:
                    seg += 1
            self._advance()
            if pacer is not None and (seg >= pacer.budget or self._done()):
                self._progress(tel)
                self.seg_chunks = pacer.update(time.monotonic() - t_seg, seg)
                seg, t_seg = 0, time.monotonic()
            if checkpoint and time.monotonic() - last >= checkpoint_every_s:
                with phases.phase("snapshot"):
                    self.save_checkpoint(checkpoint, init_key)
                if tel is not None:
                    tel.checkpoint(checkpoint)
                last = time.monotonic()
        return True

    def _progress(self, tel) -> None:
        """Close a segment: one progress record (the reference's)."""
        c = self.carry
        with tel.phases.phase("export"):
            cov = aggregate_coverage(self.table, c["cov"][:self.A].cpu())  # lint: jit-ok once a segment
        self._syncs.n += 1
        self.stats["segments"] = self.stats.get("segments", 0) + 1
        tel.segment(n_states=c["n_states"], level=c["lvl"],
                    n_transitions=c["n_trans"], coverage=dict(cov))

    def check(self, init_override: interp.PyState | None = None,
              checkpoint: str | None = None,
              checkpoint_every_s: float = 600.0,
              resume: str | None = None,
              max_chunks: int | None = None,
              on_progress=None, retain_carry: bool = False,
              events: str | None = None) -> EngineResult:
        """Run the search from Init (or ``init_override``, or a ``resume``
        checkpoint) to the end, or for at most ``max_chunks`` chunks
        (then ``complete`` is False and ``checkpoint``, if given, holds the
        carry).  ``on_progress``, if given, receives the reference's
        progress record (a dict) after every segment.

        ``retain_carry=True`` keeps the final carry (``store``, ``conflag``,
        ...) on ``self.retained_carry`` for a post-hoc pass (the liveness
        graph export, models/liveness.engine_graph).  Its buffers stay in
        device memory until the caller drops both ``retained_carry`` and
        ``carry``, which is the same dict.

        ``events`` is the run-event log (else ``RAFT_TLA_EVENTS``;
        obs/events.py), with the phase timers and trace spans of
        ``RAFT_TLA_PHASE_TIMERS`` and ``RAFT_TLA_TRACE``."""
        t0 = time.monotonic()
        tel = RunTelemetry(
            "device", config=self.config, caps=self.caps,
            on_progress=on_progress, events=events,
            resumed=resume is not None,
            n0=1 if resume is None else None, t0=t0)
        try:
            return self._check_impl(tel, t0, init_override, checkpoint,
                                    checkpoint_every_s, resume, max_chunks,
                                    retain_carry)
        finally:
            tel.close()

    def _check_impl(self, tel, t0, init_override, checkpoint,
                    checkpoint_every_s, resume, max_chunks,
                    retain_carry) -> EngineResult:
        bounds = self.bounds
        init_py = init_override if init_override is not None \
            else interp.init_state(bounds)
        tel.run_start()
        for nm in self.config.invariants:
            if not inv_mod.py_invariant(nm)(init_py, bounds):
                res = EngineResult(
                    n_states=1, diameter=0, n_transitions=0,
                    coverage=Counter(),
                    violation=Violation(nm, init_py, [(None, init_py)]),
                    levels=[1], wall_s=time.monotonic() - t0)
                tel.run_end(res)
                return res
        self._syncs = SyncCounter()
        # CUDA events around each step and each dedup insert (device time)
        self._events = [] if self.device.type == "cuda" else None
        self.stats = {"chunks": 0}
        init_vec = interp.to_vec(init_py, bounds)
        key = sym.init_fingerprint(self.config, init_py, init_vec) \
            if self.config.symmetry or self.config.view else None
        init_key = self.init_carry(init_vec,
                                   interp.constraint_ok(init_py, bounds), key)
        if resume:
            self.load_checkpoint(resume, init_key)
        done = self._run(max_chunks, checkpoint, checkpoint_every_s,
                         init_key, tel)
        if not done and checkpoint:
            with tel.phases.phase("snapshot"):
                self.save_checkpoint(checkpoint, init_key)
            tel.checkpoint(checkpoint)
        if self._events is not None:
            torch.cuda.synchronize(self.device)
            for key, (a, b) in (("step_s", (0, 1)), ("dedup_s", (2, 3))):
                self.stats[key] = sum(e[a].elapsed_time(e[b])
                                      for e in self._events) / 1e3
        self.stats["syncs"] = self._syncs.n
        c = self.carry
        if c["fail"]:
            raise RuntimeError(
                f"device search aborted: {decode_fail(c['fail'])} "
                f"(caps={self.caps}) — grow Capacities and rerun")
        levels = [1] + [int(x) for x in c["levels"][:c["lvl"]] if int(x) > 0]
        coverage = aggregate_coverage(self.table, c["cov"][:self.A].cpu())
        violation = self._extract_trace() if c["viol_g"] >= 0 else None
        if retain_carry:
            self.retained_carry = c
        result = EngineResult(
            n_states=c["n_states"], diameter=len(levels) - 1,
            n_transitions=c["n_trans"], coverage=coverage,
            violation=violation, levels=levels,
            wall_s=time.monotonic() - t0, complete=done)
        tel.run_end(result)
        return result

    def _extract_trace(self) -> Violation:
        """Two transfers: parent/lane links, then the chain's rows."""
        c = self.carry
        viol_g = c["viol_g"]
        parent = c["parent"][:viol_g + 1].cpu().numpy()
        lane = c["lane"][:viol_g + 1].cpu().numpy()
        chain_idx = []
        cur = viol_g
        while cur >= 0:
            chain_idx.append(cur)
            cur = int(parent[cur])
        chain_idx.reverse()
        rows = c["store"][torch.as_tensor(chain_idx, device=self.device)
                          ].cpu().numpy()
        chain = []
        for k, g in enumerate(chain_idx):
            py = interp.from_struct(st.unpack(rows[k], self.lay), self.bounds)
            label = self.table[int(lane[g])].label() if g > 0 else None
            chain.append((label, py))
        vi = c["viol_i"]
        inv_name = DEADLOCK if vi == len(self.config.invariants) \
            else self.config.invariants[vi]
        return Violation(invariant=inv_name, state=chain[-1][1], trace=chain)
