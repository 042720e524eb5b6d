"""The sharded BFS engine over a mesh of shards — the port of
``raft_tla_tpu/parallel/shard_engine.py``.

Every shard owns the slice of fingerprint space ``fp_hi % ndev == d``: its
part of the store (the states it owns, in its own discovery order), their
parent links as **global ids** ``d * Ncap + row`` (a trace crosses shards),
lanes, constraint flags and its own fingerprint table.  The frontier is a
contiguous window of each shard's store, as in the device engine, and the
mesh advances in lockstep: every shard expands the same number of chunks a
level (``n_chunks``, the largest window's), idle rows masked off.

One process drives every shard.  The reference's ``shard_map`` is itself
single-controller; here a :class:`Mesh` is a plain list of
``torch.device`` objects with its ``(n_slices, per_slice)`` shape, each
shard's tensors live on its device, and the reference's three collectives
become host-side code over the shards:

- **all_to_all** is :func:`exchange`, a pure function over the per-shard
  payloads: each source count-sorts its rows into ``n_dest x cap`` blocks
  (stable within a destination), and destination ``d`` receives the
  concatenation, in source order, of every source's block for ``d``
  (a ``.to(device, non_blocking=True)`` copy between cards).  A 2-D mesh
  exchanges in two stages, within a slice and then across slices, as the
  reference's hierarchical exchange does;
- **pmax** (the lockstep chunk count) and **psum** (termination, violation
  broadcast, level totals) are reductions over the host's per-shard
  scalars, read once a chunk: every shard's stats in one stacked tensor.

Per lockstep chunk, in the reference's order (``_build_segment``):

1. each shard expands its window's chunk with the fused step (K1 on the
   card, ops/pallas_step.build_step; the plain step on the CPU);
2. every valid candidate is routed to its owner with its flags word (bit 0
   occupied, bit 1 constraint, bits 2.. the invariants), its parent's
   global id and its lane;
3. the owner inserts the keys it received into its table
   (device_engine.DedupInsert; every shard's probe round shares one host
   sync), appends the new states in receive order, counts coverage, and
   finds its first violating new state and, with ``check_deadlock``, its
   first expanded row without an enabled action.

Determinism is the reference's: within a shard candidates arrive in
(sender shard, send slot) order and the dedup keeps the smallest index, so
discovery order, parent ids, lanes, coverage attribution and the
violation trace are fixed for a given mesh size and equal the JAX
``ShardEngine``'s at the same mesh size, bit for bit; totals, levels and
verdicts equal the single-device engines'.  Snapshots are the reference's
``SCarry`` arrays ``c0..c18`` (uint32 tables and ``n_trans`` limbs at the
numpy edge) under the reference's digest, so a search moves between the
two packages, and :func:`reshard_checkpoint` moves one between mesh
sizes.

Host syncs: one a probe round of the dedup insert (all shards together)
and one stats read a chunk; :attr:`ShardEngine.stats` counts them, with
the chunks and, on the card, the CUDA-event time of the steps, the
exchange and the dedup inserts (events on the first shard's device: on
one card that is every shard's work).
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from raft_tla_tpu_torch.config import CheckConfig
from raft_tla_tpu_torch.device_engine import (
    _MAX_PROBE, BUCKET, EMPTY, FAIL_LEVEL, FAIL_PROBE, FAIL_ROUTE,
    FAIL_STORE, FAIL_WIDTH, DedupInsert, SyncCounter, aggregate_coverage,
    decode_fail, n_trans_of)
from raft_tla_tpu_torch.engine import DEADLOCK, EngineResult, Violation
from raft_tla_tpu_torch.models import interp, invariants as inv_mod, spec as S
from raft_tla_tpu_torch.obs.events import RunTelemetry
from raft_tla_tpu_torch.ops import pallas_fp, pallas_step
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym
from raft_tla_tpu_torch.utils import ckpt, pacing

I32, I64 = torch.int32, torch.int64

# The reference's SCarry fields, in order: a snapshot's c0..c18.
SCARRY_FIELDS = ("store", "parent", "lane", "conflag", "tbl_hi", "tbl_lo",
                 "n_states", "lvl_start", "lvl_end", "viol_g", "viol_i",
                 "n_trans", "cov", "fail", "levels", "lvl", "c", "n_chunks",
                 "stop")


@dataclasses.dataclass(frozen=True)
class ShardCapacities:
    """Sizes of one sharded search, per shard where noted (the reference's
    ``ShardCapacities``: same fields and defaults, so the same digest).

    ``send`` is the per-destination routing depth of a chunk (None: the
    safe bound ``chunk * A``); a smaller one trades memory for a loud abort
    when one shard's candidates crowd one owner.  ``send2`` is the
    cross-slice stage's per-slice depth on a 2-D mesh (None: ``per_slice *
    send``)."""

    n_states: int = 1 << 17      # store rows per shard
    levels: int = 256
    send: Optional[int] = None
    send2: Optional[int] = None

    @property
    def table(self) -> int:      # per-shard hash slots, load factor <= 0.5
        return 1 << (2 * self.n_states - 1).bit_length()


class Mesh:
    """The shards' devices, flat id ``slice * per_slice + chip``, in
    ``n_slices`` slices of ``per_slice``.  A device may repeat: several shards
    then share one card (or the CPU)."""

    def __init__(self, devices, n_slices: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if n_slices < 1 or len(self.devices) % n_slices:
            raise ValueError(f"{len(self.devices)} devices do not make "
                             f"{n_slices} equal slices")
        for d in self.devices:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("device='cuda' asked for, but torch "
                                   "sees no GPU; pass device='cpu' to run "
                                   "on the CPU")
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {d}")
        self.n_slices = n_slices
        self.per_slice = len(self.devices) // n_slices

    @property
    def size(self) -> int:
        return len(self.devices)

    def groups(self) -> list:
        """Runs of consecutive shards on one device: ``(device, first
        shard, count)``; the engine stacks each run's tensors."""
        out = []
        for d, dev in enumerate(self.devices):
            if out and out[-1][0] == dev:
                out[-1] = (dev, out[-1][1], out[-1][2] + 1)
            else:
                out.append((dev, d, 1))
        return out

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"n_slices={self.n_slices})")


def _devices(n: int | None, device: str) -> list:
    """The first ``n`` devices of kind ``device`` (the reference's
    ``jax.devices()[:n]``): the cards, or ``n`` shards on the CPU."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (1 if n is None else n)
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but torch sees no GPU; "
                           "pass device='cpu' to run on the CPU")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n is not None:
        if n > len(devs):
            raise ValueError(
                f"need {n} devices, have {len(devs)} "
                "(tests: make_mesh(n, device='cpu'))")
        devs = devs[:n]
    return devs


def make_mesh(n_devices: int | None = None, device: str = "cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` cards (default: all), or of
    ``n_devices`` shards on the CPU with ``device="cpu"``."""
    return Mesh(_devices(n_devices, device))


def make_slice_mesh(n_slices: int, per_slice: int,
                    device: str = "cuda") -> Mesh:
    """A 2-D mesh of ``n_slices`` slices of ``per_slice`` shards: the
    exchange runs within a slice first, then across slices in one
    aggregated block a destination slice; flat ids are ``slice *
    per_slice + chip``."""
    devs = _devices(None if torch.device(device).type == "cuda"
                    else n_slices * per_slice, device)
    if n_slices * per_slice > len(devs):
        raise ValueError(
            f"need {n_slices * per_slice} devices, have {len(devs)} "
            "(tests: make_slice_mesh(s, n, device='cpu'))")
    return Mesh(devs[:n_slices * per_slice], n_slices=n_slices)


def _tolist(tensors: list) -> list:
    return [row for t in tensors for row in t.tolist()]  # lint: jit-ok the exchange's one count read


def exchange(n_dest: int, cap: int, dest: list, payload: list,
             read=_tolist) -> tuple:
    """The all_to_all of one mesh axis over ``n_dest`` shards.

    The shards come in blocks, each block's shards on one device: ``dest``
    lists each block's int64 ``[S_b, N]`` destinations (a row's destination
    shard, ``>= n_dest`` drops it) and ``payload`` each block's sequence of
    ``(values, fill)``, ``values`` of shape ``[S_b, N, ...]``; the rows of
    the blocks, in order, number the shards (sources and destinations
    alike, so ``n_dest`` is their total).

    Each source count-sorts its rows by destination (stable) into blocks of
    ``cap`` rows; rows past ``cap`` are dropped and set the source's
    overflow flag.  Destination ``d`` receives, in source order, every
    source's block for ``d``: the reference's ``n_dest * cap`` receive
    buffer with its padding left out, so a row's index there keeps the
    order of its (source, slot) position.  The per-destination counts come
    to the host in one ``read`` (one sync); the rows are gathered on the
    source's device and copied to the destination's (``non_blocking``).

    Returns ``(received, n_recv, overflow)``: per block, the payload as
    ``[S_b, M_b, ...]`` tensors (each shard's rows first, then ``fill``;
    ``M_b`` the block's largest count, at least 1), and per shard, the host
    count received and the host overflow flag."""
    offs = np.cumsum([0] + [d.shape[0] for d in dest])
    if offs[-1] != n_dest:
        raise ValueError(f"{offs[-1]} shards in the blocks, n_dest {n_dest}")
    sorted_rows, edges = [], []
    for d_b in dest:
        S_b, N = d_b.shape
        key = torch.where(d_b < n_dest, d_b, n_dest)
        skey, order = torch.sort(key, dim=1, stable=True)
        # each destination's run in the sorted keys (no atomics)
        edges.append(torch.searchsorted(skey, torch.arange(
            n_dest + 1, dtype=I64, device=d_b.device).expand(
                S_b, -1).contiguous()))
        sorted_rows.append((order + torch.arange(
            0, S_b * N, N, device=d_b.device)[:, None]).reshape(-1))
    edge = np.asarray(read(edges), np.int64).reshape(n_dest, n_dest + 1)
    start = edge[:, :n_dest]
    count = edge[:, 1:] - start
    take = np.minimum(count, cap)
    overflow = (count > cap).any(1).tolist()  # lint: jit-ok a numpy array, no copy from the card
    at = np.cumsum(take, axis=0) - take        # source s's rows in d's array
    n_recv = take.sum(0)
    received = []
    for h, d_h in enumerate(dest):
        dsts = range(int(offs[h]), int(offs[h + 1]))
        M = max(1, int(n_recv[dsts].max()))
        out = None
        for b, (d_b, pay_b) in enumerate(zip(dest, payload)):
            N = d_b.shape[1]
            # the sorted position of each received row from this block
            pos = np.full((len(dsts), M), -1, np.int64)
            for i, d in enumerate(dsts):
                for s in range(int(offs[b]), int(offs[b + 1])):
                    t = take[s, d]
                    pos[i, at[s, d]:at[s, d] + t] = \
                        (s - offs[b]) * N + start[s, d] + np.arange(t)
            if (pos < 0).all():
                continue
            pos_t = torch.as_tensor(pos, device=d_b.device)
            keep = pos_t >= 0
            src = sorted_rows[b][pos_t.clamp(min=0)]
            got = []
            for val, fill in pay_b:
                v = val.reshape((-1,) + val.shape[2:])[src]
                k = keep.reshape(keep.shape + (1,) * (val.dim() - 2))
                got.append((torch.where(k, v, fill).to(
                    d_h.device, non_blocking=True),
                    k.to(d_h.device, non_blocking=True)))
            out = [g for g, _k in got] if out is None else \
                [torch.where(k, g, o) for (g, k), o in zip(got, out)]
        if out is None:             # nothing for this block's shards
            out = [torch.full((len(dsts), M) + val.shape[2:], fill,
                              dtype=val.dtype, device=d_h.device)
                   for val, fill in payload[h]]
        received.append(out)
    return received, n_recv.tolist(), overflow  # lint: jit-ok a numpy array, no copy from the card


class ShardEngine:
    """The segmented exhaustive checker over a mesh of shards; reusable
    across runs."""

    # The reference's segment pacing.
    SEG_TARGET_S = 8.0
    SEG_CLAMP_S = 25.0
    SEG_MIN, SEG_MAX = 16, 1 << 16

    def __init__(self, config: CheckConfig, mesh: Mesh | None = None,
                 caps: ShardCapacities | None = None, seg_chunks: int = 256):
        self.config = config
        self.bounds = config.bounds
        self.lay = st.Layout.of(self.bounds)
        self.table = S.action_table(self.bounds, config.spec)
        self.A = len(self.table)
        self.W = self.lay.width
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ndev = self.mesh.size
        self.caps = caps or ShardCapacities()
        if self.caps.n_states < config.chunk:
            raise ValueError("ShardCapacities.n_states must be >= chunk")
        # Global state ids are int32 ``dev * Ncap + row`` (parent links,
        # viol_g): the address space must fit, or ids on high shards wrap
        # negative.  Fail at construction, not mid-run.
        if self.ndev * self.caps.n_states > 2**31 - 1:
            raise ValueError(
                f"ndev * n_states = {self.ndev} * {self.caps.n_states} "
                "exceeds the int32 global-id space (2^31-1); shrink "
                "ShardCapacities.n_states")
        if len(config.invariants) > 29:
            raise ValueError("at most 29 invariants (bit-packed into int32 "
                             "flags)")
        self.seg_chunks = seg_chunks
        self.nici = self.mesh.per_slice
        self.nslice = self.mesh.n_slices
        B = config.chunk
        self.csend = self.caps.send if self.caps.send is not None \
            else B * self.A
        self.csend2 = self.caps.send2 if self.caps.send2 is not None \
            else self.nici * self.csend
        # shards on one device form a group whose tensors are stacked:
        # (device, first shard, shard count), and each shard's place
        self.groups = self.mesh.groups()
        self.place = [(g, p) for g, (_dev, _d0, n) in enumerate(self.groups)
                      for p in range(n)]
        # one step a device (its tables live there)
        self.steps = {}
        for dev, _d0, _n in self.groups:
            if dev not in self.steps:
                self.steps[dev] = pallas_step.build_step(
                    self.bounds, config.spec, tuple(config.invariants), dev,
                    symmetry=tuple(config.symmetry), view=config.view)
        self.stats = {}
        self._syncs = SyncCounter()
        self._events = None
        self.gc = None
        self.h = None

    # -- carry ----------------------------------------------------------------

    def _alloc(self) -> list:
        Ncap, TB, W = self.caps.n_states, self.caps.table // BUCKET, self.W
        out = []
        for dev, _d0, n in self.groups:
            out.append({
                "store": torch.zeros((n, Ncap + 1, W), dtype=I32, device=dev),
                "parent": torch.full((n, Ncap + 1), -1, dtype=I32,
                                     device=dev),
                "lane": torch.full((n, Ncap + 1), -1, dtype=I32, device=dev),
                "conflag": torch.zeros((n, Ncap + 1), dtype=torch.bool,
                                       device=dev),
                "tbl_hi": torch.full((n, TB + 1, BUCKET), EMPTY, dtype=I32,
                                     device=dev),
                "tbl_lo": torch.full((n, TB + 1, BUCKET), EMPTY, dtype=I32,
                                     device=dev),
                "cov": torch.zeros((n, self.A + 1), dtype=I64, device=dev),
            })
        return out

    def _init_carry(self, init_vec, key: tuple, con0: bool) -> None:
        """Init on its fingerprint owner, its key in that shard's table."""
        nd = self.ndev
        hi0, lo0 = key
        own = hi0 % nd
        self.gc = self._alloc()
        g, p = self.place[own]
        gc = self.gc[g]
        gc["store"][p, 0] = torch.as_tensor(np.asarray(init_vec, np.int32),
                                            device=gc["store"].device)
        gc["conflag"][p, 0] = bool(con0)
        b0 = lo0 & (self.caps.table // BUCKET - 1)
        gc["tbl_hi"][p, b0, 0] = int(np.uint32(hi0).view(np.int32))
        gc["tbl_lo"][p, b0, 0] = int(np.uint32(lo0).view(np.int32))
        n0 = [0] * nd
        n0[own] = 1
        self.h = dict(
            n_states=n0, lvl_start=[0] * nd, lvl_end=list(n0),
            viol_g=[-1] * nd, viol_i=[0] * nd, n_trans=[0] * nd,
            fail=[0] * nd, levels=np.zeros((self.caps.levels,), np.int32),
            lvl=1, c=0, n_chunks=1, stop=False)

    def carry_to_numpy(self) -> list:
        """The mesh-wide carry as the reference's ``SCarry`` arrays
        ``c0..c18`` (global leading dims ``ndev * per-shard``)."""
        Ncap, A, h = self.caps.n_states, self.A, self.h

        def cat(f, cut, dtype=None):
            parts = []
            for gc in self.gc:
                x = gc[f][:, :cut].cpu().numpy()  # lint: jit-ok checkpoint snapshot, one copy a carry array
                parts.append(x.reshape((-1,) + x.shape[2:]))
            x = parts[0] if len(parts) == 1 else np.concatenate(parts)
            return x.view(np.uint32) if dtype == "u32" else \
                x.astype(dtype) if dtype else x
        out = []
        for f in SCARRY_FIELDS:
            if f in ("store", "parent", "lane", "conflag"):
                out.append(cat(f, Ncap))
            elif f in ("tbl_hi", "tbl_lo"):
                out.append(cat(f, -1, "u32"))
            elif f == "cov":
                out.append(cat(f, A, np.int32))
            elif f == "n_trans":
                out.append(np.array([[x & 0xFFFFFFFF, x >> 32]
                                     for x in h[f]], np.uint32).reshape(-1))
            elif f == "levels":
                out.append(h[f].astype(np.int32).copy())
            elif f == "stop":
                out.append(np.asarray(bool(h[f])))
            else:
                out.append(np.asarray(h[f], np.int32))
        return out

    def carry_from_numpy(self, arrays) -> None:
        """Adopt a carry given as the reference's ``SCarry`` arrays."""
        a = dict(zip(SCARRY_FIELDS, (np.asarray(x) for x in arrays)))
        if len(a) != len(SCARRY_FIELDS):
            raise ValueError(f"expected {len(SCARRY_FIELDS)} carry arrays")
        nd, Ncap, A = self.ndev, self.caps.n_states, self.A
        TB = self.caps.table // BUCKET
        if a["store"].shape != (nd * Ncap, self.W) \
                or a["tbl_hi"].shape != (nd * TB, BUCKET) \
                or a["cov"].shape != (nd * A,) \
                or a["n_states"].shape != (nd,) \
                or a["levels"].shape != (self.caps.levels,):
            raise ValueError("carry shapes do not match this engine's "
                             "mesh, capacities and layout")
        self.gc = self._alloc()
        for gc, (dev, d0, n) in zip(self.gc, self.groups):
            def put(f, per, dtype, cut):
                x = a[f][d0 * per:(d0 + n) * per]
                x = x.astype(np.uint32).view(np.int32) if dtype == "u32" \
                    else x.astype(dtype)
                gc[f][:, :cut] = torch.as_tensor(
                    x.reshape((n, per) + x.shape[1:]), device=dev)
            for f, dt in (("store", np.int32), ("parent", np.int32),
                          ("lane", np.int32), ("conflag", bool)):
                put(f, Ncap, dt, Ncap)
            put("tbl_hi", TB, "u32", TB)
            put("tbl_lo", TB, "u32", TB)
            put("cov", A, np.int64, A)
        nt = a["n_trans"].astype(np.uint64).reshape(nd, -1)
        self.h = dict(
            n_states=[int(x) for x in a["n_states"]],
            lvl_start=[int(x) for x in a["lvl_start"]],
            lvl_end=[int(x) for x in a["lvl_end"]],
            viol_g=[int(x) for x in a["viol_g"]],
            viol_i=[int(x) for x in a["viol_i"]],
            n_trans=[n_trans_of(x) for x in nt],
            fail=[int(x) for x in a["fail"]],
            levels=a["levels"].astype(np.int32).copy(), lvl=int(a["lvl"]),
            c=int(a["c"]), n_chunks=int(a["n_chunks"]),
            stop=bool(a["stop"]))

    def save_checkpoint(self, path: str, init_key: tuple) -> None:
        """The reference's snapshot (the mesh size joins the digest key: the
        ownership map depends on it)."""
        ckpt.atomic_savez(
            path, **{f"c{i}": x for i, x in enumerate(self.carry_to_numpy())},
            config_digest=np.uint64(ckpt.config_digest(
                self.config, self.caps, tuple(init_key) + (self.ndev,))))

    def load_checkpoint(self, path: str, init_key: tuple) -> None:
        """Load a snapshot written by either package (digest-checked)."""
        with ckpt.load_npz_checked(
                path, ckpt.config_digest(
                    self.config, self.caps,
                    tuple(init_key) + (self.ndev,))) as z:
            arrs = [z[f"c{i}"] for i in range(len(SCARRY_FIELDS))]
        self.carry_from_numpy(arrs)

    # -- the lockstep chunk ---------------------------------------------------

    def _read(self, tensors: list) -> list:
        """One host sync for tensors of one trailing shape on any devices,
        concatenated along dim 0."""
        dev0 = self.groups[0][0]
        self._syncs.n += 1
        return torch.cat([t.to(dev0, non_blocking=True)  # lint: jit-ok one read of every shard's values, stacked
                          for t in tensors]).tolist()

    def _owner(self, key_hi: torch.Tensor) -> torch.Tensor:
        return (key_hi.to(I64) & 0xFFFFFFFF) % self.ndev

    def _blocks(self, ids: list) -> list:
        """The shards ``ids`` (ascending, evenly spaced) as ``(group,
        slice of its stacked rows)`` blocks, in order."""
        out = []
        for g, (_dev, d0, n) in enumerate(self.groups):
            pos = [d - d0 for d in ids if d0 <= d < d0 + n]
            if pos:
                step = pos[1] - pos[0] if len(pos) > 1 else 1
                out.append((g, slice(pos[0], pos[-1] + 1, step)))
        return out

    def _exchange(self, ids_of, n_dest, cap, dests, payload, fills):
        """Run :func:`exchange` over each shard set of ``ids_of`` (the
        slices, or the chips across slices).  Returns each group's received
        payload (``[n, M]`` tensors, ``M`` the group's largest count), and
        each shard's overflow flag."""
        parts, ovf = [], [False] * self.ndev
        for ids in ids_of:
            blocks = self._blocks(ids)
            got, _n_recv, of = exchange(
                n_dest, cap, [dests[g][sl] for g, sl in blocks],
                [[(v[sl], f) for v, f in zip(payload[g], fills)]
                 for g, sl in blocks], read=self._read)
            for d, o in zip(ids, of):
                ovf[d] = o
            parts += [(g, sl, vals) for (g, sl), vals in zip(blocks, got)]
        recv = [None] * len(self.groups)
        for g, (_dev, _d0, n) in enumerate(self.groups):
            mine = [(sl, vals) for gg, sl, vals in parts if gg == g]
            if len(mine) == 1 and mine[0][0] == slice(0, n, 1):
                recv[g] = mine[0][1]
                continue
            M = max(vals[0].shape[1] for _sl, vals in mine)
            recv[g] = [torch.full((n, M) + v.shape[2:], f, dtype=v.dtype,
                                  device=v.device)
                       for v, f in zip(mine[0][1], fills)]
            for sl, vals in mine:
                for dst, v in zip(recv[g], vals):
                    dst[sl, :v.shape[1]] = v
        return recv, ovf

    def _chunk(self) -> None:
        """One lockstep chunk on every shard (``chunk_body``)."""
        h, B, A, W = self.h, self.config.chunk, self.A, self.W
        Ncap, BA = self.caps.n_states, self.config.chunk * self.A
        nici, nslice = self.nici, self.nslice
        n_inv = len(self.config.invariants)
        ev = self._events
        if ev is not None:
            ev.append([torch.cuda.Event(enable_timing=True)
                       for _ in range(4)])
            ev[-1][0].record()
        starts = [s + h["c"] * B for s in h["lvl_start"]]
        gstarts = [min(max(s, 0), Ncap - B) for s in starts]
        outs = []
        for gc, (dev, d0, n) in zip(self.gc, self.groups):
            rows = torch.stack([gc["store"][p, gstarts[d0 + p]:
                                            gstarts[d0 + p] + B]
                                for p in range(n)])
            outs.append(self.steps[dev](rows.reshape(n * B, W)))
        if ev is not None:
            ev[-1][1].record()
        # route every valid candidate to its owner's in-slice index
        dests, sends, src_stats = [], [], []
        for gc, out, (dev, d0, n) in zip(self.gc, outs, self.groups):
            live = torch.zeros((n, B), dtype=torch.bool, device=dev)
            par = torch.empty((n, BA), dtype=I32, device=dev)
            flat = torch.arange(BA, dtype=I32, device=dev)
            for p in range(n):
                d, g0 = d0 + p, gstarts[d0 + p]
                lo = min(max(starts[d] - g0, 0), B)
                hi = min(max(h["lvl_end"][d] - g0, 0), B)
                live[p, lo:hi] = gc["conflag"][p, g0 + lo:g0 + hi]
                torch.add(flat // A, d * Ncap + g0, out=par[p])
            valid0 = out["valid"].view(n, B, A)
            valid = valid0 & live[:, :, None]
            fvalid = valid.reshape(n, BA)
            fhi, flo = out["fp_hi"].view(n, BA), out["fp_lo"].view(n, BA)
            flags = 1 | (out["con_ok"].view(n, BA).to(I32) << 1)
            if n_inv:
                bits = 1 << (2 + torch.arange(n_inv, dtype=I32, device=dev))
                flags = flags | (out["inv_ok"].view(n, BA, n_inv).to(I32)
                                 * bits).sum(2, dtype=I32)
            dests.append(torch.where(fvalid, self._owner(fhi) % nici, nici))
            sends.append((out["svecs"].view(n, BA, W), fhi, flo, par,
                          (flat % A).expand(n, BA), flags))
            if self.config.check_deadlock:
                dead = live & ~valid0.any(2)
                drow = torch.where(dead.any(1), dead.to(I64).argmax(1), -1)
            else:
                drow = torch.full((n,), -1, dtype=I64, device=dev)
            src_stats.append((valid.sum((1, 2)),
                              (valid & out["overflow"].view(n, B, A)
                               ).flatten(1).any(1), drow))
        del outs
        # stage A within each slice (on a 1-D mesh, the whole exchange)
        fills = (0, EMPTY, EMPTY, -1, -1, 0)
        recv, ovf = self._exchange(
            [list(range(s * nici, (s + 1) * nici)) for s in range(nslice)],
            nici, self.csend, dests, sends, fills)
        lanes = nici * self.csend           # the reference's receive buffer
        del sends, dests
        if nslice > 1:
            # stage B across slices: every active row already sits on its
            # owner's chip index; forward it to the owner's slice
            dest_b = [torch.where((r[5] & 1) == 1,
                                  self._owner(r[1]) // nici, nslice)
                      for r in recv]
            recv, ovf_b = self._exchange(
                [[s * nici + c for s in range(nslice)] for c in range(nici)],
                nslice, self.csend2, dest_b, recv, fills)
            ovf = [a or b for a, b in zip(ovf, ovf_b)]
            lanes = nslice * self.csend2
        if ev is not None:
            ev[-1][2].record()
        # owner-side dedup: every group's probe round in one host sync
        TB = self.caps.table // BUCKET
        ins = []
        for gc, r, (_dev, _d0, n) in zip(self.gc, recv, self.groups):
            ins.append(DedupInsert(
                gc["tbl_hi"].view(n * (TB + 1), BUCKET),
                gc["tbl_lo"].view(n * (TB + 1), BUCKET), r[1].reshape(-1),
                r[2].reshape(-1), ((r[5] & 1) == 1).reshape(-1), shards=n,
                lanes=lanes))
        live = list(range(len(self.groups)))
        while live:
            live = [g for g in live if ins[g].rounds < _MAX_PROBE]
            if not live:
                break
            more = self._read([ins[g].unres.any()[None] for g in live])
            live = [g for g, m in zip(live, more) if m]
            for g in live:
                ins[g].round()
        if ev is not None:
            ev[-1][3].record()
        # each shard's first violating new state, then one stats read
        stats, csums = [], []
        for g, (r, (dev, _d0, n)) in enumerate(zip(recv, self.groups)):
            NR = r[1].shape[1]
            is_new = ins[g].is_new.view(n, NR)
            csum = torch.cumsum(is_new.to(I64), 1)
            csums.append(csum)
            if n_inv:
                ok_all = (1 << n_inv) - 1
                inv_bad = is_new & (((r[5] >> 2) & ok_all) != ok_all)
                first = torch.where(inv_bad.any(1),
                                    inv_bad.to(I64).argmax(1), -1)
                fc = first.clamp(min=0)[:, None]
                rank = csum.gather(1, fc)[:, 0] - 1
                fbits = (r[5].gather(1, fc) >> 2).to(I64)
                bad_inv = (((fbits >> torch.arange(n_inv, device=dev)) & 1)
                           == 0).to(I64).argmax(1)
            else:
                first = rank = bad_inv = torch.full((n,), -1, dtype=I64,
                                                    device=dev)
            stats.append(torch.stack([t.to(I64) for t in (
                *src_stats[g], ins[g].unres.view(n, NR).any(1), csum[:, -1],
                first, rank, bad_inv)], dim=1))
        vals = self._read(stats)
        for d, v in enumerate(vals):
            n_valid, wovf, drow, unres, n_new, first, rank, bad_inv = v
            oa = ovf[d]
            g, p = self.place[d]
            gc, r = self.gc[g], recv[g]
            h["n_trans"][d] += n_valid
            h["fail"][d] |= (FAIL_WIDTH if wovf else 0) \
                | (FAIL_ROUTE if oa else 0) \
                | (FAIL_PROBE if unres else 0)
            n0 = h["n_states"][d]
            k = max(0, min(n_new, Ncap - n0))
            if k:
                idx = torch.searchsorted(csums[g][p], torch.arange(
                    1, k + 1, dtype=I64, device=csums[g].device))
                gc["store"][p, n0:n0 + k] = r[0][p, idx]
                gc["parent"][p, n0:n0 + k] = r[3][p, idx]
                lane = r[4][p, idx]
                gc["lane"][p, n0:n0 + k] = lane
                gc["conflag"][p, n0:n0 + k] = ((r[5][p, idx] >> 1) & 1) == 1
                gc["cov"][p].index_add_(0, lane.to(I64),
                                        torch.ones_like(idx))
            if n0 + n_new > Ncap:
                h["fail"][d] |= FAIL_STORE
            h["n_states"][d] = min(n0 + n_new, Ncap)
            if first >= 0 and h["viol_g"][d] < 0:
                h["viol_g"][d], h["viol_i"][d] = d * Ncap + n0 + rank, bad_inv
            if drow >= 0 and h["viol_g"][d] < 0:
                h["viol_g"][d] = d * Ncap + gstarts[d] + drow
                h["viol_i"][d] = n_inv
        h["stop"] = any(g >= 0 for g in h["viol_g"]) or any(h["fail"])
        h["c"] += 1

    def _advance(self) -> None:
        """Close the level once its lockstep chunks are done (the level
        advance of ``outer_body``)."""
        h, B, Lcap = self.h, self.config.chunk, self.caps.levels
        if h["c"] < h["n_chunks"] or h["stop"]:
            return
        n_new_tot = sum(n - e for n, e in zip(h["n_states"], h["lvl_end"]))
        h["levels"][min(h["lvl"], Lcap - 1)] = n_new_tot
        if h["lvl"] >= Lcap - 1 and n_new_tot > 0:
            h["fail"] = [f | FAIL_LEVEL for f in h["fail"]]
        h["lvl_start"], h["lvl_end"] = h["lvl_end"], list(h["n_states"])
        h["n_chunks"] = max(-(-(e - s) // B) for s, e in
                            zip(h["lvl_start"], h["lvl_end"]))
        h["stop"] = n_new_tot == 0 or any(h["fail"])
        h["lvl"] += 1
        h["c"] = 0

    def _segment(self, budget: int) -> int:
        """Up to ``budget`` lockstep chunks (the reference's segment);
        returns the chunks executed."""
        steps = 0
        while steps < budget and not self.h["stop"]:
            self._chunk()
            steps += 1
            self._advance()
        self.stats["chunks"] = self.stats.get("chunks", 0) + steps
        return steps

    # -- public API -----------------------------------------------------------

    def check(self, init_override: interp.PyState | None = None,
              checkpoint: str | None = None,
              checkpoint_every_s: float = 600.0,
              resume: str | None = None,
              on_progress=None, events: str | None = None) -> EngineResult:
        """Run the search from Init (or ``init_override``, or a ``resume``
        snapshot of either package) to the end; ``checkpoint`` receives a
        snapshot at segment ends every ``checkpoint_every_s`` seconds."""
        t0 = time.monotonic()
        tel = RunTelemetry(
            "shard", config=self.config, caps=self.caps,
            on_progress=on_progress, events=events,
            resumed=resume is not None,
            n0=1 if resume is None else None,
            n_devices=self.ndev, t0=t0)
        try:
            return self._check_impl(tel, t0, init_override, checkpoint,
                                    checkpoint_every_s, resume)
        finally:
            tel.close()

    def init_key(self, init_py, init_vec) -> tuple:
        """Init's dedup key as uint32 ints: the host key under SYMMETRY or
        a VIEW (ops/symmetry.init_fingerprint), else K2 on the first
        shard's device (its plain version on the CPU)."""
        if self.config.symmetry or self.config.view:
            return sym.init_fingerprint(self.config, init_py, init_vec)
        row = torch.as_tensor(np.asarray(init_vec, np.int32),
                              device=self.mesh.devices[0]).reshape(1, -1)
        hi, lo = pallas_fp.fingerprint_rows(row)
        return (hi.to(I64).item() & 0xFFFFFFFF,  # lint: jit-ok Init key, once a run
                lo.to(I64).item() & 0xFFFFFFFF)  # lint: jit-ok Init key, once a run

    def _check_impl(self, tel, t0, init_override, checkpoint,
                    checkpoint_every_s, resume) -> EngineResult:
        bounds = self.bounds
        init_py = init_override if init_override is not None \
            else interp.init_state(bounds)
        init_vec = interp.to_vec(init_py, bounds)
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
        self._events = [] if self.groups[0][0].type == "cuda" else None
        self.stats = {"chunks": 0}
        key = self.init_key(init_py, init_vec)
        if resume:
            self.load_checkpoint(resume, key)
        else:
            self._init_carry(init_vec, key,
                             interp.constraint_ok(init_py, bounds))
        pacer = pacing.SegmentPacer(self.seg_chunks, self.SEG_MIN,
                                    self.SEG_MAX, self.SEG_TARGET_S,
                                    self.SEG_CLAMP_S)
        budget = pacer.budget
        last_ckpt = time.monotonic()
        while True:
            t_seg = time.monotonic()
            with tel.phases.phase("expand"):     # a chunk ends in a sync
                executed = self._segment(budget)
            self.stats["segments"] = self.stats.get("segments", 0) + 1
            if tel.active:
                with tel.phases.phase("export"):
                    cov = self._coverage()
                tel.segment(n_states=sum(self.h["n_states"]),
                            level=self.h["lvl"],
                            n_transitions=sum(self.h["n_trans"]),
                            coverage=dict(cov))
            if self.h["stop"]:
                break
            dt = time.monotonic() - t_seg
            if checkpoint and (time.monotonic() - last_ckpt
                               >= checkpoint_every_s):
                with tel.phases.phase("snapshot"):
                    self.save_checkpoint(checkpoint, key)
                tel.checkpoint(checkpoint)
                last_ckpt = time.monotonic()
            budget = pacer.update(dt, max(1, executed))
            self.seg_chunks = budget
        if self._events is not None:
            torch.cuda.synchronize(self.groups[0][0])
            for name, (a, b) in (("step_s", (0, 1)), ("exchange_s", (1, 2)),
                                 ("dedup_s", (2, 3))):
                self.stats[name] = sum(e[a].elapsed_time(e[b])
                                       for e in self._events) / 1e3
        self.stats["syncs"] = self._syncs.n
        self.stats["per_shard_states"] = list(self.h["n_states"])
        h = self.h
        fail = 0
        for f in h["fail"]:
            fail |= f
        if fail:
            raise RuntimeError(
                f"sharded search aborted: {decode_fail(fail)} "
                f"(caps={self.caps}, ndev={self.ndev}) — grow "
                "ShardCapacities and rerun")
        # the partly explored violating level is never recorded (the level
        # window only advances on completed levels), as in refbfs
        levels = [1] + [int(x) for x in h["levels"][:h["lvl"]] if int(x) > 0]
        violation = None
        viol = [d for d, g in enumerate(h["viol_g"]) if g >= 0]
        if viol:
            violation = self._extract_trace(h["viol_g"][viol[0]],
                                            h["viol_i"][viol[0]])
        result = EngineResult(
            n_states=sum(h["n_states"]), diameter=len(levels) - 1,
            n_transitions=sum(h["n_trans"]), coverage=self._coverage(),
            violation=violation, levels=levels,
            wall_s=time.monotonic() - t0)
        tel.run_end(result)
        return result

    def _coverage(self) -> Counter:
        """Per-action-family new-state counts summed over the shards."""
        self._syncs.n += 1
        cov = sum(gc["cov"][:, :self.A].sum(0).cpu() for gc in self.gc)  # lint: jit-ok once a segment
        return aggregate_coverage(self.table, cov)

    def _extract_trace(self, viol_g: int, viol_i: int) -> Violation:
        """Walk the cross-shard parent chain by global id."""
        Ncap = self.caps.n_states
        chain = []
        cur = viol_g
        while cur >= 0:
            d, row = divmod(cur, Ncap)
            g, p = self.place[d]
            gc = self.gc[g]
            chain.append((cur, gc["store"][p, row].cpu().numpy(),  # lint: jit-ok trace extraction, one row a step
                          int(gc["lane"][p, row])))
            cur = int(gc["parent"][p, row])
        chain.reverse()
        trace = []
        for k, (_g, row, lane) in enumerate(chain):
            py = interp.from_struct(st.unpack(row, self.lay), self.bounds)
            trace.append((self.table[lane].label() if k > 0 else None, py))
        inv_name = DEADLOCK if viol_i == len(self.config.invariants) \
            else self.config.invariants[viol_i]
        return Violation(invariant=inv_name, state=trace[-1][1], trace=trace)


def check(config: CheckConfig, mesh: Mesh | None = None,
          caps: ShardCapacities | None = None, **kw) -> EngineResult:
    """One-shot convenience mirroring the other engines' ``check``."""
    return ShardEngine(config, mesh, caps).check(**kw)


def reshard_keys(config: CheckConfig, rows: np.ndarray, device) -> tuple:
    """The dedup keys of stored rows (uint32 ``(hi, lo)`` arrays), on
    ``device`` with the kernels that key the run: K2 without SYMMETRY or a
    VIEW, else the orbit-key entry of K1's library with the run's axes and
    view (ops/orbit_key.py); on the CPU their plain versions."""
    from raft_tla_tpu_torch.ops import orbit_key
    device = torch.device(device)
    keyer = orbit_key.build_keyer(config.bounds, tuple(config.symmetry),
                                  config.view) \
        if config.symmetry or config.view else None
    M = rows.shape[0]
    hi = np.empty((M,), np.uint32)
    lo = np.empty((M,), np.uint32)
    CH = 1 << 20
    for o in range(0, M, CH):
        blk = torch.as_tensor(rows[o:o + CH], device=device)
        h, l = keyer(blk) if keyer is not None \
            else pallas_fp.fingerprint_rows(blk)
        hi[o:o + blk.shape[0]] = h.cpu().numpy().view(np.uint32)  # lint: jit-ok reshard keys, one copy a block of 2^20 rows
        lo[o:o + blk.shape[0]] = l.cpu().numpy().view(np.uint32)  # lint: jit-ok reshard keys, one copy a block of 2^20 rows
    return hi, lo


def reshard_checkpoint(config: CheckConfig, caps_src: ShardCapacities,
                       src_path: str, dst_path: str, ndev_dst: int,
                       caps_dst: ShardCapacities | None = None,
                       init_override: interp.PyState | None = None,
                       device: str = "cuda") -> dict:
    """Rewrite a shard-engine snapshot (of either package) for a mesh of
    ``ndev_dst`` shards — the reference's ``reshard_checkpoint``.

    The snapshot's ownership map (``owner = fp_hi % ndev``) and its global
    ids (``dev * Ncap + row``) are baked into the carry, so the digest pins
    the mesh size.  The carry is rebuilt host-side:

    - every stored state's dedup key is recomputed from its row on
      ``device`` (:func:`reshard_keys`), and the state moves to its new
      owner ``hi % ndev_dst``, keeping its sequence order;
    - the expanded prefix of the current window (``c`` lockstep chunks) is
      promoted into the done region, so a mid-level snapshot reshards
      exactly: the new window holds only unexpanded rows and ``c`` is 0;
    - parent links are remapped old gid -> new gid (traces survive);
    - each shard's table is rebuilt by the engine's own insert
      (device_engine.DedupInsert) over its keys in their new order, in
      batches of 4,096 as the reference's are (slot placement depends on
      the batch boundaries);
    - ``n_trans`` and ``cov``, which only report as mesh-wide sums, are
      totalled onto shard 0.

    ``caps_dst`` may grow ``n_states``/``levels`` (default ``caps_src``).
    Refuses a finished, failed or violating run, and a snapshot whose
    digest is not this config's.  Returns a summary dict.

    Under a VIEW the keys are the run's view-folded ones; the reference
    recomputes them without the view (ROADMAP.md, reference caveat C-R5),
    so there the two packages' outputs differ and the port's resumes to its
    own straight run's counts."""
    caps_dst = caps_dst or caps_src
    bounds = config.bounds
    lay = st.Layout.of(bounds)
    A = len(S.action_table(bounds, config.spec))
    B = config.chunk
    W = lay.width
    Ncap_s, Ncap_d = caps_src.n_states, caps_dst.n_states
    if ndev_dst * Ncap_d > 2**31 - 1:
        raise ValueError("ndev_dst * n_states exceeds the int32 global-id "
                         "address space")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but torch sees no GPU; "
                           "pass device='cpu' to run on the CPU")

    init_py = init_override if init_override is not None \
        else interp.init_state(bounds)
    init_vec = interp.to_vec(init_py, bounds)
    hi0, lo0 = sym.init_fingerprint(config, init_py, init_vec)
    init_key = (int(hi0), int(lo0))

    with ckpt.load_npz_verified(src_path) as z:
        arrs = [np.asarray(z[f"c{i}"]) for i in range(len(SCARRY_FIELDS))]
        stored_digest = int(z["config_digest"])
    src = dict(zip(SCARRY_FIELDS, arrs))
    nd_src = src["n_states"].shape[0]
    want = ckpt.config_digest(config, caps_src, init_key + (nd_src,))
    if stored_digest != np.uint64(want):
        raise ValueError(
            f"checkpoint digest mismatch: {src_path} was not written by "
            f"this config/caps on a {nd_src}-device mesh")
    if bool(src["stop"]):
        raise ValueError("run already complete (stop flag set) — "
                         "nothing to reshard")
    fail = int(np.bitwise_or.reduce(src["fail"]))
    if fail != 0:
        raise ValueError(f"refusing to reshard a failed run: "
                         f"{decode_fail(fail)}")
    if (src["viol_g"] >= 0).any():
        raise ValueError("refusing to reshard a run with a recorded "
                         "violation")

    # -- live rows in (group, old_dev, row) order --------------------------
    # group 0: done + expanded window prefix; 1: unexpanded window;
    # 2: next-level states
    store = src["store"].reshape(nd_src, Ncap_s, W)
    c_cur = int(src["c"])
    devs_l, rows_l, grp_l = [], [], []
    for d in range(nd_src):
        ns_d = int(src["n_states"][d])
        ls_d, le_d = int(src["lvl_start"][d]), int(src["lvl_end"][d])
        ec_d = min(c_cur * B, le_d - ls_d)       # expanded window prefix
        g = np.empty((ns_d,), np.int8)
        g[:ls_d + ec_d] = 0
        g[ls_d + ec_d:le_d] = 1
        g[le_d:] = 2
        devs_l.append(np.full((ns_d,), d, np.int64))
        rows_l.append(np.arange(ns_d, dtype=np.int64))
        grp_l.append(g)
    devs = np.concatenate(devs_l)
    rows = np.concatenate(rows_l)
    grp = np.concatenate(grp_l)
    M = devs.size
    if M == 0:
        raise ValueError("empty checkpoint")
    # dev-major with ascending rows, so a stable sort on the group alone
    # gives (group, dev, row) order
    order = np.argsort(grp, kind="stable")
    devs, rows, grp = devs[order], rows[order], grp[order]
    vecs_all = np.ascontiguousarray(store[devs, rows])
    del store, order

    keys_hi, keys_lo = reshard_keys(config, vecs_all, device)

    # -- new owners, sequence order kept per owner -------------------------
    owner_of = (keys_hi % np.uint32(ndev_dst)).astype(np.int64)
    counts = np.bincount(owner_of, minlength=ndev_dst)
    ns_new = counts.astype(np.int32)
    if (ns_new > Ncap_d).any():
        raise ValueError(
            f"caps_dst.n_states={Ncap_d} too small: a device would hold "
            f"{int(ns_new.max())} states — grow caps_dst")
    perm = np.argsort(owner_of, kind="stable")   # owner-major, seq order
    offsets = np.cumsum(counts) - counts
    local_idx = np.empty((M,), np.int64)
    local_idx[perm] = np.arange(M) - np.repeat(offsets, counts)
    new_gid = owner_of * Ncap_d + local_idx
    gid_map = np.full((nd_src * Ncap_s,), -1, np.int64)
    gid_map[devs * Ncap_s + rows] = new_gid
    ls_new = np.bincount(owner_of[grp == 0],
                         minlength=ndev_dst).astype(np.int32)
    le_new = ls_new + np.bincount(owner_of[grp == 1],
                                  minlength=ndev_dst).astype(np.int32)

    # -- the sharded leaves ------------------------------------------------
    par_src = src["parent"].reshape(nd_src, Ncap_s)
    lane_src = src["lane"].reshape(nd_src, Ncap_s)
    con_src = src["conflag"].reshape(nd_src, Ncap_s)
    parent_new = np.full((ndev_dst * Ncap_d,), -1, np.int32)
    lane_new = np.full((ndev_dst * Ncap_d,), -1, np.int32)
    con_new = np.zeros((ndev_dst * Ncap_d,), bool)
    p_old = par_src[devs, rows]
    parent_new[new_gid] = np.where(p_old >= 0, gid_map[np.maximum(p_old, 0)],
                                   -1).astype(np.int32)
    lane_new[new_gid] = lane_src[devs, rows]
    con_new[new_gid] = con_src[devs, rows]
    nt = src["n_trans"].astype(np.uint64).reshape(nd_src, -1)
    n_trans_tot = sum(n_trans_of(x) for x in nt)
    cov_tot = src["cov"].reshape(nd_src, A).sum(axis=0)
    levels_src = src["levels"].copy()
    lvl_src = src["lvl"].copy()
    del par_src, lane_src, con_src, p_old, gid_map, src, arrs

    store_new = np.zeros((ndev_dst * Ncap_d, W), np.int32)
    store_new[new_gid] = vecs_all
    del vecs_all
    # every shard's table at once: batch j of each shard's keys (in their
    # new order, IB at a time, ragged tails inactive) inserted together
    TBd = caps_dst.table // BUCKET
    IB = 4096
    nb = max(1, -(-int(counts.max()) // IB))
    kh = np.zeros((ndev_dst, nb * IB), np.uint32)
    kl = np.zeros((ndev_dst, nb * IB), np.uint32)
    act = np.zeros((ndev_dst, nb * IB), bool)
    for o in range(ndev_dst):
        sl = perm[offsets[o]:offsets[o] + counts[o]]     # new local order
        kh[o, :sl.size], kl[o, :sl.size] = keys_hi[sl], keys_lo[sl]
        act[o, :sl.size] = True
    kh, kl, act = (torch.as_tensor(x, device=device).view(
        ndev_dst, nb, IB) for x in (kh.view(np.int32), kl.view(np.int32),
                                    act))
    th = torch.full((ndev_dst * (TBd + 1), BUCKET), EMPTY, dtype=I32,
                    device=device)
    tl = torch.full_like(th, EMPTY)
    bad = torch.zeros((), dtype=torch.bool, device=device)
    for j in range(nb):
        a = act[:, j].reshape(-1)
        ins = DedupInsert(th, tl, kh[:, j].reshape(-1), kl[:, j].reshape(-1),
                          a, shards=ndev_dst)
        while ins.rounds < _MAX_PROBE and bool(ins.unres.any()):
            ins.round()
        bad |= ins.unres.any() | (a & ~ins.is_new).any()
    if bool(bad):
        raise RuntimeError("table rebuild failed (probe overflow or "
                           "duplicate key) — grow caps_dst.table")
    tbl_hi_new, tbl_lo_new = (
        t.view(ndev_dst, TBd + 1, BUCKET)[:, :TBd].reshape(-1, BUCKET)  # lint: jit-ok the rebuilt tables, one copy each
        .cpu().numpy().view(np.uint32) for t in (th, tl))

    n_trans_new = np.zeros((ndev_dst * 2,), np.uint32)
    n_trans_new[0] = np.uint32(n_trans_tot & 0xFFFFFFFF)
    n_trans_new[1] = np.uint32(n_trans_tot >> 32)
    cov_new = np.zeros((ndev_dst * A,), np.int32)
    cov_new[:A] = cov_tot

    # the levels array is caps.levels long: resize it to caps_dst
    lvl_cur = int(lvl_src)
    if caps_dst.levels <= lvl_cur + 1:
        raise ValueError(
            f"caps_dst.levels={caps_dst.levels} too small: the run is "
            f"already at BFS level {lvl_cur}")
    levels_new = np.zeros((caps_dst.levels,), np.int32)
    n_keep = min(caps_src.levels, caps_dst.levels)
    levels_new[:n_keep] = levels_src[:n_keep]

    win = (le_new - ls_new).astype(np.int64)
    n_chunks = int(max(1, ((win + B - 1) // B).max()))
    dst = dict(
        store=store_new, parent=parent_new, lane=lane_new,
        conflag=con_new, tbl_hi=tbl_hi_new, tbl_lo=tbl_lo_new,
        n_states=ns_new, lvl_start=ls_new, lvl_end=le_new,
        viol_g=np.full((ndev_dst,), -1, np.int32),
        viol_i=np.zeros((ndev_dst,), np.int32),
        n_trans=n_trans_new, cov=cov_new,
        fail=np.zeros((ndev_dst,), np.int32),
        levels=levels_new, lvl=lvl_src,
        c=np.asarray(0, np.int32), n_chunks=np.asarray(n_chunks, np.int32),
        stop=np.asarray(False))
    ckpt.atomic_savez(
        dst_path,
        **{f"c{i}": np.asarray(dst[f]) for i, f in enumerate(SCARRY_FIELDS)},
        config_digest=np.uint64(ckpt.config_digest(
            config, caps_dst, init_key + (ndev_dst,))))
    return {"ndev_src": nd_src, "ndev_dst": ndev_dst,
            "n_states": int(ns_new.sum()),
            "per_device": ns_new.tolist(),
            "window": win.tolist(),
            "promoted_expanded": c_cur > 0}
