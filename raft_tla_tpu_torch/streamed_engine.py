"""Host-streamed frontier engine — the port of
``raft_tla_tpu/streamed_engine.py``: no live-window ceiling.

The paged engine (paged_engine.py) must hold the live BFS window (current +
next level) in its device ring.  This engine inverts the data flow:

- **The frontier streams host → device in fixed blocks.**  Every
  discovered state lives in the host store (utils/native.make_store); each
  block of the current level is read from it, copied into a device
  frontier buffer (through a pinned host buffer on the card), expanded in
  paced segments, and replaced by the next block.  The device never holds
  more than one block of frontier.  The upload is blocking (timed as the
  ``upload`` phase and in ``stats["upload_s"]``).
- **The ring only buffers appends** between pageouts.  New states append at
  (discovery index mod ring) and page out to the host store when the ring
  is half full: the one ring invariant is ``n_states - paged <= ring``,
  whatever the level widths (``FAIL_RING`` otherwise).
- **Level bookkeeping lives on the host**, which knows every level
  boundary (the discovery count at each advance).
- Only the fingerprint table scales with the whole space on the device.

A chunk is the paged engine's (:meth:`paged_engine.RingEngine._expand`) on
``chunk`` rows of the block.  Discovery order — and so counts, levels,
coverage and the first violation — is the reference's.  Checkpoints are
taken at block boundaries only (re-expanding rows on resume would count
their transitions twice): the reference's ``SCarry`` arrays ``c0..c12`` in
an npz with ``paged``, ``level_ends`` and ``blocks_done``, beside the host
store's ``.rows``, ``.links`` and ``.con`` streams, each extended in place
(utils/ckpt.stream_rows_append); either package resumes the other's.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from raft_tla_tpu_torch.config import CheckConfig
from raft_tla_tpu_torch.device_engine import (
    BUCKET, FAIL_LEVEL, aggregate_coverage, carry_arrays, decode_fail,
    load_carry)
from raft_tla_tpu_torch.engine import EngineResult
from raft_tla_tpu_torch.models import interp, spec as S
from raft_tla_tpu_torch.obs.events import RunTelemetry
from raft_tla_tpu_torch.ops import symmetry as sym
from raft_tla_tpu_torch.paged_engine import RingEngine
from raft_tla_tpu_torch.utils import ckpt, native, pacing

I32 = torch.int32
# The reference's SCarry fields, in order (the checkpoint's c0..c12).
SCARRY_FIELDS = ("store", "parent", "lane", "conflag", "tbl_hi", "tbl_lo",
                 "n_states", "viol_g", "viol_i", "n_trans", "cov", "fail",
                 "c")


@dataclasses.dataclass(frozen=True)
class StreamedCapacities:
    """Static sizes (the reference's).  ``block`` is the frontier upload
    granularity; ``ring`` buffers appends between pageouts (both
    independent of level widths); ``table`` bounds total distinct states
    at ~2 slots a state."""

    block: int = 1 << 20
    ring: int = 1 << 22
    table: int = 1 << 26
    levels: int = 1 << 12        # host-side level-count bound

    def __post_init__(self):
        for nm in ("block", "ring", "table"):
            v = getattr(self, nm)
            if v & (v - 1):
                raise ValueError(f"{nm}={v} must be a power of two")


class StreamedEngine(RingEngine):
    """Exhaustive checker with no live-window ceiling: frontier and store
    bounded by host memory; only the fingerprint table scales on the
    device."""

    KIND = "streamed"

    def __init__(self, config: CheckConfig,
                 caps: StreamedCapacities | None = None,
                 seg_chunks: int = 64, device="cuda"):
        caps = caps or StreamedCapacities()
        A = len(S.action_table(config.bounds, config.spec))
        if caps.ring < 2 * config.chunk * A:
            raise ValueError(
                f"ring={caps.ring} must be >= 2 * chunk * A = "
                f"{2 * config.chunk * A} (pageout headroom)")
        if caps.block < config.chunk:
            raise ValueError("block must be >= chunk")
        super().__init__(config, caps, seg_chunks, device)

    # -- the frontier buffer ----------------------------------------------------

    def _buffers(self) -> tuple:
        """The device frontier buffer (packed rows, constraint flags) and,
        on the card, the pinned host buffer a block is staged in."""
        F, P, dev = self.caps.block, self.schema.P, self.device
        dbuf = (torch.zeros((F, P), dtype=I32, device=dev),
                torch.zeros((F,), dtype=torch.bool, device=dev))
        if dev.type != "cuda":
            return dbuf, None
        return dbuf, (torch.empty((F, P), dtype=I32, pin_memory=True),
                      torch.empty((F,), dtype=torch.bool, pin_memory=True))

    def _upload(self, host, constore, start: int, rows: int, dbuf,
                pinned) -> None:
        """Copy frontier rows ``[start, start + rows)`` and their
        constraint flags from the host stores into the device buffer (the
        rows past them keep stale values, which no chunk reads)."""
        blk = host.read(start, rows)
        con = constore.read(start, rows)[:, 0] != 0
        if pinned is None:
            dbuf[0][:rows] = torch.from_numpy(blk)
            dbuf[1][:rows] = torch.from_numpy(con)
            return
        pinned[0].numpy()[:rows] = blk  # lint: jit-ok pinned host buffer, a view
        pinned[1].numpy()[:rows] = con  # lint: jit-ok pinned host buffer, a view
        dbuf[0][:rows].copy_(pinned[0][:rows], non_blocking=True)
        dbuf[1][:rows].copy_(pinned[1][:rows], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        # blocking: the pinned buffer is refilled by the next block
        ev.synchronize()

    # -- checkpoint / resume --------------------------------------------------

    def carry_to_numpy(self) -> list:
        """The carry as the reference's ``SCarry`` arrays ``c0..c12``."""
        return carry_arrays(self.carry, self.caps.ring, self.A,
                            SCARRY_FIELDS)

    def _load_carry(self, arrays: list) -> None:
        a = [np.asarray(x) for x in arrays]
        R, TB = self.caps.ring, self.caps.table // BUCKET
        if a[0].shape != (R, self.schema.P) or a[4].shape != (TB, BUCKET) \
                or a[10].shape != (self.A,):
            raise ValueError("checkpoint carry shapes do not match this "
                             "engine's capacities and layout")
        self.carry = load_carry(self._alloc(0, 0), a, R, self.A,
                                SCARRY_FIELDS)

    def save_checkpoint(self, path: str, host, constore, paged: int,
                        level_ends: list, blocks_done: int,
                        init_key) -> None:
        """Snapshots land at block boundaries only; ``blocks_done`` counts
        the completed blocks of the frontier level.  The streams extend in
        place (the host stores are append-only), the npz is written
        last."""
        ckpt.stream_rows_append(path + ".rows", host.read, paged,
                                self.schema.P)

        def links_reader(start, n):
            par, lan = host.read_links(start, n)
            return np.stack([par, lan], axis=1)

        ckpt.stream_rows_append(path + ".links", links_reader, paged, 2)
        ckpt.stream_rows_append(path + ".con", constore.read, paged, 1)
        ckpt.atomic_savez(
            path,
            **{f"c{i}": x for i, x in enumerate(self.carry_to_numpy())},
            paged=np.int64(paged),
            level_ends=np.asarray(level_ends, np.int64),
            blocks_done=np.int64(blocks_done),
            config_digest=np.uint64(
                ckpt.config_digest(self.config, self.caps, init_key)))

    def load_checkpoint(self, path: str, init_key) -> tuple:
        """Restore the carry; returns ``(host, constore, paged, level_ends,
        blocks_done)``."""
        with ckpt.load_npz_checked(
                path, ckpt.config_digest(self.config, self.caps,
                                         init_key)) as z:
            a = [np.asarray(z[f"c{i}"]) for i in range(len(SCARRY_FIELDS))]
            paged = int(z["paged"])
            level_ends = [int(x) for x in z["level_ends"]]
            blocks_done = int(z["blocks_done"])
        self._load_carry(a)
        host = native.make_store(self.schema.P)
        constore = native.make_store(1)
        ckpt.stream_rows_in(path + ".rows", host.append, paged,
                            expect_width=self.schema.P)
        ckpt.stream_rows_in(
            path + ".links",
            lambda blk: host.append_links(blk[:, 0], blk[:, 1]), paged,
            expect_width=2)
        ckpt.stream_rows_in(path + ".con", constore.append, paged,
                            expect_width=1)
        return host, constore, paged, level_ends, blocks_done

    # -- the search -------------------------------------------------------------

    def check(self, init_override: interp.PyState | None = None,
              on_progress=None, checkpoint: str | None = None,
              checkpoint_every_s: float = 600.0,
              resume: str | None = None,
              deadline_s: float | None = None,
              events: str | None = None,
              max_chunks: int | None = None) -> EngineResult:
        """As PagedEngine.check; ``max_chunks`` stops at the first block
        boundary past that many chunks (there the checkpoint, if given, is
        written), so a resume never re-expands a row.  It is a test hook,
        kept for parity with ``DeviceEngine.check(max_chunks=)``: no CLI
        flag sets it."""
        t0 = time.monotonic()
        tel = RunTelemetry(
            "streamed", config=self.config, caps=self.caps,
            on_progress=on_progress, events=events,
            resumed=resume is not None,
            n0=1 if resume is None else None, t0=t0)
        try:
            return self._check_impl(tel, t0, init_override, checkpoint,
                                    checkpoint_every_s, resume, deadline_s,
                                    max_chunks)
        finally:
            tel.close()

    def _fresh(self, init_py, init_vec, hi0, lo0) -> tuple:
        """The carry, host stores and level bookkeeping of a new search."""
        c = self._alloc(hi0, lo0)
        c.update(n_states=1, viol_g=-1, viol_i=0, n_trans=0, fail=0, c=0)
        self.carry = c
        host = native.make_store(self.schema.P)
        constore = native.make_store(1)
        host.append(self.schema.pack(np.asarray(init_vec, np.int32),
                                     np)[None, :])
        host.append_links(np.asarray([-1], np.int64),
                          np.asarray([-1], np.int32))
        constore.append(np.asarray(
            [[interp.constraint_ok(init_py, self.bounds)]], np.int32))
        # level_ends[k] = discovery index just past level k
        return host, constore, 1, [1], 0

    def _check_impl(self, tel, t0, init_override, checkpoint,
                    checkpoint_every_s, resume, deadline_s,
                    max_chunks) -> EngineResult:
        bounds, B = self.bounds, self.config.chunk
        init_py = init_override if init_override is not None \
            else interp.init_state(bounds)
        init_vec = interp.to_vec(init_py, bounds)
        hi0, lo0 = sym.init_fingerprint(self.config, init_py, init_vec)
        tel.run_start()
        res = self._init_violation(init_py, t0)
        if res is not None:
            tel.run_end(res)
            return res
        self._begin()
        # Snapshots extend the checkpoint's streams in place, trusting their
        # prefix only for rows this run wrote: a fresh run deletes streams
        # left at the path; a resume from the same path trims them to the
        # npz's ``paged`` after the load.
        same = bool(checkpoint and resume and os.path.abspath(resume)
                    == os.path.abspath(checkpoint))
        if checkpoint and not same:
            for suf in (".rows", ".links", ".con"):
                try:
                    os.remove(checkpoint + suf)
                except FileNotFoundError:
                    pass
        if resume:
            host, constore, paged, level_ends, blocks_done = \
                self.load_checkpoint(resume, (hi0, lo0))
            if same:
                for suf, w in ((".rows", self.schema.P), (".links", 2),
                               (".con", 1)):
                    ckpt.trim_stream(checkpoint + suf, paged, w)
        else:
            host, constore, paged, level_ends, blocks_done = self._fresh(
                init_py, init_vec, hi0, lo0)
        c = self.carry
        dbuf, pinned = self._buffers()
        pacer = pacing.SegmentPacer(self.seg_chunks, self.SEG_MIN,
                                    self.SEG_MAX, self.SEG_TARGET_S,
                                    self.SEG_CLAMP_S)
        complete, stopped = True, False
        t_warm, last_ckpt, steps = None, time.monotonic(), 0
        F = self.caps.block

        while not stopped:
            lvl_lo = level_ends[-2] if len(level_ends) > 1 else 0
            lvl_hi = level_ends[-1]
            for b_start in range(lvl_lo + blocks_done * F, lvl_hi, F):
                b_rows = min(F, lvl_hi - b_start)
                t_up = time.monotonic()
                with tel.phases.phase("upload") as ph:
                    self._upload(host, constore, b_start, b_rows, dbuf,
                                 pinned)
                    ph.sync(dbuf)
                self.stats["upload_s"] += time.monotonic() - t_up
                c["c"] = 0
                n_chunks = -(-b_rows // B)
                while c["c"] < n_chunks:
                    if (deadline_s is not None and t_warm is not None
                            and time.monotonic() - t_warm > deadline_s):
                        complete, stopped = False, True
                        tel.stop_requested("deadline")
                        break
                    pause_at = paged + self.caps.ring // 2
                    t_seg, executed = time.monotonic(), 0
                    with tel.phases.phase("expand"):
                        while (c["c"] < n_chunks and executed < pacer.budget
                               and c["n_states"] < pause_at
                               and c["viol_g"] < 0 and not c["fail"]):
                            r0 = c["c"] * B
                            n = min(B, b_rows - r0)
                            self._expand(
                                self.schema.unpack(dbuf[0][r0:r0 + n], torch),
                                dbuf[1][r0:r0 + n], b_start + r0, paged)
                            c["c"] += 1
                            executed += 1
                    steps += executed
                    with tel.phases.phase("export"):
                        paged = self._pageout(host, paged, c["n_states"],
                                              constore)
                    self._progress(tel, len(level_ends))
                    if c["fail"] or c["viol_g"] >= 0:
                        stopped = True
                        break
                    if t_warm is None:
                        t_warm = time.monotonic()
                    self.seg_chunks = pacer.update(
                        time.monotonic() - t_seg, max(1, executed))
                if stopped:
                    break
                blocks_done += 1
                # snapshots land exactly at block boundaries
                at_max = max_chunks is not None and steps >= max_chunks
                if checkpoint and (at_max or time.monotonic() - last_ckpt
                                   >= checkpoint_every_s):
                    with tel.phases.phase("snapshot"):
                        self.save_checkpoint(checkpoint, host, constore,
                                             paged, level_ends, blocks_done,
                                             (hi0, lo0))
                    tel.checkpoint(checkpoint)
                    last_ckpt = time.monotonic()
                if at_max:
                    complete, stopped = False, True
                    break
            if stopped:
                break
            blocks_done = 0
            if c["n_states"] == level_ends[-1]:          # no new states
                break
            level_ends.append(c["n_states"])
            if len(level_ends) > self.caps.levels:
                # host-side, with the device-side FAIL_* wording
                raise RuntimeError(
                    f"streamed search aborted: {decode_fail(FAIL_LEVEL)} "
                    f"(caps={self.caps}) — grow StreamedCapacities and "
                    "rerun")
        self.stats["syncs"] = self._syncs.n
        self._aborted()
        levels = [level_ends[0]] + [level_ends[k] - level_ends[k - 1]
                                    for k in range(1, len(level_ends))]
        coverage = aggregate_coverage(self.table, c["cov"][:self.A].cpu())
        violation = self._host_trace(host, c["viol_g"], c["viol_i"]) \
            if c["viol_g"] >= 0 else None
        host.close()
        constore.close()
        result = EngineResult(
            n_states=c["n_states"], diameter=len(levels) - 1,
            n_transitions=c["n_trans"], coverage=coverage,
            violation=violation, levels=levels,
            wall_s=time.monotonic() - t0, complete=complete)
        tel.run_end(result)
        return result


def check(config: CheckConfig, caps: StreamedCapacities | None = None,
          device="cuda", **kw) -> EngineResult:
    return StreamedEngine(config, caps, device=device).check(**kw)
