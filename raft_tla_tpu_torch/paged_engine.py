"""Host-paged BFS engine — the port of ``raft_tla_tpu/paged_engine.py``.

The device engine (device_engine.py) keeps every discovered state in device
memory.  This engine keeps there only what the search is working on, the
way TLC keeps its ``states/`` queue on disk:

- **Only the live BFS window lives on the device**, in a ring of
  bit-packed rows (ops/bitpack.BitSchema): the level being expanded and the
  next one being appended.  A state's ring row is its discovery index
  ``& (ring - 1)``; level-synchronous BFS keeps the window ``[lvl_start,
  n_states)`` contiguous, so reusing ring rows is safe while the window
  fits, and the search fails loudly (``FAIL_RING``) when it does not.
- **Every new state pages out to the native host store**
  (utils/native.make_store) with its (parent, lane) trace link, whenever
  ``n_states`` crosses the pause mark (half a ring past what is already
  paged) and at the end of every segment.  Host memory is the capacity
  bound, not the card's.
- **Only the fingerprint table scales with the whole space** on the card
  (``device_engine.dedup_insert``'s table, 8 bytes a slot).
- Violation traces come from the host store alone
  (``HostStore.trace_chain``).

A chunk (the reference's ``chunk_body``, ``paged_engine.py:97-164``) is the
fused step (K1 on the card) on the unpacked rows of the window, the dedup
insert, the append at the ring's wrap point, coverage, and the first
violation or deadlock; its scalars come back in one host read, as in the
device engine.  Discovery order — and so counts, levels, coverage and the
first violation — is the reference's.  Checkpoints are the reference's:
the ``Carry`` arrays ``c0..c16`` (the ring in place of the store) in an npz
with the ``paged`` counter and the config digest, beside the host store's
``.rows`` and ``.links`` streams, so either package resumes the other's.

:class:`RingEngine` holds what this engine shares with the streamed engine
(streamed_engine.py): the ring, the chunk, the pageout and the host trace.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter

import numpy as np
import torch

from raft_tla_tpu_torch.config import CheckConfig
from raft_tla_tpu_torch.device_engine import (
    BIG, BUCKET, CARRY_FIELDS, EMPTY, FAIL_INDEX, FAIL_LEVEL, FAIL_PROBE, FAIL_RING,
    FAIL_WIDTH, SyncCounter, aggregate_coverage, carry_arrays, decode_fail,
    dedup_insert, load_carry)
from raft_tla_tpu_torch.engine import DEADLOCK, EngineResult, Violation
from raft_tla_tpu_torch.models import interp, invariants as inv_mod, spec as S
from raft_tla_tpu_torch.obs.events import RunTelemetry
from raft_tla_tpu_torch.ops import bitpack, pallas_step
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym
from raft_tla_tpu_torch.utils import ckpt, native, pacing

I32, I64 = torch.int32, torch.int64


@dataclasses.dataclass(frozen=True)
class PagedCapacities:
    """Static sizes of one paged search (the reference's).

    ``ring`` bounds the *live window* (current + next BFS level), not the
    total space; ``table`` bounds total distinct states at ~2 slots a
    state."""

    ring: int = 1 << 20          # device rows for the live window
    table: int = 1 << 24         # fingerprint slots (power of two)
    levels: int = 1 << 10

    def __post_init__(self):
        if self.ring & (self.ring - 1) or self.table & (self.table - 1):
            raise ValueError("ring and table must be powers of two")


class RingEngine:
    """The device ring of bit-packed rows and its chunk, shared by the
    paged and the streamed engine.  The carry is a dict: the ring
    (``store``, ``parent``, ``lane``, ``conflag``), the table (``tbl_hi``,
    ``tbl_lo``, ``[TB + 1, BUCKET]`` with the sink row) and ``cov`` on the
    device; the counters as host ints."""

    SEG_TARGET_S = 8.0
    SEG_CLAMP_S = 25.0       # bounds how long a stop waits for a segment
    SEG_MIN, SEG_MAX = 16, 1 << 16
    KIND = "ring"

    def __init__(self, config: CheckConfig, caps, seg_chunks: int = 64,
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
        self.caps = caps
        self.seg_chunks = seg_chunks
        self.schema = bitpack.BitSchema(self.bounds)
        self.step = pallas_step.build_step(
            self.bounds, config.spec, tuple(config.invariants), self.device,
            symmetry=tuple(config.symmetry), view=config.view)
        # The int32 discovery index could reach 2^31 on a host-bounded
        # store: fail loudly with a chunk's worth of headroom left.
        self.idx_ceil = np.iinfo(np.int32).max - 2 * config.chunk * self.A
        # the violation scan's constants, built once (no upload a chunk)
        dev = self.device
        self._big = torch.full((), BIG, dtype=I64, device=dev)
        self._none = torch.full((), -1, dtype=I64, device=dev)
        self._zero = torch.zeros((), dtype=I64, device=dev)
        self.stats = {}
        self.carry = None

    # -- the ring -------------------------------------------------------------

    def _alloc(self, hi0: int, lo0: int) -> dict:
        """The ring and the table with the Init key in it."""
        R, dev = self.caps.ring, self.device
        TB = self.caps.table // BUCKET
        c = {
            "store": torch.zeros((R, self.schema.P), dtype=I32, device=dev),
            "parent": torch.full((R,), -1, dtype=I32, device=dev),
            "lane": torch.full((R,), -1, dtype=I32, device=dev),
            "conflag": torch.zeros((R,), dtype=torch.bool, device=dev),
            "tbl_hi": torch.full((TB + 1, BUCKET), EMPTY, dtype=I32,
                                 device=dev),
            "tbl_lo": torch.full((TB + 1, BUCKET), EMPTY, dtype=I32,
                                 device=dev),
            "cov": torch.zeros((self.A + 1,), dtype=I64, device=dev),
        }
        b0 = lo0 & (TB - 1)
        c["tbl_hi"][b0, 0] = int(np.uint32(hi0).view(np.int32))
        c["tbl_lo"][b0, 0] = int(np.uint32(lo0).view(np.int32))
        return c

    def _put(self, n0: int, k: int, cols: dict) -> None:
        """Write ``k`` new states' ring columns at discovery indices
        ``n0 ..`` (one wrap at most)."""
        c, R = self.carry, self.caps.ring
        s0 = n0 & (R - 1)
        m = min(k, R - s0)
        for name, x in cols.items():
            c[name][s0:s0 + m] = x[:m]
            if m < k:
                c[name][:k - m] = x[m:]

    def _expand(self, vecs, live, base: int, floor: int) -> None:
        """One chunk over the unpacked rows ``vecs`` (``live``: rows to
        expand), whose first row has discovery index ``base``; appends may
        not lap ``floor`` (the reference's ``chunk_body``)."""
        c, A, R = self.carry, self.A, self.caps.ring
        n_inv = len(self.config.invariants)
        out = self.step(vecs)
        valid = out["valid"] & live[:, None]
        is_new, unres = dedup_insert(
            c["tbl_hi"], c["tbl_lo"], out["fp_hi"].reshape(-1),
            out["fp_lo"].reshape(-1), valid.reshape(-1), self._syncs)
        new_idx = is_new.nonzero().squeeze(1)
        self._syncs.n += 1                     # nonzero reads its size
        n_new = new_idx.numel()
        n0 = c["n_states"]
        # appends that fit the ring; past it the chunk fails FAIL_RING
        k = max(0, min(n_new, floor + R - n0))
        if k:
            idx = new_idx[:k]
            self._put(n0, k, {
                "store": self.schema.pack(
                    out["svecs"].reshape(vecs.shape[0] * A, -1)[idx], torch),
                "parent": (base + idx // A).to(I32),
                "lane": (idx % A).to(I32),
                "conflag": out["con_ok"].reshape(-1)[idx]})
        if n_new:
            c["cov"].index_add_(0, new_idx % A, torch.ones_like(new_idx))
        # the first invariant violation among the new states, in discovery
        # order; with check_deadlock, the first expanded row without an
        # enabled action (flat priority b * A), whichever comes first
        if n_inv and n_new:
            bad = ~out["inv_ok"].reshape(-1, n_inv)[new_idx]
            bad_any = bad.any(1)
            kfirst = torch.where(bad_any.any(), bad_any.to(I32).argmax(), -1)
            kc = kfirst.clamp(min=0)
            first = torch.where(kfirst >= 0, new_idx[kc], self._big)
            bad_inv = bad[kc].to(I32).argmax()
        else:
            kfirst, first, bad_inv = self._none, self._big, self._zero
        if self.config.check_deadlock:
            dead = live & ~out["valid"].any(1)
            drow = torch.where(dead.any(), dead.to(I32).argmax(), -1)
        else:
            drow = self._none
        n_valid, ovf, punres, kfirst, first, bad_inv, drow = \
            self._syncs.read(torch.stack([t.to(I64) for t in (
                valid.sum(), (valid & out["overflow"]).any(), unres.any(),
                kfirst, first, bad_inv, drow)]))
        c["n_trans"] += n_valid
        c["fail"] |= (FAIL_WIDTH if ovf else 0) | (FAIL_PROBE if punres else 0)
        if n0 + n_new - floor > R:
            c["fail"] |= FAIL_RING
        if n0 > self.idx_ceil:
            c["fail"] |= FAIL_INDEX
        c["n_states"] = n0 + n_new
        g_target = n0 + kfirst
        if drow >= 0 and drow * A < first:
            first, g_target, bad_inv = drow * A, base + drow, n_inv
        if first < BIG and c["viol_g"] < 0:
            c["viol_g"], c["viol_i"] = g_target, bad_inv
        self.stats["chunks"] += 1

    def _pageout(self, host, paged: int, n_states: int,
                 constore=None) -> int:
        """Copy the ring rows of discovery indices ``[paged, n_states)`` to
        the host store, with their links (and constraint flags into
        ``constore``); returns the new ``paged``."""
        c, R = self.carry, self.caps.ring
        t0 = time.monotonic()
        while paged < n_states:
            s0 = paged & (R - 1)
            n = min(n_states - paged, R - s0)
            sl = slice(s0, s0 + n)
            host.append(c["store"][sl].cpu().numpy())  # lint: jit-ok pageout, once a segment; ROADMAP queue B (d) 6
            host.append_links(c["parent"][sl].cpu().numpy(),  # lint: jit-ok pageout, once a segment; ROADMAP queue B (d) 6
                              c["lane"][sl].cpu().numpy())  # lint: jit-ok pageout, once a segment; ROADMAP queue B (d) 6
            if constore is not None:
                constore.append(c["conflag"][sl].to(I32)[:, None].cpu()  # lint: jit-ok pageout, once a segment; ROADMAP queue B (d) 6
                                .numpy())
            paged += n
        self.stats["pageout_s"] += time.monotonic() - t0
        return paged

    def _init_violation(self, init_py, t0):
        """The result when Init itself violates an invariant, else None."""
        for nm in self.config.invariants:
            if not inv_mod.py_invariant(nm)(init_py, self.bounds):
                return EngineResult(
                    n_states=1, diameter=0, n_transitions=0,
                    coverage=Counter(),
                    violation=Violation(nm, init_py, [(None, init_py)]),
                    levels=[1], wall_s=time.monotonic() - t0)
        return None

    def _host_trace(self, host, viol_g: int, viol_i: int) -> Violation:
        """The violation's trace, from the host store alone."""
        chain = []
        for k, g in enumerate(host.trace_chain(viol_g)):
            row = self.schema.unpack(host.read(int(g), 1)[0], np)
            _, lane_g = host.read_links(int(g), 1)
            py = interp.from_struct(st.unpack(row, self.lay), self.bounds)
            label = self.table[int(lane_g[0])].label() if k > 0 else None
            chain.append((label, py))
        inv = DEADLOCK if viol_i == len(self.config.invariants) \
            else self.config.invariants[viol_i]
        return Violation(invariant=inv, state=chain[-1][1], trace=chain)

    def _progress(self, tel, level: int) -> None:
        """Close a segment: one progress record (the reference's)."""
        c = self.carry
        if not tel.active:
            return
        with tel.phases.phase("export"):
            cov = aggregate_coverage(self.table, c["cov"][:self.A].cpu())
        self._syncs.n += 1
        self.stats["segments"] += 1
        tel.segment(n_states=c["n_states"], level=level,
                    n_transitions=c["n_trans"], coverage=dict(cov))

    def _begin(self):
        self._syncs = SyncCounter()
        self.stats = {"chunks": 0, "segments": 0, "pageout_s": 0.0,
                      "upload_s": 0.0}

    def _aborted(self) -> None:
        if self.carry["fail"]:
            raise RuntimeError(
                f"{self.KIND} search aborted: "
                f"{decode_fail(self.carry['fail'])} (caps={self.caps}) — "
                f"grow {type(self.caps).__name__} and rerun")


class PagedEngine(RingEngine):
    """Exhaustive checker bounded by host memory, not the card's."""

    KIND = "paged"

    def __init__(self, config: CheckConfig, caps: PagedCapacities | None =
                 None, seg_chunks: int = 64, device="cuda"):
        caps = caps or PagedCapacities()
        # One chunk appends up to chunk*A rows past the pause mark (the
        # pause check runs between chunks); ring//2 headroom must absorb
        # it so unpaged rows are never overwritten.
        A = len(S.action_table(config.bounds, config.spec))
        if caps.ring < 2 * config.chunk * A:
            raise ValueError(
                f"PagedCapacities.ring={caps.ring} must be >= "
                f"2 * chunk * A = {2 * config.chunk * A}")
        super().__init__(config, caps, seg_chunks, device)
        self._iota = torch.arange(config.chunk, dtype=I64,
                                  device=self.device)

    # -- checkpoint / resume ------------------------------------------------

    def carry_to_numpy(self) -> list:
        """The carry as the reference's ``Carry`` arrays ``c0..c16``."""
        return carry_arrays(self.carry, self.caps.ring, self.A)

    def save_checkpoint(self, path: str, host, paged: int,
                        init_key: tuple) -> None:
        """The host store's row and link logs stream to ``path + ".rows"``
        and ``".links"``; the npz with the carry and ``paged`` is written
        last, so a crash between files leaves an older counter beside
        longer streams, which is safe (the store is append-only)."""
        ckpt.stream_rows_out(path + ".rows", host.read, paged,
                             self.schema.P)

        def links_reader(start, n):
            par, lan = host.read_links(start, n)
            return np.stack([par, lan], axis=1)

        ckpt.stream_rows_out(path + ".links", links_reader, paged, 2)
        ckpt.atomic_savez(
            path,
            **{f"c{i}": x for i, x in enumerate(self.carry_to_numpy())},
            paged=np.int64(paged),
            config_digest=np.uint64(
                ckpt.config_digest(self.config, self.caps, init_key)))

    def load_checkpoint(self, path: str, init_key: tuple):
        """Restore the carry from ``path`` (either package's); returns
        ``(host, paged)``."""
        with ckpt.load_npz_checked(
                path, ckpt.config_digest(self.config, self.caps,
                                         init_key)) as z:
            a = [np.asarray(z[f"c{i}"]) for i in range(len(CARRY_FIELDS))]
            paged = int(z["paged"])
        R, TB = self.caps.ring, self.caps.table // BUCKET
        if a[0].shape != (R, self.schema.P) or a[4].shape != (TB, BUCKET) \
                or a[12].shape != (self.A,) \
                or a[14].shape != (self.caps.levels,):
            raise ValueError("checkpoint carry shapes do not match this "
                             "engine's capacities and layout")
        self.carry = load_carry(self._alloc(0, 0), a, R, self.A)
        host = native.make_store(self.schema.P)
        ckpt.stream_rows_in(path + ".rows", host.append, paged,
                            expect_width=self.schema.P)
        ckpt.stream_rows_in(
            path + ".links",
            lambda blk: host.append_links(blk[:, 0], blk[:, 1]), paged,
            expect_width=2)
        return host, paged

    # -- the search -----------------------------------------------------------

    def _done(self) -> bool:
        c = self.carry
        return (c["lvl_end"] <= c["lvl_start"] or c["viol_g"] >= 0
                or c["fail"] != 0)

    def _chunk(self) -> None:
        """One chunk of the current level, its rows read from the ring."""
        c, B = self.carry, self.config.chunk
        start = c["lvl_start"] + c["c"] * B
        n = min(B, c["lvl_end"] - start)
        ridx = (self._iota[:n] + start) & (self.caps.ring - 1)
        vecs = self.schema.unpack(c["store"][ridx], torch)
        self._expand(vecs, c["conflag"][ridx], start, c["lvl_start"])
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

    def check(self, init_override: interp.PyState | None = None,
              on_progress=None, checkpoint: str | None = None,
              checkpoint_every_s: float = 300.0,
              resume: str | None = None,
              deadline_s: float | None = None,
              events: str | None = None) -> EngineResult:
        """``on_progress``/``events`` as in DeviceEngine.check (one
        progress record a segment); ``checkpoint``/``resume`` as there,
        with the host store's streams.  ``deadline_s`` stops the search
        at the first segment boundary that many seconds after the first
        segment: the result has ``complete=False`` and the counts so
        far."""
        t0 = time.monotonic()
        tel = RunTelemetry(
            "paged", config=self.config, caps=self.caps,
            on_progress=on_progress, events=events,
            resumed=resume is not None,
            n0=1 if resume is None else None, t0=t0)
        try:
            return self._check_impl(tel, t0, init_override, checkpoint,
                                    checkpoint_every_s, resume, deadline_s)
        finally:
            tel.close()

    def _check_impl(self, tel, t0, init_override, checkpoint,
                    checkpoint_every_s, resume, deadline_s) -> EngineResult:
        bounds = self.bounds
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
        if resume:
            host, paged = self.load_checkpoint(resume, (hi0, lo0))
        else:
            host, paged = native.make_store(self.schema.P), 0
            c = self._alloc(hi0, lo0)
            c["store"][0] = torch.as_tensor(
                self.schema.pack(init_vec.astype(np.int32), np),
                device=self.device)
            c["conflag"][0] = bool(interp.constraint_ok(init_py, bounds))
            c.update(n_states=1, lvl_start=0, lvl_end=1, viol_g=-1, viol_i=0,
                     n_trans=0, fail=0, lvl=1, c=0,
                     levels=np.zeros((self.caps.levels,), np.int32))
            self.carry = c
        c = self.carry
        pacer = pacing.SegmentPacer(self.seg_chunks, self.SEG_MIN,
                                    self.SEG_MAX, self.SEG_TARGET_S,
                                    self.SEG_CLAMP_S)
        complete, t_warm, last_ckpt = True, None, time.monotonic()
        while True:
            if (deadline_s is not None and t_warm is not None
                    and time.monotonic() - t_warm > deadline_s):
                complete = False
                tel.stop_requested("deadline")
                break
            # Pause before unpaged rows could be overwritten: rows below
            # pause_at are safe while n_states - lvl_start <= ring.
            pause_at = paged + self.caps.ring // 2
            t_seg, executed = time.monotonic(), 0
            with tel.phases.phase("expand"):      # each chunk ends in a sync
                while (not self._done() and executed < pacer.budget
                       and c["n_states"] < pause_at):
                    n_chunks = -(-(c["lvl_end"] - c["lvl_start"])
                                 // self.config.chunk)
                    if c["c"] < n_chunks:
                        self._chunk()
                        executed += 1
                    self._advance()
            with tel.phases.phase("export"):
                paged = self._pageout(host, paged, c["n_states"])
            self._progress(tel, c["lvl"])
            if self._done():
                break
            if checkpoint and (time.monotonic() - last_ckpt
                               >= checkpoint_every_s):
                with tel.phases.phase("snapshot"):
                    self.save_checkpoint(checkpoint, host, paged, (hi0, lo0))
                tel.checkpoint(checkpoint, c["n_states"])
                last_ckpt = time.monotonic()
            if t_warm is None:
                t_warm = time.monotonic()   # the deadline starts after it
            # dt includes the pageout: it overestimates the chunk cost,
            # the safe direction for the pacing clamp
            self.seg_chunks = pacer.update(time.monotonic() - t_seg,
                                           max(1, executed))
        self.stats["syncs"] = self._syncs.n
        self._aborted()
        levels = [1] + [int(x) for x in c["levels"][:c["lvl"]] if int(x) > 0]
        coverage = aggregate_coverage(self.table, c["cov"][:self.A].cpu())
        violation = self._host_trace(host, c["viol_g"], c["viol_i"]) \
            if c["viol_g"] >= 0 else None
        host.close()
        result = EngineResult(
            n_states=c["n_states"], diameter=len(levels) - 1,
            n_transitions=c["n_trans"], coverage=coverage,
            violation=violation, levels=levels,
            wall_s=time.monotonic() - t0, complete=complete)
        tel.run_end(result)
        return result


def check(config: CheckConfig, caps: PagedCapacities | None = None,
          device="cuda", **kw) -> EngineResult:
    return PagedEngine(config, caps, device=device).check(**kw)
