"""Async dispatch scheduler — keep the card busy through every host phase
of the serving loop; the port of ``raft_tla_tpu/serve/sched.py``.

A synchronous executor would pack bin A's chunk, launch its step, then
fetch the outputs and walk every lane's host phases (fetch -> dedup ->
lane scan -> backfill) while the card sits idle — and every new step
signature would pay its kernel build on that same critical path.  This
module keeps the reference's pipeline, in PyTorch idiom:

- **Pipelined dispatch** — up to ``depth`` dispatches are in flight at
  once.  A dispatch uploads its rows from a pinned staging buffer
  (``non_blocking``), launches the bin's step on the current stream and
  queues one device-to-host copy of each small output (valid, overflow,
  keys, invariant and constraint bits) into pinned host memory behind
  it, then records a CUDA event; nothing waits.  The harvest waits on
  that ticket's event alone, so bin B's step — or bin A's *next* chunk
  of the same level — runs on the card while bin A's harvest runs on the
  host.  Tickets are harvested strictly FIFO, so per-lane slice order
  equals dispatch order equals the order a solo ``engine.Engine`` would
  process the same frontier, and completing lanes stay identical to
  their solo runs.
- **Staging** (the DDD bufset discipline): each bin owns ``depth``
  pinned host staging buffers; a dispatch claims one and the harvest
  frees it only after its outputs have been fetched, so an in-flight
  upload is never overwritten.
- **One gather per dispatch**: the rows of every lane's new states are
  gathered on the card with one index tensor and copied to the host in
  one copy, on a harvest stream of their own (so the gather does not
  queue behind the steps dispatched after this ticket).
- **Speculative same-bin dispatch**: within a BFS level, chunk k+1 of a
  lane's frontier does not depend on chunk k's harvest (new states only
  extend the *next* level), so it may be dispatched before k's results
  land.  If k stops the lane (violation, deadlock, failure), k+1's
  slice for that lane is dropped whole at harvest, which leaves every
  counter identical to a run that never speculated.
- **Builds off the critical path**: a bin's "compile" is the nvcc build
  of the kernel libraries its step launches (K1's for the layout, or
  K2's for a schema step; ``ops/build.py`` caches them by source hash
  under ``build/torch_kernels/``).  Each bin builds on a background
  thread, so already-built bins keep the card fed while a new signature
  compiles; the scheduler blocks on a build only when nothing else has
  work.  A failed build fails that bin's lanes with the build's error
  and nothing falls back.  :func:`enable_compile_cache`
  (``--compile-cache DIR`` / ``RAFT_TLA_COMPILE_CACHE``) points the
  library directory at DIR, so restarts are warm.
- **Fair-share packing** (deficit round robin): when a bin's live lanes
  oversubscribe the chunk, each dispatch grants every pending lane a
  quantum of ``max(1, B // n_live)`` rows plus any deficit carried from
  dispatches where the chunk ran out; the ring head advances past the
  lanes served, so consecutive dispatches sweep the ring.  Starvation
  bound (asserted in tests): a live lane with pending rows rides at
  least once in any window of ``n_live`` consecutive dispatches.
  Leftover chunk space backfills greedily in ring order
  (work-conserving), so the chunk stays full whenever any lane has work.

Unlike the reference, a dispatch is not padded to the chunk shape: the
pow2 padding bounded XLA's compiled shapes, and torch needs none.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from raft_tla_tpu_torch.obs.trace import NULL_TRACER

ENV_COMPILE_CACHE = "RAFT_TLA_COMPILE_CACHE"


def enable_compile_cache(path: str | None = None) -> str | None:
    """Point the kernel library directory (``ops/build.BUILD_DIR``) at
    ``path`` (or the ``RAFT_TLA_COMPILE_CACHE`` environment variable), so
    a restart re-serving the same step signatures loads its libraries
    instead of running nvcc.  The directory is also exported to the
    environment, so pool workers (plain serve CLIs) share it.  Returns
    the resolved directory, or None when neither source names one."""
    path = path or os.environ.get(ENV_COMPILE_CACHE) or None
    if not path:
        return None
    from raft_tla_tpu_torch.ops import build
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    build.BUILD_DIR = Path(path)
    os.environ[ENV_COMPILE_CACHE] = path
    return path


class _Ticket:
    """One in-flight dispatch: the device outputs, their host copies (the
    harvest reads them after ``done``), and the host metadata needed to
    demux them per lane."""

    __slots__ = ("bn", "slices", "out", "host", "done", "timing",
                 "buf_idx", "t_disp")

    def __init__(self, bn, slices, out, host, done, timing, buf_idx,
                 t_disp=0.0):
        self.bn = bn
        self.slices = slices            # [(lane, row0, nrows, gidx)]
        self.out = out                  # device dict (svecs read at harvest)
        self.host = host                # {name: host tensor} (_fetch)
        self.done = done                # CUDA event after the copies
        self.timing = timing            # (start, end) events of the step
        self.buf_idx = buf_idx
        self.t_disp = t_disp            # monotonic issue time (tracing)


class _BinState:
    """Scheduler-side state for one bin: staging buffers, the DRR ring,
    and the background build."""

    __slots__ = ("bn", "bufs", "views", "free", "rr", "deficit", "step",
                 "error", "thread", "compile_wall_s", "compiled_async",
                 "dispatches", "rows", "step_ms")

    def __init__(self, bn, depth: int, chunk: int):
        self.bn = bn
        pin = bn.device.type == "cuda"
        self.bufs = [torch.zeros((chunk, bn.lay.width), dtype=torch.int32,
                                 pin_memory=pin) for _ in range(depth)]
        self.views = [b.numpy() for b in self.bufs]  # lint: jit-ok host staging buffers: numpy views of host memory, no copy
        self.free = list(range(depth))
        self.rr = 0
        self.deficit: dict[str, int] = {}
        self.step = None
        self.error: str | None = None
        self.thread: threading.Thread | None = None
        self.compile_wall_s: float | None = None
        self.compiled_async = False
        self.dispatches = 0
        self.rows = 0
        self.step_ms = 0.0


class DispatchScheduler:
    """Route every bin dispatch through one pipelined issue/harvest loop.

    ``depth`` is the global in-flight dispatch cap (2 = the DDD two-deep
    precedent; 1 = fully synchronous).  ``compile_async=False`` also
    moves the builds back onto the dispatch path (built at first
    dispatch), completing the sequential baseline.  ``stop`` is an
    optional zero-arg callable; when it turns truthy the scheduler stops
    submitting, harvests what is in flight (their rows were already
    claimed from the frontiers, so the accounting stays exact) and
    returns — the daemon's drain hook.
    """

    def __init__(self, chunk: int, max_states: int | None = None,
                 depth: int = 2, compile_async: bool = True,
                 stop=None, tracer=None, device="cuda"):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.chunk = chunk
        self.max_states = max_states
        self.depth = depth
        self.compile_async = compile_async
        self.stop = stop
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        # the harvest stream: the row gathers run here, so they never
        # queue behind steps dispatched after their ticket
        self.side = torch.cuda.Stream(self.device) if self.cuda else None
        # v8 tracing (``--trace``): dispatch/harvest/compile spans plus
        # per-ticket issue->harvest lifetimes on a synthetic "tickets"
        # track (they overlap the main thread's nested spans).  The
        # NULL tracer's span() returns one shared no-op handle, so the
        # untraced path stays allocation-free.
        self.tracer = tracer or NULL_TRACER
        self.inflight: deque[_Ticket] = deque()
        self.stats = {"dispatches": 0, "peak_inflight": 0,
                      "async_compiles": 0, "compile_wall_s": {},
                      "bins": {}}

    # -- build --------------------------------------------------------------

    def _compile(self, st: _BinState) -> None:
        """Build a bin's step and its kernel libraries (the compile
        thread, or the dispatch path without async compiles).  A failure
        is kept as the bin's error — its lanes fail with it; there is no
        fallback."""
        with self.tracer.span("compile", bin=st.bn.tag):
            t0 = time.monotonic()
            try:
                st.step = st.bn.build()
            except Exception as e:      # the nvcc error, attributed
                st.error = f"{type(e).__name__}: {e}"
            st.compile_wall_s = time.monotonic() - t0

    def _start_compile(self, st: _BinState) -> None:
        if not self.compile_async:
            return                      # built at its first dispatch
        st.compiled_async = True
        st.thread = threading.Thread(
            target=self._compile, args=(st,),
            name=f"serve-compile-{st.bn.tag}", daemon=True)
        st.thread.start()

    def _ready(self, st: _BinState) -> bool:
        if st.step is not None:
            return True
        if st.thread is None:
            if st.error is None and not self.compile_async:
                self._compile(st)       # sequential baseline: build now
            return st.step is not None
        if not st.thread.is_alive():
            st.thread.join()
            return st.step is not None
        return False

    def _fail_bin(self, st: _BinState, outcomes: dict) -> None:
        """A bin whose build failed: every live lane stops with the
        build's error in its record (the service then exits 1)."""
        for lane in st.bn.live_lanes():
            lane.fail(f"step build failed for {st.bn.tag}: {st.error}")
            outcomes[lane.job_id] = lane.outcome

    # -- fair-share packing (deficit round robin) ---------------------------

    def _plan_takes(self, st: _BinState, live: list) -> list:
        """Decide how many rows each live lane rides this dispatch.
        Returns ``[(lane, take)]`` in ring order (takes > 0 only)."""
        B = self.chunk
        n = len(live)
        quantum = max(1, B // n)
        start = st.rr % n
        order = live[start:] + live[:start]
        budget = B
        takes: dict[str, int] = {}
        cut = n                          # ring index where the chunk ran out
        for i, lane in enumerate(order):
            if budget == 0:
                cut = i
                break
            d = min(st.deficit.get(lane.job_id, 0) + quantum, B)
            t = min(d, lane.pending_rows(), budget)
            if t > 0:
                takes[lane.job_id] = t
                budget -= t
            # deficit carries only while the lane still has unserved work
            st.deficit[lane.job_id] = \
                d - t if lane.pending_rows() - t > 0 else 0
        # ring head past the lanes served: consecutive dispatches sweep
        # the ring (the starvation bound); on a full sweep rotate by one
        # so pass-2 leftover priority also rotates
        st.rr = (start + (cut if cut < n else 1)) % n
        if budget:
            # work-conserving backfill: leftover space goes to deeper
            # frontiers in ring order, no deficit charge (it's idle space)
            for lane in order:
                if budget == 0:
                    break
                extra = min(lane.pending_rows() - takes.get(lane.job_id, 0),
                            budget)
                if extra > 0:
                    takes[lane.job_id] = takes.get(lane.job_id, 0) + extra
                    budget -= extra
        return [(lane, takes[lane.job_id]) for lane in order
                if takes.get(lane.job_id, 0) > 0]

    # -- issue --------------------------------------------------------------

    def _fetch(self, out: dict) -> dict:
        """The small outputs a harvest reads: on the card, one
        ``non_blocking`` copy each into pinned host memory, queued behind
        the step; on the CPU the tensors themselves.  ``overflow`` is
        masked by ``valid`` (the kernel leaves an invalid lane's other
        outputs unwritten) and the keys are fused into one int64."""
        valid = out["valid"]
        small = {"valid": valid,
                 "overflow": out["overflow"] & valid,
                 "keys": out["fp_hi"].to(torch.int64) << 32
                 | (out["fp_lo"].to(torch.int64) & 0xFFFFFFFF),
                 "inv_ok": out["inv_ok"], "con_ok": out["con_ok"]}
        if not self.cuda:
            return small
        return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                .copy_(v, non_blocking=True) for k, v in small.items()}

    def _try_submit(self, st: _BinState) -> bool:
        """Pack and dispatch one chunk from this bin.  False when the bin
        has nothing packable right now (no live pending lanes, step not
        built yet, or no free staging buffer)."""
        bn = st.bn
        if not st.free or st.error is not None:
            return False
        live = [ln for ln in bn.live_lanes() if ln.pending_rows() > 0]
        if not live or not self._ready(st):
            return False
        plan = self._plan_takes(st, live)
        if not plan:
            return False
        tr = self.tracer
        with tr.span("dispatch", bin=bn.tag) as sp:
            buf_idx = st.free.pop(0)
            view = st.views[buf_idx]
            slices, pos = [], 0
            for lane, take in plan:
                gidx, vecs = lane.take(take)
                lane.inflight_slices += 1
                view[pos:pos + take] = vecs
                slices.append((lane, pos, take, gidx))
                pos += take
            rows = st.bufs[buf_idx][:pos]
            timing = done = None
            if self.cuda:
                rows = rows.to(self.device, non_blocking=True)
                timing = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                timing[0].record()
            out = st.step(rows)         # queued on the stream, no wait
            if self.cuda:
                timing[1].record()
            host = self._fetch(out)
            if self.cuda:
                done = torch.cuda.Event()
                done.record()
            sp.set(rows=pos, lanes=len(slices))
        t_disp = time.monotonic() if tr.enabled else 0.0
        self.inflight.append(_Ticket(bn, slices, out, host, done, timing,
                                     buf_idx, t_disp))
        st.dispatches += 1
        st.rows += pos
        self.stats["dispatches"] += 1
        self.stats["peak_inflight"] = max(self.stats["peak_inflight"],
                                          len(self.inflight))
        return True

    # -- harvest ------------------------------------------------------------

    def _harvest_one(self, states: dict, outcomes: dict) -> None:
        """Pop the oldest ticket, wait for its copies, and run every host
        phase (dedup, lane scan, gather, backfill) — minus the lanes
        stopped since issue (their speculative slices drop whole)."""
        tk = self.inflight.popleft()
        tr = self.tracer
        tag = tk.bn.tag
        with tr.span("harvest", bin=tag):
            self._harvest_ticket(tk, states, outcomes)
        if tr.enabled:
            # The ticket's issue->harvest lifetime overlaps the main
            # thread's nested spans, so it rides a synthetic track.
            tr.emit_span("ticket", tk.t_disp,
                         time.monotonic() - tk.t_disp,
                         thread="tickets", bin=tag)

    def _gather(self, svecs, sel_flat: list, W: int) -> np.ndarray:
        """The rows at ``sel_flat`` of ``svecs`` (``[n, A, W]``): one
        index tensor, one gather on the device, one copy to the host."""
        sel = torch.as_tensor(np.asarray(sel_flat, dtype=np.int64))
        if not self.cuda:
            return svecs.reshape(-1, W)[sel].numpy()
        # everything on the harvest stream: the ticket's event has fired,
        # so svecs is complete, and a copy the reshape may make must not
        # queue on the main stream behind later tickets' steps
        with torch.cuda.stream(self.side):
            rows = svecs.reshape(-1, W)[sel.to(self.device,
                                               non_blocking=True)]
            return rows.cpu().numpy()

    def _harvest_ticket(self, tk: _Ticket, states: dict,
                        outcomes: dict) -> None:
        from raft_tla_tpu_torch.serve.batch import _LaneFailure
        bn = tk.bn
        st = states[bn.key]
        W, A = bn.lay.width, bn.A
        if tk.done is not None:
            tk.done.synchronize()       # this ticket's step and copies only
            st.step_ms += tk.timing[0].elapsed_time(tk.timing[1])
        h = tk.host
        # host memory (the pinned copies, or the CPU step's tensors)
        valid = h["valid"].numpy()
        ovf = h["overflow"].numpy()
        keys = h["keys"].numpy().view(np.uint64)
        inv_ok = h["inv_ok"].numpy()
        con_ok = h["con_ok"].numpy()

        # Phase 1 per lane slice; collect the dispatch-global flat indices
        # of every accepted new state for one shared device gather.
        sel_flat: list[int] = []
        committing = []
        for lane, r0, nb, gidx in tk.slices:
            lane.inflight_slices -= 1
            if not lane.active:          # stopped since issue: drop whole
                continue
            sl = slice(r0, r0 + nb)
            try:
                new_flat = lane.scan_slice(valid[sl], ovf[sl], keys[sl],
                                           inv_ok[sl], con_ok[sl], gidx)
            except _LaneFailure as e:
                lane.fail(str(e))
                outcomes[lane.job_id] = lane.outcome
                continue
            committing.append((lane, len(new_flat)))
            sel_flat.extend(r0 * A + fi for fi in new_flat)

        # One gather for the whole dispatch, then split back per lane in
        # chunk order.
        if sel_flat:
            rows_all = self._gather(tk.out["svecs"], sel_flat, W)
        else:
            rows_all = np.empty((0, W), dtype=np.int32)
        off = 0
        inflight_now = len(self.inflight)
        for lane, n_lane in committing:
            lane.commit_slice(rows_all[off:off + n_lane])
            off += n_lane
            try:
                lane.advance(self.max_states, inflight=inflight_now)
            except _LaneFailure as e:
                lane.fail(str(e))
            if not lane.active:
                outcomes[lane.job_id] = lane.outcome
        # the staging buffer's upload finished before this ticket's event
        st.free.append(tk.buf_idx)

    # -- main loop ----------------------------------------------------------

    def _stopping(self) -> bool:
        return bool(self.stop and self.stop())

    def run(self, bins: dict, outcomes: dict) -> dict:
        """Drive every bin to quiescence (or to the stop signal).
        Returns the scheduler stats (also kept on ``self.stats``)."""
        states = {key: _BinState(bn, self.depth, self.chunk)
                  for key, bn in bins.items()}
        # Kick off every build up-front: the first signatures to finish
        # start dispatching while the rest still build in background.
        for st in states.values():
            if st.bn.live_lanes():
                self._start_compile(st)
        order = list(states.values())
        rr = 0
        while True:
            stopping = self._stopping()
            if not stopping:
                # fill the pipeline, round-robin across bins
                while len(self.inflight) < self.depth:
                    submitted = False
                    for k in range(len(order)):
                        st = order[(rr + k) % len(order)]
                        if self._try_submit(st):
                            rr = (rr + k + 1) % len(order)
                            submitted = True
                            break
                        if st.error is not None and st.bn.live_lanes():
                            self._fail_bin(st, outcomes)
                    if not submitted:
                        break
            if self.inflight:
                self._harvest_one(states, outcomes)
                continue
            if stopping:
                break
            # Nothing in flight and nothing packable: done, unless a bin
            # with live work is still building — then wait for it (the
            # card would idle regardless; this is the only block).
            waiting = [st for st in order
                       if st.thread is not None and st.thread.is_alive()
                       and any(ln.pending_rows() > 0
                               for ln in st.bn.live_lanes())]
            if not waiting:
                break
            waiting[0].thread.join()
        for st in order:
            tag = st.bn.tag
            if st.compile_wall_s is not None:
                self.stats["compile_wall_s"][tag] = \
                    round(st.compile_wall_s, 3)
                if st.compiled_async:
                    self.stats["async_compiles"] += 1
            self.stats["bins"][tag] = {
                "lanes": len(st.bn.lanes), "dispatches": st.dispatches,
                "rows": st.rows, "step_ms": round(st.step_ms, 4),
                "error": st.error}
        return self.stats
