"""Lane-packed batch executor — N independent checks per fused dispatch;
the port of ``raft_tla_tpu/serve/batch.py``.

The continuous-batching shape that makes inference stacks fast, applied
to model checking: admitted small-universe jobs are binned by **step
signature** (bounds + spec subset + invariants + symmetry + view + the
step's gate resolutions — ``ops/kernels.step_signature``, which pins the
packed state width and the kernel variant), and each bin's lanes share
ONE step: on the card K1 (``csrc/step.cu``) for a Raft bin, the schema
step keyed by K2 (``csrc/fingerprint.cu``) for a twophase or IR bin.
Every dispatch packs rows from all of the bin's live frontiers into one
``[B, W]`` launch — lane-tagged on the host, anonymous on the device — so
one launch advances N independent BFS frontiers at once.  As a lane
completes, its chunk share backfills with the remaining lanes' rows on
the very next dispatch (continuous batching, not static batching): the
chunk stays full while any lane has work.

Why it is sound: lanes never share dedup state — each lane owns its
fingerprint set, store, parent links, coverage and level accounting,
exactly the per-run state of the port's solo ``engine.Engine.check`` —
so a lane's slice of a dispatch is processed with the same logic as a
solo chunk.  For runs that complete (no violation), counts are
chunk-boundary-independent, hence **identical to a solo run of the same
cfg**; a violating lane's transition tally depends on its slice
boundaries, the same way a solo Engine's depends on ``--chunk`` (the
verdict and trace do not).
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from raft_tla_tpu_torch.config import CheckConfig
from raft_tla_tpu_torch.engine import (DEADLOCK, EngineResult, Violation,
                                       _VecStore)
from raft_tla_tpu_torch.frontend.registry import _cuda_device
from raft_tla_tpu_torch.obs import RunTelemetry
from raft_tla_tpu_torch.ops import kernels
from raft_tla_tpu_torch.serve.sched import DispatchScheduler


def bin_key(config: CheckConfig, device="cuda") -> tuple:
    """The step-signature bin: everything the step is built over.

    Delegates to ``ops/kernels.step_signature`` — THE definition of a
    step's identity, including the construction-time gate resolutions
    for ``device`` (prescan / sig-prune / megakernel / devdedup) — so a
    gate flipping between admissions can never mix step variants inside
    one bin.  ``chunk`` is deliberately excluded: the executor imposes
    its own shared chunk, so jobs differing only in requested chunk share
    a bin (and a build).  ``check_deadlock`` is appended even though the
    step is not built over it: the executor's per-lane scan branches on
    it, and bins share that scan path.
    """
    return kernels.step_signature(
        config.bounds, config.spec, tuple(config.invariants),
        tuple(config.symmetry), config.view, device) \
        + (config.check_deadlock,)


class _LaneFailure(Exception):
    """A per-lane abort (capacity overflow, cap exceeded) — poisons the
    lane, never the dispatch: the other tenants keep running."""


@dataclasses.dataclass
class LaneOutcome:
    """One job's terminal state, service-attribution-ready."""

    job_id: str
    status: str                       # completed | violation | deadlock
    #                                 # | stopped (lane failure)
    result: Optional[EngineResult] = None
    error: str | None = None


class _Lane:
    """One job's BFS state — the per-run state of ``engine.Engine.check``
    factored out so N of them can interleave on one step."""

    def __init__(self, job_id: str, config: CheckConfig, table, lay,
                 tel: RunTelemetry | None = None, init_override=None,
                 model=None, wall_s: float | None = None):
        if model is None:
            from raft_tla_tpu_torch.frontend.registry import resolve_model
            model = resolve_model(config.spec)
        self.job_id = job_id
        self.config = config
        self.model = model
        self.table = table
        self.A = len(table)
        self.lay = lay
        self.tel = tel
        self.wall_s = wall_s            # per-job wall budget (JobOptions)
        self.t0 = time.monotonic()

        bounds = config.bounds
        init_py = init_override if init_override is not None \
            else model.init_py(bounds)
        init_vec = model.to_vec(init_py, bounds)
        hi0, lo0 = model.init_fingerprint(config, init_py, init_vec)
        self.seen: set[int] = {hi0 << 32 | lo0}
        self.store = _VecStore(lay.width)
        self.store.append(init_vec[None, :])
        self.parents: list = [None]
        self.coverage: Counter = Counter()
        self.levels = [1]
        self.n_transitions = 0
        self.violation: Optional[Violation] = None
        self.new_this_level = 0
        self.next_frontier: list[int] = []
        self.outcome: Optional[LaneOutcome] = None
        self._pending = None

        if tel is not None:
            tel.run_start()
        for nm in config.invariants:
            if not model.py_invariant(nm)(init_py, bounds):
                self.violation = self._make_violation(nm, 0)
                break
        self.frontier = [0] if self.violation is None and \
            model.constraint_ok(init_py, bounds) else []
        self.cursor = 0
        # Slices taken by a dispatch but not yet harvested.  The cursor
        # advances at take() time (so a speculative same-level dispatch
        # can claim the NEXT rows before the previous harvest lands), so
        # "cursor at end of frontier" alone does not mean the level is
        # done — promotion must also wait for the in-flight count to
        # drain back to zero.
        self.inflight_slices = 0
        if self.violation is not None or not self.frontier:
            self._finish()

    # -- executor interface ---------------------------------------------------

    @property
    def active(self) -> bool:
        return self.outcome is None

    def pending_rows(self) -> int:
        return len(self.frontier) - self.cursor

    def take(self, n: int):
        """Claim the next ``n`` frontier rows: (gidx list, stacked vecs)."""
        gidx = self.frontier[self.cursor:self.cursor + n]
        self.cursor += len(gidx)
        vecs = np.stack([self.store.get(g) for g in gidx])
        return gidx, vecs

    def scan_slice(self, valid, ovf, keys, inv_ok, con_ok, gidx) -> list:
        """Phase 1 on this lane's slice of a dispatch (its 'chunk'):
        dedup in discovery order, transition/deadlock accounting, and
        the violation cut — ``engine.Engine.check`` semantics verbatim.
        ``ovf`` is already masked by ``valid`` (the kernel leaves an
        invalid lane's other outputs unwritten).  Returns slice-relative
        flat indices of accepted new states."""
        A = self.A
        if ovf.any():
            _, a = np.argwhere(ovf)[0]
            raise _LaneFailure(
                "state-capacity overflow at "
                f"{self.table[int(a)].label()} — bounds reasoning "
                "violated (config.py capacity scheme)")
        dead_limit = None
        if self.config.check_deadlock:
            dead = ~valid.any(axis=1)
            if dead.any():
                dead_limit = int(np.argmax(dead)) * A
        flat_keys = keys.reshape(-1)
        flat_valid = valid.reshape(-1)
        if dead_limit is not None:
            flat_valid = flat_valid.copy()
            flat_valid[dead_limit:] = False
        self.n_transitions += int(flat_valid.sum())
        new_flat: list[int] = []
        seen = self.seen
        for fi in np.nonzero(flat_valid)[0].tolist():
            kk = int(flat_keys[fi])
            if kk in seen:
                continue
            seen.add(kk)
            new_flat.append(fi)
        for t, fi in enumerate(new_flat):
            b, a = divmod(fi, A)
            if not inv_ok[b, a].all():
                new_flat = new_flat[:t + 1]
                break
        self._pending = (new_flat, inv_ok, con_ok, gidx, dead_limit)
        return new_flat

    def commit_slice(self, rows: np.ndarray) -> None:
        """Phase 2: append the gathered new-state rows and record
        parents/coverage/verdicts in discovery order."""
        new_flat, inv_ok, con_ok, gidx, dead_limit = self._pending
        self._pending = None
        inv_names = list(self.config.invariants)
        if not new_flat:
            if dead_limit is not None:
                self.violation = self._make_violation(
                    DEADLOCK, gidx[dead_limit // self.A])
            return
        base = len(self.store)
        self.store.append(rows)
        for t, fi in enumerate(new_flat):
            b, a = divmod(fi, self.A)
            g = base + t
            self.parents.append((gidx[b], a))
            self.coverage[self.table[a].family] += 1
            self.new_this_level += 1
            bad = np.nonzero(~inv_ok[b, a])[0]
            if bad.size:
                self.violation = self._make_violation(
                    inv_names[int(bad[0])], g)
                break
            if con_ok[b, a]:
                self.next_frontier.append(g)
        if self.violation is None and dead_limit is not None:
            self.violation = self._make_violation(
                DEADLOCK, gidx[dead_limit // self.A])

    def advance(self, max_states: int | None,
                inflight: int | None = None) -> None:
        """Post-slice lane control: violation stop, level promotion,
        completion — with a per-lane segment event at each boundary.
        ``inflight`` is the scheduler's dispatch-pipeline depth at the
        boundary (schema-v4 attribution, with the lane's bin tag)."""
        if self.violation is not None:
            self._finish()
            return
        if self.cursor < len(self.frontier) or self.inflight_slices > 0:
            return                      # level still in flight
        if self.new_this_level:
            self.levels.append(self.new_this_level)
        if self.tel is not None:
            self.tel.segment(len(self.store), len(self.levels) - 1,
                             self.n_transitions,
                             coverage=dict(self.coverage),
                             bin=getattr(self, "bin_tag", None),
                             inflight=inflight)
        if max_states is not None and len(self.store) > max_states:
            raise _LaneFailure(f"state count exceeded {max_states}")
        if self.wall_s is not None:
            spent = time.monotonic() - self.t0
            if spent > self.wall_s:
                # lossless deadline stop, the engines' --deadline analog:
                # the level boundary is a consistent cut, so every count
                # this lane reported stands and the record attributes the
                # stop to the tenant's own budget, not a service fault
                raise _LaneFailure(
                    f"budget-exceeded: wall {spent:.3f}s over the "
                    f"{self.wall_s:g}s wall_s budget (lossless "
                    "level-boundary stop)")
        self.frontier = self.next_frontier
        self.next_frontier = []
        self.cursor = 0
        self.new_this_level = 0
        if not self.frontier:
            self._finish()

    def fail(self, message: str) -> None:
        """Poison this lane (its tenants' verdict is 'stopped', with the
        failure as the reason); the dispatch and the other lanes live."""
        res = self._result(complete=False)
        if self.tel is not None:
            self.tel.stop_requested(message, source="serve")
            self.tel.run_end(res)
        self.outcome = LaneOutcome(self.job_id, "stopped", result=res,
                                   error=message)

    # -- internals ------------------------------------------------------------

    def _result(self, complete: bool = True) -> EngineResult:
        return EngineResult(
            n_states=len(self.store), diameter=len(self.levels) - 1,
            n_transitions=self.n_transitions, coverage=self.coverage,
            violation=self.violation, levels=self.levels,
            wall_s=time.monotonic() - self.t0, complete=complete)

    def _finish(self) -> None:
        res = self._result()
        if self.violation is None:
            status = "completed"
        else:
            status = "deadlock" if self.violation.invariant == DEADLOCK \
                else "violation"
        if self.tel is not None:
            self.tel.run_end(res)
        self.outcome = LaneOutcome(self.job_id, status, result=res)

    def _make_violation(self, inv_name: str, gidx: int) -> Violation:
        chain = []
        cur: Optional[int] = gidx
        while cur is not None:
            py = self.model.from_vec(self.store.get(cur),
                                     self.config.bounds)
            entry = self.parents[cur]
            label = self.table[entry[1]].label() if entry else None
            chain.append((label, py))
            cur = entry[0] if entry else None
        chain.reverse()
        return Violation(invariant=inv_name, state=chain[-1][1], trace=chain)


class _Bin:
    """One step signature: a step + the lanes sharing it.  The step is
    *built* by the scheduler (:meth:`build`, on a background thread when
    async compiles are on, at first dispatch otherwise), so a new
    signature's nvcc build never stalls bins that are already serving."""

    def __init__(self, key: tuple, config: CheckConfig, device,
                 tag: str = "bin"):
        from raft_tla_tpu_torch.frontend.registry import resolve_model
        self.key = key
        self.tag = tag                  # stable per-run label (obs v4)
        self.config = config
        self.device = torch.device(device)
        self.bounds = config.bounds
        self.model = resolve_model(config.spec)
        self.lay = self.model.layout(config.bounds)
        self.table = self.model.action_table(config.bounds)
        self.A = len(self.table)
        self.step = None
        self.lanes: list[_Lane] = []

    def build(self):
        """The bin's compile: its step for the device and, on the card,
        every kernel library the step's launches load — K1's for the
        layout (built inside ``build_step``), K2's for a step whose rows
        K2 keys, K1's again for the orbit key of an IR step under
        SYMMETRY or a VIEW — so the first dispatch never waits on nvcc.
        Raises what the build raises (the nvcc error); nothing falls
        back."""
        step = self.model.build_step(self.config, self.device)
        if self.device.type == "cuda" and self.model.use_ir:
            from raft_tla_tpu_torch.ops import build, pallas_fp, pallas_step
            build.library(pallas_fp.SOURCE)
            if self.config.symmetry or self.config.view:
                build.library(pallas_step.SOURCE,
                              pallas_step.layout_defines(self.bounds))
        return step

    def live_lanes(self) -> list:
        return [ln for ln in self.lanes if ln.active]


class BatchExecutor:
    """Run N admitted jobs with shared, lane-packed fused dispatches.

    ``chunk`` is the shared dispatch width ``B`` (a dispatch packs at most
    ``B`` frontier rows); ``max_states`` is a per-lane cap mirroring the
    engines' state cap.  ``run`` returns ``{job_id: LaneOutcome}`` — one
    terminal record per job, always.

    Every dispatch is routed through :class:`~raft_tla_tpu_torch.serve.
    sched.DispatchScheduler`: ``depth`` dispatches ride the device at once
    (issue bin B's step while bin A's harvest runs on the host) and new
    bins build on a background thread.  ``depth=1`` with
    ``compile_async=False`` is the synchronous baseline.  ``stop`` is an
    optional zero-arg callable polled at dispatch boundaries: when
    truthy, in-flight work is harvested and every still-active lane is
    stopped with drain attribution — the daemon's lossless-SIGINT
    contract.  ``device`` is where every step runs (``cuda`` unless the
    caller asks for the CPU).
    """

    def __init__(self, chunk: int = 1024, max_states: int | None = None,
                 depth: int = 2, compile_async: bool = True, stop=None,
                 tracer=None, device="cuda"):
        self.chunk = chunk
        self.max_states = max_states
        self.depth = depth
        self.compile_async = compile_async
        self.stop = stop
        self.tracer = tracer            # SpanTracer | None (v8 tracing)
        self.device = _cuda_device(device)   # cuda without a GPU raises
        self.last_stats: dict | None = None   # scheduler stats of last run

    def run(self, jobs, telemetry: dict | None = None,
            init_overrides: dict | None = None,
            budgets: dict | None = None) -> dict:
        """``jobs``: iterable of ``(job_id, CheckConfig)``; ``telemetry``
        optionally maps job_id -> RunTelemetry (the service wires one
        per-job event log each; callers owning none pass nothing).
        ``init_overrides`` maps job_id -> PyState, mirroring the solo
        engines' ``init_override`` hook.  ``budgets`` maps job_id -> wall
        seconds (``JobOptions.wall_s``): an over-budget lane is stopped
        losslessly at its next level boundary with a ``budget-exceeded``
        record."""
        telemetry = telemetry or {}
        init_overrides = init_overrides or {}
        budgets = budgets or {}
        bins: dict[tuple, _Bin] = {}
        outcomes: dict[str, LaneOutcome] = {}
        lanes: list[_Lane] = []
        for job_id, config in jobs:
            if job_id in outcomes or any(ln.job_id == job_id
                                         for ln in lanes):
                raise ValueError(f"duplicate job id {job_id!r}")
            key = bin_key(config, self.device)
            bn = bins.get(key)
            if bn is None:
                bn = bins[key] = _Bin(key, config, self.device,
                                      tag=f"bin{len(bins)}")
            lane = _Lane(job_id, config, bn.table, bn.lay,
                         tel=telemetry.get(job_id),
                         init_override=init_overrides.get(job_id),
                         model=bn.model, wall_s=budgets.get(job_id))
            lane.bin_tag = bn.tag
            bn.lanes.append(lane)
            lanes.append(lane)
            if not lane.active:         # init-state verdict, no dispatch
                outcomes[job_id] = lane.outcome

        sched = DispatchScheduler(
            chunk=self.chunk, max_states=self.max_states,
            depth=self.depth, compile_async=self.compile_async,
            stop=self.stop, tracer=self.tracer, device=self.device)
        try:
            self.last_stats = sched.run(bins, outcomes)
            # The scheduler returns with live lanes only when stopped
            # (daemon drain): those get an attributed terminal record,
            # never silence.  A bin whose build failed had its lanes
            # failed by the scheduler, with the build's error.
            stopped = bool(self.stop and self.stop())
            for lane in lanes:
                if lane.active:
                    lane.fail("stop requested (drain)" if stopped
                              else "scheduler quiescent with live lanes "
                                   "(step unrunnable)")
                    outcomes[lane.job_id] = lane.outcome
        finally:
            for lane in lanes:
                if lane.tel is not None:
                    lane.tel.close()
        return {ln.job_id: outcomes[ln.job_id] for ln in lanes}
