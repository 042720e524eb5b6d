"""Versioned JSONL run-event telemetry — the port's copy of
``raft_tla_tpu/obs/events.py``: the one progress schema the device and DDD
engines emit, byte-compatible with the reference's logs.

- :class:`ProgressRecord` — one dataclass carrying cumulative counters
  *and* incremental (honest-rate) counters, plus the dedup-hit-rate and
  route-peak fields.
- :class:`ProgressTracker` — the rate/anchor arithmetic in one place:
  ``inc_states_per_sec`` is primary (delta since the last record, immune
  to resume inflation); cumulative fields are tagged ``since_resume``
  (False = the counters span prior processes, so cumulative rates mix
  prior-process states with this-process wall and are NOT trustworthy).
- :class:`EventLog` — a non-blocking buffered JSONL writer (background
  thread; ``emit`` never blocks the check loop).
- :class:`RunTelemetry` — the facade engines drive: ``run_start`` /
  ``segment`` / ``checkpoint`` / ``stop_requested`` / ``run_end``, with
  ``level_end`` derived automatically from level transitions and
  ``violation`` derived from the final
  :class:`~raft_tla_tpu_torch.engine.EngineResult`.

The schema, its version history and :func:`validate_event` are the
reference's verbatim, so a log written by either package validates the
same way in both; the event types of every layer (the walker fleet's
``sim``, the serve pool's lifecycle, the metrics snapshot) are in it.

Event grammar (``SCHEMA_VERSION`` = 10; earlier-version lines remain
valid) —
every line is one JSON object with base fields ``v`` (schema version),
``event`` (type) and ``ts`` (unix epoch seconds):

``run_start``      engine, universe, spec, invariants, resumed
                   [+ bounds, symmetry, view, chunk, caps, n_states,
                      n_devices, git_sha, fiducials, pid]
``segment``        the ProgressRecord fields (below)
``level_end``      level, n_states           (as observed at a boundary)
``checkpoint``     path [+ n_states]
``violation``      invariant [+ kind]
``stop_requested`` reason [+ source, pid]    (clean stop vs crash vs abort)
``run_end``        n_states, n_transitions, complete, outcome
                   [+ diameter, levels, wall_s]

Version 2 adds the campaign-supervisor lifecycle (emitted by
``campaign/``, never by the engines themselves):

``preempt``        reason [+ detail, pid, stale_s, drift]
                   (the supervisor declared the child unhealthy / got a
                    preemption signal and is driving the lossless stop)
``reshard``        ndev_src, ndev_dst [+ n_states, path, block]
``resume_attempt`` attempt [+ path, ndev, backoff_s, quarantined]

Version 3 adds the statistical-checking (walker fleet) fields — both
optional, both invalid on a ``"v" < 3`` line:

``segment.device_rates``   per-device walker states/s for the segment
                           (fleet runs; list of numbers, mesh order)
``run_end.sim``            confidence summary for simulation runs:
                           behaviors / sampled_transitions / max_depth /
                           walkers / n_devices / coverage_entropy /
                           steer_tau / per_invariant states-checked —
                           what a statistical run actually established,
                           next to the exhaustive engines' proofs

Version 4 adds the serve-scheduler attribution fields — both optional,
both invalid on a ``"v" < 4`` line:

``segment.bin``            the step-signature bin tag of a serve lane's
                           dispatch stream, so the monitor can attribute
                           device time per compiled bin
``segment.inflight``       async-scheduler dispatches in flight when the
                           segment boundary was observed (0 = the lane
                           ran synchronously)

Version 5 adds the ddd background host-dedup attribution field —
optional, invalid on a ``"v" < 5`` line:

``segment.flush_backlog``  sealed dedup flushes pending/in flight on the
                           background worker when the segment boundary
                           was observed (0/1 — the worker is depth-1
                           ordered; absent = synchronous host dedup)

Version 6 adds the ddd upload-prefetch attribution fields — both
optional, both invalid on a ``"v" < 6`` line:

``segment.upload_wait_ms`` cumulative main-thread wall spent waiting in
                           the upload phase for a staged block (hits)
                           or loading one inline (misses); absent =
                           prefetch gate off
``segment.prefetch_hits``  block uploads served from an already-staged
                           buffer since the run started (misses =
                           blocks - hits; the in-engine warm rate
                           runs/prefetch_ab.py reports)

Version 7 adds the serve worker-pool supervision lifecycle (emitted by
``serve/pool``, never by the engines themselves) — all four
event types invalid on a ``"v" < 7`` line:

``worker_spawn``   worker, pid [+ jobs, bins, chunk, respawn, attempt]
                   (a pool worker child came up, with its job assignment
                    and the dispatch width it was granted)
``worker_lost``    worker, kind [+ pid, exit_code, jobs, detail]
                   (the pool reaped a dead/preempted worker; ``kind`` is
                    the death classification: killed / segfault / oom /
                    signal / crashed / heartbeat-stale / session-wall)
``job_retry``      job_id, attempt [+ worker, backoff_s, reason]
                   (a surviving job was requeued to a fresh worker)
``quarantine``     job_id, reason [+ deaths, worker, detail]
                   (poison verdict: the job killed its worker K times
                    and will never be executed again)

Version 8 adds the cross-process tracing layer (obs/trace.py — gated by
``--trace`` / ``RAFT_TLA_TRACE``, never on by default):

``span``           name, span_id, t0, dur, thread [+ parent_id, args]
                   (one completed traced region: ``t0`` is
                    ``time.monotonic()`` in the emitting process and
                    ``dur`` seconds; ``thread`` the emitting thread's
                    name or a synthetic track like ``"tickets"``;
                    ``parent_id`` nests spans per thread)
``run_start.anchor``  wall/mono/err_s clock-anchor pair — the emitting
                   process's ``time.time()`` read bracketed by two
                   ``time.monotonic()`` reads, so the trace collector
                   (obs/collect.py) can place monotonic span timestamps
                   from many processes on one wall axis with a recorded
                   error bound
``run_start.host`` host context for cross-session comparison (nproc,
                   torch and CUDA versions, the card)

Version 9 adds ddd device-dedup attribution (ops/devdedup — gated by
``--device-dedup`` / ``RAFT_TLA_DEVDEDUP``): segment ``export_rows``
(cumulative rows actually exported d2h, post-filter; emitted by the DDD
engines regardless of the gate so A/B off arms stay comparable) and
``dev_dedup_hits`` (cumulative rows the device set dropped pre-export;
only present when the gate is on).

Version 10 adds the live metrics layer (obs/metrics.py — gated by
``--metrics-port`` / ``RAFT_TLA_METRICS``, never on by default):

``metrics_snapshot``  metrics [+ port, root]
                   (one periodic snapshot of the streaming-reducer
                    registry: a flat ``{prometheus_name: value}`` dict
                    — counters, gauges, and the per-tenant latency
                    histogram quantiles the OpenMetrics endpoint
                    exposes — so the scrape record is replayable from
                    the event log alone; ``port`` the bound endpoint
                    port, ``root`` the swept log directory)

A run log with no ``run_end`` means the process died — crash attribution
for free.  The schema is strict: unknown fields fail validation and the
v2/v7/v8/v10-only event types (resp. v3/v4/v5/v6/v8/v9-only fields) are
invalid on a ``"v" < 2`` / ``"v" < 7`` / ``"v" < 8`` / ``"v" < 10``
(resp. ``"v" < 3`` / ``"v" < 4`` / ``"v" < 5`` / ``"v" < 6`` /
``"v" < 8`` / ``"v" < 9``) line, so any addition requires a version
bump (versioning policy in README.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import subprocess
import threading
import time

SCHEMA_VERSION = 10
_VERSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10)  # versions validate_event accepts

# Environment knobs (set by check.py --events/--phase-timers; inherited by
# liveness re-runs and campaign children the same way).
ENV_EVENTS = "RAFT_TLA_EVENTS"


def events_path(explicit: str | None = None) -> str | None:
    """The one resolution point for the EVENTS gate: an explicit path
    wins, else ``RAFT_TLA_EVENTS``, else None (telemetry off).  Every
    consumer (RunTelemetry, check.py's --trace validation) goes through
    here so the precedence can never fork."""
    return explicit or os.environ.get(ENV_EVENTS) or None


_DEADLOCK_NAME = "Deadlock"  # engine.DEADLOCK's invariant name (avoid import)


# --------------------------------------------------------------------------
# schema validation


def _is(value, spec) -> bool:
    """Type check where bool is NOT an int (JSON booleans are not counts)."""
    if spec is int:
        return type(value) is int
    if spec is _NUM:
        return type(value) in (int, float)
    if isinstance(spec, tuple):
        return any(_is(value, s) for s in spec)
    return isinstance(value, spec)


class _NUM:  # sentinel: int or float, not bool
    pass


_BASE = {"v": int, "event": str, "ts": _NUM}

_SEGMENT_REQUIRED = {
    "wall_s": _NUM,
    "n_states": int,
    "level": int,
    "n_transitions": int,
    "dedup_hit_rate": _NUM,
    "states_per_sec": _NUM,
    "inc_states_per_sec": _NUM,
    "since_resume": bool,
}

_REQUIRED = {
    "run_start": {"engine": str, "universe": dict, "spec": str,
                  "invariants": list, "resumed": bool},
    "segment": _SEGMENT_REQUIRED,
    "level_end": {"level": int, "n_states": int},
    "checkpoint": {"path": str},
    "violation": {"invariant": str},
    "stop_requested": {"reason": str},
    "run_end": {"n_states": int, "n_transitions": int, "complete": bool,
                "outcome": str},
    "preempt": {"reason": str},
    "reshard": {"ndev_src": int, "ndev_dst": int},
    "resume_attempt": {"attempt": int},
    "worker_spawn": {"worker": str, "pid": int},
    "worker_lost": {"worker": str, "kind": str},
    "job_retry": {"job_id": str, "attempt": int},
    "quarantine": {"job_id": str, "reason": str},
    "span": {"name": str, "span_id": int, "t0": _NUM, "dur": _NUM,
             "thread": str},
    "metrics_snapshot": {"metrics": dict},
}

# Event types that only exist from schema version 2 on (the campaign
# supervisor lifecycle) — invalid on a "v": 1 line.
_V2_EVENTS = frozenset({"preempt", "reshard", "resume_attempt"})

# Event types that only exist from schema version 7 on (the serve
# worker-pool supervision lifecycle) — invalid on a "v" < 7 line.
_V7_EVENTS = frozenset({"worker_spawn", "worker_lost", "job_retry",
                        "quarantine"})

# Event types that only exist from schema version 8 on (the cross-process
# tracing layer, obs/trace.py) — invalid on a "v" < 8 line.
_V8_EVENTS = frozenset({"span"})

# Event types that only exist from schema version 10 on (the live
# metrics layer, obs/metrics.py) — invalid on a "v" < 10 line.
_V10_EVENTS = frozenset({"metrics_snapshot"})

# Fields that only exist from schema version 3 on (walker-fleet
# statistical checking) — invalid on a "v" < 3 line.
_V3_FIELDS = {"segment": frozenset({"device_rates"}),
              "run_end": frozenset({"sim"})}

# Fields that only exist from schema version 4 on (serve async-scheduler
# per-bin attribution) — invalid on a "v" < 4 line.
_V4_FIELDS = {"segment": frozenset({"bin", "inflight"})}

# Fields that only exist from schema version 5 on (ddd background
# host-dedup attribution) — invalid on a "v" < 5 line.
_V5_FIELDS = {"segment": frozenset({"flush_backlog"})}

# Fields that only exist from schema version 6 on (ddd upload-prefetch
# attribution) — invalid on a "v" < 6 line.
_V6_FIELDS = {"segment": frozenset({"upload_wait_ms", "prefetch_hits"})}

# Fields that only exist from schema version 8 on (trace clock anchors
# and host context) — invalid on a "v" < 8 line.
_V8_FIELDS = {"run_start": frozenset({"anchor", "host"})}

# Fields that only exist from schema version 9 on (ddd device-dedup
# attribution) — invalid on a "v" < 9 line.
_V9_FIELDS = {"segment": frozenset({"export_rows", "dev_dedup_hits"})}

_OPTIONAL = {
    "run_start": {"bounds": dict, "symmetry": list, "view": str,
                  "chunk": int, "caps": str, "n_states": int,
                  "n_devices": int, "git_sha": str, "fiducials": dict,
                  "pid": int, "anchor": dict, "host": dict},
    "segment": {"coverage": dict, "route_peak": int, "n_devices": int,
                "inv_evals": dict, "phase_s": dict, "device_rates": list,
                "bin": str, "inflight": int, "flush_backlog": int,
                "upload_wait_ms": _NUM, "prefetch_hits": int,
                "export_rows": int, "dev_dedup_hits": int},
    "level_end": {},
    "checkpoint": {"n_states": int},
    "violation": {"kind": str},
    "stop_requested": {"source": str, "pid": int},
    "run_end": {"diameter": int, "levels": list, "wall_s": _NUM,
                "sim": dict},
    "preempt": {"detail": str, "pid": int, "stale_s": _NUM,
                "drift": dict},
    "reshard": {"n_states": int, "path": str, "block": int},
    "resume_attempt": {"path": str, "ndev": int, "backoff_s": _NUM,
                       "quarantined": str},
    "worker_spawn": {"jobs": list, "bins": int, "chunk": int,
                     "respawn": bool, "attempt": int},
    "worker_lost": {"pid": int, "exit_code": int, "jobs": list,
                    "detail": str},
    "job_retry": {"worker": str, "backoff_s": _NUM, "reason": str},
    "quarantine": {"deaths": int, "worker": str, "detail": str},
    "span": {"parent_id": int, "args": dict},
    "metrics_snapshot": {"port": int, "root": str},
}


def validate_event(d: dict) -> list:
    """Return the list of schema violations in ``d`` ([] = valid).

    Strict by design: unknown event types and unknown fields are errors,
    so schema drift between engines is caught by the conformance test
    instead of accumulating silently (the pre-obs failure mode).
    """
    errs = []
    if not isinstance(d, dict):
        return [f"not an object: {type(d).__name__}"]
    for k, spec in _BASE.items():
        if k not in d:
            errs.append(f"missing base field {k!r}")
        elif not _is(d[k], spec):
            errs.append(f"base field {k!r} has wrong type")
    if errs:
        return errs
    if d["v"] not in _VERSIONS:
        errs.append(f"schema version {d['v']} not in {list(_VERSIONS)}")
    ev = d["event"]
    if ev not in _REQUIRED:
        return errs + [f"unknown event type {ev!r}"]
    if ev in _V2_EVENTS and d["v"] in _VERSIONS and d["v"] < 2:
        errs.append(f"{ev}: event type requires schema version >= 2")
    if ev in _V7_EVENTS and d["v"] in _VERSIONS and d["v"] < 7:
        errs.append(f"{ev}: event type requires schema version >= 7")
    if ev in _V8_EVENTS and d["v"] in _VERSIONS and d["v"] < 8:
        errs.append(f"{ev}: event type requires schema version >= 8")
    if ev in _V10_EVENTS and d["v"] in _VERSIONS and d["v"] < 10:
        errs.append(f"{ev}: event type requires schema version >= 10")
    req, opt = _REQUIRED[ev], _OPTIONAL[ev]
    for k, spec in req.items():
        if k not in d:
            errs.append(f"{ev}: missing required field {k!r}")
        elif not _is(d[k], spec):
            errs.append(f"{ev}: field {k!r} has wrong type")
    v3_only = _V3_FIELDS.get(ev, frozenset())
    v4_only = _V4_FIELDS.get(ev, frozenset())
    v5_only = _V5_FIELDS.get(ev, frozenset())
    v6_only = _V6_FIELDS.get(ev, frozenset())
    v8_only = _V8_FIELDS.get(ev, frozenset())
    v9_only = _V9_FIELDS.get(ev, frozenset())
    for k, val in d.items():
        if k in _BASE or k in req:
            continue
        if k not in opt:
            errs.append(f"{ev}: unknown field {k!r} (schema is strict; "
                        "additions need a version bump)")
        elif not _is(val, opt[k]):
            errs.append(f"{ev}: field {k!r} has wrong type")
        elif k in v3_only and d["v"] in _VERSIONS and d["v"] < 3:
            errs.append(f"{ev}: field {k!r} requires schema version >= 3")
        elif k in v4_only and d["v"] in _VERSIONS and d["v"] < 4:
            errs.append(f"{ev}: field {k!r} requires schema version >= 4")
        elif k in v5_only and d["v"] in _VERSIONS and d["v"] < 5:
            errs.append(f"{ev}: field {k!r} requires schema version >= 5")
        elif k in v6_only and d["v"] in _VERSIONS and d["v"] < 6:
            errs.append(f"{ev}: field {k!r} requires schema version >= 6")
        elif k in v8_only and d["v"] in _VERSIONS and d["v"] < 8:
            errs.append(f"{ev}: field {k!r} requires schema version >= 8")
        elif k in v9_only and d["v"] in _VERSIONS and d["v"] < 9:
            errs.append(f"{ev}: field {k!r} requires schema version >= 9")
    return errs


# --------------------------------------------------------------------------
# progress schema


@dataclasses.dataclass
class ProgressRecord:
    """The shared ``segment`` payload — what every engine's ``on_progress``
    callback now receives (as a plain dict, via :meth:`to_dict`).

    ``inc_states_per_sec`` is the primary rate: states discovered since
    the previous record over wall time since the previous record.  It is
    immune to the resume-inflation wart (ddd campaigns resume with the
    prior process's ``n_states`` but a fresh wall clock).  The cumulative
    ``states_per_sec`` is kept for quick glances and tagged by
    ``since_resume``: True means the counters were accumulated entirely
    by this process and the cumulative rate is honest; False means they
    span prior processes and only the incremental rate is trustworthy.
    """

    wall_s: float
    n_states: int
    level: int
    n_transitions: int
    dedup_hit_rate: float
    states_per_sec: float
    inc_states_per_sec: float
    since_resume: bool
    coverage: dict | None = None      # per-action discovery counts
    route_peak: int | None = None     # ddd: peak per-bucket route occupancy
    n_devices: int | None = None      # shard engines: mesh size
    inv_evals: dict | None = None     # per-invariant evaluation counts
    phase_s: dict | None = None       # per-phase wall since last record
    device_rates: list | None = None  # fleet: per-device walker states/s
    bin: str | None = None            # serve: step-signature bin tag
    inflight: int | None = None       # serve: dispatches in flight
    flush_backlog: int | None = None  # ddd: background flushes pending
    upload_wait_ms: float | None = None  # ddd: cumulative upload wait
    prefetch_hits: int | None = None  # ddd: staged-buffer block uploads
    export_rows: int | None = None    # ddd: cumulative d2h export rows
    dev_dedup_hits: int | None = None  # ddd: device-set pre-export drops

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


class ProgressTracker:
    """Rate arithmetic shared by every engine.

    ``n0`` is the state count already present when this process started:
    1 for a fresh run, the checkpoint's count for a ddd resume, or None
    when the baseline is unknown until the first device fetch (table
    engines resuming a donated carry) — the first record then just
    anchors and reports a zero incremental rate rather than a fabricated
    one.

    ``record(n_incl=...)`` takes the *inclusive* count (states + pending
    keys awaiting host dedup) the ddd engines report; the anchor is
    ``max`` -monotone across checkpoint-rollback resumes so incremental
    rates never go negative.
    """

    def __init__(self, t0: float, n0: int | None = 1,
                 invariants: tuple = (), resumed: bool = False,
                 n_devices: int | None = None):
        self.t0 = t0
        self._prev_wall = 0.0
        self._prev_n = n0
        self.invariants = tuple(invariants)
        self.since_resume = not resumed
        self.n_devices = n_devices

    def anchor(self, n_states: int) -> None:
        """Set the incremental-rate baseline (a resume's restored count),
        so the first post-resume record's rate covers only new states."""
        self._prev_n = max(self._prev_n or 0, int(n_states))

    def record(self, n_states: int, level: int, n_transitions: int,
               coverage: dict | None = None, route_peak: int | None = None,
               n_incl: int | None = None,
               phase_s: dict | None = None,
               device_rates: list | None = None,
               bin: str | None = None,
               inflight: int | None = None,
               flush_backlog: int | None = None,
               upload_wait_ms: float | None = None,
               prefetch_hits: int | None = None,
               export_rows: int | None = None,
               dev_dedup_hits: int | None = None) -> ProgressRecord:
        wall = time.monotonic() - self.t0
        reported = n_states if n_incl is None else max(n_states, n_incl)
        if self._prev_n is None:  # unknown baseline: anchor, rate 0
            self._prev_n = reported
        dn = max(0, reported - self._prev_n)
        dt = wall - self._prev_wall
        inc = dn / dt if dt > 0 else 0.0
        self._prev_wall = wall
        self._prev_n = max(self._prev_n, reported)
        # Dedup hit rate uses the *exact* count: candidates generated vs
        # distinct states actually admitted.
        hit = 1.0 - n_states / max(1, n_transitions)
        inv_evals = ({nm: n_transitions for nm in self.invariants}
                     if self.invariants else None)
        return ProgressRecord(
            wall_s=round(wall, 3),
            n_states=reported,
            level=level,
            n_transitions=n_transitions,
            dedup_hit_rate=round(hit, 4),
            states_per_sec=round(reported / max(wall, 1e-9), 1),
            inc_states_per_sec=round(inc, 1),
            since_resume=self.since_resume,
            coverage=coverage,
            route_peak=route_peak,
            n_devices=self.n_devices,
            inv_evals=inv_evals,
            phase_s=phase_s or None,
            device_rates=device_rates,
            bin=bin,
            inflight=inflight,
            flush_backlog=flush_backlog,
            upload_wait_ms=upload_wait_ms,
            prefetch_hits=prefetch_hits,
            export_rows=export_rows,
            dev_dedup_hits=dev_dedup_hits,
        )


# --------------------------------------------------------------------------
# JSONL writer


_CLOSE = object()  # writer-thread sentinel


class EventLog:
    """Append-only JSONL event sink with a background writer thread.

    ``emit`` serialises on the caller (cheap: small dicts) and enqueues;
    file I/O happens on the daemon thread so a slow disk never stalls a
    segment boundary.  ``close`` drains the queue and joins.  The file is
    opened in append mode line-at-a-time-ish, so external one-shot
    emitters (``python -m raft_tla_tpu_torch.obs emit`` from campaign_stop.sh)
    can interleave whole lines with a live run.
    """

    def __init__(self, path: str):
        self.path = path
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._writer, name="obs-eventlog", daemon=True)
        self._closed = False
        self._thread.start()

    def emit(self, event: str, **fields) -> dict:
        d = {"v": SCHEMA_VERSION, "event": event,
             "ts": round(time.time(), 3), **fields}
        if not self._closed:
            self._q.put(json.dumps(d, sort_keys=False) + "\n")
        return d

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(_CLOSE)
        self._thread.join(timeout=10.0)

    def _writer(self) -> None:
        with open(self.path, "a") as fh:
            while True:
                item = self._q.get()
                if item is _CLOSE:
                    break
                lines = [item]
                try:  # batch whatever queued up behind it
                    while True:
                        nxt = self._q.get_nowait()
                        if nxt is _CLOSE:
                            fh.writelines(lines)
                            return
                        lines.append(nxt)
                except queue.Empty:
                    pass
                fh.writelines(lines)
                fh.flush()


def append_event(log_path: str, event: str, **fields) -> dict:
    """Synchronously validate + append one event (external emitters:
    the supervisor, the ``obs emit`` CLI).

    First parameter named ``log_path`` so ``checkpoint`` events can pass
    their ``path`` field as a keyword.
    """
    d = {"v": SCHEMA_VERSION, "event": event,
         "ts": round(time.time(), 3), **fields}
    errs = validate_event(d)
    if errs:
        raise ValueError(f"invalid {event!r} event: " + "; ".join(errs))
    with open(log_path, "a") as fh:
        fh.write(json.dumps(d) + "\n")
    return d


_GIT_SHA_CACHE: list = []


def git_sha() -> str | None:
    """Short commit sha of the checkout (best-effort, cached)."""
    if not _GIT_SHA_CACHE:
        try:
            out = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"],
                cwd=os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))),
                capture_output=True, text=True, timeout=5)
            sha = out.stdout.strip() if out.returncode == 0 else ""
            _GIT_SHA_CACHE.append(sha or None)
        except Exception:
            _GIT_SHA_CACHE.append(None)
    return _GIT_SHA_CACHE[0]


# --------------------------------------------------------------------------
# engine facade


class RunTelemetry:
    """What an engine's check loop drives instead of hand-rolled dicts.

    Resolution: an explicit ``events`` path wins, else ``RAFT_TLA_EVENTS``
    (the check.py wiring), else no log — and with neither a log
    nor an ``on_progress`` callback, :attr:`active` is False so engines
    skip the per-segment device fetches entirely (the pre-obs fast path).

    ``segment`` emits the shared record to both sinks and derives
    ``level_end`` events from observed level transitions; ``run_end``
    derives the ``violation`` event from the result.  ``close`` is
    idempotent and safe under exceptions — a log ending without
    ``run_end`` is the crash signature the monitor reports.
    """

    def __init__(self, engine: str, config=None, caps=None,
                 on_progress=None, events: str | None = None,
                 resumed: bool = False, n0: int | None = 1,
                 n_devices: int | None = None, t0: float | None = None):
        from raft_tla_tpu_torch.obs.phases import PhaseTimers
        from raft_tla_tpu_torch.obs.trace import (NULL_TRACER, SpanTracer,
                                                  trace_enabled)
        self.engine = engine
        self.config = config
        self.caps = caps
        self.on_progress = on_progress
        self.resumed = resumed
        path = events_path(events)
        self.log = EventLog(path) if path else None
        # Spans need a sink: tracing stays NULL (the off path) without a
        # log even when the gate is on, preserving `active`'s contract.
        self.trace = (SpanTracer(self.log.emit)
                      if self.log is not None and trace_enabled()
                      else NULL_TRACER)
        self.phases = PhaseTimers.from_env()
        self.phases.tracer = self.trace
        inv = tuple(config.invariants) if config is not None else ()
        self.tracker = ProgressTracker(
            t0 if t0 is not None else time.monotonic(),
            n0=n0, invariants=inv, resumed=resumed, n_devices=n_devices)
        self._n_devices = n_devices
        self._last_level: int | None = None
        self._ended = False

    @property
    def active(self) -> bool:
        """True when someone is listening (else skip the stats fetches)."""
        return self.on_progress is not None or self.log is not None

    # -- lifecycle events ---------------------------------------------------

    def run_start(self, n_states: int | None = None,
                  fiducials: dict | None = None) -> None:
        if n_states is not None:
            self.tracker.anchor(n_states)
        if self.log is None:
            return
        cfg = self.config
        fields: dict = {"engine": self.engine, "resumed": self.resumed}
        if cfg is not None:
            b = cfg.bounds
            fields["universe"] = {"servers": b.n_servers, "values": b.n_values}
            fields["bounds"] = {
                "max_term": b.max_term, "max_log": b.max_log,
                "max_msgs": b.max_msgs, "max_dup": b.max_dup,
                "history": b.history}
            fields["spec"] = cfg.spec
            fields["invariants"] = list(cfg.invariants)
            if cfg.symmetry:
                fields["symmetry"] = list(cfg.symmetry)
            if cfg.view is not None:
                fields["view"] = cfg.view
            fields["chunk"] = cfg.chunk
        else:
            fields["universe"] = {}
            fields["spec"] = ""
            fields["invariants"] = []
        if self.caps is not None:
            fields["caps"] = repr(self.caps)
        if n_states is not None:
            fields["n_states"] = int(n_states)
        if self._n_devices is not None:
            fields["n_devices"] = self._n_devices
        sha = git_sha()
        if sha:
            fields["git_sha"] = sha
        if fiducials:
            fields["fiducials"] = fiducials
        fields["pid"] = os.getpid()
        # The v8 clock anchor: always stamped (cheap, three clock reads)
        # so any log joins a merged trace timeline; host context rides
        # along only when tracing, where cross-host comparison matters.
        from raft_tla_tpu_torch.obs.trace import clock_anchor, host_context
        fields["anchor"] = clock_anchor()
        if self.trace.enabled:
            fields["host"] = host_context()
        self.log.emit("run_start", **fields)

    def segment(self, n_states: int, level: int, n_transitions: int,
                coverage: dict | None = None, route_peak: int | None = None,
                n_incl: int | None = None,
                device_rates: list | None = None,
                bin: str | None = None,
                inflight: int | None = None,
                flush_backlog: int | None = None,
                upload_wait_ms: float | None = None,
                prefetch_hits: int | None = None,
                export_rows: int | None = None,
                dev_dedup_hits: int | None = None) -> ProgressRecord:
        rec = self.tracker.record(
            n_states, level, n_transitions, coverage=coverage,
            route_peak=route_peak, n_incl=n_incl,
            phase_s=self.phases.snapshot(),
            device_rates=device_rates,
            bin=bin, inflight=inflight,
            flush_backlog=flush_backlog,
            upload_wait_ms=upload_wait_ms,
            prefetch_hits=prefetch_hits,
            export_rows=export_rows,
            dev_dedup_hits=dev_dedup_hits)
        if self.log is not None:
            if self._last_level is not None and level > self._last_level:
                # The boundary count is the count as observed at the first
                # segment of the new level (exact for engines that call
                # segment() at each boundary, best-known otherwise).
                self.log.emit("level_end", level=level - 1,
                              n_states=rec.n_states)
            self.log.emit("segment", **rec.to_dict())
        self._last_level = level
        if self.on_progress is not None:
            self.on_progress(rec.to_dict())
        return rec

    def checkpoint(self, path: str, n_states: int | None = None) -> None:
        if self.log is None:
            return
        extra = {} if n_states is None else {"n_states": int(n_states)}
        self.log.emit("checkpoint", path=str(path), **extra)

    def stop_requested(self, reason: str, source: str = "engine") -> None:
        if self.log is None:
            return
        self.log.emit("stop_requested", reason=reason, source=source,
                      pid=os.getpid())

    def violation(self, invariant: str, kind: str = "invariant") -> None:
        if self.log is None:
            return
        self.log.emit("violation", invariant=invariant, kind=kind)

    def run_end(self, result) -> None:
        if self.log is None or self._ended:
            return
        self._ended = True
        outcome = "ok" if result.complete else "stopped"
        if result.violation is not None:
            inv = result.violation.invariant
            kind = "deadlock" if inv == _DEADLOCK_NAME else "invariant"
            self.violation(inv, kind=kind)
            outcome = "violation"
        self.log.emit(
            "run_end", n_states=int(result.n_states),
            n_transitions=int(result.n_transitions),
            complete=bool(result.complete), outcome=outcome,
            diameter=int(result.diameter), levels=list(result.levels),
            wall_s=round(float(result.wall_s), 3))

    def run_end_sim(self, *, n_states: int, n_behaviors: int,
                    max_depth: int, wall_s: float, complete: bool,
                    violation=None, sim: dict | None = None) -> None:
        """``run_end`` for statistical (simulation) runs: honest per-field
        semantics instead of shoehorning walker counters into the
        exhaustive-result shape.  ``n_transitions`` is the sampled
        transition count (== states generated along walks), ``diameter``
        the deepest walk observed, and the v3 ``sim`` dict carries the
        confidence summary (behaviors, per-invariant states-checked,
        coverage entropy, fleet geometry).
        """
        if self.log is None or self._ended:
            return
        self._ended = True
        outcome = "ok" if complete else "stopped"
        if violation is not None:
            inv = violation.invariant
            kind = "deadlock" if inv == _DEADLOCK_NAME else "invariant"
            self.violation(inv, kind=kind)
            outcome = "violation"
        fields = dict(
            n_states=int(n_states), n_transitions=int(n_states),
            complete=bool(complete), outcome=outcome,
            diameter=int(max_depth), levels=[],
            wall_s=round(float(wall_s), 3))
        if sim is not None:
            fields["sim"] = dict(sim, behaviors=int(n_behaviors))
        self.log.emit("run_end", **fields)

    def close(self) -> None:
        if self.log is not None:
            self.log.close()
