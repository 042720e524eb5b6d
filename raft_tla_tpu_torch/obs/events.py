"""Progress records — the port's copy of the progress part of
``raft_tla_tpu/obs/events.py``.

:class:`ProgressRecord` is the reference's, field for field: the payload
every engine's ``on_progress`` callback receives (``--stats`` prints it,
one JSON line per segment); :class:`ProgressTracker` is its rate
arithmetic.
:class:`RunTelemetry` keeps only the progress part of the reference's
facade, ``segment``; the run-event log (``--events``), its schema checks
and the phase timers are not ported (ROADMAP.md queue A 4), so a record's
``phase_s`` is always absent.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class ProgressRecord:
    """The shared ``segment`` payload — what every engine's ``on_progress``
    callback receives (as a plain dict, via :meth:`to_dict`).

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
    """Rate arithmetic shared by every engine (the reference's).

    ``n0`` is the state count already present when this process started:
    the count at Init or at a resumed snapshot, or None when the baseline
    is unknown until the first device fetch (a resumed device-engine
    carry) — the first record then just anchors and reports a zero
    incremental rate rather than a fabricated one.

    ``record(n_incl=...)`` takes the *inclusive* count (states + pending
    keys awaiting host dedup) the ddd engine reports; the anchor is
    ``max`` -monotone so incremental rates never go negative.
    """

    def __init__(self, t0: float, n0: int | None = 1,
                 invariants: tuple = (), resumed: bool = False):
        self.t0 = t0
        self._prev_wall = 0.0
        self._prev_n = n0
        self.invariants = tuple(invariants)
        self.since_resume = not resumed

    def record(self, n_states: int, level: int, n_transitions: int,
               n_incl: int | None = None, **fields) -> ProgressRecord:
        """One record; ``fields`` are the optional fields of
        :class:`ProgressRecord` the engine has (None: absent)."""
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
            inv_evals=inv_evals,
            **fields)


class RunTelemetry:
    """The progress part of the reference's facade: ``segment`` builds the
    shared record and hands it to ``on_progress`` as a dict.
    :attr:`active` is False without a callback, so engines skip their
    per-segment stats fetches."""

    def __init__(self, config, on_progress, t0: float,
                 resumed: bool = False, n0: int | None = 1):
        self.on_progress = on_progress
        self.tracker = ProgressTracker(t0, n0=n0,
                                       invariants=tuple(config.invariants),
                                       resumed=resumed)

    @property
    def active(self) -> bool:
        return self.on_progress is not None

    def segment(self, n_states: int, level: int, n_transitions: int,
                **kw) -> ProgressRecord:
        """One record; ``kw`` are :meth:`ProgressTracker.record`'s
        optional arguments."""
        rec = self.tracker.record(n_states, level, n_transitions, **kw)
        if self.on_progress is not None:
            self.on_progress(rec.to_dict())
        return rec
