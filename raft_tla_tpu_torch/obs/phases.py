"""Device-sync-aware phase timers — the port's copy of
``raft_tla_tpu/obs/phases.py``.

Timing an asynchronous CUDA program phase by phase needs a wait at each
phase edge, which *serialises* the very pipelining the engines rely on
(the DDD engine dispatches segment k+1 before harvesting segment k).  So
the timers are **off by default** and the off path is engineered to be
unmeasurable:

- ``phase(name)`` returns one shared, stateless no-op handle when
  disabled — no allocation, no clock read, no sync.
- enabled (``--phase-timers`` / ``RAFT_TLA_PHASE_TIMERS=1``), each
  ``with timers.phase("expand") as ph: ... ph.sync(out)`` waits for the
  value handed to ``sync`` before stamping, so the phase wall is honest
  device time, not dispatch time.  Enabling timers trades pipelining for
  attribution — per-phase numbers are for anatomy runs, not records.

**What ``sync`` waits for.**  The reference blocks with
``jax.block_until_ready``.  Here ``ph.sync(x)`` records a CUDA event on
the stream that produced ``x`` — the current stream when ``sync`` is
called — and the phase's exit synchronizes on that event alone; ``x``
may also be a ``torch.cuda.Event`` the producer recorded on its own
stream (the DDD export's copy stream), which is then waited for as is.
Never ``torch.cuda.synchronize()``: that would also time the other
segment in flight.  CPU tensors, numpy arrays and ``None`` need no wait.

Accumulated walls are drained into each ``segment`` event's ``phase_s``
field by :meth:`PhaseTimers.snapshot`.

Phase vocabulary (shared so logs compare across engines): ``upload``
(host->device frontier/block staging), ``expand`` (the K1 segment),
``export`` (device->host harvest / pageout), ``dedup`` (host-side exact
dedup flush run inline, ddd only), ``snapshot`` (checkpoint save).
With background host dedup (``RAFT_TLA_HOSTDEDUP``) the ddd engine
splits ``dedup`` into ``dedup_submit`` (sealing + handing the batch to
the depth-1 worker — blocks only while the *previous* flush is still
running, so a nonzero wall here means the device outran the host dedup)
and ``dedup_wait`` (drain at a block/checkpoint/level/stop boundary —
the part of the flush that did NOT overlap device compute), so the
overlap is attributable, not inferred.  With upload prefetch
(``RAFT_TLA_PREFETCH``) the per-block ``dedup_wait`` drain disappears
entirely — block reads rely on the stores' disjoint-range concurrency
contract instead — so ``dedup_wait`` fires only at
checkpoint/level/stop drains (the on/off asymmetry is the gate's
phase-timer signature), and ``upload`` becomes the wait for an
already-staged buffer (a prefetch *hit* costs a swap; a *miss* pays
the old read+pad+h2d inline).  With the device dedup set
(``--device-dedup``) ``devdedup`` times its filter of each segment
before the export.

**Thread attribution** (schema v8): phases recorded on a thread other
than the one that built the ``PhaseTimers`` accumulate under
``{name}@{thread-name}`` — a background flush shows up as
``dedup@raft-tla-flush``, never silently folded into (or racing with)
the main thread's bucket.  Accumulation is lock-protected so background
workers (flushq, prefetch) can time their own work.

**Span integration**: when a :class:`~raft_tla_tpu_torch.obs.trace.SpanTracer`
is attached (``timers.tracer``, wired by ``RunTelemetry``), every
enabled phase handle also emits one v8 ``span`` event at exit — the same
named region lands in both the per-segment ``phase_s`` aggregate and the
merged trace timeline.  With tracing on but timers off the handle skips
``sync`` (no event, no wait), so spans record honest *host-side*
walls — dispatch time, not device time — and the engine pipelining the
timers would serialise stays intact.

This module imports nothing of torch: a handle only touches it when it
is handed a tensor or an event.
"""

from __future__ import annotations

import os
import sys
import threading
import time

ENV_PHASE_TIMERS = "RAFT_TLA_PHASE_TIMERS"


class _NullPhase:
    """The disabled-path handle: a shared singleton that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def sync(self, value=None):
        return value


_NULL = _NullPhase()


def _cuda_tensors(value):
    """The CUDA tensors in ``value`` (a tensor, or nested tuples, lists and
    dicts of them)."""
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _cuda_tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _cuda_tensors(v)
    elif getattr(value, "is_cuda", False):
        yield value


def _mark(value):
    """What a phase's exit waits for: ``value`` itself when it is a CUDA
    event, else an event recorded now on the current stream of the device
    holding ``value``'s CUDA tensors (None when there are none)."""
    torch = sys.modules.get("torch")
    if torch is None or value is None:
        return None
    if isinstance(value, torch.cuda.Event):
        return value
    t = next(_cuda_tensors(value), None)
    if t is None:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


class _Phase:
    """An enabled timed region; ``sync(x)`` marks x to block on at exit."""

    __slots__ = ("_timers", "_name", "_t0", "_pending", "_span")

    def __init__(self, timers: "PhaseTimers", name: str):
        self._timers = timers
        self._name = name
        self._pending = None
        self._span = None

    def __enter__(self):
        tr = self._timers.tracer
        if tr is not None and tr.enabled:
            self._span = tr.span(self._name).__enter__()
        self._t0 = time.monotonic()
        return self

    def sync(self, value=None):
        if self._timers.enabled:
            self._pending = _mark(value)
        return value

    def __exit__(self, *exc):
        timers = self._timers
        if self._pending is not None:
            self._pending.synchronize()
        self._pending = None
        if timers.enabled:
            dur = time.monotonic() - self._t0
            name = self._name
            if threading.get_ident() != timers._owner:
                # Explicit background-thread attribution: never race
                # with (or masquerade as) the owning thread's bucket.
                name = f"{name}@{threading.current_thread().name}"
            with timers._lock:
                acc = timers._acc
                acc[name] = acc.get(name, 0.0) + dur
        if self._span is not None:
            # Close after the sync so a timed phase's span covers the
            # same (device-honest) wall the phase_s bucket records.
            self._span.__exit__()
        return False


class PhaseTimers:
    """Per-phase wall-time accumulator; disabled unless asked for.

    ``tracer`` (attached by ``RunTelemetry``) piggybacks v8 trace spans
    on the same phase sites: the handle is live when *either* layer is
    on, but syncs (and accumulates) only when the timers are.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.tracer = None               # SpanTracer | None (NULL ok)
        self._acc: dict = {}
        self._lock = threading.Lock()
        self._owner = threading.get_ident()

    @classmethod
    def from_env(cls) -> "PhaseTimers":
        return cls(os.environ.get(ENV_PHASE_TIMERS, "").lower()
                   in ("1", "on", "true", "yes"))

    def phase(self, name: str):
        if not self.enabled:
            tr = self.tracer
            if tr is None or not tr.enabled:
                return _NULL
        return _Phase(self, name)

    def snapshot(self, reset: bool = True) -> dict:
        """Drain accumulated per-phase walls (rounded; {} when disabled)."""
        with self._lock:
            if not self._acc:
                return {}
            out = {k: round(v, 4) for k, v in sorted(self._acc.items())}
            if reset:
                self._acc = {}
        return out
