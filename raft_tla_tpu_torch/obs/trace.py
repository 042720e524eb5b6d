"""Cross-process trace spans — the schema-v8 profiling layer; the port's
copy of ``raft_tla_tpu/obs/trace.py``.

The obs event logs (events.py) record *what happened* per process; this
module records *where the wall went*: nested, thread-attributed spans
emitted as schema-v8 ``span`` events through the same JSONL sinks, so a
supervised pool run (supervisor + N serve children + per-process
background threads) collects into one merged timeline (obs/collect.py)
that Perfetto can render (obs/perfetto.py) and ``raft-tla-trace report``
can attribute.

Design points, in the order they matter:

- **Off by default, off path unmeasurable.**  Tracing is gated by
  ``--trace`` / ``RAFT_TLA_TRACE``.  Disabled, every instrumentation
  site touches :data:`NULL_TRACER`, whose ``span()`` returns one shared
  stateless handle — no allocation, no clock read, nothing enqueued —
  the same discipline as ``PhaseTimers``'s null handle.
- **Monotonic timestamps + a wall anchor.**  Span ``t0`` is
  ``time.monotonic()`` in the emitting process (immune to NTP steps
  mid-run); each process stamps one wall/monotonic :func:`clock_anchor`
  pair into its ``run_start`` so the collector can place every process's
  spans on one wall-clock axis, with the alignment error bounded by the
  recorded ``err_s`` (the width of the anchor's wall read).
- **Thread-aware context.**  Every span records the emitting thread's
  name, and parenthood nests per thread via a thread-local stack — a
  flush running on ``raft-tla-flush`` is attributed to that track, never
  folded into the main thread's phase.  :meth:`SpanTracer.emit_span` additionally places *manual*
  spans on synthetic tracks (``thread="tickets"``/``"workers"``) for
  lifetimes that start and end in different stack frames (dispatch
  tickets, pool worker lifetimes).
- **One sink, no new I/O machinery.**  Spans ride the existing
  non-blocking ``EventLog`` (engines: ``tracer = SpanTracer(log.emit)``)
  or the synchronous validated ``append_event`` (supervisors, low rate),
  so `tel.active`'s no-listener fast path and the crash-attribution
  contract (log without ``run_end`` = death) are untouched.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

ENV_TRACE = "RAFT_TLA_TRACE"


def trace_enabled(env: str | None = None) -> bool:
    """The ``--trace`` / ``RAFT_TLA_TRACE`` gate (default: off)."""
    v = (env if env is not None
         else os.environ.get(ENV_TRACE, "")).strip().lower()
    return v in ("1", "on", "true", "yes")


def clock_anchor() -> dict:
    """One wall/monotonic pair: ``wall`` was read between two monotonic
    reads whose spread is ``err_s`` — the bound on how precisely this
    process's monotonic span timestamps can be placed on the wall axis
    (plus whatever NTP skew separates the hosts, which no process can
    observe alone)."""
    m1 = time.monotonic()
    wall = time.time()
    m2 = time.monotonic()
    return {"wall": round(wall, 6), "mono": round((m1 + m2) / 2.0, 6),
            "err_s": round(m2 - m1, 6)}


def host_context() -> dict:
    """Best-effort host identity for cross-session trace comparison:
    nproc always; the torch and CUDA versions, and the card's name when
    a card is visible, only if torch is already imported (never force
    the import — obs stays light)."""
    import sys
    ctx: dict = {"nproc": os.cpu_count() or 1}
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            ctx["torch"] = str(torch.__version__)
            ctx["cuda"] = str(torch.version.cuda)
            if torch.cuda.is_available():
                ctx["device"] = torch.cuda.get_device_name(0)
        except Exception:
            pass
    return ctx


class _NullSpan:
    """The disabled-path handle: a shared singleton that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method is a no-op returning the shared
    null span, so instrumentation sites need no ``if`` guards."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, **args):
        return _NULL_SPAN

    def emit_span(self, name: str, t0: float, dur: float,
                  thread: str | None = None, **args) -> None:
        pass

    def current_id(self):
        return None


NULL_TRACER = NullTracer()


class _Span:
    """An open traced region; emitted as one ``span`` event at exit."""

    __slots__ = ("_tr", "_name", "_args", "_id", "_parent", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tr = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        tr = self._tr
        stack = tr._stack()
        self._parent = stack[-1] if stack else None
        self._id = next(tr._ids)
        stack.append(self._id)
        self._t0 = time.monotonic()
        return self

    def set(self, **args):
        """Attach result attributes discovered inside the region (row
        counts, hit/miss) — lands in the event's ``args`` dict."""
        self._args.update(args)
        return self

    def __exit__(self, *exc):
        dur = time.monotonic() - self._t0
        stack = self._tr._stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        fields = {"name": self._name, "span_id": self._id,
                  "t0": round(self._t0, 6), "dur": round(dur, 6),
                  "thread": threading.current_thread().name}
        if self._parent is not None:
            fields["parent_id"] = self._parent
        if self._args:
            fields["args"] = self._args
        self._tr._emit("span", **fields)
        return False


class SpanTracer:
    """Emit nested, thread-attributed ``span`` events through ``emit``.

    ``emit`` is any ``(event_type, **fields) -> ...`` callable — an
    ``EventLog.emit`` bound method (non-blocking; engines) or a
    ``functools.partial(append_event, path)`` (synchronous + validated;
    supervisors).  Span ids are unique per tracer; parenthood nests via
    a per-thread stack, so concurrent threads trace independently.
    """

    enabled = True

    def __init__(self, emit):
        self._emit = emit
        self._ids = itertools.count(1)   # CPython-atomic __next__
        self._tls = threading.local()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, **args) -> _Span:
        """Context manager for a region on the current thread."""
        return _Span(self, name, args)

    def emit_span(self, name: str, t0: float, dur: float,
                  thread: str | None = None, **args) -> None:
        """Manual span for lifetimes that open and close in different
        stack frames (dispatch tickets, worker lifetimes).  ``thread``
        names the track — pass a synthetic one (``"tickets"``) when the
        span overlaps the emitting thread's nested spans, so renderers
        that require proper nesting per track stay happy."""
        fields = {"name": name, "span_id": next(self._ids),
                  "t0": round(t0, 6), "dur": round(max(0.0, dur), 6),
                  "thread": thread or threading.current_thread().name}
        if args:
            fields["args"] = args
        self._emit("span", **fields)

    def current_id(self):
        """Id of the innermost open span on this thread (or None)."""
        st = self._stack()
        return st[-1] if st else None


def tracer_for(log_path: str) -> SpanTracer:
    """A tracer whose spans append synchronously (validated) to
    ``log_path`` — the supervisor-side sink (low event rate)."""
    import functools

    from raft_tla_tpu_torch.obs.events import append_event
    return SpanTracer(functools.partial(append_event, log_path))


def anchored_run_start(log_path: str, engine: str) -> dict:
    """Append the minimal ``run_start`` that makes a supervisor-side log
    (pool.events / supervisor.events / sched-*.events) alignable: the
    clock anchor, host context and pid.  Engine logs get theirs through
    ``RunTelemetry.run_start`` instead."""
    from raft_tla_tpu_torch.obs.events import append_event
    return append_event(log_path, "run_start", engine=engine,
                        universe={}, spec="", invariants=[],
                        resumed=False, pid=os.getpid(),
                        anchor=clock_anchor(), host=host_context())
