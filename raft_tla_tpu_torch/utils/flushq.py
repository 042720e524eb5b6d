"""Depth-1 ordered background flush worker for the DDD engine — the
port's copy of ``raft_tla_tpu/utils/flushq.py``.

`DedupWorker` moves the exact-dedup flush (`DDDEngine._flush`) onto one
daemon thread with **depth-1 ordered** submission: `submit(batch_i)`
blocks until flush i-1 has fully completed, so flushes execute strictly
in submission order and at most one sealed batch is ever in flight.
Cross-flush first-occurrence order (the whole exactness argument of
ddd_engine.py) is therefore untouched: flush i's new keys are in the
master tiers before flush i+1's dedup begins, exactly as in the
synchronous engine.

The engine's drain discipline (ddd_engine.py): every reader of state the
flush mutates — checkpoint save, level boundaries, `_IDX_CEIL` checks,
violation identity, lossless SIGINT/deadline stops — calls `drain()`
first, so all byte-identity and lossless-stop arguments reduce to the
synchronous case.  The block upload drains too when the prefetch gate is
off; with ``RAFT_TLA_PREFETCH`` on it instead relies on the stores'
one-appender + disjoint-range-reader contract (utils/native,
utils/prefetch) — uploads read only rows published before the level
began, while an in-flight flush appends strictly past them.

Worker exceptions are captured and re-raised on the main thread at the
next `submit`/`collect`/`drain`, so a flush failure cannot be silently
swallowed.  Gated by ``RAFT_TLA_HOSTDEDUP`` (utils/keyset.py); the
``off`` arm never constructs a worker.  ``phases`` (a ``PhaseTimers``;
duck-typed, may be None) times each flush: it accrues a
``dedup@raft-tla-flush`` bucket and, with tracing on, a v8 ``dedup`` span
on the flush thread's own track, beside the main thread's
``dedup_submit``/``dedup_wait``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable


class DedupWorker:
    """Run ``fn(batch) -> n_new`` on a background thread, one batch at a
    time, in submission order."""

    def __init__(self, fn: Callable[[Any], int], *,
                 name: str = "raft-tla-flush", phases=None):
        self._fn = fn
        self._phases = phases                 # PhaseTimers | None
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._slot = threading.Semaphore(1)   # depth-1 backpressure
        self._lock = threading.Lock()
        self._done_new = 0                    # flushed, not yet collected
        self._inflight_keys = 0               # raw keys of pending batch
        self._exc: BaseException | None = None
        self._closed = False
        self._t = threading.Thread(target=self._run, name=name, daemon=True)
        self._t.start()

    # -- worker thread -------------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch, _n_keys = item
            try:
                if self._phases is not None:
                    with self._phases.phase("dedup"):
                        n_new = int(self._fn(batch))
                else:
                    n_new = int(self._fn(batch))
                with self._lock:
                    self._done_new += n_new
            except BaseException as e:        # noqa: BLE001 — re-raised on main
                with self._lock:
                    self._exc = e
            finally:
                with self._lock:
                    self._inflight_keys = 0
                self._slot.release()

    def _reraise(self) -> None:
        with self._lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise RuntimeError("background dedup flush failed") from exc

    # -- main thread ---------------------------------------------------------

    def submit(self, batch: Any, n_keys: int) -> None:
        """Enqueue a sealed batch.  Blocks until the previous flush has
        completed (ordered, depth-1), so the harvest loop overlaps at
        most one flush with device compute."""
        if self._closed:
            raise RuntimeError("DedupWorker is closed")
        self._slot.acquire()
        try:
            self._reraise()
        except BaseException:
            self._slot.release()              # keep drain() unblocked
            raise
        with self._lock:
            self._inflight_keys = int(n_keys)
        self._q.put((batch, n_keys))

    def collect(self) -> int:
        """Non-blocking: take (and reset) the new-state count of every
        flush completed since the last collect/drain."""
        self._reraise()
        with self._lock:
            n, self._done_new = self._done_new, 0
        return n

    def drain(self) -> int:
        """Block until the in-flight flush (if any) completes; return
        the uncollected new-state count.  After this returns, the master
        set, stores and coverage reflect every submitted batch."""
        self._slot.acquire()
        self._slot.release()
        return self.collect()

    def backlog(self) -> int:
        """1 if a flush is pending/in flight, else 0 (obs flush_backlog)."""
        with self._lock:
            return 1 if self._inflight_keys else 0

    def inclusive_extra(self) -> int:
        """Completed-but-uncollected new states plus raw in-flight keys,
        for the progress n_incl upper bound (telemetry only)."""
        with self._lock:
            return self._done_new + self._inflight_keys

    def close(self) -> None:
        """Drain, stop and join the worker thread (idempotent).  Any
        uncollected count is discarded — callers drain first."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._t.join(timeout=60.0)
