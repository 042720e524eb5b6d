"""Double-buffered upload prefetch for the DDD engine — the port of
``raft_tla_tpu/utils/prefetch.py``.

At each block boundary the engine must read the next block's rows and
constraint column from the host store (a DISK read in frontier
retention), pad them, and copy them to the card.  `BlockPrefetcher` moves
that chain onto one daemon thread: while the card expands block k, the
worker reads block k+1 (its address is known from ``level_ends`` the
moment the level starts) into one of two pinned host buffers and starts
its copy to the card with ``non_blocking=True`` on a side CUDA stream,
which records an event.  At the boundary the engine makes its compute
stream wait on that event — the card waits, not the host (the engine's
loader, ``ddd_engine.DDDEngine._check_impl``).

Why this is safe (the byte-identity argument):

- **Disjointness.** Within a level, every block read targets rows in
  ``[lvl_lo, lvl_hi)`` — fully published before the level began (the
  level boundary drains the flush worker before ``level_ends`` grows).
  Concurrent flush appends only ever land at ``>= lvl_hi``.  The host
  stores guarantee one-appender + disjoint-range-reader safety
  (``utils/native``: atomic block directory with release-published
  size in C++, snapshot reads in the NumPy twin, positionless ``preadv``
  in `FileStore`), so the prefetch read and the in-flight flush never
  touch the same rows and the upload can drop its unconditional
  ``dedup_wait`` drain.
- **Depth-1, strict protocol.** At most one prefetch is in flight; the
  engine calls ``take(start, rows)`` then ``schedule(next)``, and a
  ``take`` whose range does not match the staged result falls back to
  a synchronous load (a *miss*) — so the values uploaded are the same
  bytes the synchronous path would have read, hit or miss.
- **Invalidation.** Stop events (violation / SIGINT / deadline) and
  level boundaries call ``invalidate()``, which discards staged and
  in-flight work and returns only once the worker is quiescent — no
  in-flight store read survives into a frontier rotation or teardown,
  and the refbfs-exact stop point is untouched.

Worker exceptions are captured and re-raised on the main thread at the
next ``schedule``/``take`` (the `flushq.DedupWorker` pattern);
``invalidate``/``close`` never raise, so stop paths cannot be masked.

Gated by ``RAFT_TLA_PREFETCH`` / ``check.py --prefetch``; the ``off``
arm never constructs a prefetcher.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

ENV_PREFETCH = "RAFT_TLA_PREFETCH"


def prefetch_enabled(env: str | None = None) -> bool:
    """Resolve the upload-prefetch gate (``RAFT_TLA_PREFETCH``).

    ``on`` / ``off`` force; anything else is ``auto``: enabled iff the
    host has a second core to run the prefetch thread on (the
    reference's policy, ``runs/prefetch_ab.py``: a time-sliced worker
    that has not finished by the boundary costs more than the inline
    chain), as ``keyset.host_dedup_enabled``.
    """
    v = (env if env is not None else os.environ.get(ENV_PREFETCH, "auto"))
    v = v.strip().lower()
    if v == "on":
        return True
    if v == "off":
        return False
    return (os.cpu_count() or 1) >= 2


class BlockPrefetcher:
    """Stage block reads on a background thread, depth-1, double-buffered.

    ``loader(start, rows, slot) -> Any`` is engine-supplied: it reads
    the stores into the slot-indexed preallocated buffers and returns
    what the engine uploads (on the card: device tensors and the event
    their copy records).
    The loader runs on the worker thread on hits and on the caller's
    thread on misses — it must be safe for either, which the store
    concurrency contract (module docstring) provides.
    """

    def __init__(self, loader: Callable[[int, int, int], Any], *,
                 slots: int = 2, name: str = "raft-tla-prefetch",
                 phases=None, tracer=None):
        self._loader = loader
        self._phases = phases               # PhaseTimers | None: the
        # worker-side stage accrues a prefetch@<thread> bucket (and a
        # span) so background reads are attributed, not invisible
        self._tracer = tracer               # SpanTracer | None: take()
        # emits a hit/miss-tagged span nested under the engine's upload
        self._slots = int(slots)
        self._next_slot = 0
        self._gen = 0                       # bumped by invalidate()
        self._cv = threading.Condition()
        self._req: tuple | None = None      # (gen, start, rows, slot)
        self._ready: tuple | None = None    # (gen, start, rows, result)
        self._busy = False
        self._exc: BaseException | None = None
        self._closed = False
        self.hits = 0
        self.misses = 0
        self.wait_s = 0.0                   # main-thread wall in take()
        self._t = threading.Thread(target=self._run, name=name,
                                   daemon=True)
        self._t.start()

    # -- worker thread ----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._req is None and not self._closed:
                    self._cv.wait()
                if self._req is None:       # closed and idle
                    return
                gen, start, rows, slot = self._req
                self._req = None
                self._busy = True
            try:
                if self._phases is not None:
                    with self._phases.phase("prefetch"):
                        res, err = self._loader(start, rows, slot), None
                else:
                    res, err = self._loader(start, rows, slot), None
            except BaseException as e:      # noqa: BLE001 — re-raised on main
                res, err = None, e
            with self._cv:
                self._busy = False
                if err is not None:
                    self._exc = self._exc or err
                elif gen == self._gen:      # stale results are dropped
                    self._ready = (gen, start, rows, res)
                self._cv.notify_all()

    def _reraise_locked(self) -> None:
        exc, self._exc = self._exc, None
        if exc is not None:
            raise RuntimeError("background upload prefetch failed") from exc

    # -- main thread ------------------------------------------------------

    def schedule(self, start: int, rows: int) -> None:
        """Non-blocking: stage ``[start, start + rows)`` in the
        background into the next slot."""
        with self._cv:
            self._reraise_locked()
            if self._closed:
                raise RuntimeError("BlockPrefetcher is closed")
            slot = self._next_slot
            self._next_slot = (slot + 1) % self._slots
            self._ready = None              # depth-1: one staged result
            self._req = (self._gen, start, rows, slot)
            self._cv.notify_all()

    def take(self, start: int, rows: int) -> Any:
        """Return staged data for ``[start, start + rows)``; waits for a
        matching in-flight stage (hit), else loads synchronously on the
        calling thread (miss).  Either way the worker is quiescent when
        this returns."""
        tr = self._tracer
        if tr is not None and tr.enabled:
            with tr.span("take", start=int(start), rows=int(rows)) as sp:
                res, hit = self._take(start, rows)
                sp.set(hit=hit)
                return res
        return self._take(start, rows)[0]

    def _take(self, start: int, rows: int) -> tuple:
        t0 = time.perf_counter()
        with self._cv:
            self._reraise_locked()
            while self._busy or self._req is not None:
                self._cv.wait()
            self._reraise_locked()
            r = self._ready
            self._ready = None
            if r is not None and r[0] == self._gen \
                    and (r[1], r[2]) == (start, rows):
                self.hits += 1
                self.wait_s += time.perf_counter() - t0
                return r[3], True
            slot = self._next_slot
            self._next_slot = (slot + 1) % self._slots
        self.misses += 1
        res = self._loader(start, rows, slot)
        self.wait_s += time.perf_counter() - t0
        return res, False

    def invalidate(self) -> None:
        """Discard staged and pending work; block until the worker is
        quiescent.  No in-flight store read survives this call.  Never
        raises (stop paths call it); worker errors surface at the next
        ``schedule``/``take``."""
        with self._cv:
            self._gen += 1
            self._req = None
            self._ready = None
            while self._busy:
                self._cv.wait()

    def close(self) -> None:
        """Invalidate, stop and join the worker thread (idempotent)."""
        if self._closed:
            return
        with self._cv:
            self._gen += 1
            self._req = None
            self._ready = None
            self._closed = True
            self._cv.notify_all()
        self._t.join(timeout=60.0)
