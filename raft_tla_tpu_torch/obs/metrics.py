"""Live metrics layer: streaming reducers over the v-schema event logs;
the port's copy of ``raft_tla_tpu/obs/metrics.py``.

The repo's acceptance bar for serving (ROADMAP item 7) is *bounded
per-tenant p99 admission-to-result latency* — a percentile, which
nothing in the per-run monitor or the post-hoc trace pipeline computes.
This module closes that gap without touching the engines: everything
here is a **reader** of the event logs the engines already write, so
the check loop's off-path cost is exactly what it was (the
``tel.active`` discipline; A/B'd by ``runs/obs_overhead_ab.py``'s
``events+metrics`` arm).

Three pieces:

- :class:`LogHistogram` — a mergeable log-bucketed histogram (base
  ``2**(1/4)``): bucket ``i`` holds values in ``[g**i, g**(i+1))``, so
  any quantile is answerable from counts alone with relative error
  bounded by ``sqrt(g) - 1`` (~9%), and merging two histograms is
  bucket-count addition — exactly associative, so per-process
  histograms roll up into fleet histograms with no resampling.
- :class:`MetricsRegistry` — a lock-guarded bag of counters, gauges and
  histograms keyed by (name, sorted label pairs), with a flat
  Prometheus-style ``snapshot()`` used both by the OpenMetrics endpoint
  (obs/openmetrics.py) and by the replayable schema-v10
  ``metrics_snapshot`` event.
- :class:`MetricsAggregator` — the streaming reducer: sweeps a
  directory with :func:`obs.collect.find_logs`, tails every log with
  the byte-offset :class:`obs.collect.LogTail` (each ``poll`` reads
  only new bytes), and folds events into the registry —
  ``inc_states_per_sec`` / ``flush_backlog`` / ``upload_wait_ms`` /
  dedup hit rates / per-bin inflight gauges, pool lifecycle counters,
  and the per-tenant admission(``run_start``)→terminal(``run_end``)
  latency histogram behind the p50/p95/p99 summaries.

Gate: ``--metrics-port`` / ``RAFT_TLA_METRICS`` (resolved once, in
:func:`metrics_port`).  Off means none of this is even constructed.
"""

from __future__ import annotations

import math
import os
import threading

from raft_tla_tpu_torch.obs.collect import LogTail, find_logs

ENV_METRICS = "RAFT_TLA_METRICS"

# Bucket base: 2**(1/4).  Quantiles read from geometric bucket midpoints
# are within sqrt(g) - 1 ~ 9.05% of the exact sample quantile.
_GAMMA = 2.0 ** 0.25
_LOG_GAMMA = math.log(_GAMMA)


def metrics_port(explicit: int | None = None) -> int | None:
    """The one resolution point for the METRICS gate: an explicit port
    wins (0 = bind an ephemeral port), else ``RAFT_TLA_METRICS`` parsed
    as a port number, else None (metrics off).  Every consumer (serve,
    campaign) goes through here so the precedence can never fork."""
    if explicit is not None:
        return explicit
    raw = os.environ.get(ENV_METRICS)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


# --------------------------------------------------------------------------
# mergeable log-bucketed histogram


class LogHistogram:
    """Counts per geometric bucket ``i = floor(log(v) / log(g))``.

    Non-positive observations clamp into the smallest representable
    bucket (latencies of identical timestamps round to 0.0); the exact
    running min/max clamp quantile answers so the edges are exact, and
    a one-sample histogram answers every quantile exactly.
    """

    __slots__ = ("counts", "n", "total", "vmin", "vmax")

    def __init__(self):
        self.counts: dict = {}
        self.n = 0
        self.total = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None

    def add(self, value: float) -> None:
        v = float(value)
        self.n += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        idx = (int(math.floor(math.log(v) / _LOG_GAMMA))
               if v > 0.0 else -4096)
        self.counts[idx] = self.counts.get(idx, 0) + 1

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Bucket-count addition — exactly associative and commutative
        (dict-sum), so fleet roll-ups are order-independent."""
        out = LogHistogram()
        out.n = self.n + other.n
        out.total = self.total + other.total
        mins = [m for m in (self.vmin, other.vmin) if m is not None]
        maxs = [m for m in (self.vmax, other.vmax) if m is not None]
        out.vmin = min(mins) if mins else None
        out.vmax = max(maxs) if maxs else None
        out.counts = dict(self.counts)
        for idx, c in other.counts.items():
            out.counts[idx] = out.counts.get(idx, 0) + c
        return out

    def quantile(self, q: float) -> float | None:
        """The geometric midpoint of the bucket holding the rank-
        ``ceil(q * n)`` observation, clamped to the exact [min, max]."""
        if self.n == 0:
            return None
        rank = max(1, math.ceil(q * self.n))
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= rank:
                mid = _GAMMA ** (idx + 0.5)
                return min(self.vmax, max(self.vmin, mid))
        return self.vmax  # unreachable: counts sum to n

    def to_dict(self) -> dict:
        return {"n": self.n, "sum": self.total,
                "min": self.vmin, "max": self.vmax,
                "counts": {str(i): c for i, c in self.counts.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        h = cls()
        h.n = int(d["n"])
        h.total = float(d["sum"])
        h.vmin = d["min"]
        h.vmax = d["max"]
        h.counts = {int(i): int(c) for i, c in d["counts"].items()}
        return h


# --------------------------------------------------------------------------
# registry


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _promname(name: str, labels: tuple, extra: tuple = ()) -> str:
    pairs = labels + extra
    if not pairs:
        return name
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return f"{name}{{{body}}}"


_QUANTILES = (0.5, 0.95, 0.99)


class MetricsRegistry:
    """Counters, gauges and histograms keyed (name, label pairs).

    Every mutator and reader takes the internal lock — the aggregator
    feeds it from whichever thread polls (the HTTP handler or the
    snapshot loop), and the exposition reads concurrently.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}

    def inc(self, name: str, value: float = 1, **labels) -> None:
        key = (name, _labelkey(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _labelkey(labels))
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, _labelkey(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = LogHistogram()
            h.add(value)

    def series(self) -> tuple:
        """(counters, gauges, histograms) — consistent copies for the
        exposition renderer (histograms merged into fresh objects so
        the renderer never races an ``add``)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: LogHistogram().merge(h)
                     for k, h in self._hists.items()}
        return counters, gauges, hists

    def snapshot(self) -> dict:
        """Flat ``{prometheus_series_name: number}`` — the replayable
        payload of the schema-v10 ``metrics_snapshot`` event (summary
        quantiles expanded, exactly what the endpoint exposes)."""
        counters, gauges, hists = self.series()
        out: dict = {}
        for (name, labels), v in sorted(counters.items()):
            out[_promname(name + "_total", labels)] = v
        for (name, labels), v in sorted(gauges.items()):
            out[_promname(name, labels)] = v
        for (name, labels), h in sorted(hists.items()):
            for q in _QUANTILES:
                qv = h.quantile(q)
                if qv is not None:
                    out[_promname(name, labels,
                                  (("quantile", f"{q:g}"),))] = round(qv, 6)
            out[_promname(name + "_count", labels)] = h.n
            out[_promname(name + "_sum", labels)] = round(h.total, 6)
        return out


# --------------------------------------------------------------------------
# streaming reducer over event logs


class MetricsAggregator:
    """Tail every ``*.events`` log under ``root`` and fold new events
    into a :class:`MetricsRegistry`.

    Pull-based: nothing runs between ``poll()`` calls, and each poll
    reads only the bytes appended since the last one (``LogTail``).
    The tenant label is the log's basename (the serve convention:
    ``{job_id}.events``); supervision logs (``pool.events``) feed the
    worker-lifecycle counters under the same rule.
    """

    def __init__(self, root: str, registry: MetricsRegistry | None = None,
                 extra_labels: dict | None = None):
        self.root = root
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._extra = dict(extra_labels or {})
        self._lock = threading.Lock()
        self._tails: dict = {}
        self._admit: dict = {}      # tenant -> run_start ts
        self._live: dict = {}       # tenant -> True while un-ended
        self._workers = 0           # spawned minus lost (pool events)

    def poll(self) -> None:
        with self._lock:
            for path in find_logs(self.root):
                if path not in self._tails:
                    self._tails[path] = LogTail(path)
            for path, tail in self._tails.items():
                tenant = os.path.basename(path)
                if tenant.endswith(".events"):
                    tenant = tenant[:-len(".events")]
                for e in tail.poll():
                    if isinstance(e.get("event"), str):
                        self._reduce(tenant, e)
            reg = self.registry
            depth = sum(1 for live in self._live.values() if live)
            reg.set_gauge("raft_tla_queue_depth", depth, **self._extra)

    # -- one event -> registry mutations ------------------------------------

    def _reduce(self, tenant: str, e: dict) -> None:
        ev = e["event"]
        reg = self.registry
        lbl = dict(self._extra, tenant=tenant)
        reg.inc("raft_tla_events", 1, event=ev, **self._extra)
        if ev == "run_start":
            ts = e.get("ts")
            if isinstance(ts, (int, float)):
                self._admit[tenant] = float(ts)
            self._live[tenant] = True
            reg.inc("raft_tla_runs_started", 1, **lbl)
        elif ev == "segment":
            for field, metric in (
                    ("inc_states_per_sec", "raft_tla_inc_states_per_sec"),
                    ("dedup_hit_rate", "raft_tla_dedup_hit_rate"),
                    ("flush_backlog", "raft_tla_flush_backlog"),
                    ("upload_wait_ms", "raft_tla_upload_wait_ms"),
                    ("n_states", "raft_tla_states")):
                v = e.get(field)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    reg.set_gauge(metric, v, **lbl)
            if isinstance(e.get("inflight"), int):
                reg.set_gauge("raft_tla_inflight", e["inflight"],
                              bin=e.get("bin") or "-", **lbl)
        elif ev == "run_end":
            self._live[tenant] = False
            reg.inc("raft_tla_runs_ended", 1,
                    outcome=str(e.get("outcome", "?")), **lbl)
            ts, t0 = e.get("ts"), self._admit.get(tenant)
            if isinstance(ts, (int, float)) and t0 is not None:
                lat = max(0.0, float(ts) - t0)
                reg.observe("raft_tla_latency_seconds", lat, **lbl)
                reg.observe("raft_tla_latency_seconds", lat, **self._extra)
        elif ev == "worker_spawn":
            self._workers += 1
            reg.inc("raft_tla_workers_spawned", 1, **self._extra)
            reg.set_gauge("raft_tla_workers_live", self._workers,
                          **self._extra)
        elif ev == "worker_lost":
            self._workers -= 1
            reg.inc("raft_tla_workers_lost", 1,
                    kind=str(e.get("kind", "?")), **self._extra)
            reg.set_gauge("raft_tla_workers_live", self._workers,
                          **self._extra)
        elif ev == "job_retry":
            reg.inc("raft_tla_job_retries", 1, **self._extra)
        elif ev == "quarantine":
            reg.inc("raft_tla_quarantines", 1, **self._extra)
        # metrics_snapshot events are deliberately NOT reduced: the
        # aggregator may be tailing its own snapshot log (same root),
        # and folding snapshots back in would be a feedback loop.
