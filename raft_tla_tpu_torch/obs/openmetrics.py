"""OpenMetrics/Prometheus text exposition for the live metrics layer;
the port's copy of ``raft_tla_tpu/obs/openmetrics.py``.

Stdlib only: a :class:`~http.server.ThreadingHTTPServer` on a daemon
thread serves ``GET /metrics`` by polling the directory's
:class:`~raft_tla_tpu_torch.obs.metrics.MetricsAggregator` (each scrape reads
only the event-log bytes appended since the previous scrape) and
rendering the registry in the Prometheus text format — ``# TYPE``
headers, ``_total`` counters, plain gauges, and summary series with
``quantile`` labels plus ``_count``/``_sum``.

A second daemon thread (only when ``snapshot_path`` is given) appends a
validated schema-v10 ``metrics_snapshot`` event on a fixed cadence, so
the scrape record is replayable from the event log alone — the fleet
monitor's latency/queue rows come from these snapshots, no endpoint
required.

Nothing here runs inside an engine process's check loop: the server
binds 127.0.0.1 in the *supervising* process (serve daemon, pool,
campaign CLI), and when the ``--metrics-port`` / ``RAFT_TLA_METRICS``
gate is off the server is never constructed at all.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from raft_tla_tpu_torch.obs.events import append_event
from raft_tla_tpu_torch.obs.metrics import (_QUANTILES, MetricsAggregator,
                                      MetricsRegistry, _promname)

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v) -> str:
    if isinstance(v, float):
        return repr(v)
    return str(v)


def render(registry: MetricsRegistry) -> str:
    """The registry in Prometheus text format, one family at a time:
    counters (``_total`` suffix), gauges, then histogram-backed
    summaries (p50/p95/p99 + ``_count``/``_sum``)."""
    counters, gauges, hists = registry.series()
    lines: list = []

    def series(name, labels, value, extra=()):
        esc = tuple((k, _escape(v)) for k, v in labels + tuple(extra))
        lines.append(f"{_promname(name, esc)} {_fmt(value)}")

    by_name: dict = {}
    for (name, labels), v in sorted(counters.items()):
        by_name.setdefault(name, []).append((labels, v))
    for name, rows in by_name.items():
        lines.append(f"# TYPE {name}_total counter")
        for labels, v in rows:
            series(name + "_total", labels, v)
    by_name = {}
    for (name, labels), v in sorted(gauges.items()):
        by_name.setdefault(name, []).append((labels, v))
    for name, rows in by_name.items():
        lines.append(f"# TYPE {name} gauge")
        for labels, v in rows:
            series(name, labels, v)
    by_name = {}
    for (name, labels), h in sorted(hists.items()):
        by_name.setdefault(name, []).append((labels, h))
    for name, rows in by_name.items():
        lines.append(f"# TYPE {name} summary")
        for labels, h in rows:
            for q in _QUANTILES:
                qv = h.quantile(q)
                if qv is not None:
                    series(name, labels, round(qv, 6),
                           extra=(("quantile", f"{q:g}"),))
            series(name + "_count", labels, h.n)
            series(name + "_sum", labels, round(h.total, 6))
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Bind the endpoint, start the scrape + snapshot threads, expose
    :attr:`port` (the real bound port — pass 0 for an ephemeral one).

    Thread discipline: every shared object (aggregator, registry, the
    stop event) is constructed and published *before* either thread
    starts, and all cross-thread mutation goes through the registry /
    aggregator locks.  ``close`` is idempotent: it stops the snapshot
    loop, takes one final poll + snapshot (so short runs still leave a
    replayable record), and shuts the HTTP server down.
    """

    def __init__(self, root: str, port: int = 0,
                 snapshot_path: str | None = None,
                 interval_s: float = 10.0,
                 labels: dict | None = None):
        self.root = root
        self.snapshot_path = snapshot_path
        self.interval_s = interval_s
        self.aggregator = MetricsAggregator(root, extra_labels=labels)
        self.registry = self.aggregator.registry
        self._stop = threading.Event()
        self._closed = False

        agg = self.aggregator

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                agg.poll()
                body = render(agg.registry).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", _CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not stderr news
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._serve_http, name="obs-metrics-http", daemon=True)
        self._snap_thread = (
            threading.Thread(target=self._snapshot_loop,
                             name="obs-metrics-snapshot", daemon=True)
            if snapshot_path else None)
        self._http_thread.start()
        if self._snap_thread is not None:
            self._snap_thread.start()

    def _serve_http(self) -> None:
        """The endpoint's thread: the HTTP server's loop, whose handler
        polls the aggregator (under its lock) on every scrape."""
        self._httpd.serve_forever()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/metrics"

    def _snapshot_once(self) -> None:
        self.aggregator.poll()
        snap = self.registry.snapshot()
        if not snap:
            return  # nothing observed yet: an empty snapshot says less
        try:
            append_event(self.snapshot_path, "metrics_snapshot",
                         metrics=snap, port=self.port, root=self.root)
        except (OSError, ValueError):
            pass  # evidence channel, never the verdict

    def _snapshot_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._snapshot_once()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self.snapshot_path:
            self._snapshot_once()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._http_thread.join(timeout=10.0)
        if self._snap_thread is not None:
            self._snap_thread.join(timeout=10.0)
