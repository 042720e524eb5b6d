"""The port's live metrics layer and monitor (``obs/metrics.py``,
``obs/openmetrics.py``, ``obs/monitor.py``) against the JAX package's.

The same samples and event logs go into both packages: histogram
quantiles (each within ``sqrt(gamma) - 1`` of the exact sample quantile),
registry snapshots, the rendered exposition, the aggregator's reductions
and the monitor's heartbeat and fleet lines are equal.  The endpoint
serves a scrape on 127.0.0.1 and leaves a valid schema-v10 snapshot on
close; the serve CLI's ``--metrics-port`` wires it; ``raft-tla-monitor-
torch`` renders every tenant of a served directory.
"""

import io
import json
import urllib.error
import urllib.request
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from raft_tla_tpu.obs import metrics as jmetrics
from raft_tla_tpu.obs import monitor as jmonitor
from raft_tla_tpu.obs import openmetrics as jopenmetrics
from raft_tla_tpu.obs.events import validate_event as jvalidate

from raft_tla_tpu_torch.obs import monitor
from raft_tla_tpu_torch.obs.events import append_event
from raft_tla_tpu_torch.obs.metrics import (_GAMMA, ENV_METRICS,
                                            LogHistogram, MetricsAggregator,
                                            MetricsRegistry, metrics_port)
from raft_tla_tpu_torch.obs.openmetrics import MetricsServer, render

torch.set_num_threads(1)

_BOUND = _GAMMA ** 0.5 - 1.0
_CFG = ("SPECIFICATION Spec\nINVARIANT NoTwoLeaders\nCONSTANTS\n"
        "    Server = {s1, s2}\n    Value = {v1}\n")


@pytest.mark.parametrize("dist", ["lognormal", "bimodal"])
def test_histogram_matches_reference_within_bound(dist):
    rng = np.random.default_rng(7)
    xs = (rng.lognormal(0.0, 2.0, 5000) if dist == "lognormal" else
          np.concatenate([rng.uniform(1e-3, 2e-3, 2500),
                          rng.uniform(50.0, 90.0, 2500)]))
    h, jh = LogHistogram(), jmetrics.LogHistogram()
    for x in xs:
        h.add(x)
        jh.add(x)
    for q in (0.5, 0.95, 0.99):
        exact = float(np.quantile(xs, q, method="inverted_cdf"))
        assert h.quantile(q) == jh.quantile(q)
        assert abs(h.quantile(q) - exact) <= _BOUND * exact + 1e-12
    parts = [LogHistogram() for _ in range(3)]
    for i, x in enumerate(xs):
        parts[i % 3].add(x)
    a = parts[0].merge(parts[1]).merge(parts[2])
    b = parts[0].merge(parts[1].merge(parts[2]))
    # bucket counts merge exactly (the float sum only to rounding)
    assert (a.counts, a.n, a.vmin, a.vmax) == (b.counts, b.n, b.vmin, b.vmax)
    assert LogHistogram.from_dict(a.to_dict()).to_dict() == a.to_dict()
    assert a.counts == h.counts and a.n == h.n


def test_metrics_port_gate(monkeypatch):
    monkeypatch.delenv(ENV_METRICS, raising=False)
    assert metrics_port(None) is None and metrics_port(0) == 0
    monkeypatch.setenv(ENV_METRICS, "9200")
    assert metrics_port(None) == 9200 and metrics_port(9108) == 9108
    monkeypatch.setenv(ENV_METRICS, "not-a-port")
    assert metrics_port(None) is None


def test_registry_snapshot_and_render_match_reference():
    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.inc("raft_tla_events", 1, event="segment")
        reg.inc("raft_tla_events", 2, event="segment")
        reg.set_gauge("raft_tla_queue_depth", 3)
        for v in (2.5, 0.125, 9.0):
            reg.observe("raft_tla_latency_seconds", v, tenant="a")
    snap = regs[0].snapshot()
    assert snap == regs[1].snapshot()
    assert snap['raft_tla_events_total{event="segment"}'] == 3
    assert jvalidate({"v": 10, "event": "metrics_snapshot", "ts": 0.0,
                      "metrics": snap}) == []
    text = render(regs[0])
    assert text == jopenmetrics.render(regs[1])
    assert "# TYPE raft_tla_latency_seconds summary" in text


def _tenant_log(path, t0, t_end=None, inflight=None):
    append_event(path, "run_start", ts=t0, engine="serve",
                 universe={"servers": 2, "values": 1}, spec="election",
                 invariants=["NoTwoLeaders"], resumed=False)
    seg = dict(ts=t0 + 1.0, wall_s=1.0, n_states=100, level=2,
               n_transitions=200, dedup_hit_rate=0.5, since_resume=True,
               states_per_sec=100.0, inc_states_per_sec=100.0,
               flush_backlog=4)
    if inflight is not None:
        seg.update(bin="bin0", inflight=inflight)
    append_event(path, "segment", **seg)
    if t_end is not None:
        append_event(path, "run_end", ts=t_end, n_states=100,
                     n_transitions=200, complete=True, outcome="ok")


def test_aggregator_matches_reference(tmp_path):
    _tenant_log(str(tmp_path / "job-a.events"), 100.0, 102.5, inflight=2)
    _tenant_log(str(tmp_path / "job-b.events"), 200.0)
    p = str(tmp_path / "pool.events")
    append_event(p, "worker_spawn", ts=1.0, worker="w0", pid=11)
    append_event(p, "worker_spawn", ts=2.0, worker="w1", pid=12)
    append_event(p, "worker_lost", ts=3.0, worker="w0", kind="killed")
    append_event(p, "job_retry", ts=4.0, job_id="a", attempt=1)
    append_event(str(tmp_path / "metrics.events"), "metrics_snapshot",
                 ts=6.0, metrics={"raft_tla_queue_depth": 99.0})
    aggs = (MetricsAggregator(str(tmp_path)),
            jmetrics.MetricsAggregator(str(tmp_path)))
    for a in aggs:
        a.poll()
    snap = aggs[0].registry.snapshot()
    assert snap == aggs[1].registry.snapshot()
    assert snap['raft_tla_latency_seconds{tenant="job-a",'
                'quantile="0.99"}'] == 2.5
    assert snap["raft_tla_queue_depth"] == 1          # not 99: no feedback
    assert snap['raft_tla_inflight{bin="bin0",tenant="job-a"}'] == 2
    assert snap["raft_tla_workers_live"] == 1
    append_event(str(tmp_path / "job-b.events"), "run_end", ts=204.0,
                 n_states=100, n_transitions=200, complete=True,
                 outcome="ok")
    for a in aggs:
        a.poll()
    snap = aggs[0].registry.snapshot()
    assert snap == aggs[1].registry.snapshot()
    assert snap["raft_tla_queue_depth"] == 0


def test_server_scrape_and_snapshot(tmp_path):
    _tenant_log(str(tmp_path / "smoke-a.events"), 10.0, 12.5, inflight=2)
    snap_path = str(tmp_path / "metrics.events")
    server = MetricsServer(str(tmp_path), port=0, snapshot_path=snap_path,
                           interval_s=3600.0)
    try:
        assert server.url == f"http://127.0.0.1:{server.port}/metrics"
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            assert resp.status == 200
            body = resp.read().decode("utf-8")
        assert 'raft_tla_latency_seconds{tenant="smoke-a",' \
               'quantile="0.99"} 2.5' in body
        assert "raft_tla_queue_depth 0" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/nope", timeout=10)
    finally:
        server.close()
    server.close()                                 # idempotent
    evs = [json.loads(line) for line in open(snap_path)]
    assert evs and all(jvalidate(e) == [] for e in evs)
    assert evs[-1]["port"] == server.port


def test_monitor_metrics_rows_match_reference(tmp_path):
    p = str(tmp_path / "metrics.events")
    append_event(p, "metrics_snapshot", ts=1.0, metrics={
        'raft_tla_latency_seconds{tenant="job-a",quantile="0.99"}': 1.5,
        'raft_tla_latency_seconds{quantile="0.99"}': 1.5,
        "raft_tla_queue_depth": 2.0})
    _tenant_log(str(tmp_path / "job-a.events"), 5.0, t_end=6.5)
    line = monitor.heartbeat(monitor.summarize(monitor.load_stream(p)))
    assert line == jmonitor.heartbeat(jmonitor.summarize(
        jmonitor.load_stream(p)))
    assert "p99 latency job-a: 1,500 ms" in line
    assert "queue depth: 2 jobs" in line
    rows, totals = monitor.fleet_view(str(tmp_path))
    jrows, jtotals = jmonitor.fleet_view(str(tmp_path))
    assert monitor._fleet_lines(rows, totals) == \
        jmonitor._fleet_lines(jrows, jtotals)


def test_serve_metrics_port_and_monitor_every_tenant(tmp_path):
    """``--metrics-port 0`` prints the endpoint, the close leaves a
    snapshot in OUT/metrics.events; ``raft-tla-monitor-torch OUT`` (and
    ``python -m raft_tla_tpu_torch.obs monitor``) render every tenant."""
    from raft_tla_tpu_torch.obs.__main__ import main as obs_main
    from raft_tla_tpu_torch.serve import service
    (tmp_path / "toy.cfg").write_text(_CFG)
    opt = {"cfg": "toy.cfg", "spec": "election", "max_term": 2,
           "max_log": 0, "max_msgs": 1}
    manifest = tmp_path / "jobs.jsonl"
    manifest.write_text("".join(json.dumps(dict(opt, id=j, **kw)) + "\n"
                                for j, kw in (("a", {}),
                                              ("b", {"symmetry": True}),
                                              ("wide", {"max_term": 99}))))
    out = tmp_path / "out"
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        code = service.main([str(manifest), "--out", str(out), "--device",
                             "cpu", "--chunk", "64", "--metrics-port", "0"])
    assert code == 0
    assert "metrics endpoint: http://127.0.0.1:" in buf.getvalue()
    snaps = [json.loads(l) for l in open(out / "metrics.events")]
    assert snaps and snaps[-1]["metrics"][
        'raft_tla_runs_ended_total{outcome="ok",tenant="a"}'] == 1
    for argv, fn in ((["monitor", str(out)], obs_main),
                     ([str(out)], monitor.main)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert fn(argv) == 0
        text = buf.getvalue()
        for jid in ("a", "b", "wide"):
            assert any(ln.startswith(jid + ".events ") for ln in
                       text.splitlines()), (jid, text)
        assert "fleet: 4 log(s)" in text and "queue depth: 0 jobs" in text
