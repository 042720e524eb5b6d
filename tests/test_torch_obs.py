"""The port's run events (``raft_tla_tpu_torch/obs/events.py``,
``obs/phases.py``, the ``--events`` CLI) against the JAX package's.

One corpus of valid and malformed lines of every schema version, 1-10,
goes through both ``validate_event``s, which must return the same errors.
The toy election universe (2 servers, 3,014 states) runs with an event log
through the JAX and the port ``device`` and ``ddd`` engines on the CPU,
each with the same fixed segment budget: the same sequence of event
types, the same ``level_end`` counts, the same per-line ``route_peak``
(the DDD ``--stats`` payload) and the same ``run_end`` fields apart from
times; every port line also passes the JAX validator.  With no listener
the phase handle and the tracer are the shared null objects.  The
tracker's rates across a resume are the reference's.
"""

import copy
import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.obs.events import ProgressTracker as JTracker
from raft_tla_tpu.obs.events import validate_event as jvalidate

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.obs import events as ev
from raft_tla_tpu_torch.obs.events import ProgressTracker, validate_event

from test_torch_cli import write_cfg

torch.set_num_threads(1)

TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
ELECTION_2S = ["--spec", "election", "--max-term", "2", "--max-log", "0",
               "--max-msgs", "2"]
ENV = ("RAFT_TLA_EVENTS", "RAFT_TLA_PHASE_TIMERS", "RAFT_TLA_TRACE")

_SEG = dict(wall_s=1.0, n_states=5, level=2, n_transitions=9,
            dedup_hit_rate=0.4, states_per_sec=5.0,
            inc_states_per_sec=5.0, since_resume=True)
# one minimal valid body per event type
_BODIES = {
    "run_start": dict(engine="ddd", universe={"servers": 2}, spec="full",
                      invariants=["NoTwoLeaders"], resumed=False),
    "segment": _SEG,
    "level_end": dict(level=3, n_states=10),
    "checkpoint": dict(path="/x.ckpt"),
    "violation": dict(invariant="NoTwoLeaders"),
    "stop_requested": dict(reason="sigint"),
    "run_end": dict(n_states=10, n_transitions=20, complete=True,
                    outcome="ok"),
    "preempt": dict(reason="session-wall"),
    "reshard": dict(ndev_src=1, ndev_dst=2),
    "resume_attempt": dict(attempt=1),
    "worker_spawn": dict(worker="w0", pid=7),
    "worker_lost": dict(worker="w0", kind="killed"),
    "job_retry": dict(job_id="j", attempt=2),
    "quarantine": dict(job_id="j", reason="poison-job"),
    "span": dict(name="expand", span_id=1, t0=1.0, dur=0.5,
                 thread="MainThread"),
    "metrics_snapshot": dict(metrics={"a": 1}),
}
# optional fields, each introduced at some version
_EXTRAS = [
    ("segment", "device_rates", [1.0]), ("segment", "bin", "b0"),
    ("segment", "inflight", 2), ("segment", "flush_backlog", 1),
    ("segment", "upload_wait_ms", 0.5), ("segment", "prefetch_hits", 3),
    ("segment", "export_rows", 4), ("segment", "dev_dedup_hits", 1),
    ("segment", "route_peak", 9), ("segment", "phase_s", {"expand": 1}),
    ("run_end", "sim", {"walkers": 4}), ("run_end", "diameter", 17),
    ("run_start", "anchor", {"wall": 1.0}), ("run_start", "host", {}),
    ("span", "parent_id", 1), ("span", "args", {"rows": 1}),
    ("checkpoint", "n_states", 5), ("resume_attempt", "backoff_s", 0.5),
]


def _corpus() -> list:
    out = []
    for v in range(0, 12):
        for name, body in _BODIES.items():
            out.append({"v": v, "event": name, "ts": 1.0, **body})
        for name, key, val in _EXTRAS:
            out.append({"v": v, "event": name, "ts": 1.0,
                        **_BODIES[name], key: val})
    bad = [None, [], "x", {"v": 10}, {"v": True, "event": "x", "ts": 1},
           {"v": 10, "event": 3, "ts": 1.0},
           {"v": 10, "event": "nope", "ts": 1.0},
           {"v": 10, "event": "segment", "ts": "now", **_SEG},
           {"v": 10, "event": "segment", "ts": 1.0, **_SEG, "extra": 1},
           {"v": 10, "event": "segment", "ts": 1.0,
            **dict(_SEG, n_states=True)},
           {"v": 10, "event": "segment", "ts": 1.0,
            **dict(_SEG, since_resume=1)},
           {"v": 10, "event": "level_end", "ts": 1.0, "level": 1.5},
           {"v": 10, "event": "run_end", "ts": 1.0}]
    for name, body in _BODIES.items():
        for k in body:                       # each required field missing
            out.append({"v": 10, "event": name, "ts": 1.0,
                        **{a: b for a, b in body.items() if a != k}})
    return out + bad


def test_validate_event_matches_reference_on_corpus():
    corpus = _corpus()
    got = [validate_event(copy.deepcopy(d)) for d in corpus]
    assert got == [jvalidate(copy.deepcopy(d)) for d in corpus]
    assert sum(g == [] for g in got) > 100 and sum(g != [] for g in got) > 100
    assert ev.SCHEMA_VERSION == 10


def _pin(eng, k: int) -> None:
    """A fixed segment budget: the same segments in both packages."""
    eng.SEG_MIN = eng.SEG_MAX = eng.seg_chunks = k


def _engines(kind):
    jc = JConfig(bounds=JBounds(**TOY), spec="election",
                 invariants=("NoTwoLeaders",), chunk=32)
    pc = CheckConfig(bounds=Bounds(**TOY), spec="election",
                     invariants=("NoTwoLeaders",), chunk=32)
    if kind == "device":
        from raft_tla_tpu.device_engine import (Capacities as JCaps,
                                                DeviceEngine as JEng)
        from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
        return (JEng(jc, JCaps(n_states=1 << 14, levels=64)),
                DeviceEngine(pc, Capacities(n_states=1 << 14, levels=64),
                             device="cpu"), 3)
    from raft_tla_tpu.ddd_engine import (DDDCapacities as JCaps,
                                         DDDEngine as JEng)
    from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
    kw = dict(block=256, table=1 << 14, flush=1 << 10, levels=64)
    return (JEng(jc, JCaps(**kw)),
            DDDEngine(pc, DDDCapacities(**kw), device="cpu"), 2)


_TIMES = ("ts", "wall_s", "states_per_sec", "inc_states_per_sec",
          "upload_wait_ms")


@pytest.mark.parametrize("kind", ["device", "ddd"])
def test_event_log_matches_jax_engine(kind, tmp_path, monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    jeng, peng, k = _engines(kind)
    logs, lines = {}, {}
    for tag, eng in (("jax", jeng), ("port", peng)):
        _pin(eng, k)
        path = tmp_path / f"{tag}.events"
        lines[tag] = []
        res = eng.check(events=str(path), on_progress=lines[tag].append)
        assert (res.n_states, res.diameter) == (3014, 17)
        logs[tag] = [json.loads(ln) for ln in path.read_text().splitlines()]
    j, p = logs["jax"], logs["port"]
    assert [e["event"] for e in p] == [e["event"] for e in j]
    assert [e for e in p if e["event"] == "level_end"] != []
    for a, b in zip(p, j):
        if a["event"] in ("level_end", "run_end", "segment"):
            assert {x: y for x, y in a.items() if x not in _TIMES} == \
                {x: y for x, y in b.items() if x not in _TIMES}
    assert p[0]["engine"] == kind and p[-1]["n_states"] == 3014
    assert all(validate_event(e) == [] == jvalidate(e) for e in p)
    # the --stats payload: route_peak (ddd) equal line by line
    assert [d.get("route_peak") for d in lines["port"]] == \
        [d.get("route_peak") for d in lines["jax"]]
    if kind == "ddd":
        assert lines["port"][-1]["route_peak"] > 0


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            code = main(list(argv))
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def test_cli_events_flags_and_their_refusals(tmp_path, monkeypatch):
    """``--events`` on device and ddd: every line passes both validators;
    ``--trace`` without ``--events`` and any of the three flags on host or
    ref exit 2 with the reference's message."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    cfg = write_cfg(tmp_path / "m.cfg", servers="s1, s2")
    for engine in ("device", "ddd"):
        path = tmp_path / f"{engine}.events"
        code, out, _ = _run(cli.main, [cfg, "--device", "cpu", *ELECTION_2S,
                                       "--engine", engine, "--events",
                                       str(path), "--chunk", "256"])
        assert code == 0 and "3014 distinct states found" in out
        evs = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert evs[0]["event"] == "run_start" and \
            evs[-1]["event"] == "run_end" and evs[-1]["n_states"] == 3014
        assert all(validate_event(e) == [] == jvalidate(e) for e in evs)
        monkeypatch.delenv("RAFT_TLA_EVENTS")
    for args in (["--trace"], ["--events", "x", "--engine", "host"],
                 ["--phase-timers", "--engine", "ref"],
                 ["--trace", "--events", "x", "--engine", "ref"]):
        code, _, err = _run(cli.main, [cfg, "--device", "cpu", *args])
        jcode, _, jerr = _run(jcli.main, [cfg, "--cpu", *args])
        assert code == jcode == 2
        assert err.splitlines()[-1].split(": error: ")[1] == \
            jerr.splitlines()[-1].split(": error: ")[1]


def test_null_handles_without_a_listener(tmp_path, monkeypatch):
    """No log, no timers, no tracing: the phase handle is the one shared
    null handle and the tracer the shared NULL_TRACER, so the chunk loops
    read no clock and wait for nothing; ``obs emit`` appends a valid line
    and ``obs monitor`` renders the log's heartbeat."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    from raft_tla_tpu_torch.obs.phases import _NULL
    from raft_tla_tpu_torch.obs.trace import NULL_TRACER
    cfg = CheckConfig(bounds=Bounds(**TOY), spec="election")
    tel = ev.RunTelemetry("ddd", config=cfg)
    assert not tel.active and tel.log is None
    assert tel.trace is NULL_TRACER
    assert tel.phases.phase("expand") is _NULL is tel.phases.phase("export")
    assert tel.trace.span("x") is NULL_TRACER.span("y")
    tel.run_start(n_states=1)
    tel.close()
    # the gate without a sink stays off
    monkeypatch.setenv("RAFT_TLA_TRACE", "1")
    assert ev.RunTelemetry("ddd", config=cfg).trace is NULL_TRACER
    from raft_tla_tpu_torch.obs.__main__ import main as obs_main
    log = tmp_path / "x.events"
    assert _run(obs_main, ["emit", str(log), "stop_requested", "--reason",
                           "x", "--source", "y"])[0] == 0
    (line,) = log.read_text().splitlines()
    assert jvalidate(json.loads(line)) == []
    assert _run(obs_main, ["emit", str(log), "bogus"])[0] == 2
    code, out, _ = _run(obs_main, ["monitor", str(log)])
    assert code == 0 and "stop_requested" not in out and out.strip()


def test_tracker_rates_across_a_resume_match_reference(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    trackers = [cls(t0=0.0, n0=1, invariants=("NoTwoLeaders",),
                    resumed=True) for cls in (ProgressTracker, JTracker)]
    for tr in trackers:
        tr.anchor(1_000_000)
    steps = [(1_000_050, 7, 2_000_000, None), (999_000, 7, 2_000_001,
                                               999_500),
             (1_200_000, 8, 2_500_000, 1_300_000), (1_300_000, 9,
                                                    2_600_000, None)]
    recs = []
    for n, lv, nt, incl in steps:
        clock[0] += 7.5
        got, want = (tr.record(n_states=n, level=lv, n_transitions=nt,
                               n_incl=incl, route_peak=5).to_dict()
                     for tr in trackers)
        assert got == want
        recs.append(got)
    # the first record's wall runs from t0; a dip below the running max
    # reads 0, never negative
    assert [r["inc_states_per_sec"] for r in recs] == \
        [round(50 / 107.5, 1), 0.0, round(299_950 / 7.5, 1), 0.0]
    assert {r["since_resume"] for r in recs} == {False}
