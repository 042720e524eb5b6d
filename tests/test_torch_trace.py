"""The port's trace layer (``raft_tla_tpu_torch/obs/{trace,collect,
perfetto,tracecli}.py``) against the JAX package's.

Spans nest per thread and carry their thread's name; two processes'
logs merge onto one wall axis through their clock anchors; and the
port's ``collect``, ``report`` and Perfetto export of one log equal the
JAX package's for the same log — here the log of a traced, phase-timed
DDD run of the port on the CPU, whose main thread and flush thread the
report attributes.
"""

import json
import subprocess
import sys
import threading

import pytest
import torch

from raft_tla_tpu.obs import collect as jcollect, perfetto as jperfetto
from raft_tla_tpu.obs.events import validate_event as jvalidate

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.obs import collect, perfetto
from raft_tla_tpu_torch.obs.events import append_event, validate_event
from raft_tla_tpu_torch.obs.trace import SpanTracer

torch.set_num_threads(1)

CFG = CheckConfig(
    bounds=Bounds(n_servers=2, n_values=1, max_term=2, max_log=0,
                  max_msgs=2),
    spec="election", invariants=("NoTwoLeaders",), chunk=32)


def _capture():
    rows = []
    return SpanTracer(lambda event, **f: rows.append(dict(f))), rows


def test_spans_nest_per_thread_and_name_their_thread():
    tr, rows = _capture()
    with tr.span("outer", a=1):
        with tr.span("inner") as sp:
            sp.set(rows=256)

        def work():
            with tr.span("bg"):
                with tr.span("bg-inner"):
                    pass

        t = threading.Thread(target=work, name="raft-tla-flush")
        t.start()
        t.join()
    assert tr.current_id() is None
    by = {r["name"]: r for r in rows}
    assert [r["name"] for r in rows] == ["inner", "bg-inner", "bg", "outer"]
    assert by["inner"]["parent_id"] == by["outer"]["span_id"]
    assert by["inner"]["args"] == {"rows": 256}
    assert by["outer"]["args"] == {"a": 1} and "parent_id" not in by["outer"]
    # the worker's stack is its own: its root has no parent
    assert "parent_id" not in by["bg"]
    assert by["bg-inner"]["parent_id"] == by["bg"]["span_id"]
    assert {by["bg"]["thread"], by["bg-inner"]["thread"]} == \
        {"raft-tla-flush"}
    assert by["outer"]["thread"] == threading.current_thread().name
    assert len({r["span_id"] for r in rows}) == 4
    assert by["outer"]["t0"] <= by["inner"]["t0"] \
        and by["inner"]["dur"] <= by["outer"]["dur"]


_CHILD = """
import sys, time
from raft_tla_tpu_torch.obs.trace import anchored_run_start, tracer_for
path = sys.argv[1]
anchored_run_start(path, "campaign")
tr = tracer_for(path)
with tr.span("child-work"):
    time.sleep(0.05)
"""


def test_two_process_clock_alignment(tmp_path):
    """A span of this process and one of a child process land on one wall
    axis, each log anchored, the child's after this one's; the synthetic
    pair with disjoint monotonic bases aligns to the recorded bound, in
    both packages' collectors alike."""
    from raft_tla_tpu_torch.obs.trace import anchored_run_start, tracer_for
    a, b = str(tmp_path / "a.events"), str(tmp_path / "b.events")
    anchored_run_start(a, "ddd")
    with tracer_for(a).span("parent-work"):
        pass
    subprocess.run([sys.executable, "-c", _CHILD, b], check=True,
                   timeout=120)
    col = collect.collect([a, b])
    assert [p["anchored"] for p in col["processes"]] == [True, True]
    assert len({p["os_pid"] for p in col["processes"]}) == 2
    spans = {s["name"]: s for s in col["spans"]}
    assert spans["parent-work"]["ts"] <= spans["child-work"]["ts"]
    assert col["skew_bound_s"] < 0.01
    for p in (a, b):
        assert all(validate_event(json.loads(ln)) == []
                   for ln in open(p))

    c, d = str(tmp_path / "c.events"), str(tmp_path / "d.events")
    wall = 1_700_000_000.0
    for path, pid, mono in ((c, 100, 50.0), (d, 200, 9000.0)):
        append_event(path, "run_start", engine="ddd", universe={}, spec="",
                     invariants=[], resumed=False, pid=pid,
                     anchor={"wall": wall, "mono": mono, "err_s": 1e-6},
                     host={"nproc": 1})
        append_event(path, "span", name="expand", span_id=1,
                     t0=mono + 1.0, dur=0.5, thread="MainThread")
    col = collect.collect([c, d])
    sc, sd = col["spans"]
    assert abs(sc["ts"] - (wall + 1.0)) <= 1e-6
    assert abs(sc["ts"] - sd["ts"]) <= 2 * col["skew_bound_s"] + 1e-9
    assert col == jcollect.collect([c, d])


def test_traced_ddd_run_collect_report_export_match_jax(tmp_path,
                                                        monkeypatch):
    """A traced, phase-timed DDD run of the port (background flush and
    prefetch on): every line passes both validators, segments carry
    ``phase_s``, the report attributes the main thread and
    ``raft-tla-flush``, and collect, report and the Perfetto export equal
    the JAX package's on the same log; tracecli's three commands run."""
    monkeypatch.setenv("RAFT_TLA_TRACE", "1")
    monkeypatch.setenv("RAFT_TLA_PHASE_TIMERS", "1")
    monkeypatch.setenv("RAFT_TLA_HOSTDEDUP", "on")
    monkeypatch.setenv("RAFT_TLA_PREFETCH", "on")
    from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
    log = str(tmp_path / "ddd.events")
    eng = DDDEngine(CFG, DDDCapacities(block=256, table=1 << 14,
                                       flush=1 << 8, levels=64),
                    device="cpu")
    res = eng.check(events=log)
    assert (res.n_states, res.diameter) == (3014, 17)
    evs = [json.loads(ln) for ln in open(log)]
    assert all(validate_event(e) == [] == jvalidate(e) for e in evs)
    segs = [e for e in evs if e["event"] == "segment"]
    phases = set().union(*(s.get("phase_s", {}) for s in segs))
    assert {"expand", "export", "upload", "dedup_wait",
            "dedup@raft-tla-flush"} <= phases
    spans = [e for e in evs if e["event"] == "span"]
    assert {"expand", "export", "upload", "dedup"} <= \
        {s["name"] for s in spans}
    assert {"MainThread", "raft-tla-flush", "raft-tla-prefetch"} <= \
        {s["thread"] for s in spans}

    col = collect.collect(collect.find_logs(str(tmp_path)))
    assert col == jcollect.collect(jcollect.find_logs(str(tmp_path)))
    rep = collect.report(col)
    assert rep == jcollect.report(col)
    assert collect.render_report(rep) == jcollect.render_report(rep)
    (proc,) = rep["processes"]
    assert proc["threads"]["MainThread"]["attributed_frac"] > 0.5
    assert proc["threads"]["raft-tla-flush"]["attributed_frac"] > 0
    out, jout = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert perfetto.export(col, out) == jperfetto.export(col, jout)
    assert json.load(open(out)) == json.load(open(jout))

    from raft_tla_tpu_torch.obs.tracecli import main as trace_main
    assert trace_main(["export", str(tmp_path), "-o", out]) == 0
    assert any(e["ph"] == "X" for e in json.load(open(out))["traceEvents"])
    assert trace_main(["collect", log]) == 0
    assert trace_main(["report", str(tmp_path), "--json"]) == 0
    assert trace_main(["report", str(tmp_path / "nothing-here")]) == 1


@pytest.mark.parametrize("timers", [False, True])
def test_phase_handles_off_path_and_trace_only(timers, monkeypatch):
    """Off: one shared handle, no span, nothing accumulated.  Trace-only:
    spans without accumulation or waits.  Timers: both."""
    from raft_tla_tpu_torch.obs.phases import _NULL, PhaseTimers
    pt = PhaseTimers(enabled=False)
    assert pt.phase("expand") is _NULL and pt.phase("x") is _NULL
    tr, rows = _capture()
    pt = PhaseTimers(enabled=timers)
    pt.tracer = tr
    with pt.phase("expand") as ph:
        assert ph.sync(torch.zeros(3)) is not None
    assert [r["name"] for r in rows] == ["expand"]
    assert set(pt.snapshot()) == ({"expand"} if timers else set())
