"""The port's history store and regression sentinel (``obs/history.py``,
``obs/regress.py``, ``raft-tla-regress-torch``) against the JAX package's.

The shared drift policy gives the reference's verdicts on a grid of
baselines; bench and run records (from the committed ``BENCH_r0*.json``
drivers and from event logs) are the reference's records, keys included;
the store's baseline is the per-field median; and the CLI's exit codes are
the CI contract: 0 within tolerance, 2 usage, 3 no baseline, 4 drift —
including the mechanical reproduction of the recorded devdedup A/B
refutation from ``runs/devdedup_ab.out``.
"""

import json
import os

import pytest

from raft_tla_tpu.obs import history as jhistory

from raft_tla_tpu_torch.obs.events import append_event
from raft_tla_tpu_torch.obs.history import (HistoryStore, bench_record,
                                            drift_report, fiducial_drift,
                                            history_path, ingest_file,
                                            run_record)
from raft_tla_tpu_torch.obs.regress import (EXIT_DRIFT, EXIT_NO_BASELINE,
                                            EXIT_OK, EXIT_USAGE, main)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_FILES = sorted(
    os.path.join(REPO, f) for f in os.listdir(REPO)
    if f.startswith("BENCH_r") and f.endswith(".json"))
R05 = os.path.join(REPO, "BENCH_r05.json")


def _verdict(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_drift_policy_matches_reference():
    base = {"wall_s": 10.0, "orbits_per_sec": 100.0, "hit_rate": 0.5,
            "trace_emit_overhead_us": 0.1, "n": 3, "flag": True}
    for cur in ({"wall_s": 12.0, "orbits_per_sec": 50.0},
                {"wall_s": 30.0, "orbits_per_sec": 120.0, "hit_rate": 0.1},
                {"trace_emit_overhead_us": 9.0, "n": 3},
                {"wall_s": 0.0, "flag": False}):
        for gate in (0.0, 1.2, 2.5):
            assert fiducial_drift(base, cur, gate) == \
                jhistory.fiducial_drift(base, cur, gate)
            assert drift_report(base, cur, gate) == \
                jhistory.drift_report(base, cur, gate)


def test_records_match_reference(tmp_path):
    parsed = {"metric": "orbits_per_sec", "unit": "1/s", "value": 100.0}
    assert bench_record(parsed, ts=1.0) == jhistory.bench_record(parsed,
                                                                 ts=1.0)
    assert bench_record({"metric": "m", "unit": "u"}) is None
    p = str(tmp_path / "run.events")
    append_event(p, "run_start", ts=10.0, engine="device",
                 universe={"servers": 3, "values": 2}, spec="election",
                 invariants=["NoTwoLeaders"], resumed=False,
                 fiducials={"synthetic_step_ms": 12.0})
    append_event(p, "run_end", ts=110.0, n_states=1000, n_transitions=2000,
                 complete=True, outcome="ok", wall_s=100.0)
    (rec,) = ingest_file(p)
    assert [rec] == jhistory.ingest_file(p)
    assert rec["parsed"]["states_per_sec"] == 10.0
    events = [json.loads(line) for line in open(p)]
    assert run_record(events, "x") == jhistory.run_record(events, "x")
    for f in BENCH_FILES:
        assert ingest_file(f) == jhistory.ingest_file(f), f


def test_store_median_baseline_and_gate(tmp_path, monkeypatch):
    store = HistoryStore(str(tmp_path / "h.jsonl"))
    for wall in (100.0, 300.0, 120.0):
        store.append(bench_record({"metric": "m", "unit": "s",
                                   "wall_s": wall}, ts=wall))
    key = store.load()[0]["key"]
    assert store.baseline(key) == {"wall_s": 120.0}
    assert store.baseline("bench:nope") is None
    monkeypatch.delenv("RAFT_TLA_HISTORY", raising=False)
    assert history_path(None) is None
    monkeypatch.setenv("RAFT_TLA_HISTORY", "h2.jsonl")
    assert history_path(None) == "h2.jsonl" and history_path("x") == "x"


@pytest.fixture
def seeded(tmp_path):
    hist = str(tmp_path / "h.jsonl")
    assert main(["ingest", *BENCH_FILES, "--history", hist]) == EXIT_OK
    assert len(HistoryStore(hist).load()) == len(BENCH_FILES) - 1
    return hist


def test_check_clean_rerun_exit_0(seeded, capsys):
    capsys.readouterr()
    assert main(["check", R05, "--history", seeded]) == EXIT_OK
    v = _verdict(capsys)
    assert v["verdict"] == "ok" and v["drifted"] == []


def test_check_planted_drift_exit_4(seeded, tmp_path, capsys):
    doc = json.load(open(R05))
    for k, v in list(doc["parsed"].items()):
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and ("wall" in k or "_ms" in k):
            doc["parsed"][k] = v * 10.0
    bad = tmp_path / "slow.json"
    bad.write_text(json.dumps(doc))
    capsys.readouterr()
    assert main(["check", str(bad), "--history", seeded]) == EXIT_DRIFT
    v = _verdict(capsys)
    assert v["verdict"] == "drift" and v["worst"][1] > 5.0


def test_check_no_baseline_exit_3_and_usage_exit_2(tmp_path, capsys,
                                                   monkeypatch):
    hist = tmp_path / "empty.jsonl"
    hist.write_text("")
    assert main(["check", R05, "--history", str(hist)]) == EXIT_NO_BASELINE
    assert _verdict(capsys)["verdict"] == "no-baseline"
    monkeypatch.delenv("RAFT_TLA_HISTORY", raising=False)
    assert main(["check", R05]) == EXIT_USAGE
    assert main(["ingest", R05]) == EXIT_USAGE
    capsys.readouterr()


@pytest.mark.parametrize("name,code", [("devdedup_ab.out", EXIT_DRIFT),
                                       ("bench_obs_ab.out", EXIT_OK)])
def test_ab_verdicts(name, code, capsys):
    capsys.readouterr()
    assert main(["ab", os.path.join(REPO, "runs", name)]) == code
    v = _verdict(capsys)
    if code == EXIT_DRIFT:
        rates = {k: r for k, r in v["keys"].items()
                 if "full.on_vs_off_warm_rate" in k}
        assert rates and all(abs(r["ratio"] - 0.444) < 0.01
                             for r in rates.values())
    else:
        assert v["keys"]["events_over_off"]["ratio"] < 1.1
