"""The port's pipelined dispatch scheduler (``serve/sched.py``) on the CPU.

The scheduler changes WHEN work runs, never WHAT it computes: depth 2 with
bin builds on background threads leaves every tenant's records and event
stream identical to the depth-1 synchronous baseline, and every lane equal
to a solo ``Engine`` at depths 1, 2 and 3.  Deficit-round-robin packing
plans exactly the reference's takes and keeps its starvation bound; bin
builds run off the dispatch thread; the bin key ignores ``chunk`` and
follows the step's gate resolutions; the daemon's drain hook gives every
accepted lane an attributed record, through ``--watch`` and SIGINT too.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

from raft_tla_tpu.serve.sched import DispatchScheduler as JScheduler

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.engine import Engine
from raft_tla_tpu_torch.serve import CheckJob, JobOptions
from raft_tla_tpu_torch.serve.batch import BatchExecutor, _Bin, bin_key
from raft_tla_tpu_torch.serve.sched import DispatchScheduler
from raft_tla_tpu_torch.serve.service import run_service

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG_TEXT = ("SPECIFICATION Spec\nINVARIANT NoTwoLeaders\nCONSTANTS\n"
             "    Server = {s1, s2}\n    Value = {v1}\n")


def _cfg(**kw):
    b = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
    sym = kw.pop("symmetry", ())
    b.update(kw)
    return CheckConfig(bounds=Bounds(**b), spec="election",
                       invariants=("NoTwoLeaders",), symmetry=sym,
                       chunk=256)


TOY_M1 = _cfg(max_msgs=1)               # 524 states
TOY_M1S = _cfg(max_msgs=1, symmetry=("Server",))
TOY = _cfg()                            # 3,014 states
TOY_SYM = _cfg(symmetry=("Server",))

# Everything that varies run to run without changing WHAT was computed.
_VOLATILE = frozenset({"ts", "wall_s", "states_per_sec",
                       "inc_states_per_sec", "admission_s", "inflight",
                       "phase_s", "pid", "git_sha", "anchor", "events"})


def _scrub(d):
    return {k: v for k, v in d.items() if k not in _VOLATILE}


def test_interleaved_matches_sequential(tmp_path):
    """Ten jobs over four bins: depth 2 with async builds against depth 1
    with builds on the dispatch path — every results record and every
    tenant event line equal, scrubbed of timings only."""
    kws = ([dict(max_msgs=1)] * 4 + [dict(max_msgs=1, symmetry=True)] * 3
           + [dict()] * 2 + [dict(symmetry=True)])
    jobs = [CheckJob(f"j{i}", JobOptions(spec="election", max_term=2,
                                         max_log=0, **kw),
                     cfg_text=_CFG_TEXT) for i, kw in enumerate(kws)]
    arms = {}
    for name, depth, async_ in (("seq", 1, False), ("pipe", 2, True)):
        out = tmp_path / name
        st = {}
        recs = run_service(jobs, str(out), chunk=128, quiet=True,
                           depth=depth, compile_async=async_,
                           device="cpu", stats=st)
        logs = {r["job_id"]: [_scrub(json.loads(l)) for l in
                              open(r["events"])] for r in recs}
        arms[name] = ({r["job_id"]: _scrub(r) for r in recs}, logs, st)
    assert arms["seq"][0] == arms["pipe"][0]
    assert arms["seq"][1] == arms["pipe"][1]
    assert arms["seq"][2]["peak_inflight"] == 1
    assert arms["pipe"][2]["peak_inflight"] == 2
    assert arms["seq"][2]["async_compiles"] == 0
    assert arms["pipe"][2]["async_compiles"] == 4


def test_executor_parity_vs_solo_all_depths():
    solo = {jid: Engine(cfg, device="cpu").check()
            for jid, cfg in [("a", TOY_M1), ("s", TOY_M1S)]}
    for depth in (1, 2, 3):
        out = BatchExecutor(chunk=128, depth=depth, device="cpu").run(
            [("a", TOY_M1), ("s", TOY_M1S)])
        for jid, ref in solo.items():
            got = out[jid].result
            assert out[jid].status == "completed", (depth, jid)
            assert (got.n_states, got.diameter, got.n_transitions,
                    list(got.levels), dict(got.coverage)) == \
                (ref.n_states, ref.diameter, ref.n_transitions,
                 list(ref.levels), dict(ref.coverage)), (depth, jid)


class _StubLane:
    def __init__(self, jid, pending):
        self.job_id = jid
        self._pending = pending

    def pending_rows(self):
        return self._pending


def _drive(sched, chunk, pendings, dispatches):
    """Run ``_plan_takes`` repeatedly on stub lanes, applying the takes;
    returns the plans as ``[[(lane id, take)]]``."""
    lanes = [_StubLane(f"l{i}", p) for i, p in enumerate(pendings)]
    st = types.SimpleNamespace(rr=0, deficit={})
    plans = []
    for _ in range(dispatches):
        live = [ln for ln in lanes if ln.pending_rows() > 0]
        if not live:
            break
        plan = sched._plan_takes(st, live)
        assert sum(t for _ln, t in plan) <= chunk
        for ln, t in plan:
            assert 0 < t <= ln.pending_rows()
            ln._pending -= t
        plans.append([(ln.job_id, t) for ln, t in plan])
    return plans


@pytest.mark.parametrize("chunk,pendings", [
    (4, [40] * 16), (64, [1000, 3, 100]), (8, [5, 0, 70, 9, 1, 33]),
    (7, [13, 2, 29, 8])], ids=["over", "under", "ragged", "prime"])
def test_drr_plans_equal_reference(chunk, pendings):
    port = _drive(DispatchScheduler(chunk=chunk, depth=1, device="cpu"),
                  chunk, pendings, 200)
    ref = _drive(JScheduler(chunk=chunk, depth=1, compile_async=False),
                 chunk, pendings, 200)
    assert port == ref
    if chunk == 4:
        # the starvation bound: every lane rides within ceil(n / B)
        # consecutive dispatches, and the chunk is full while work remains
        window = -(-len(pendings) // chunk)
        served = [{j for j, _t in p} for p in port[:40]]  # none drained
        for w0 in range(len(served) - window + 1):
            assert set().union(*served[w0:w0 + window]) == \
                {f"l{i}" for i in range(len(pendings))}
        assert all(sum(t for _j, t in p) == chunk for p in port[:8])


def test_depth_validation_and_bin_key(monkeypatch):
    with pytest.raises(ValueError, match="depth"):
        DispatchScheduler(chunk=64, depth=0, device="cpu")
    rechunked = CheckConfig(bounds=TOY.bounds, spec="election",
                            invariants=("NoTwoLeaders",), chunk=64)
    assert bin_key(TOY, "cpu") == bin_key(rechunked, "cpu")
    assert bin_key(TOY, "cpu") != bin_key(TOY_SYM, "cpu")
    # the prescan resolves per device (|G| = 2: on for the CPU, off for
    # the card), and a flipped gate makes another bin
    auto = bin_key(TOY_SYM, "cpu")
    assert dict(auto[5:9])["prescan"] is True
    assert dict(bin_key(TOY_SYM, "cuda")[5:9])["prescan"] is False
    monkeypatch.setenv("RAFT_TLA_PRESCAN", "off")
    off = bin_key(TOY_SYM, "cpu")
    assert off != auto and dict(off[5:9])["prescan"] is False
    # the step carries the signature it was built with
    step = _Bin(off, TOY_SYM, "cpu").build()
    assert step.signature + (TOY_SYM.check_deadlock,) == off


def test_builds_run_off_the_dispatch_thread(monkeypatch):
    """Every bin builds on its own ``serve-compile-*`` thread; a slow
    build does not hold the other bin's dispatches."""
    names, order = {}, []
    real = _Bin.build

    def build(self):
        names[self.tag] = threading.current_thread().name
        if self.tag == "bin0":
            time.sleep(0.5)
        order.append(self.tag)
        return real(self)

    monkeypatch.setattr(_Bin, "build", build)
    ex = BatchExecutor(chunk=128, depth=2, device="cpu")
    out = ex.run([("slow", TOY_M1), ("fast", TOY_M1S)])
    assert names == {"bin0": "serve-compile-bin0",
                     "bin1": "serve-compile-bin1"}
    assert order == ["bin1", "bin0"]
    st = ex.last_stats
    assert st["async_compiles"] == 2 and st["compile_wall_s"]["bin0"] >= 0.5
    assert {oc.status for oc in out.values()} == {"completed"}


def test_executor_stop_drains_with_attribution():
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > 4

    out = BatchExecutor(chunk=64, depth=2, stop=stop, device="cpu").run(
        [("a", TOY), ("b", TOY_SYM)])
    assert set(out) == {"a", "b"}
    for oc in out.values():
        assert oc.status in ("completed", "stopped")
        if oc.status == "stopped":
            assert "stop requested (drain)" in oc.error
            assert oc.result.complete is False
    assert any(oc.status == "stopped" for oc in out.values())


def test_daemon_watch_sigint_drain(tmp_path):
    """``--watch`` on a queue directory: a dropped job file is served
    while the daemon stays up, a duplicate id is rejected, and SIGINT
    drains to exit 0."""
    qdir, out = tmp_path / "q", tmp_path / "out"
    qdir.mkdir()
    job = {"id": "watched", "cfg_text": _CFG_TEXT, "spec": "election",
           "max_term": 2, "max_log": 0, "max_msgs": 1}
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_tla_tpu_torch.serve", str(qdir),
         "--watch", "--out", str(out), "--chunk", "64", "--poll", "0.2",
         "--device", "cpu", "--quiet"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def records():
        p = out / "results.jsonl"
        return [json.loads(l) for l in p.read_text().splitlines()] \
            if p.exists() else []

    try:
        (qdir / "001-a.json").write_text(json.dumps(job))
        deadline = time.monotonic() + 120
        while not any(r["job_id"] == "watched" for r in records()):
            assert proc.poll() is None and time.monotonic() < deadline, \
                proc.communicate()
            time.sleep(0.2)
        (qdir / "002-dup.json").write_text(json.dumps(job))
        while len([r for r in records() if r["job_id"] == "watched"]) < 2:
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        proc.send_signal(signal.SIGINT)
        _out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    first, dup = [r for r in records() if r["job_id"] == "watched"]
    assert first["status"] == "completed" and first["n_states"] == 524
    assert dup["status"] == "rejected" and dup["reason"] == "duplicate-id"
