"""The port's fault-isolated serving (``serve/pool.py``, ``supervise.py``,
``chaos.py``) on the CPU.

Two live pool runs, each worker a ``python -m raft_tla_tpu_torch.serve``
child that imports torch: a worker SIGKILLed mid-dispatch leaves every
job's canonical results record and tenant event log equal to an
unsupervised in-process pass; a job that kills every worker it rides is
bisected to and quarantined within K deaths while its cellmates complete.
The rest is host-only: death classification (torch's CUDA out-of-memory
texts are ``oom``, as the reference classifies its allocator failures),
partitioning by bin as the reference partitions, torn results tails,
terminal statuses, the drain of undispatched jobs, per-job wall budgets
and the daemon's restart dedup.
"""

import json
import os

import pytest
import torch

from raft_tla_tpu.serve import supervise as jsupervise
from raft_tla_tpu.serve.jobs import admit as jadmit
from raft_tla_tpu.serve.jobs import CheckJob as JCheckJob
from raft_tla_tpu.serve.jobs import JobOptions as JJobOptions
from raft_tla_tpu.serve.pool import _partition as j_partition

from raft_tla_tpu_torch.serve.chaos import (PoolChaos, canon_events,
                                            canon_record)
from raft_tla_tpu_torch.serve.jobs import CheckJob, JobOptions, admit
from raft_tla_tpu_torch.serve.pool import _partition, run_pool
from raft_tla_tpu_torch.serve.service import (read_results,
                                              record_is_terminal,
                                              run_daemon, run_service)
from raft_tla_tpu_torch.serve.supervise import PoolPolicy, classify_death

torch.set_num_threads(1)

_CFG = ("SPECIFICATION Spec\nINVARIANT NoTwoLeaders\nCONSTANTS\n"
        "    Server = {s1, s2}\n    Value = {v1}\n")
# the 524-state election universe (max_msgs 1): the cheapest real check
OPT = dict(spec="election", max_term=2, max_log=0, max_msgs=1)
FAST = PoolPolicy(poll_s=0.02, backoff_base_s=0.05, backoff_cap_s=0.2,
                  backoff_jitter_seed=7)


def _jobs(cfg, ids, alternate=True, cls=(CheckJob, JobOptions)):
    """Jobs over one cfg; ``alternate`` flips symmetry on odd indices so
    the batch spans two bins."""
    job, opts = cls
    return [job(j, opts(symmetry=bool(alternate and i % 2), **OPT),
                cfg_path=str(cfg)) for i, j in enumerate(ids)]


@pytest.fixture
def cfg(tmp_path):
    p = tmp_path / "toy.cfg"
    p.write_text(_CFG)
    return p


def test_classify_death_kinds_and_cuda_oom():
    texts = ["", "usage: ...", "MemoryError: ...", "std::bad_alloc",
             "Traceback ...\nValueError: x"]
    for rc in (-9, -11, -15, 1, 2, 134):
        for t in texts:
            assert classify_death(rc, t) == jsupervise.classify_death(rc, t)
    # torch's allocator and the CUDA runtime: out of memory, not a poison
    for t in ("torch.OutOfMemoryError: CUDA out of memory. Tried to "
              "allocate 2.00 GiB. GPU 0 has a total capacity of 79.19 GiB",
              "RuntimeError: CUDA error: out of memory\nCUDA kernel "
              "errors might be asynchronously reported",
              "step kernel launch: CUDA error 2 (cudaErrorMemoryAllocation)"):
        assert classify_death(1, t)[0] == "oom", t
        assert classify_death(-6, t)[0] == "oom", t
    assert classify_death(-9)[0] == "killed"
    assert classify_death(-11)[0] == "segfault"


def test_partition_equals_reference(cfg):
    for ids, alt, workers in ((["a", "b", "c", "d"], True, 2),
                              (["x", "y", "z"], False, 2),
                              (["p", "q", "r", "s", "t"], True, 3)):
        port = _partition([(j, admit(j), {}) for j in
                           _jobs(cfg, ids, alt)], workers, "cpu")
        ref = j_partition([(j, jadmit(j), {}) for j in
                           _jobs(cfg, ids, alt, (JCheckJob, JJobOptions))],
                          workers)
        assert [[pj.job_id for pj in g] for g in port] == \
            [[pj.job_id for pj in g] for g in ref]


def test_torn_results_tail_and_terminal_statuses(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    good = {"job_id": "a", "status": "completed", "digest": "d1"}
    with open(out / "results.jsonl", "w") as f:
        f.write(json.dumps(good) + "\n" + "garbage not json\n"
                + json.dumps({"no_job_id": True}) + "\n"
                + '{"job_id": "torn", "status": "comp')
    assert read_results(str(out)) == [good]
    assert read_results(str(tmp_path / "missing")) == []
    for st in ("completed", "violation", "deadlock", "rejected",
               "quarantined"):
        assert record_is_terminal({"status": st})
    assert not record_is_terminal({"status": "stopped",
                                   "error": "stop requested (drain)"})
    assert not record_is_terminal({"status": "stopped",
                                   "error": "step build failed for bin0"})
    assert record_is_terminal({"status": "stopped",
                               "error": "budget-exceeded: wall 1.2s"})


def test_pool_parity_under_worker_sigkill(cfg, tmp_path):
    """SIGKILL a worker mid-dispatch: every job still completes, records
    and tenant logs canonically equal to the in-process pass."""
    jobs = _jobs(cfg, ["j0", "j1", "j2", "j3"])
    ref = {r["job_id"]: r for r in run_service(
        jobs, str(tmp_path / "ref"), chunk=256, quiet=True, device="cpu")}
    chaos = PoolChaos(kill_after_events=2)
    recs = run_pool(jobs, str(tmp_path / "pool"), workers=2, chunk=256,
                    device="cpu", quiet=True, policy=FAST,
                    spawn_hook=chaos.spawn_hook)
    assert chaos.kills and chaos.kills[0][1] == "kill-after-events"
    by = {r["job_id"]: r for r in recs}
    for job in jobs:
        jid = job.job_id
        assert by[jid]["status"] == "completed"
        assert by[jid]["n_states"] == (524 if jid in ("j0", "j2") else 267)
        assert canon_record(ref[jid]) == canon_record(by[jid])
        assert canon_events(str(tmp_path / "ref" / f"{jid}.events")) \
            == canon_events(str(tmp_path / "pool" / f"{jid}.events"))
    pool_events = [json.loads(l) for l in
                   open(tmp_path / "pool" / "pool.events")]
    kinds = [e["event"] for e in pool_events]
    assert kinds.count("worker_lost") >= 1
    assert "job_retry" in kinds and "quarantine" not in kinds


def test_pool_poison_bisection_quarantine(cfg, tmp_path):
    jobs = _jobs(cfg, ["i0", "poison", "i2"], alternate=False)
    out = str(tmp_path / "out")
    K = 2
    chaos = PoolChaos(poison="poison")
    recs = run_pool(jobs, out, workers=2, chunk=256, device="cpu",
                    quiet=True,
                    policy=PoolPolicy(poll_s=0.02, backoff_base_s=0.05,
                                      backoff_cap_s=0.2,
                                      backoff_jitter_seed=7,
                                      max_job_deaths=K),
                    spawn_hook=chaos.spawn_hook)
    by = {r["job_id"]: r for r in recs}
    assert by["poison"]["status"] == "quarantined"
    assert by["poison"]["reason"] == "poison-job"
    assert by["poison"]["deaths"] <= K and len(chaos.kills) == K
    assert record_is_terminal(by["poison"])
    assert by["i0"]["status"] == by["i2"]["status"] == "completed"
    assert by["i0"]["n_states"] == by["i2"]["n_states"] == 524
    ev = [json.loads(l) for l in open(os.path.join(out, "poison.events"))]
    assert ev[-1]["event"] == "run_end"
    assert ev[-1]["outcome"] == "quarantined"


def test_pool_drain_and_no_gpu(cfg, tmp_path, monkeypatch):
    """stop() truthy before any spawn: no worker starts and every job has
    an attributed, non-terminal record.  ``device='cuda'`` without a GPU
    raises before any spawn."""
    jobs = _jobs(cfg, ["a", "b"])
    recs = run_pool(jobs, str(tmp_path / "out"), workers=2, device="cpu",
                    quiet=True, policy=FAST, stop=lambda: True)
    assert len(recs) == 2
    for r in recs:
        assert r["status"] == "stopped"
        assert "never reached a worker" in r["error"]
        assert not record_is_terminal(r)
        ev = [json.loads(l) for l in open(r["events"])]
        assert ev[-1]["outcome"] == "stopped"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch sees no GPU"):
        run_pool(jobs, str(tmp_path / "o2"), workers=2, quiet=True)
    assert not os.path.exists(tmp_path / "o2" / "pool")


def test_wall_budget_and_daemon_restart_dedup(cfg, tmp_path):
    """``wall_s`` stops a lane losslessly with a terminal record while its
    cellmate completes; a restarted daemon re-runs no terminal digest."""
    jobs = [CheckJob("fast", JobOptions(**OPT), cfg_path=str(cfg)),
            CheckJob("capped", JobOptions(wall_s=1e-4, **OPT),
                     cfg_path=str(cfg))]
    by = {r["job_id"]: r for r in run_service(
        jobs, str(tmp_path / "out"), chunk=256, quiet=True, device="cpu")}
    assert by["fast"]["status"] == "completed"
    assert by["capped"]["error"].startswith("budget-exceeded")
    assert record_is_terminal(by["capped"])
    q = tmp_path / "q"
    q.mkdir()
    (q / "toy.cfg").write_text(_CFG)
    (q / "001-a.json").write_text(json.dumps(dict(id="a", cfg="toy.cfg",
                                                  **OPT)))
    out = str(tmp_path / "d")
    for _ in range(2):
        assert run_daemon(str(q), out, chunk=256, quiet=True, poll_s=0.05,
                          max_idle_polls=2, device="cpu") == 0
    assert [r["status"] for r in read_results(out)] == ["completed"]


def test_chaos_cli_spells_device(cfg, tmp_path, capsys):
    from raft_tla_tpu_torch.serve import chaos
    with pytest.raises(SystemExit) as e:
        chaos.main([str(cfg), "--workdir", str(tmp_path), "--cpu"])
    assert e.value.code == 2
    assert "--cpu is spelled --device cpu" in capsys.readouterr().err
