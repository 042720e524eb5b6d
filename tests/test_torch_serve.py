"""The port's serving path (``raft_tla_tpu_torch/serve/``) against the JAX
package's, on the CPU.

One manifest — six jobs in four bins: the 3,014-state toy twice, its
Server quotient, two-phase commit at 3 RMs, a seeded violation (``count(role
= 2) <= 0``: the first leader breaks it) and a width-unsafe job rejected at
admission — goes through the JAX ``run_service`` once (a module fixture)
and through the port's ``run_service(device="cpu")``.  Their results
records and tenant event logs are equal in canonical form
(``serve/chaos.canon_record`` / ``canon_events``: timings, pids and paths
stripped), and so is each job's content digest.  Every completing lane
equals a solo port ``Engine`` run of the same cfg; the violating lane's
verdict and trace equal the solo run's; pipeline depths 1, 2 and 3 give
the same records and logs.  A step build that raises (the nvcc error, here
monkeypatched) stops its bin's lanes with that error and the service exits
1; nothing falls back.
"""

import json
import os

import pytest
import torch

from raft_tla_tpu.serve import jobs as jjobs
from raft_tla_tpu.serve.service import load_jobs as jload_jobs
from raft_tla_tpu.serve.service import run_service as jrun_service

from raft_tla_tpu_torch.engine import Engine
from raft_tla_tpu_torch.serve import jobs
from raft_tla_tpu_torch.serve import service
from raft_tla_tpu_torch.serve.chaos import (canon_events, canon_record,
                                            last_records)
from raft_tla_tpu_torch.serve.service import load_jobs, run_service

torch.set_num_threads(1)

_CONSTANTS = "CONSTANTS\n    Server = {s1, s2}\n    Value = {v1}\n"
TOY = {"spec": "election", "max_term": 2, "max_log": 0, "max_msgs": 2}
IDS = ("toy-a", "toy-b", "sym", "tp", "viol", "wide")


def write_manifest(d) -> str:
    (d / "toy.cfg").write_text("SPECIFICATION Spec\nINVARIANT NoTwoLeaders\n"
                               + _CONSTANTS)
    (d / "viol.cfg").write_text(
        "SPECIFICATION Spec\nINVARIANT NoTwoLeaders\n"
        "INVARIANT count(role = 2) <= 0\n" + _CONSTANTS)
    tp = ("SPECIFICATION Spec\nINVARIANT TCConsistent\n"
          "CONSTANT RM = {r1, r2, r3}\n")
    lines = [dict(id="toy-a", cfg="toy.cfg", **TOY),
             dict(id="toy-b", cfg="toy.cfg", **TOY),
             dict(id="sym", cfg="toy.cfg", symmetry=True, **TOY),
             dict(id="tp", cfg_text=tp, spec="twophase"),
             dict(id="viol", cfg="viol.cfg", **TOY),
             dict(id="wide", cfg="toy.cfg", **dict(TOY, max_term=99))]
    path = d / "jobs.jsonl"
    path.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's pass and the port's (depth 2), same manifest."""
    d = tmp_path_factory.mktemp("serve")
    manifest = write_manifest(d)
    jrun_service(jload_jobs(manifest), str(d / "jax"), chunk=256,
                 quiet=True)
    stats = {}
    recs = run_service(load_jobs(manifest), str(d / "port"), chunk=256,
                       quiet=True, device="cpu", stats=stats)
    return {"dir": d, "manifest": manifest, "recs": recs, "stats": stats}


def _canon(out_dir) -> dict:
    return {jid: (canon_record(r), canon_events(r["events"]))
            for jid, r in last_records(str(out_dir)).items()}


def test_records_and_event_logs_match_reference(runs):
    d = runs["dir"]
    port, ref = _canon(d / "port"), _canon(d / "jax")
    assert set(port) == set(ref) == set(IDS)
    for jid in IDS:
        assert port[jid][0] == ref[jid][0], jid
        assert port[jid][1] == ref[jid][1], jid
    by = {r["job_id"]: r for r in runs["recs"]}
    assert [by[j]["status"] for j in IDS] == [
        "completed", "completed", "completed", "completed", "violation",
        "rejected"]
    assert by["wide"]["reason"] == "width-unsafe" and by["wide"]["findings"]
    assert by["toy-a"]["n_states"] == 3014 and by["sym"]["n_states"] == 1514
    assert by["tp"]["n_states"] == 288


def test_job_digests_and_dicts_match_reference(runs):
    port = {j.job_id: j for j in load_jobs(runs["manifest"])}
    ref = {j.job_id: j for j in jload_jobs(runs["manifest"])}
    for jid in IDS:
        assert port[jid].digest() == ref[jid].digest(), jid
        assert port[jid].to_dict() == ref[jid].to_dict(), jid
        again = jobs.CheckJob.from_dict(port[jid].to_dict())
        assert again.digest() == port[jid].digest()
    assert jjobs.CheckJob.from_dict(port["tp"].to_dict()).digest() \
        == port["tp"].digest()


def test_lanes_equal_solo_engine(runs):
    """Each completing lane's counts, levels and coverage are a solo port
    Engine's on the same cfg; the violating lane's verdict and trace are
    the solo run's."""
    by = {r["job_id"]: r for r in runs["recs"]}
    for job in load_jobs(runs["manifest"]):
        adm = jobs.admit(job)
        if not adm.admitted:
            continue
        solo = Engine(adm.config, device="cpu").check()
        rec = by[job.job_id]
        if job.job_id == "viol":
            assert rec["violation"] == solo.violation.invariant \
                == "count(role = 2) <= 0"
            continue
        assert (rec["n_states"], rec["diameter"], rec["n_transitions"],
                rec["levels"]) == (solo.n_states, solo.diameter,
                                   solo.n_transitions, solo.levels)
    # the trace itself, through the executor the service drives
    from raft_tla_tpu_torch.serve.batch import BatchExecutor
    viol = jobs.admit(next(j for j in load_jobs(runs["manifest"])
                           if j.job_id == "viol")).config
    out = BatchExecutor(chunk=256, device="cpu").run([("viol", viol)])
    solo = Engine(viol, device="cpu").check()
    assert out["viol"].status == "violation"
    assert out["viol"].result.violation.trace == solo.violation.trace
    assert out["viol"].result.violation.state == solo.violation.state


@pytest.mark.parametrize("depth", [1, 3])
def test_pipeline_depths_give_identical_results(runs, tmp_path, depth):
    out = tmp_path / f"d{depth}"
    run_service(load_jobs(runs["manifest"]), str(out), chunk=256,
                quiet=True, device="cpu", depth=depth,
                compile_async=depth > 1)
    assert _canon(out) == _canon(runs["dir"] / "port")


def test_scheduler_stats(runs):
    st = runs["stats"]
    assert st["dispatches"] > 0 and 1 <= st["peak_inflight"] <= 2
    # four bins built, each on its own thread
    assert st["async_compiles"] == 4 == len(st["compile_wall_s"])
    assert sum(b["dispatches"] for b in st["bins"].values()) \
        == st["dispatches"]
    assert all(b["error"] is None for b in st["bins"].values())


def test_build_failure_fails_its_bin_with_the_error(runs, tmp_path,
                                                     monkeypatch):
    """K1's build raising stops the Raft bins' lanes with the nvcc text in
    their records (no fallback step runs), the twophase bin completes,
    and the CLI exits 1."""
    from raft_tla_tpu_torch.ops import kernels, pallas_step

    def broken(*a, **kw):
        raise RuntimeError("nvcc failed (2) building libstep-x.so:\n"
                           "ptxas fatal   : planted")
    monkeypatch.setattr(pallas_step, "build_step", broken)
    calls = kernels.calls
    out = tmp_path / "out"
    code = service.main([runs["manifest"], "--out", str(out), "--device",
                         "cpu", "--chunk", "256", "--quiet"])
    assert code == 1
    by = last_records(str(out))
    for jid in ("toy-a", "toy-b", "sym", "viol"):
        assert by[jid]["status"] == "stopped", jid
        assert "step build failed" in by[jid]["error"]
        assert "ptxas fatal   : planted" in by[jid]["error"]
        assert by[jid]["n_states"] == 1        # Init only, nothing ran
    assert by["tp"]["status"] == "completed" and by["tp"]["n_states"] == 288
    assert kernels.calls == calls              # no plain Raft step either


def test_cli_device_spelling_and_no_gpu(runs, tmp_path, monkeypatch,
                                        capsys):
    with pytest.raises(SystemExit) as e:
        service.main([runs["manifest"], "--cpu"])
    assert e.value.code == 2
    assert "--cpu is spelled --device cpu" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert service.main([runs["manifest"], "--out",
                         str(tmp_path / "o")]) == 1
    assert "torch sees no GPU" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="torch sees no GPU"):
        run_service(load_jobs(runs["manifest"]), str(tmp_path / "o2"),
                    quiet=True)
    assert not os.path.exists(tmp_path / "o2")


def test_compile_cache_points_the_library_directory(tmp_path, monkeypatch):
    """``--compile-cache DIR`` (and RAFT_TLA_COMPILE_CACHE) move the
    kernel libraries' directory, in the check CLI too, and are inherited
    by child processes through the environment."""
    from raft_tla_tpu_torch import check
    from raft_tla_tpu_torch.ops import build
    from raft_tla_tpu_torch.serve.sched import (ENV_COMPILE_CACHE,
                                                enable_compile_cache)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.delenv(ENV_COMPILE_CACHE, raising=False)
    assert enable_compile_cache(None) is None
    cache = tmp_path / "cache"
    monkeypatch.setenv(ENV_COMPILE_CACHE, str(cache))
    assert enable_compile_cache(None) == str(cache)
    assert build.BUILD_DIR == cache and cache.is_dir()
    other = tmp_path / "other"
    cfg = tmp_path / "toy.cfg"
    cfg.write_text("SPECIFICATION Spec\nINVARIANT NoTwoLeaders\n"
                   + _CONSTANTS)
    code, _, res = check.run([str(cfg), "--device", "cpu", "--spec",
                              "election", "--max-term", "2", "--max-log",
                              "0", "--max-msgs", "2", "--compile-cache",
                              str(other)])
    assert code == 0 and res.n_states == 3014
    assert build.BUILD_DIR == other and os.environ[ENV_COMPILE_CACHE] \
        == str(other)
