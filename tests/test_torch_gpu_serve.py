"""The serving path on the card.

Marked ``gpu``: they skip where torch sees no CUDA device.  They import
neither JAX nor the reference::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_serve.py -q

One manifest (the 3,014-state toy twice, its Server quotient, two-phase
commit at 3 RMs and a seeded violation) served on the card: every
completing lane equals a solo ``Engine`` on the card, the violating
lane's trace is the solo run's, K1 and K2 launched and no plain step or
orbit key ran; depths 1 and 2 give the same canonical records and logs;
a K1 build that raises stops its bins' lanes with the error and nothing
falls back.  ``chip_smoke.py`` phase 20 runs the same at full size.
"""

import json

import pytest
import torch

from raft_tla_tpu_torch.engine import Engine
from raft_tla_tpu_torch.ops import kernels, pallas_fp, pallas_step
from raft_tla_tpu_torch.ops import symmetry as sym
from raft_tla_tpu_torch.serve import jobs
from raft_tla_tpu_torch.serve.batch import BatchExecutor
from raft_tla_tpu_torch.serve.chaos import (canon_events, canon_record,
                                            last_records)
from raft_tla_tpu_torch.serve.service import load_jobs, run_service

pytestmark = pytest.mark.gpu

_CONSTANTS = "CONSTANTS\n    Server = {s1, s2}\n    Value = {v1}\n"
TOY = {"spec": "election", "max_term": 2, "max_log": 0, "max_msgs": 2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture
def manifest(tmp_path):
    (tmp_path / "toy.cfg").write_text(
        "SPECIFICATION Spec\nINVARIANT NoTwoLeaders\n" + _CONSTANTS)
    (tmp_path / "viol.cfg").write_text(
        "SPECIFICATION Spec\nINVARIANT NoTwoLeaders\n"
        "INVARIANT count(role = 2) <= 0\n" + _CONSTANTS)
    tp = ("SPECIFICATION Spec\nINVARIANT TCConsistent\n"
          "CONSTANT RM = {r1, r2, r3}\n")
    lines = [dict(id="toy-a", cfg="toy.cfg", **TOY),
             dict(id="toy-b", cfg="toy.cfg", **TOY),
             dict(id="sym", cfg="toy.cfg", symmetry=True, **TOY),
             dict(id="tp", cfg_text=tp, spec="twophase"),
             dict(id="viol", cfg="viol.cfg", **TOY)]
    path = tmp_path / "jobs.jsonl"
    path.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return str(path)


def _reset():
    pallas_step.launches = pallas_fp.launches = 0
    kernels.calls = sym.plain_calls = 0


def test_lanes_equal_solo_runs_on_the_card(cuda, manifest, tmp_path):
    _reset()
    stats = {}
    recs = {r["job_id"]: r for r in run_service(
        load_jobs(manifest), str(tmp_path / "out"), chunk=1024,
        quiet=True, stats=stats)}
    assert pallas_step.launches > 0 and pallas_fp.launches > 0
    assert kernels.calls == 0 and sym.plain_calls == 0
    assert stats["async_compiles"] == 4 and stats["dispatches"] > 0
    for job in load_jobs(manifest):
        config = jobs.admit(job).config
        solo = Engine(config, device=cuda).check()
        rec = recs[job.job_id]
        if job.job_id == "viol":
            out = BatchExecutor(chunk=1024, device=cuda).run(
                [("viol", config)])["viol"]
            assert out.status == "violation"
            assert out.result.violation.trace == solo.violation.trace
            continue
        assert rec["status"] == "completed"
        assert (rec["n_states"], rec["diameter"], rec["n_transitions"],
                rec["levels"]) == (solo.n_states, solo.diameter,
                                   solo.n_transitions, solo.levels)


def test_depths_give_the_same_artifacts(cuda, manifest, tmp_path):
    canon = []
    for depth in (1, 2):
        out = tmp_path / f"d{depth}"
        run_service(load_jobs(manifest), str(out), chunk=256, quiet=True,
                    depth=depth, compile_async=depth > 1)
        canon.append({j: (canon_record(r), canon_events(r["events"]))
                      for j, r in last_records(str(out)).items()})
    assert canon[0] == canon[1]


def test_k1_build_failure_stops_its_lanes(cuda, manifest, tmp_path,
                                          monkeypatch):
    def broken(bounds):
        raise RuntimeError("nvcc failed (2) building libstep: planted")
    monkeypatch.setattr(pallas_step, "_lib", broken)
    _reset()
    recs = {r["job_id"]: r for r in run_service(
        load_jobs(manifest), str(tmp_path / "out"), quiet=True)}
    for jid in ("toy-a", "toy-b", "sym", "viol"):
        assert recs[jid]["status"] == "stopped"
        assert "planted" in recs[jid]["error"]
    assert recs["tp"]["status"] == "completed"
    assert kernels.calls == 0 and pallas_step.launches == 0
