"""The port's campaign layer (``raft_tla_tpu_torch/campaign/``, its
``serve/jobs.admit`` gate and ``analysis/cfglint``) against the JAX
package's.

``verify_snapshot`` gives the same verdict in both packages on snapshots
the port wrote, in both retentions: good, a truncated stream, a missing
member, a torn metadata npz and a wrong row width.  ``admit`` and
``lint_cfg`` give the same findings and reasons on a grid of good and bad
cfgs.  The child's argv has the port's shape (``--device cpu``), and a
mesh plan above one card is refused.  On the CPU, a campaign whose first
child is SIGKILLed after its second checkpoint resumes to the
uninterrupted run's 3,014 states, 5,274 transitions and diameter 17.
"""

import os
import shutil
import sys

import pytest
import torch

from raft_tla_tpu.analysis import cfglint as jcfglint
from raft_tla_tpu.campaign import integrity as jintegrity
from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.serve import jobs as jjobs
from raft_tla_tpu.utils import cfgparse as jcfgparse

from raft_tla_tpu_torch.analysis import cfglint
from raft_tla_tpu_torch.campaign import integrity
from raft_tla_tpu_torch.campaign.chaos import ChaosMonkey, final_record
from raft_tla_tpu_torch.campaign.supervisor import (CampaignPolicy,
                                                    CampaignSpec, Supervisor)
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.serve import jobs
from raft_tla_tpu_torch.utils import cfgparse

torch.set_num_threads(1)

TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
TOY_OPTS = {"max_term": 2, "max_log": 0, "max_msgs": 2}
_CONSTANTS = "CONSTANTS\n    Server = {%s}\n    Value = {v1}\n"


def _cfg(tmp_path, name, invariants="NoTwoLeaders", servers="s1, s2",
         extra=""):
    p = tmp_path / f"{name}.cfg"
    p.write_text(f"SPECIFICATION Spec\nINVARIANT {invariants}\n{extra}"
                 + _CONSTANTS % servers)
    return str(p)


def _verdict(verify, path, **kw):
    try:
        return ("ok", verify(path, **kw))
    except FileNotFoundError as e:
        return ("missing", str(e))
    except ValueError as e:                  # CheckpointCorrupt
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("retention", ["full", "frontier"])
def test_verify_snapshot_verdicts_match_reference(retention, tmp_path):
    from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
    cfg = CheckConfig(bounds=Bounds(**TOY), spec="election",
                      invariants=("NoTwoLeaders",), chunk=32)
    eng = DDDEngine(cfg, DDDCapacities(block=256, table=1 << 12,
                                       levels=64, retention=retention),
                    device="cpu")
    src = tmp_path / "src" / "s.ckpt"
    src.parent.mkdir()
    res = eng.check(checkpoint=str(src), deadline_s=0.0)
    assert not res.complete
    P = eng.schema.P
    fam = integrity.snapshot_family(str(src))
    assert fam == jintegrity.snapshot_family(str(src)) and len(fam) >= 4

    def damaged(tag, fn):
        d = tmp_path / tag
        shutil.copytree(src.parent, d)
        path = str(d / "s.ckpt")
        fn(path)
        return path

    def truncate(member, keep):
        def f(path):
            m = path + member
            with open(m, "r+b") as fh:
                fh.truncate(int(os.path.getsize(m) * keep))
        return f

    stream = ".keys" if retention == "frontier" else ".rows"
    cases = {
        "good": damaged("good", lambda p: None),
        "truncated-stream": damaged("trunc", truncate(stream, 0.6)),
        "missing-member": damaged("missing",
                                  lambda p: os.remove(p + ".keys")),
        "torn-npz": damaged("torn", truncate("", 1 / 3)),
    }
    verdicts = {}
    for name, path in cases.items():
        got = _verdict(integrity.verify_snapshot, path)
        assert got == _verdict(jintegrity.verify_snapshot, path), name
        verdicts[name] = got[0]
    for w in (P, P + 1):            # the right width, then a wrong one
        got = _verdict(integrity.verify_snapshot, cases["good"],
                       row_width=w)
        assert got == _verdict(jintegrity.verify_snapshot, cases["good"],
                               row_width=w)
        verdicts[f"width {w - P}"] = got[0]
    assert verdicts == {
        "good": "ok", "truncated-stream": "CheckpointCorrupt",
        "missing-member": "CheckpointCorrupt",
        "torn-npz": "CheckpointCorrupt", "width 0": "ok",
        "width 1": "CheckpointCorrupt"}


def test_admit_and_cfglint_match_reference(tmp_path):
    grid = [
        ("good", _cfg(tmp_path, "good"), {}),
        ("good-sym", _cfg(tmp_path, "sym", extra="SYMMETRY Server\n"),
         {"symmetry": True}),
        ("typo", _cfg(tmp_path, "typo", "NoTwoLeaderz"), {}),
        ("vacuous", _cfg(tmp_path, "vac", "NoTwoLeaders LogMatching"), {}),
        ("history", _cfg(tmp_path, "hist", "ElectionSafetyHist"), {}),
        ("faithful", _cfg(tmp_path, "faith", "ElectionSafetyHist"),
         {"faithful": True, "max_elections": 4}),
        ("expression", _cfg(tmp_path, "expr", "count(role = 2) <= 1"), {}),
        ("bad-expression", _cfg(tmp_path, "bexpr", "role[[1] = 2"), {}),
        ("too-many-servers", _cfg(tmp_path, "big", servers=", ".join(
            f"s{i}" for i in range(20))), {}),
        ("bound-constant", _cfg(tmp_path, "bc", extra="CONSTANTS\n    "
                                "MaxTerm = 5\n"), {}),
        ("view-symmetry", _cfg(tmp_path, "vs", "NoTwoLeaders",
                               extra="SYMMETRY Value\n"),
         {"view": "deadvotes"}),
        ("unknown-spec", _cfg(tmp_path, "us"), {"spec": "electoin"}),
        ("budget", _cfg(tmp_path, "bud"), {"wall_s": 0}),
    ]
    reasons = {}
    for name, path, opts in grid:
        d = {"id": name, "cfg": path, "spec": "election", **TOY_OPTS,
             **opts}
        got, want = jobs.admit(jobs.CheckJob.from_dict(d)), \
            jjobs.admit(jjobs.CheckJob.from_dict(d))
        assert (got.admitted, got.reason, got.findings_text()) == \
            (want.admitted, want.reason, want.findings_text()), name
        if got.admitted:
            assert got.config.symmetry == want.config.symmetry
            assert got.config.bounds.history == want.config.bounds.history
        reasons[name] = got.reason
        text = open(path).read()
        for spec in ("election", "full"):
            for kw in ({}, {"view": "deadvotes"}):
                b = dict(TOY, n_servers=2)
                lint = cfglint.lint_cfg(cfgparse.parse_cfg(text),
                                        Bounds(**b), spec=spec, path=path,
                                        **kw)
                jlint = jcfglint.lint_cfg(jcfgparse.parse_cfg(text),
                                          JBounds(**b), spec=spec,
                                          path=path, **kw)
                assert [f.format() for f in lint] == \
                    [f.format() for f in jlint], (name, spec, kw)
    assert reasons == {
        "good": None, "good-sym": None, "typo": "cfg-invalid",
        "vacuous": "vacuous", "history": "cfg-invalid", "faithful": None,
        "expression": None, "bad-expression": "cfg-invalid",
        "too-many-servers": "width-unsafe", "bound-constant": None,
        "view-symmetry": None, "unknown-spec": "spec-unknown",
        "budget": "budget-invalid"}
    # the reference's frontend targets, admitted or refused as it does:
    # the IR-compiled Raft on a Raft cfg, and twophase, whose adapter
    # refuses the Raft invariant
    for spec, reason in (("ir-election", None), ("twophase", "cfg-invalid")):
        d = {"id": spec, "cfg": grid[0][1], "spec": spec, **TOY_OPTS}
        got, want = jobs.admit(jobs.CheckJob.from_dict(d)), \
            jjobs.admit(jjobs.CheckJob.from_dict(d))
        assert (got.admitted, got.reason, got.findings_text()) == \
            (want.admitted, want.reason, want.findings_text()), spec
        assert got.reason == reason


def test_child_argv_and_one_card_mesh(tmp_path):
    cfg = _cfg(tmp_path, "toy")
    spec = CampaignSpec(cfg_path=cfg, spec="election", window=128,
                        chunk=32, cap=1 << 14, options=TOY_OPTS, cpu=True,
                        extra_args=("--retention", "frontier"))
    pol = CampaignPolicy(checkpoint_every_s=0.0, session_wall_s=30.0)
    sup = Supervisor(spec, str(tmp_path / "w"), policy=pol, quiet=True)
    assert sup._child_argv(1, resume=True) == [
        sys.executable, "-m", "raft_tla_tpu_torch.check", cfg,
        "--spec", "election", "--chunk", "32", "--levels", "256",
        "--cap", str(1 << 14), "--block", "128", "--checkpoint", sup.ckpt,
        "--checkpoint-every", "0.0", "--events", sup.events_path,
        "--no-trace", "--engine", "ddd", "--deadline", "30.0",
        "--resume", sup.ckpt, "--device", "cpu", "--max-log", "0",
        "--max-msgs", "2", "--max-term", "2", "--retention", "frontier"]
    assert sup._mesh_for(0) == 1
    for plan in ([2], [1, 2], lambda a: 2):
        s2 = Supervisor(spec, str(tmp_path / "w2"), policy=pol,
                        mesh_plan=plan, quiet=True)
        with pytest.raises(ValueError, match="item 11"):
            s2._mesh_for(1)
    with pytest.raises(ValueError, match="item 11"):
        sup._reshard(1, 2)
    from raft_tla_tpu_torch.campaign.cli import main as campaign_main
    for extra in (["--cpu"], ["--metrics-port", "x"]):
        with pytest.raises(SystemExit) as e:
            campaign_main([cfg, "--workdir", str(tmp_path / "c"), *extra])
        assert e.value.code == 2
    # a vacuous campaign is rejected before any child runs: exit 1
    vac = _cfg(tmp_path, "vac", "NoTwoLeaders LogMatching")
    assert campaign_main([vac, "--workdir", str(tmp_path / "v"), "--spec",
                          "election", "--max-term", "2", "--max-log", "0",
                          "--max-msgs", "2", "--device", "cpu",
                          "--quiet"]) == 1
    assert not os.path.exists(tmp_path / "v" / "attempt000.out")


def test_chaos_kill_after_second_checkpoint_resumes_exactly(tmp_path):
    cfg = _cfg(tmp_path, "toy")
    spec = CampaignSpec(cfg_path=cfg, spec="election", window=128,
                        chunk=32, cap=1 << 14, options=TOY_OPTS, cpu=True)
    monkey = ChaosMonkey(kills={0: ("kill", 2)})
    sup = Supervisor(spec, str(tmp_path / "chaos"),
                     policy=CampaignPolicy(checkpoint_every_s=0.0,
                                           backoff_base_s=0.0, grace_s=5.0,
                                           poll_s=0.05),
                     spawn_hook=monkey.spawn_hook,
                     pre_verify_hook=monkey.pre_verify_hook, quiet=True)
    res = sup.run()
    end = final_record(sup.events_path)
    assert monkey.fired == [(0, "kill", 2)]
    assert (res.outcome, res.exit_code, res.attempts) == ("ok", 0, 2)
    assert (end["n_states"], end["n_transitions"], end["diameter"]) == \
        (3014, 5274, 17)
    assert [k for _a, _n, k in monkey.observed] in (["mid-level"],
                                                    ["boundary"])
