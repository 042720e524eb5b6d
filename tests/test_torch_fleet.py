"""The port's walker fleet on one card (``raft_tla_tpu_torch/fleet/``), on
the CPU.

No fleet run of the JAX package is a usable reference here: its
``shard_map`` segment fails on the installed JAX at one device as at two
(ROADMAP.md queue C, C-R1).  So the port's fleet is held to the reference's
contracts (``tests/test_fleet.py``) and to the port's own simulator, and to
the JAX package where no fleet runs: the constructor's ``ValueError`` texts,
the scenario helpers, the event validator and the CLI's flag checks.
"""

import io
import json
import re
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.fleet import FleetSimulator as JFleet
from raft_tla_tpu.fleet import fault_matrix as jfault_matrix
from raft_tla_tpu.fleet import run_matrix as jrun_matrix
from raft_tla_tpu.obs import validate_event as jvalidate
from raft_tla_tpu.parallel.shard_engine import make_mesh

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.fleet import FleetSimulator, fault_matrix, run_matrix
from raft_tla_tpu_torch.fleet.scenario import FAULT_FAMILIES
from raft_tla_tpu_torch.obs import validate_event
from raft_tla_tpu_torch.simulate import Simulator

torch.set_num_threads(1)

B3 = dict(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)
CV = CheckConfig(bounds=Bounds(**B3), spec="election",
                 invariants=("NaiveNoTwoLeaders",))
CLEAN = CheckConfig(bounds=Bounds(n_servers=2, n_values=1, max_term=2,
                                  max_log=1, max_msgs=2),
                    spec="full", invariants=("NoTwoLeaders",))


def fleet(config, **kw):
    kw.setdefault("walkers", 64)
    kw.setdefault("depth", 24)
    kw.setdefault("steps_per_dispatch", 12)
    kw.setdefault("seed", 11)
    return FleetSimulator(config, device="cpu", **kw)


def test_unsteered_fleet_walks_the_simulators_walks():
    """Unit weights and ``tau = 0``: on a clean run the fleet's walks,
    counts and deepest walk equal the solo simulator's, dispatch for
    dispatch."""
    r = fleet(CLEAN).run(300, snapshot_walks=True)
    sim = Simulator(CLEAN, walkers=64, depth=24, steps_per_dispatch=12,
                    seed=11, device="cpu")
    w = sim.start()
    while True:
        _f, nb, nst, mx, _vw, _vi, _dw = sim.dispatch(w)
        if nb >= 300:
            break
    assert r.violation is None
    assert (r.n_behaviors, r.n_states, r.max_depth_seen) == (nb, nst, mx)
    assert np.array_equal(r.walks[0], w.hist.numpy())
    assert np.array_equal(r.walks[1], w.hlen.numpy())
    assert r.device_states == [r.n_states] and r.n_devices == 1
    assert sum(r.coverage.values()) == r.n_states


def test_steering_raises_coverage_entropy():
    """Coverage steering flattens the per-action histogram: normalized
    entropy rises, over the same universe and invariants."""
    base = fleet(CV, walkers=128, seed=5).run(400)
    steered = fleet(CV, walkers=128, seed=5, steer_tau=2.0).run(400)
    assert steered.coverage_entropy > base.coverage_entropy
    assert steered.violation is None and base.violation is None
    assert sum(steered.coverage.values()) > 0


def test_fault_weights_shift_sampling():
    """One fleet sweeps the fault-intensity matrix: weight 0 starves the
    fault lanes, weight 2 feeds them — without touching enabledness."""
    cc = CheckConfig(bounds=Bounds(n_servers=2, n_values=1, max_term=2,
                                   max_log=1, max_msgs=2, max_dup=1),
                     spec="full", invariants=("NoTwoLeaders",))
    sim = fleet(cc, walkers=128, depth=30, steps_per_dispatch=15)
    cells = run_matrix(sim, fault_matrix((0.0, 2.0)), 300)
    by_name = {sc.name: r for sc, r in cells}
    visits = lambda r: sum(r.coverage.get(f, 0) for f in FAULT_FAMILIES)
    assert visits(by_name["faults-x0"]) == 0
    assert visits(by_name["faults-x2"]) > visits(by_name["uniform"]) > 0


def test_zero_weight_never_false_deadlocks():
    """When the weight-0 lanes are the only enabled ones the sampler draws
    uniformly over them: from Raft's Init only Timeout is enabled, and
    starving it must not strand the fleet or report a deadlock."""
    cd = CheckConfig(bounds=Bounds(**B3), spec="election",
                     invariants=("NaiveNoTwoLeaders",), check_deadlock=True)
    r = fleet(cd, fault_weights={"Timeout": 0.0}, depth=8).run(100)
    assert r.violation is None and r.n_behaviors >= 100
    assert r.coverage["Timeout"] > 0          # the fallback sampled it


def test_bad_shapes_and_weights():
    """The constructor's refusals: the JAX FleetSimulator's ValueError
    texts for weights and SYMMETRY; a mesh of two devices names ROADMAP
    item 11."""
    jcv = JConfig(bounds=JBounds(**B3), spec="election",
                  invariants=("NaiveNoTwoLeaders",))
    for kw, cfg, jcfg in (
            (dict(fault_weights={"Restart": 1.0}), CV, jcv),
            (dict(fault_weights={"Timeout": -1.0}), CV, jcv),
            ({}, CheckConfig(bounds=Bounds(**B3), spec="election",
                             invariants=(), symmetry=("Server",)),
             JConfig(bounds=JBounds(**B3), spec="election", invariants=(),
                     symmetry=("Server",)))):
        with pytest.raises(ValueError) as e:
            fleet(cfg, **kw)
        with pytest.raises(ValueError) as je:
            JFleet(jcfg, mesh=make_mesh(1), walkers=64, **kw)
        assert str(e.value) == str(je.value)
    with pytest.raises(NotImplementedError, match="item 11"):
        fleet(CV, mesh=2)
    with pytest.raises(ValueError, match="walkers must be >= 1"):
        fleet(CV, walkers=0)


def test_scenario_helpers_equal_the_reference():
    """``fault_matrix`` and ``run_matrix`` are the reference's."""
    for args in ((), ((0.0, 0.5, 1.0, 2.0),), ((3.0,), ("Restart",))):
        mine, ref = fault_matrix(*args), jfault_matrix(*args)
        assert [(s.name, s.fault_weights, s.describe()) for s in mine] == \
            [(s.name, s.fault_weights, s.describe()) for s in ref]

    class Rec:
        def __init__(self):
            self.calls = []

        def run(self, n, **kw):
            self.calls.append((n, sorted(kw.items(), key=str)))
            return len(self.calls)

    a, b = Rec(), Rec()
    got = run_matrix(a, fault_matrix(), 7, max_wall_s=1.0)
    want = jrun_matrix(b, jfault_matrix(), 7, max_wall_s=1.0)
    assert a.calls == b.calls
    assert [(s.name, r) for s, r in got] == [(s.name, r) for s, r in want]


def test_fleet_events_conform(tmp_path):
    """The fleet speaks RunTelemetry: every line valid under both
    validators, one-device segment rates, and a run_end carrying the
    confidence payload."""
    path = str(tmp_path / "fleet.events")
    r = fleet(CLEAN).run(300, events=path)
    events = [json.loads(ln) for ln in open(path)]
    assert not [e for d in events for e in validate_event(d) + jvalidate(d)]
    assert events[0]["event"] == "run_start"
    assert events[0]["engine"] == "fleet" and events[0]["n_devices"] == 1
    segs = [d for d in events if d["event"] == "segment"]
    assert segs and all(len(d["device_rates"]) == 1 for d in segs)
    end = events[-1]
    assert end["event"] == "run_end" and end["outcome"] == "ok"
    conf = r.confidence(CLEAN.invariants)
    assert end["sim"] == {**conf, "behaviors": r.n_behaviors}
    assert conf["n_devices"] == 1 and conf["walkers"] == 64
    assert 0.0 <= conf["coverage_entropy"] <= 1.0


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            code = main(list(argv))
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def test_cli_fleet_smoke(tmp_path):
    from test_torch_cli import write_cfg
    cfg = write_cfg(tmp_path / "f.cfg")
    code, out, _ = _cli(cli.main, [
        cfg, "--device", "cpu", "--spec", "election", "--max-term", "2",
        "--max-log", "0", "--max-msgs", "2", "--simulate", "200",
        "--depth", "20", "--walkers", "64", "--seed", "5", "--fleet",
        "--steer", "1.5", "--fault-weights", "Timeout=2"])
    assert code == cli.EXIT_OK, out
    assert "behaviors generated" in out and "not exhaustive" in out
    assert re.search(r"Fleet: 1 devices x 64 walkers, steer tau=1.5; "
                     r"action-coverage entropy 0\.\d{3}\n", out)
    assert "  NoTwoLeaders: held on " in out


def test_cli_fleet_flag_validation_matches_jax(tmp_path):
    """``--fleet`` without ``--simulate``, ``--steer`` and
    ``--fault-weights`` without ``--fleet``, and a bad weight cell: the
    JAX CLI's texts and exit codes."""
    from test_torch_cli import write_cfg
    cfg = write_cfg(tmp_path / "v.cfg")
    base = [cfg, "--spec", "election", "--max-term", "2", "--max-log", "0",
            "--max-msgs", "2"]
    for extra, want in ((["--fleet"], 2),
                        (["--simulate", "10", "--steer", "1"], 2),
                        (["--simulate", "10", "--fault-weights",
                          "Restart=2"], 2),
                        (["--simulate", "10", "--fleet", "--fault-weights",
                          "Restart"], 1)):
        got = []
        for main, dev in ((cli.main, ["--device", "cpu"]),
                          (jcli.main, ["--engine", "ref"])):
            code, _out, err = _cli(main, base + extra + dev)
            last = err.strip().splitlines()[-1]
            got.append((code, re.sub(r"^.*?: error: ", "error: ", last)))
        assert got[0] == got[1] and got[0][0] == want, got
