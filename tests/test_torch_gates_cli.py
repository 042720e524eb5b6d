"""The step and engine gates through the port's CLI (``--prescan``,
``--sig-prune``, ``--megakernel``, ``--route``, ``--device-dedup`` /
``--devdedup``): every value accepted, with the result lines of the JAX
CLI's oracle (``--engine ref``, which no step gate changes: one run per
universe, shared by the file);
the reference's argument errors, word for word; ``--megakernel off``
refused for the card; and the whole slice, the port's DDD engine under
every gate against the JAX ``DDDEngine`` under the same gates on the
3-server election under SYMMETRY (23,902 orbits, diameter 31).
"""

import os
from contextlib import redirect_stderr
import io

import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.config import CheckConfig as JCheckConfig
from raft_tla_tpu.ddd_engine import DDDCapacities as JDDDCapacities
from raft_tla_tpu.ddd_engine import DDDEngine as JDDDEngine

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
from raft_tla_tpu_torch.ops import pallas_step

from test_torch_cli import _result_lines, _run, write_cfg

torch.set_num_threads(1)

ENVS = ("RAFT_TLA_PRESCAN", "RAFT_TLA_SIGPRUNE", "RAFT_TLA_MEGAKERNEL",
        "RAFT_TLA_DEVDEDUP")
BASE = ["--spec", "election", "--max-term", "2", "--max-log", "0",
        "--max-msgs", "2", "--chunk", "64"]


@pytest.fixture(autouse=True)
def _gates_restored(monkeypatch):
    """The CLI sets the gates process-wide; each test gets them back."""
    for env in ENVS:
        monkeypatch.setenv(env, "auto")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The JAX CLI's oracle on the test cfg, run once per universe:
    ``symmetry -> (exit code, result lines)``."""
    cfg = write_cfg(tmp_path_factory.mktemp("oracle") / "m.cfg")
    runs = {}

    def run(symmetry: bool) -> tuple:
        if symmetry not in runs:
            jcode, jout, _ = _run(jcli.main, [
                cfg, "--engine", "ref", *BASE,
                *(["--symmetry"] if symmetry else [])])
            runs[symmetry] = (jcode, _result_lines(jout))
        return runs[symmetry]

    return run


@pytest.mark.parametrize("gates", [
    ["--prescan", "on", "--sig-prune", "on", "--device-dedup", "hash",
     "--route", "200", "--symmetry"],
    ["--prescan", "off", "--sig-prune", "off", "--megakernel", "auto",
     "--devdedup", "sort", "--route", "600"],
    ["--prescan", "auto", "--sig-prune", "auto", "--megakernel", "on",
     "--device-dedup", "off", "--symmetry"],
    ["--megakernel", "off", "--device-dedup", "on", "--device-dedup",
     "auto", "--sig-prune", "on"],
], ids=["all-on", "off-sort", "megakernel-on", "megakernel-off"])
def test_gate_flags_print_the_jax_lines(tmp_path, gates, oracle):
    """The port's DDD engine on the CPU under the gates, against the JAX
    CLI's oracle on the same universe: the same lines, exit 0; the gates
    set their environment variables."""
    cfg = write_cfg(tmp_path / "m.cfg")
    code, out, _ = _run(cli.main, [cfg, "--device", "cpu", "--engine",
                                   "ddd", *BASE, *gates])
    jcode, jlines = oracle("--symmetry" in gates)
    assert code == jcode == cli.EXIT_OK
    assert _result_lines(out) == jlines
    want = "1514" if "--symmetry" in gates else "3014"
    assert f"{want} distinct states found" in out
    flag_env = dict(zip(("--prescan", "--sig-prune", "--megakernel",
                         "--device-dedup"), ENVS))
    for k, g in enumerate(gates[:-1]):
        env = flag_env.get("--device-dedup" if g == "--devdedup" else g)
        if env and (k + 2 >= len(gates) or gates[k + 2] != g):
            assert os.environ[env] == gates[k + 1]


@pytest.mark.parametrize("argv", [
    ["--route", "64", "--engine", "host"],
    ["--route", "64", "--engine", "ddd", "--megakernel", "on"],
    ["--prescan", "yes"],
    ["--device-dedup", "maybe"],
], ids=["route-host", "route-megakernel", "prescan-value", "devdedup-value"])
def test_reference_argument_errors(tmp_path, argv):
    """Exit 2 with the reference's message, word for word."""
    cfg = write_cfg(tmp_path / "m.cfg")
    msgs = []
    for main in (cli.main, jcli.main):
        err = io.StringIO()
        with pytest.raises(SystemExit) as e, redirect_stderr(err):
            main([cfg, *BASE, *argv])
        assert e.value.code == 2
        msgs.append(err.getvalue().strip().splitlines()[-1])
    assert msgs[0].split("error: ")[1] == msgs[1].split("error: ")[1]


def test_megakernel_off_is_refused_for_the_card(tmp_path, monkeypatch):
    """``--megakernel off`` (the reference's XLA step) on the card: exit 2
    at parse time, before any step is built; the same setting through the
    environment is refused by the card's step builder."""
    cfg = write_cfg(tmp_path / "m.cfg")
    err = io.StringIO()
    with pytest.raises(SystemExit) as e, redirect_stderr(err):
        cli.main([cfg, *BASE, "--megakernel", "off"])
    assert e.value.code == 2
    assert pallas_step.MEGAKERNEL_OFF_CUDA in err.getvalue()
    monkeypatch.setenv("RAFT_TLA_MEGAKERNEL", "off")
    with pytest.raises(ValueError, match="its step on the card is K1"):
        pallas_step.build_step(Bounds(2, 1, 2, 0, 2), "election", (),
                               "cuda")


def test_whole_slice_matches_jax_ddd_engine(monkeypatch):
    """The 3-server election (t2 l0 m1) under SYMMETRY Server through the
    port's DDD engine with the prescan, sig-prune, the routed step and
    the hash device set, against the JAX DDDEngine under the same gates:
    23,902 orbits, diameter 31, and the same levels, transitions and
    coverage."""
    for env, v in zip(ENVS, ("on", "on", "auto", "hash")):
        monkeypatch.setenv(env, v)
    kw = dict(n_servers=3, n_values=1, max_term=2, max_log=0, max_msgs=1)
    common = dict(spec="election", invariants=("NoTwoLeaders",),
                  symmetry=("Server",), chunk=256)
    caps = dict(block=1 << 12, table=1 << 14, flush=1 << 14,
                seg_rows=1 << 14, levels=64, route_rows=2048)
    eng = DDDEngine(CheckConfig(bounds=Bounds(**kw), **common),
                    DDDCapacities(**caps), device="cpu")
    got = eng.check()
    want = JDDDEngine(JCheckConfig(bounds=JBounds(**kw), **common),
                      JDDDCapacities(**caps)).check()
    assert (got.n_states, got.diameter) == (want.n_states, want.diameter) \
        == (23_902, 31)
    assert got.levels == want.levels
    assert got.n_transitions == want.n_transitions
    assert dict(got.coverage) == dict(want.coverage)
    assert eng.stats["dev_dedup_hits"] > 0
