"""The orbit key of given rows (ops/orbit_key.py) and the CLI of the paged
and streamed engines, on the CPU.

The orbit-key entry of ``csrc/step.cu`` keys the IR-compiled Raft
(``ir-full``, ``ir-election``) under SYMMETRY and VIEWs on the card; on the
CPU its wrapper runs the plain version, which must give the plain step's
keys on every valid lane (the contract the kernel is held to on the card,
at |G| = 6 and 120), and the IR specs through the port's host engine give
the JAX package's counts: 23,902 orbits and diameter 31 for the 3-server
election at t2 m1, the JAX oracle's elsewhere.  ``--engine paged|streamed``
and ``--ring`` through the CLI give the JAX oracle's result lines, and
``--deadline`` with them, and a ring too small for the window, fail with
the reference's texts and exit codes; ``--property`` after either engine
gives the JAX CLI's verdict lines.
"""

import io
from contextlib import redirect_stderr

import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import refbfs

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
from raft_tla_tpu_torch.engine import Engine
from raft_tla_tpu_torch.frontend import raft_ir, registry
from raft_tla_tpu_torch.ops import kernels, orbit_key

from test_torch_cli import _result_lines, _run, write_cfg

torch.set_num_threads(1)

ELECTION_2S = ["--spec", "election", "--max-term", "2", "--max-log", "0",
               "--max-msgs", "2", "--chunk", "64", "--device", "cpu"]


def _rows(b, spec, invs, n, chunks=12):
    eng = DeviceEngine(CheckConfig(bounds=b, spec=spec, invariants=invs,
                                   chunk=128),
                       Capacities(n_states=1 << 14, levels=64), device="cpu")
    res = eng.check(max_chunks=chunks)
    idx = torch.linspace(0, res.n_states - 1, min(n, res.n_states)).long()
    return eng.carry["store"][idx].clone()


@pytest.mark.parametrize("kw,spec,axes,view", [
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2),
     "full", ("Server",), None),
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2),
     "full", ("Server", "Value"), "deadvotes"),
    (dict(n_servers=5, n_values=2, max_term=2, max_log=0, max_msgs=2),
     "election", ("Server",), None),
], ids=["flagship-G6", "flagship-G12-view", "elect5-G120"])
def test_plain_keys_are_the_plain_steps_keys(kw, spec, axes, view):
    """The keyer's plain version on the canonical successors gives the
    plain step's dedup keys on every valid lane, and so does the IR step
    keyed through the keyer."""
    b = Bounds(**kw)
    rows = _rows(b, spec, ("NoTwoLeaders",), 48 if kw["n_servers"] < 5
                 else 8)
    want = kernels.build_step(b, spec, ("NoTwoLeaders",), axes, view)(rows)
    val = want["valid"]
    hi, lo = orbit_key.build_keyer(b, axes, view)(want["svecs"][val])
    assert torch.equal(hi, want["fp_hi"][val])
    assert torch.equal(lo, want["fp_lo"][val])
    ir = kernels.build_step(b, spec, ("NoTwoLeaders",), axes, view,
                            family_kernels=raft_ir.family_kernels(b),
                            keyer=orbit_key.build_keyer(b, axes, view))(rows)
    assert torch.equal(ir["valid"], val)
    for k in ("fp_hi", "fp_lo", "svecs"):
        assert torch.equal(ir[k][val], want[k][val])
    # the keyer is handed the valid lanes' mask and keys the others 0
    assert not ir["fp_hi"][~val].any() and not ir["fp_lo"][~val].any()


def test_ir_election_under_symmetry_counts_the_jax_orbits():
    """The 3-server election (t2 l0 m1) under SYMMETRY Server through the
    host engine: the JAX package's 23,902 orbits, diameter 31, for
    ``ir-election`` and ``election`` alike."""
    got = {}
    for spec in ("ir-election", "election"):
        cfg = CheckConfig(bounds=Bounds(n_servers=3, n_values=1, max_term=2,
                                        max_log=0, max_msgs=1),
                          spec=spec, invariants=("NoTwoLeaders",),
                          symmetry=("Server",), chunk=4096)
        r = Engine(cfg, device="cpu").check()
        got[spec] = (r.n_states, r.diameter, r.n_transitions, r.levels)
    assert got["ir-election"] == got["election"]
    assert got["ir-election"][:2] == (23_902, 31)


@pytest.mark.parametrize("kw,spec,axes,view", [
    (dict(n_servers=2, n_values=2, max_term=2, max_log=1, max_msgs=1),
     "full", ("Server", "Value"), "deadvotes"),
    (dict(n_servers=2, n_values=1, max_term=2, max_log=1, max_msgs=1),
     "full", (), "deadvotes"),
    (dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2),
     "election", (), "deadvotes"),
], ids=["full-symmetry-view", "full-view", "election-view"])
def test_ir_specs_under_symmetry_or_a_view_match_the_jax_oracle(
        kw, spec, axes, view):
    cfg = CheckConfig(bounds=Bounds(**kw), spec="ir-" + spec,
                      invariants=("NoTwoLeaders",), symmetry=axes, view=view,
                      chunk=4096)
    got = Engine(cfg, device="cpu").check()
    want = refbfs.check(JConfig(bounds=JBounds(**kw), spec=spec,
                                invariants=("NoTwoLeaders",), symmetry=axes,
                                view=view))
    assert (got.n_states, got.diameter, got.levels, got.n_transitions) == \
        (want.n_states, want.diameter, want.levels, want.n_transitions)
    assert dict(got.coverage) == dict(want.coverage)
    # the card keys it with the orbit-key kernel; here the plain key
    assert registry.resolve_model("ir-" + spec).build_step(cfg, "cpu")


def test_cli_paged_and_streamed_with_ring_print_the_oracles_lines(tmp_path):
    cfg = write_cfg(tmp_path / "m.cfg")
    jcode, jout, _ = _run(jcli.main, [cfg, "--engine", "ref",
                                      *ELECTION_2S[:-2], "--coverage"])
    for argv in (["--engine", "paged", "--ring", "2048"],
                 ["--engine", "streamed", "--ring", "2048"],
                 ["--engine", "paged"]):
        code, out, _ = _run(cli.main, [cfg, *ELECTION_2S, "--coverage",
                                       *argv])
        assert (code, _result_lines(out)) == (jcode, _result_lines(jout))


def test_cli_refusals_and_failures_are_the_references(tmp_path):
    """``--deadline`` with either engine exits 2 with the reference's
    message; a ring below the window exits 1 with the engine's FAIL_RING
    text, as the reference's CLI prints it."""
    cfg = write_cfg(tmp_path / "m.cfg")
    for engine in ("paged", "streamed"):
        msgs = []
        for main in (cli.main, jcli.main):
            err = io.StringIO()
            with pytest.raises(SystemExit) as e, redirect_stderr(err):
                main([cfg, *ELECTION_2S[:-2], "--engine", engine,
                      "--deadline", "5"])
            assert e.value.code == 2
            msgs.append(err.getvalue().strip().splitlines()[-1])
        assert msgs[0].split("error: ")[1] == msgs[1].split("error: ")[1]
    code, _out, err = _run(cli.main, [cfg, *ELECTION_2S, "--engine",
                                      "paged", "--ring", "512", "--chunk",
                                      "16"])
    assert code == 1
    assert "Error: paged search aborted: live BFS window exceeded the HBM " \
           "ring (caps=PagedCapacities(ring=512" in err
    err = io.StringIO()
    with pytest.raises(SystemExit) as e, redirect_stderr(err):
        cli.main([cfg, *ELECTION_2S, "--engine", "pagedshard"])
    assert e.value.code == 2 and "item 11 (c), the paged shard engine" in \
        err.getvalue()


def test_cli_property_after_paged_and_streamed(tmp_path):
    """``--property`` routes the paged engine to the device engine's graph
    export and the streamed one to the DDD store's, as the reference's CLI
    routes them; the verdict lines are the JAX oracle's."""
    cfg = write_cfg(tmp_path / "m.cfg")
    prop = ["--property", "EventuallyLeader"]
    jcode, jout, _ = _run(jcli.main, [cfg, "--engine", "ref",
                                      *ELECTION_2S[:-2], *prop])
    for engine in ("paged", "streamed"):
        code, out, _ = _run(cli.main, [cfg, *ELECTION_2S, "--engine",
                                       engine, "--ring", "2048", "--cap",
                                       "4096", *prop])
        assert (code, _result_lines(out)) == (jcode, _result_lines(jout))
