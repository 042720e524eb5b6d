"""Faithful mode in the port against the JAX reference: the orbit key, the
device engine, checkpoints carried between the packages, and the CLI's
faithful-mode refusals.

Same inputs through ``raft_tla_tpu`` and ``raft_tla_tpu_torch`` with
``Bounds(history=True)`` (helpers from tests/test_torch_history.py).
Tolerance: bit-exact.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu import device_engine as jdev
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import interp as jinterp
from raft_tla_tpu.ops import state as jst
from raft_tla_tpu.ops import symmetry as jsym

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
from raft_tla_tpu_torch.models import interp
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import pallas_step, state as st
from raft_tla_tpu_torch.ops import symmetry as sym
from raft_tla_tpu_torch.utils import ckpt

from test_torch_cli import ELECTION_2S, _run, write_cfg
from test_torch_history import FULL2, INV_H, _rows, _scramble

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

ELECT2 = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2,
              history=True, max_elections=4)
CAPS = dict(n_states=1 << 16, levels=64)


# -- the orbit key ---------------------------------------------------------------

@pytest.mark.parametrize("axes", [("Server",), ("Value",),
                                  ("Server", "Value")])
def test_orbit_key_matches_reference(axes):
    """The plain batched key, the host key and Init's key against the JAX
    host functions, on canonical rows with seeded history."""
    jb, b = JBounds(**FULL2), Bounds(**FULL2)
    jlay, lay = jst.Layout.of(jb), st.Layout.of(b)
    rows = _scramble(_rows(FULL2, depth=7, cap=40), FULL2, 3)
    rows = np.stack([jst.pack(jst.canonicalize(jst.unpack(r, jlay, np), np),
                              np) for r in rows])
    consts = jsym._host_consts(jlay.width)
    want = [tuple(int(x) for x in jsym.orbit_fingerprint(
        jst.unpack(r, jlay, np), jb, consts, np, axes)) for r in rows]
    host = [sym.orbit_fingerprint(st.unpack(r, lay), b,
                                  sym._host_consts(lay.width), axes)
            for r in rows]
    assert host == want
    tc = fpr.torch_constants(lay.width, "cpu")
    hi, lo = sym.build_orbit_fp(b, axes, tc)(
        st.unpack(torch.as_tensor(rows), lay))
    assert list(zip(fpr.as_uint32(hi).tolist(),
                    fpr.as_uint32(lo).tolist())) == want
    for view in (None, "deadvotes"):
        jcfg = JConfig(bounds=jb, symmetry=axes, view=view)
        cfg = CheckConfig(bounds=b, symmetry=axes, view=view)
        ji, pi = jinterp.init_state(jb), interp.init_state(b)
        assert sym.init_fingerprint(cfg, pi, interp.to_vec(pi, b)) == \
            tuple(int(x) for x in jsym.init_fingerprint(
                jcfg, ji, jinterp.to_vec(ji, jb)))


def test_kernel_rank_maps():
    b = Bounds(**FULL2)
    rm = sym.kernel_rank_maps(b, ("Server", "Value"))
    assert rm.dtype == np.int16 and rm.shape == (2, 43)
    assert np.array_equal(rm[0], np.arange(43))
    assert np.array_equal(rm, np.stack(jsym._rank_maps(JBounds(**FULL2))))
    assert sym.kernel_rank_maps(b, ("Server",)).size == 0
    assert sym.kernel_rank_maps(Bounds(n_servers=2), ("Value",)).size == 0
    assert pallas_step.layout_defines(b) == dict(
        RT_N=2, RT_L=2, RT_S=3, RT_E=4, RT_WA=2, RT_T=3, RT_V=2)


def test_orbit_sizes_sum_to_the_levels_without_symmetry():
    """The check that holds phase 6 of chip_smoke.py, at toy size: the
    orbit sizes of a symmetric run's representatives, summed per level,
    are the level counts of the run without symmetry."""
    kw = dict(ELECT2)
    cfg = CheckConfig(bounds=Bounds(**kw), spec="election",
                      invariants=("ElectionSafetyHist",),
                      symmetry=("Server",), chunk=256)
    eng = DeviceEngine(cfg, Capacities(**CAPS), device="cpu")
    res = eng.check()
    assert (res.n_states, res.diameter) == (1514, 17)
    sizes = sym.orbit_sizes(eng.carry["store"][:res.n_states], cfg.bounds,
                            ("Server",))
    starts = np.cumsum([0] + res.levels)
    sums = [int(sizes[a:z].sum()) for a, z in zip(starts[:-1], starts[1:])]
    plain = DeviceEngine(CheckConfig(bounds=cfg.bounds, spec="election",
                                     chunk=256),
                         Capacities(**CAPS), device="cpu").check()
    assert plain.n_states == 3014 and plain.levels == sums


# -- the engine and checkpoints --------------------------------------------------

def _configs(kw, spec, invs, chunk, axes=()):
    return (CheckConfig(bounds=Bounds(**kw), spec=spec, invariants=invs,
                        symmetry=axes, chunk=chunk),
            JConfig(bounds=JBounds(**kw), spec=spec, invariants=invs,
                    symmetry=axes, chunk=chunk))


def _same_result(got, want):
    assert (got.n_states, got.diameter, got.levels, got.n_transitions) == \
        (want.n_states, want.diameter, want.levels, want.n_transitions)
    assert dict(got.coverage) == dict(want.coverage)
    assert (got.violation is None) == (want.violation is None)


@pytest.fixture(scope="module")
def faithful_toy_jax():
    """The JAX engine for the faithful 3,014-state election, built once."""
    _, jcfg = _configs(ELECT2, "election", ("ElectionSafetyHist",), 64)
    return jdev.DeviceEngine(jcfg, jdev.Capacities(**CAPS), seg_chunks=8)


def test_faithful_engine_matches_jax_engine(faithful_toy_jax):
    cfg, _ = _configs(ELECT2, "election", ("ElectionSafetyHist",), 64)
    eng = DeviceEngine(cfg, Capacities(**CAPS), device="cpu")
    got = eng.check()
    want = faithful_toy_jax.check(retain_carry=True)
    _same_result(got, want)
    assert got.n_states == 3014
    n = got.n_states
    mine = eng.carry_to_numpy()
    theirs = [np.asarray(x) for x in faithful_toy_jax.retained_carry]
    faithful_toy_jax.retained_carry = None
    assert mine[0].shape[1] == 64                             # W, faithful
    assert np.array_equal(mine[0][:n], theirs[0][:n])         # store rows
    assert np.array_equal(mine[1][:n], theirs[1][:n])         # parents
    assert np.array_equal(mine[4], theirs[4])                 # key table


def test_faithful_checkpoints_move_both_ways(faithful_toy_jax, tmp_path):
    """A JAX mid-search checkpoint resumes in the port, a port one resumes
    in JAX, both to the straight run's result; a parity run refuses the
    faithful checkpoint."""
    cfg, jcfg = _configs(ELECT2, "election", ("ElectionSafetyHist",), 64)
    jeng = faithful_toy_jax
    straight = jeng.check()
    path = str(tmp_path / "jax.ckpt")
    jeng.SEG_MAX = 8
    jeng.seg_chunks = 8
    jeng.check(checkpoint=path, checkpoint_every_s=0.0)
    with np.load(path) as z:
        assert 1 < int(z["c6"]) < straight.n_states
    _same_result(DeviceEngine(cfg, Capacities(**CAPS), device="cpu")
                 .check(resume=path), straight)

    port_path = str(tmp_path / "port.ckpt")
    eng = DeviceEngine(cfg, Capacities(**CAPS), device="cpu")
    assert not eng.check(checkpoint=port_path, max_chunks=6).complete
    init = jinterp.init_state(jcfg.bounds)
    init_key = tuple(int(x) for x in jdev.sym_mod.init_fingerprint(
        jcfg, init, jinterp.to_vec(init, jcfg.bounds)))
    assert ckpt.config_digest(cfg, eng.caps, init_key) == \
        jdev.ckpt.config_digest(jcfg, jeng.caps, init_key)
    _same_result(jeng.check(resume=port_path), straight)

    parity = CheckConfig(bounds=Bounds(**dict(ELECT2, history=False)),
                         spec="election", chunk=64)
    with pytest.raises(ValueError, match="different model config"):
        DeviceEngine(parity, Capacities(**CAPS), device="cpu").check(
            resume=port_path)


@pytest.mark.slow
@pytest.mark.parametrize("kw,axes,want_n", [
    (dict(FULL2, n_values=1), (), 53398),
    (FULL2, (), 84572),
    (FULL2, ("Server", "Value"), 28121),
    (dict(FULL2, n_values=1), ("Server",), 26723),
], ids=["full-2s1v", "full-2s2v", "full-2s2v-ServerxValue",
        "full-2s1v-Server"])
def test_faithful_verified_counts_match_jax_engine(kw, axes, want_n):
    """The verified faithful counts (tests/test_history.py, RESULTS.md),
    each with the JAX engine's levels, transitions, coverage, rows and
    parents."""
    cfg, jcfg = _configs(kw, "full", INV_H, 1024, axes)
    caps = dict(n_states=1 << 17, levels=64)
    eng = DeviceEngine(cfg, Capacities(**caps), device="cpu")
    got = eng.check()
    jeng = jdev.DeviceEngine(jcfg, jdev.Capacities(**caps))
    want = jeng.check(retain_carry=True)
    _same_result(got, want)
    assert (got.n_states, got.diameter) == (want_n, 32)
    n = got.n_states
    mine = eng.carry_to_numpy()
    theirs = [np.asarray(x) for x in jeng.retained_carry]
    assert np.array_equal(mine[0][:n], theirs[0][:n])
    assert np.array_equal(mine[1][:n], theirs[1][:n])


# -- the CLI -----------------------------------------------------------------------

def test_cli_faithful_refusals_match_jax_cli(tmp_path):
    """A *Hist invariant without --faithful, and a cfg VIEW with it, are
    refused with the reference's own text; --faithful prints its banner."""
    hist = write_cfg(tmp_path / "h.cfg", invariant="ElectionSafetyHist")
    view = write_cfg(tmp_path / "v.cfg", extra="VIEW ParityView\n")
    for argv in ([hist] + ELECTION_2S, [view, "--faithful"] + ELECTION_2S):
        code, _, err = _run(cli.main, [*argv, "--device", "cpu"])
        jcode, _, jerr = _run(jcli.main, [*argv, "--engine", "ref"])
        assert code == jcode == cli.EXIT_ERROR
        assert err.splitlines()[-1] == jerr.splitlines()[-1]
    assert "require faithful mode" in _run(
        cli.main, [hist, "--device", "cpu"])[2]
    code, out, _ = _run(cli.main, [hist, "--device", "cpu", "--faithful",
                                   "--max-elections", "3", "--spec",
                                   "election", "--max-term", "1",
                                   "--max-log", "0", "--max-msgs", "1"])
    assert code == cli.EXIT_OK
    assert "Faithful mode: history variables (elections/allLogs/voterLog/" \
        "mlog) carried; elections capacity 3" in out
