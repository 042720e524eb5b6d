"""The port's device engine (on the CPU) against the JAX reference.

The port's ``DeviceEngine(device="cpu")`` runs the plain torch step; the
JAX ``DeviceEngine`` runs its default step (tests/test_pallas_step.py holds
the JAX megakernel build to the same engine results) and ``refbfs`` is the
pure-Python oracle.  Exact equality of states, diameter, per-level counts,
transitions, coverage, violation and trace; and a search carried across
between the two packages through their shared checkpoint format.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu import device_engine as jdev
from raft_tla_tpu.models import interp as jinterp, refbfs, spec as JS
from raft_tla_tpu.ops import msgbits as jmb

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
from raft_tla_tpu_torch.engine import DEADLOCK
from raft_tla_tpu_torch.models import interp
from raft_tla_tpu_torch.utils import ckpt

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
FULL21 = dict(n_servers=2, n_values=1, max_term=2, max_log=1, max_msgs=2)
CAPS = dict(n_states=1 << 16, levels=64)


def _configs(kw, spec, invs, chunk):
    return (CheckConfig(bounds=Bounds(**kw), spec=spec, invariants=invs,
                        chunk=chunk),
            JConfig(bounds=JBounds(**kw), spec=spec, invariants=invs,
                    chunk=chunk))


def _port_state(s):
    return interp.PyState(**{f: getattr(s, f)
                             for f in interp.PyState.__dataclass_fields__})


def _same_result(got, want):
    assert got.n_states == want.n_states
    assert got.diameter == want.diameter
    assert got.levels == want.levels
    assert got.n_transitions == want.n_transitions
    assert dict(got.coverage) == dict(want.coverage)
    assert (got.violation is None) == (want.violation is None)


@pytest.fixture(scope="module")
def toy_jax():
    """The JAX engine for the 3,014-state toy, built once for the module."""
    _, jcfg = _configs(TOY, "election", ("NoTwoLeaders",), 64)
    return jcfg, jdev.DeviceEngine(jcfg, jdev.Capacities(**CAPS),
                                   seg_chunks=8)


def test_toy_matches_jax_engine_and_oracle(toy_jax):
    jcfg, jeng = toy_jax
    cfg, _ = _configs(TOY, "election", ("NoTwoLeaders",), 64)
    got = DeviceEngine(cfg, Capacities(**CAPS), device="cpu").check()
    want = jeng.check()
    _same_result(got, want)
    _same_result(got, refbfs.check(jcfg))
    assert got.n_states == 3014 and got.diameter == 17


def test_full_spec_matches_jax_engine():
    invs = ("NoTwoLeaders", "LogMatching", "CommittedWithinLog",
            "LeaderCompleteness")
    cfg, jcfg = _configs(FULL21, "full", invs, 512)
    got = DeviceEngine(cfg, Capacities(**CAPS), device="cpu").check()
    _same_result(got, jdev.DeviceEngine(jcfg, jdev.Capacities(**CAPS))
                 .check())
    assert got.n_states == 48041 and got.violation is None


def test_seeded_violation_trace_matches_oracle_and_replays():
    kw = dict(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4,
              max_dup=1)
    cfg, jcfg = _configs(kw, "election", ("NaiveNoTwoLeaders",), 256)
    jstart = jinterp.init_state(jcfg.bounds)._replace(
        role=(JS.LEADER, JS.FOLLOWER, JS.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=((jmb.rv_response(3, 1, 1, 2), 1),))
    start = _port_state(jstart)
    ref = refbfs.check(jcfg, init_override=jstart)
    got = DeviceEngine(cfg, Capacities(n_states=1 << 15, levels=64),
                       device="cpu").check(init_override=start)
    assert got.violation.invariant == "NaiveNoTwoLeaders"
    assert got.violation.state == _port_state(ref.violation.state)
    assert [lbl for lbl, _ in got.violation.trace] == \
        [lbl for lbl, _ in ref.violation.trace]
    assert got.levels == ref.levels and got.diameter == ref.diameter
    trace = got.violation.trace
    assert trace[0] == (None, start)
    for (_l, prev), (_label, cur) in zip(trace, trace[1:]):
        assert cur in [t for _i, t in interp.successors(prev, cfg.bounds,
                                                       spec="election")]


def test_one_server_deadlock_matches_oracle():
    kw = dict(n_servers=1, n_values=1, max_term=2, max_log=0, max_msgs=2)
    cfg = CheckConfig(bounds=Bounds(**kw), spec="election",
                      invariants=("NoTwoLeaders",), chunk=64,
                      check_deadlock=True)
    jcfg = JConfig(bounds=JBounds(**kw), spec="election",
                   invariants=("NoTwoLeaders",), chunk=64,
                   check_deadlock=True)
    got = DeviceEngine(cfg, Capacities(n_states=1 << 12, levels=64),
                       device="cpu").check()
    ref = refbfs.check(jcfg)
    assert got.violation.invariant == DEADLOCK == ref.violation.invariant
    assert got.violation.state == _port_state(ref.violation.state)
    assert len(got.violation.trace) == len(ref.violation.trace)


def test_jax_checkpoint_resumes_in_the_port(toy_jax, tmp_path):
    """A JAX engine runs a few segments and leaves a mid-search checkpoint;
    the port resumes it to the straight JAX run's result, and the port's
    own checkpoint passes the JAX engine's digest check and resumes there
    to the same result."""
    jcfg, jeng = toy_jax
    straight = jeng.check()
    path = str(tmp_path / "jax.ckpt")
    jeng.SEG_MAX = 8
    jeng.seg_chunks = 8
    jeng.check(checkpoint=path, checkpoint_every_s=0.0)
    with np.load(path) as z:
        c = int(z["c6"])
        assert 1 < c < straight.n_states       # a mid-search carry
    cfg, _ = _configs(TOY, "election", ("NoTwoLeaders",), 64)
    eng = DeviceEngine(cfg, Capacities(**CAPS), device="cpu")
    _same_result(eng.check(resume=path), straight)

    port_path = str(tmp_path / "port.ckpt")
    eng2 = DeviceEngine(cfg, Capacities(**CAPS), device="cpu")
    part = eng2.check(checkpoint=port_path, max_chunks=20)
    assert not part.complete
    init_key = tuple(int(x) for x in jdev.sym_mod.init_fingerprint(
        jcfg, jinterp.init_state(jcfg.bounds),
        jinterp.to_vec(jinterp.init_state(jcfg.bounds), jcfg.bounds)))
    assert ckpt.config_digest(cfg, eng2.caps, init_key) == \
        jdev.ckpt.config_digest(jcfg, jeng.caps, init_key)
    carry = jeng.load_checkpoint(port_path, init_key)
    for got, want in zip(carry, eng2.carry_to_numpy()):
        assert np.array_equal(np.asarray(got), want)
        assert np.asarray(got).dtype == want.dtype
    _same_result(jeng.check(resume=port_path), straight)


def test_cuda_engine_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg, _ = _configs(TOY, "election", ("NoTwoLeaders",), 64)
    with pytest.raises(RuntimeError, match="no GPU"):
        DeviceEngine(cfg, Capacities(**CAPS))


# -- SYMMETRY and VIEW: the dedup-key stage ----------------------------------

FULL22 = dict(n_servers=2, n_values=2, max_term=2, max_log=1, max_msgs=2)
ELECT3 = dict(n_servers=3, n_values=1, max_term=2, max_log=0, max_msgs=1)


def _sym_configs(kw, spec, axes, view, chunk, invs=("NoTwoLeaders",)):
    return (CheckConfig(bounds=Bounds(**kw), spec=spec, invariants=invs,
                        symmetry=axes, view=view, chunk=chunk),
            JConfig(bounds=JBounds(**kw), spec=spec, invariants=invs,
                    symmetry=axes, view=view, chunk=chunk))


@pytest.fixture(scope="module")
def sym_toy_jax():
    """The JAX engine for the 1,514-orbit toy, built once for the module."""
    _, jcfg = _sym_configs(TOY, "election", ("Server",), None, 64)
    return jdev.DeviceEngine(jcfg, jdev.Capacities(**CAPS), seg_chunks=8)


def _engines_agree(kw, spec, axes, view, chunk, want_n, jeng=None,
                   caps=CAPS):
    """The port's engine on the CPU against the JAX engine: the results,
    and the stored rows and parents of the final carry."""
    cfg, jcfg = _sym_configs(kw, spec, axes, view, chunk)
    eng = DeviceEngine(cfg, Capacities(**caps), device="cpu")
    got = eng.check()
    jeng = jeng or jdev.DeviceEngine(jcfg, jdev.Capacities(**caps))
    want = jeng.check(retain_carry=True)
    _same_result(got, want)
    assert got.n_states == want_n
    n = got.n_states
    mine = eng.carry_to_numpy()
    theirs = [np.asarray(x) for x in jeng.retained_carry]
    assert np.array_equal(mine[0][:n], theirs[0][:n])         # store rows
    assert np.array_equal(mine[1][:n], theirs[1][:n])         # parents
    assert np.array_equal(mine[4], theirs[4])                 # key table
    return got


def test_symmetric_engine_matches_jax_engine(sym_toy_jax):
    _engines_agree(TOY, "election", ("Server",), None, 64, 1514, sym_toy_jax)
    sym_toy_jax.retained_carry = None


def test_value_symmetric_engine_matches_jax_engine():
    _engines_agree(FULL22, "full", ("Server", "Value"), None, 256, 25281)


@pytest.mark.slow
@pytest.mark.parametrize("kw,spec,axes,view,chunk,want_n", [
    (ELECT3, "election", ("Server",), None, 1024, 23902),
    (ELECT3, "election", (), "deadvotes", 4096, 129134),
    (FULL22, "full", ("Server",), None, 1024, 37472),
    (FULL22, "full", ("Value",), None, 1024, 50515),
], ids=["election-3s-Server", "election-3s-deadvotes", "full-2s2v-Server",
        "full-2s2v-Value"])
def test_verified_quotient_counts_match_jax_engine(kw, spec, axes, view,
                                                   chunk, want_n):
    """The other verified orbit and view counts (RESULTS.md), each with the
    JAX engine's levels, transitions, coverage, rows and parents."""
    _engines_agree(kw, spec, axes, view, chunk, want_n,
                   caps=dict(n_states=1 << 18, levels=64))


def test_symmetric_seeded_violation_matches_oracle_and_replays():
    """The case of the JAX package's tests/test_symmetry.py:117."""
    kw = dict(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4,
              max_dup=1)
    cfg, jcfg = _sym_configs(kw, "election", ("Server",), None, 256,
                             invs=("NaiveNoTwoLeaders",))
    jstart = jinterp.init_state(jcfg.bounds)._replace(
        role=(JS.LEADER, JS.FOLLOWER, JS.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=((jmb.rv_response(3, 1, 1, 2), 1),))
    start = _port_state(jstart)
    ref = refbfs.check(jcfg, init_override=jstart)
    got = DeviceEngine(cfg, Capacities(n_states=1 << 15, levels=64),
                       device="cpu").check(init_override=start)
    assert got.violation.invariant == "NaiveNoTwoLeaders"
    assert got.violation.state == _port_state(ref.violation.state)
    assert got.levels == ref.levels
    trace = got.violation.trace
    assert trace[0] == (None, start)
    for (_l, prev), (_label, cur) in zip(trace, trace[1:]):
        assert cur in [t for _i, t in interp.successors(prev, cfg.bounds,
                                                       spec="election")]


def test_symmetric_checkpoints_move_both_ways(sym_toy_jax, tmp_path):
    """Under SYMMETRY Server: a JAX mid-search checkpoint resumes in the
    port, a port one resumes in JAX, both to the straight run's result; a
    run without symmetry refuses the symmetric checkpoint."""
    cfg, jcfg = _sym_configs(TOY, "election", ("Server",), None, 64)
    jeng = sym_toy_jax
    straight = jeng.check()
    assert straight.n_states == 1514
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

    plain, _ = _configs(TOY, "election", ("NoTwoLeaders",), 64)
    with pytest.raises(ValueError, match="different model config"):
        DeviceEngine(plain, Capacities(**CAPS), device="cpu").check(
            resume=port_path)
