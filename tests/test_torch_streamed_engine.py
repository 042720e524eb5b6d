"""The port's streamed engine (on the CPU) against the JAX
``StreamedEngine`` and the oracle.

``StreamedEngine(device="cpu")`` runs the plain torch step.  Blocks and
rings small enough to cycle many times per run: exact equality of states,
diameter, levels, transitions and coverage with the JAX engine (one engine
instance, so one JAX build, shared through a module fixture) and the
pure-Python oracle; a live window wider than the ring completes (where the
paged engine fails); SYMMETRY, faithful mode and a deadlock; and
block-boundary checkpoints that either package resumes to the
uninterrupted result.
"""

import pytest
import torch

from raft_tla_tpu import streamed_engine as jstreamed
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import refbfs

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.engine import DEADLOCK
from raft_tla_tpu_torch.paged_engine import PagedCapacities, PagedEngine
from raft_tla_tpu_torch.streamed_engine import (StreamedCapacities,
                                                StreamedEngine)

torch.set_num_threads(1)

TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
CAPS = dict(block=256, ring=4096, table=1 << 14, levels=64)


def _configs(kw, spec="election", invs=("NoTwoLeaders",), chunk=32,
             **more):
    return (CheckConfig(bounds=Bounds(**kw), spec=spec, invariants=invs,
                        chunk=chunk, **more),
            JConfig(bounds=JBounds(**kw), spec=spec, invariants=invs,
                    chunk=chunk, **more))


def _same(got, want):
    assert (got.n_states, got.diameter, got.levels, got.n_transitions) == \
        (want.n_states, want.diameter, want.levels, want.n_transitions)
    assert dict(got.coverage) == dict(want.coverage)
    assert (got.violation is None) == (want.violation is None)


def _engine(**kw):
    """The port's engine at the toy's caps; small segments, so a block
    takes several."""
    eng = StreamedEngine(_configs(TOY)[0], StreamedCapacities(**CAPS),
                         seg_chunks=8, device="cpu", **kw)
    eng.SEG_MAX = 8
    return eng


@pytest.fixture(scope="module")
def jax_engine():
    """One JAX StreamedEngine (one build) at the toy's caps, and its
    uninterrupted run."""
    eng = jstreamed.StreamedEngine(_configs(TOY)[1],
                                   jstreamed.StreamedCapacities(**CAPS),
                                   seg_chunks=8)
    eng.SEG_MAX = 8
    return eng, eng.check()


def test_tiny_block_and_ring_match_the_jax_engine(jax_engine):
    got = _engine().check()
    _same(got, jax_engine[1])
    _same(got, refbfs.check(_configs(TOY)[1]))
    assert (got.n_states, got.diameter) == (3014, 17) and got.complete


def test_window_past_any_ring_completes():
    """The toy's widest level pair is 812 rows; a 512-row ring holds it
    only as an append buffer: the streamed engine completes where the
    paged engine fails FAIL_RING."""
    cfg, jcfg = _configs(TOY, chunk=16)
    got = StreamedEngine(cfg, StreamedCapacities(
        block=128, ring=512, table=1 << 14, levels=64), device="cpu").check()
    _same(got, refbfs.check(jcfg))
    with pytest.raises(RuntimeError, match="live BFS window exceeded"):
        PagedEngine(cfg, PagedCapacities(ring=512, table=1 << 14,
                                         levels=64), device="cpu").check()


@pytest.mark.parametrize("case", ["symmetry", "view", "faithful"])
def test_symmetry_view_and_faithful_match_the_oracle(case):
    """Init keyed on the host (ops/symmetry.init_fingerprint) under
    SYMMETRY and a VIEW, and faithful rows through the host round trip."""
    if case == "symmetry":
        cfg, jcfg = _configs(TOY, symmetry=("Server",))
        want_n = 1514
    elif case == "view":
        cfg, jcfg = _configs(TOY, view="deadvotes")
        want_n = refbfs.check(jcfg).n_states
    else:
        kw = dict(TOY, history=True, max_elections=4)
        invs = ("NoTwoLeaders", "ElectionSafetyHist")
        cfg, jcfg = _configs(kw, invs=invs)
        want_n = 3014
    got = StreamedEngine(cfg, StreamedCapacities(**CAPS),
                         device="cpu").check()
    ref = refbfs.check(jcfg)
    _same(got, ref)
    assert got.n_states == want_n


def test_deadlock_detected():
    cfg, jcfg = _configs(dict(n_servers=1, n_values=1, max_term=2,
                              max_log=0, max_msgs=2), invs=(), chunk=16,
                         check_deadlock=True)
    got = StreamedEngine(cfg, StreamedCapacities(
        block=64, ring=2048, table=1 << 12, levels=64), device="cpu").check()
    ref = refbfs.check(jcfg)
    assert ref.violation is not None and got.violation is not None
    assert got.violation.invariant == DEADLOCK == ref.violation.invariant
    assert got.n_states == ref.n_states
    assert [lab for lab, _ in got.violation.trace] == \
        [lab for lab, _ in ref.violation.trace]


def test_checkpoints_cross_between_the_packages(tmp_path, jax_engine):
    """A snapshot the port writes at a block boundary, resumed by the JAX
    engine, and one the JAX engine writes, resumed by the port: both end
    at the uninterrupted counts."""
    jeng, straight = jax_engine
    mine = str(tmp_path / "port.ckpt")
    part = _engine().check(checkpoint=mine, max_chunks=40)
    assert not part.complete and part.n_states < straight.n_states
    _same(jeng.check(resume=mine), straight)
    _same(_engine().check(resume=mine), straight)
    theirs = str(tmp_path / "jax.ckpt")
    jpart = jeng.check(checkpoint=theirs, checkpoint_every_s=0.0,
                       deadline_s=0.0)
    assert not jpart.complete
    _same(_engine().check(resume=theirs), straight)
    with pytest.raises(ValueError, match="checkpoint"):
        StreamedEngine(_configs(TOY)[0], StreamedCapacities(
            **dict(CAPS, block=512)), device="cpu").check(resume=mine)
