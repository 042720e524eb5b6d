"""The step contract the device engine relies on, on the CPU.

K1 (csrc/step.cu) writes ``valid`` on every lane and leaves the other
outputs of an invalid lane unwritten.  These tests wrap the plain step so
that, on every invalid lane, ``svecs``, ``overflow``, ``fp_hi``, ``fp_lo``,
``inv_ok`` and ``con_ok`` hold seeded garbage, and hold the port's device
engine on the CPU to the same search as with the plain step itself: states,
parents, lanes, per-level counts, transitions, coverage, first violation and
trace.  No JAX: both runs are the port's.
"""

import numpy as np
import torch

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
from raft_tla_tpu_torch.models import interp, spec as SP
from raft_tla_tpu_torch.ops import msgbits as mb

torch.set_num_threads(1)

UNDEFINED = ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok")
TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)


def garbage_off_valid(step, seed: int):
    """``step`` with seeded garbage in every output but ``valid`` on the
    lanes where ``valid`` is false."""
    rng = np.random.default_rng(seed)

    def wrapped(vecs):
        out = step(vecs)
        dead = ~out["valid"]
        for k in UNDEFINED:
            t = out[k]
            if t.dtype == torch.bool:
                noise = torch.as_tensor(rng.random(t.shape) < 0.5)
            else:
                noise = torch.as_tensor(rng.integers(
                    -2**31, 2**31, size=t.shape, dtype=np.int64
                ).astype(np.int32))
            mask = dead.reshape(dead.shape + (1,) * (t.dim() - 2))
            out[k] = torch.where(mask, noise, t)
        return out

    return wrapped


def run_both(cfg: CheckConfig, start=None, n_states: int = 1 << 15):
    """The engine's result and carry with the plain step, then with the
    wrapped one."""
    runs = []
    for wrap in (False, True):
        eng = DeviceEngine(cfg, Capacities(n_states=n_states, levels=64),
                           device="cpu")
        if wrap:
            eng.step = garbage_off_valid(eng.step, seed=2026)
        res = eng.check(init_override=start)
        n = res.n_states
        c = eng.carry
        runs.append((res, c["store"][:n].clone(), c["parent"][:n].clone(),
                     c["lane"][:n].clone()))
    return runs


def assert_same_search(runs):
    (want, *wc), (got, *gc) = runs
    assert got.n_states == want.n_states
    assert got.levels == want.levels
    assert got.diameter == want.diameter
    assert got.n_transitions == want.n_transitions
    assert dict(got.coverage) == dict(want.coverage)
    for a, b in zip(gc, wc):
        assert torch.equal(a, b)
    assert (got.violation is None) == (want.violation is None)
    if want.violation is not None:
        assert got.violation.invariant == want.violation.invariant
        assert got.violation.state == want.violation.state
        assert got.violation.trace == want.violation.trace


def test_wrapper_changes_only_invalid_lanes():
    from raft_tla_tpu_torch.ops import kernels
    b = Bounds(**TOY)
    step = kernels.build_step(b, "election", ("NoTwoLeaders",))
    rows = torch.as_tensor(np.stack([interp.to_vec(interp.init_state(b), b)]
                                    * 4))
    want = step(rows)
    got = garbage_off_valid(step, seed=1)(rows)
    val = want["valid"]
    assert torch.equal(got["valid"], val) and (~val).any()
    for k in UNDEFINED:
        diff = got[k] != want[k]
        if diff.dim() > 2:
            diff = diff.flatten(2).any(-1)
        assert not (diff & val).any(), k
    assert (got["svecs"] != want["svecs"]).flatten(2).any(-1)[~val].all()


def test_verified_toy_ignores_invalid_lanes():
    cfg = CheckConfig(bounds=Bounds(**TOY), spec="election",
                      invariants=("NoTwoLeaders",), chunk=256)
    runs = run_both(cfg)
    assert runs[0][0].n_states == 3014 and runs[0][0].diameter == 17
    assert_same_search(runs)


def test_symmetry_server_ignores_invalid_lanes():
    cfg = CheckConfig(bounds=Bounds(**TOY), spec="election",
                      invariants=("NoTwoLeaders",), symmetry=("Server",),
                      chunk=256)
    runs = run_both(cfg)
    assert runs[0][0].n_states == 1514
    assert_same_search(runs)


def test_faithful_ignores_invalid_lanes():
    b = Bounds(history=True, max_elections=4, **TOY)
    cfg = CheckConfig(bounds=b, spec="election",
                      invariants=("NoTwoLeaders", "ElectionSafetyHist",
                                  "AllLogsPrefixClosed"), chunk=256)
    assert_same_search(run_both(cfg))


def test_seeded_violation_ignores_invalid_lanes():
    """The seeded NaiveNoTwoLeaders violation of the JAX package's
    tests/test_symmetry.py:117: the same first violation and trace."""
    b = Bounds(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)
    start = interp.init_state(b)._replace(
        role=(SP.LEADER, SP.FOLLOWER, SP.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=(((mb.rv_response(3, 1, 1, 2)), 1),))
    cfg = CheckConfig(bounds=b, spec="election",
                      invariants=("NaiveNoTwoLeaders",), chunk=256)
    runs = run_both(cfg, start)
    assert runs[0][0].violation.invariant == "NaiveNoTwoLeaders"
    assert_same_search(runs)


def test_deadlock_check_ignores_invalid_lanes():
    """``--deadlock`` reads ``valid`` alone: a 1-server election."""
    b = Bounds(n_servers=1, n_values=1, max_term=2, max_log=0, max_msgs=2)
    cfg = CheckConfig(bounds=b, spec="election", invariants=("NoTwoLeaders",),
                      chunk=64, check_deadlock=True)
    runs = run_both(cfg)
    assert runs[0][0].violation is not None
    assert_same_search(runs)
