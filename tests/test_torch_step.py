"""The port's fused step against the JAX reference's two step builds.

Inputs are reachable rows drawn from the reference interpreter; the plain
torch step (``raft_tla_tpu_torch.ops.kernels.build_step``), which the CUDA
kernel ``csrc/step.cu`` is held to on the card, is compared with
``kernels.build_step(..., megakernel=False)`` (the XLA step) and with
``pallas_step.build_step_megakernel(..., interpret=True)`` (the Pallas
kernel on the interpreter, in test_torch_step_pallas.py).

Contract, bit-exact: ``valid`` equal on every lane; ``svecs``,
``overflow``, ``fp_hi``, ``fp_lo``, ``inv_ok`` and ``con_ok`` equal on every
lane where ``valid`` is true.  Invalid lanes are compared masked because the
engine never reads them: the JAX step leaves whatever the unguarded effect
computed there, and the CUDA kernel writes zeros.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.models import interp as jinterp
from raft_tla_tpu.models import spec as JS
from raft_tla_tpu.ops import kernels as jkernels

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import spec as SP
from raft_tla_tpu_torch.ops import kernels, pallas_step

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

ALL_INV = ("NoTwoLeaders", "NaiveNoTwoLeaders", "LogMatching",
           "CommittedWithinLog", "LeaderCompleteness")
FULL2 = dict(n_servers=2, n_values=2, max_term=2, max_log=1, max_msgs=2)
ELECT2 = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
REPL3 = dict(n_servers=3, n_values=1, max_term=2, max_log=1, max_msgs=2)
FULL3 = dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2)


def _leader_start(b):
    return jinterp.init_state(b)._replace(
        role=(JS.LEADER, JS.FOLLOWER, JS.FOLLOWER), term=(2, 2, 2),
        votedFor=(1, 1, 1))


def _reach(b, spec, depth, cap, start=None, lane_cap=60):
    frontier = [start or jinterp.init_state(b)]
    seen = list(frontier)
    for _ in range(depth):
        nxt = []
        for s in frontier:
            if jinterp.constraint_ok(s, b):
                nxt += [t for _i, t in jinterp.successors(s, b, spec=spec)]
        frontier = nxt[:lane_cap]
        seen += frontier
    return np.stack([jinterp.to_vec(s, b) for s in seen[:cap]])


def _np(out):
    res = {}
    for k, v in out.items():
        a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if k in ("fp_hi", "fp_lo"):
            a = a.view(np.uint32)
        res[k] = a
    return res


def assert_step_contract(got, want):
    got, want = _np(got), _np(want)
    assert set(got) == set(want)
    val = want["valid"]
    assert np.array_equal(got["valid"], val)
    for k in ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok"):
        assert got[k].shape == want[k].shape, k
        diff = got[k] != want[k]
        if diff.ndim > 2:
            diff = diff.reshape(diff.shape[:2] + (-1,)).any(-1)
        assert not (diff & val).any(), k
    return int(val.sum())


CASES = {
    "full-2s2v": (FULL2, "full", ALL_INV, False, 5),
    "election-2s": (ELECT2, "election", ("NoTwoLeaders", "NaiveNoTwoLeaders"),
                    False, 6),
    "replication-3s-leader": (REPL3, "replication",
                              ("LogMatching", "CommittedWithinLog",
                               "LeaderCompleteness"), True, 6),
}


def _case_rows(name):
    kw, spec, invs, leader, depth = CASES[name]
    jb = JBounds(**kw)
    rows = _reach(jb, spec, depth, 128,
                  start=_leader_start(jb) if leader else None)
    got = kernels.build_step(Bounds(**kw), spec, invs)(torch.as_tensor(rows))
    return jb, spec, invs, rows, got


@pytest.mark.parametrize("name", list(CASES))
def test_plain_step_matches_xla_step(name):
    jb, spec, invs, rows, got = _case_rows(name)
    xla = jax.jit(jkernels.build_step(jb, spec, invs, (), megakernel=False))
    assert assert_step_contract(got, xla(jnp.asarray(rows))) > rows.shape[0]


@pytest.mark.parametrize("spec", ["full", "election", "replication"])
def test_action_table_lane_order_matches_reference(spec):
    for kw in (FULL3, ELECT2):
        got = [(a.family, a.i, a.j, a.v, a.slot)
               for a in SP.action_table(Bounds(**kw), spec)]
        want = [(a.family, a.i, a.j, a.v, a.slot)
                for a in JS.action_table(JBounds(**kw), spec)]
        assert got == want
        assert [r[0] for r in SP.lane_table(Bounds(**kw), spec)] == \
            [SP.FAMILY_CODES[f] for f, *_ in got]


def test_cpu_build_is_the_plain_step():
    b = Bounds(**ELECT2)
    rows = torch.as_tensor(_reach(JBounds(**ELECT2), "election", 4, 32))
    got = pallas_step.build_step(b, "election", ("NoTwoLeaders",), "cpu")(rows)
    want = kernels.build_step(b, "election", ("NoTwoLeaders",))(rows)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert pallas_step.launches == 0


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        pallas_step.build_step(Bounds(**ELECT2), "election", (), "cuda")

