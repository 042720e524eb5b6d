"""The port's plain step with the dedup-key stage (SYMMETRY and VIEW)
against the reference's XLA step, every output, on reachable states of the
reference interpreter (``_reach``, test_torch_symmetry.py); K1's group
table layout; and the config refusals.  Tolerance: bit-exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.models import views as jviews
from raft_tla_tpu.ops import kernels as jkernels

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.models import views
from raft_tla_tpu_torch.ops import kernels, pallas_step
from raft_tla_tpu_torch.ops import symmetry as sym

from test_torch_symmetry import ELECT4, FULL3, _reach

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)


STEP_CASES = {
    "3s2v-ServerxValue-deadvotes": (FULL3, "full", ("Server", "Value"),
                                    "deadvotes", 6),
    "3s2v-deadvotes": (FULL3, "full", (), "deadvotes", 6),
    "4s-election-Server": (ELECT4, "election", ("Server",), None, 7),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_plain_step_with_dedup_key_matches_xla_step(name):
    """Every output of the plain step with ``symmetry``/``view`` against the
    reference's XLA step: ``valid`` on every lane, the rest where valid."""
    kw, spec, axes, view, depth = STEP_CASES[name]
    jb, b = JBounds(**kw), Bounds(**kw)
    invs = ("NoTwoLeaders", "LogMatching")
    rows = _reach(jb, spec, depth, 48)
    got = kernels.build_step(b, spec, invs, axes, view)(torch.as_tensor(rows))
    want = jax.jit(jkernels.build_step(jb, spec, invs, axes, view,
                                       megakernel=False))(jnp.asarray(rows))
    val = np.asarray(want["valid"])
    assert np.array_equal(got["valid"].numpy(), val) and val.sum() > 48
    for k in ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok"):
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in ("fp_hi", "fp_lo"):
            g = g.view(np.uint32)
            if axes:                             # invalid lanes: key 0
                assert not g[~val].any() and not w[~val].any(), k
        diff = g != w
        if diff.ndim > 2:
            diff = diff.reshape(diff.shape[:2] + (-1,)).any(-1)
        assert not (diff & val).any(), k
    # the CPU build of the K1 launcher is this plain step
    cpu = pallas_step.build_step(b, spec, invs, "cpu", symmetry=axes,
                                 view=view)(torch.as_tensor(rows))
    assert torch.equal(cpu["fp_hi"], got["fp_hi"])


def test_kernel_group_table_layout():
    """K1's table: P rows of (p, inv), then Q rows of q, identity first."""
    b = Bounds(**FULL3)
    t = sym.kernel_tables(b, ("Server", "Value"))
    assert t.dtype == np.int8 and t.size == 6 * 6 + 2 * 2
    rows = t[:36].reshape(6, 6)
    for r, p in zip(rows, sym.permutations(b)):
        assert tuple(r[:3]) == p
        assert all(p[r[3 + k]] == k for k in range(3))
    assert tuple(t[36:38]) == (0, 1)
    assert sym.kernel_tables(b, ()).tolist() == [0, 1, 2, 0, 1, 2]
    assert sym.group_sizes(b, ("Server", "Value")) == (6, 2)


def test_config_refusals_match_reference():
    b = Bounds(n_servers=7, n_values=1, max_term=2, max_log=0, max_msgs=1)
    with pytest.raises(ValueError, match="at most 6 servers"):
        CheckConfig(bounds=b, symmetry=("Server",))
    with pytest.raises(ValueError, match="at most 5 values"):
        CheckConfig(bounds=Bounds(n_servers=2, n_values=6),
                    symmetry=("Value",))
    with pytest.raises(ValueError, match="unknown view 'nope'"):
        CheckConfig(view="nope")
    with pytest.raises(ValueError, match="not supported"):
        CheckConfig(symmetry=("Term",))
    assert views.REGISTRY.keys() == jviews.REGISTRY.keys()
    assert views.EQUIVARIANT_AXES == jviews.EQUIVARIANT_AXES
    assert views.VIEW_WRITES == jviews.VIEW_WRITES
