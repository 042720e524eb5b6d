"""The port's plain step against the reference's Pallas kernel (on the
interpreter), at the flagship width against the XLA step, and inside the
fused write surface; inputs and the contract are test_torch_step.py's.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.ops import kernels as jkernels
from raft_tla_tpu.ops import pallas_step as jpallas_step

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.ops import kernels, pallas_step
from raft_tla_tpu_torch.ops import state as st

from test_torch_step import (ALL_INV, FULL3, REPL3, _case_rows,
                             _leader_start, _reach, assert_step_contract)

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", [
    "election-2s",
    pytest.param("full-2s2v", marks=pytest.mark.slow),
    pytest.param("replication-3s-leader", marks=pytest.mark.slow),
])
def test_plain_step_matches_pallas_megakernel(name):
    """The Pallas build on the interpreter; its compile is the costliest
    part of these tests, so two of the three cases run in the slow tier
    (tests/test_pallas_step.py holds the megakernel to the XLA step)."""
    jb, spec, invs, rows, got = _case_rows(name)
    mega = jpallas_step.build_step_megakernel(jb, spec, invs, (),
                                              interpret=True)
    assert assert_step_contract(got, mega(jnp.asarray(rows))) > rows.shape[0]


def test_plain_step_matches_reference_at_full_width():
    """3 servers, 2 values, t2 l1 m2: W = 60, A = 42, against the XLA step
    only (it bounds the JAX compile time)."""
    jb = JBounds(**FULL3)
    rows = _reach(jb, "full", 6, 64)
    got = kernels.build_step(Bounds(**FULL3), "full", ALL_INV)(
        torch.as_tensor(rows))
    assert tuple(got["svecs"].shape) == (64, 42, 60)
    xla = jax.jit(jkernels.build_step(jb, "full", ALL_INV, (),
                                      megakernel=False))
    assert assert_step_contract(got, xla(jnp.asarray(rows))) > 64


@pytest.mark.parametrize("spec", ["full", "election", "replication"])
def test_step_stays_inside_fused_write_surface(spec):
    """A successor differs from its parent only in FUSED_WRITES fields,
    and the port's table is the reference's (faithful-mode fields
    included; tests/test_torch_history.py checks faithful successors)."""
    b = Bounds(**REPL3)
    jb = JBounds(**REPL3)
    rows = _reach(jb, spec, 5, 96,
                  start=_leader_start(jb) if spec == "replication" else None)
    out = kernels.build_step(b, spec, ())(torch.as_tensor(rows))
    lay = st.Layout.of(b)
    succ = st.unpack(out["svecs"], lay)
    par = st.unpack(torch.as_tensor(rows)[:, None, :], lay)
    val = out["valid"]
    written = {f for f in st.STATE_FIELDS
               if ((succ[f] != par[f]).reshape(val.shape + (-1,)).any(-1)
                   & val).any()}
    assert written <= set(pallas_step.FUSED_WRITES[spec])
    assert set(pallas_step.FUSED_WRITES[spec]) == \
        set(jpallas_step.FUSED_WRITES[spec])
