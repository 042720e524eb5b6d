"""The routed DDD step of the port (``ops/kernels.build_step_routed``,
``--route K``) against the reference's ``build_step_routed``: the same
rows (reachable states of the reference interpreter) and ``row_ok``, every
output on every slot; an overflow; the construction errors; and the
engine's abort.  On the card the routed step is K1's dense output then the
same compaction (``ops/pallas_step.build_step_routed``,
``test_torch_gpu.py``).  Tolerance: bit-exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.device_engine import FAIL_ROUTE as JFAIL_ROUTE
from raft_tla_tpu.device_engine import decode_fail as jdecode_fail
from raft_tla_tpu.ops import kernels as jkernels

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
from raft_tla_tpu_torch.device_engine import FAIL_ROUTE, decode_fail
from raft_tla_tpu_torch.ops import kernels, pallas_step

from test_torch_symmetry import FULL3, _reach

torch.set_num_threads(1)

INVS = ("NoTwoLeaders", "LogMatching")
K_ROWS = 24
AXES, VIEW = ("Server", "Value"), "deadvotes"


@pytest.fixture(scope="module")
def jax_routed():
    """The reference's routed step, compiled once for the file (its
    slot count is static; both cases run it on other inputs)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RAFT_TLA_SIGPRUNE", "on")        # read at construction
    try:
        fn = jax.jit(jkernels.build_step_routed(
            JBounds(**FULL3), "full", INVS, AXES, k_rows=K_ROWS, view=VIEW,
            megakernel=False))
    finally:
        mp.undo()
    return fn


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_routed_step_matches_jax(monkeypatch, case, jax_routed):
    """Server x Value, the deadvotes view and sig-prune on, 24 slots:
    with every third row not live (more enabled lanes than slots), and
    with only the leading rows whose enabled lanes fit; every output equal
    on every slot (unused slots hold lane N - 1's values in both),
    ``route_ovf`` and ``n_en`` equal; the live slots hold the dense step's
    values at ``cidx``."""
    monkeypatch.setenv("RAFT_TLA_SIGPRUNE", "on")
    jb, b = JBounds(**FULL3), Bounds(**FULL3)
    k_rows, axes, view = K_ROWS, AXES, VIEW
    rows = _reach(jb, "full", 5, 24)
    dense = kernels.build_step(b, "full", INVS, axes, view)(
        torch.as_tensor(rows))
    if case == "overflow":
        row_ok = np.arange(rows.shape[0]) % 3 != 1
    else:
        per_row = dense["valid"].sum(1).numpy()
        row_ok = np.cumsum(per_row) <= k_rows
        assert 0 < per_row[row_ok].sum() <= k_rows and not row_ok.all()
    got = kernels.build_step_routed(b, "full", INVS, axes, k_rows, view)(
        torch.as_tensor(rows), torch.as_tensor(row_ok))
    want = jax_routed(jnp.asarray(rows), jnp.asarray(row_ok))
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in ("cfp_hi", "cfp_lo"):
            g = g.view(np.uint32)
        assert np.array_equal(g, w), k
    n_live = int((np.asarray(want["valid"]) & row_ok[:, None]).sum())
    assert int(got["n_en"]) == n_live
    assert bool(got["route_ovf"]) == (n_live > k_rows) == (case == "overflow")
    cv = got["cvalid"]
    src = got["cidx"][cv].long()
    assert torch.equal(got["cfp_hi"][cv], dense["fp_hi"].reshape(-1)[src])
    assert torch.equal(got["csvecs"][cv],
                       dense["svecs"].reshape(-1, rows.shape[1])[src])


def test_routed_step_construction_errors(monkeypatch):
    """The reference's refusals: the megakernel gate on, and no slots; the
    CPU build of the routed launcher is the plain routed step."""
    jb, b = JBounds(**FULL3), Bounds(**FULL3)
    monkeypatch.setenv("RAFT_TLA_MEGAKERNEL", "on")
    with pytest.raises(ValueError) as mine:
        kernels.build_step_routed(b, "full", INVS, (), 64)
    with pytest.raises(ValueError) as ref:
        jkernels.build_step_routed(jb, "full", INVS, (), k_rows=64)
    assert str(mine.value) == str(ref.value)
    monkeypatch.setenv("RAFT_TLA_MEGAKERNEL", "auto")
    for k in (0, -3):
        with pytest.raises(ValueError) as mine:
            kernels.build_step_routed(b, "full", INVS, (), k)
        with pytest.raises(ValueError) as ref:
            jkernels.build_step_routed(jb, "full", INVS, (), k_rows=k)
        assert str(mine.value) == str(ref.value)
    step = pallas_step.build_step_routed(b, "full", INVS, "cpu",
                                         k_rows=64)
    rows = torch.as_tensor(_reach(jb, "full", 2, 4))
    out = step(rows)
    assert int(out["n_en"]) == int(kernels.build_step(b, "full", INVS)(
        rows)["valid"].sum())


def test_route_overflow_aborts_the_engine():
    """Too few slots: the DDD engine aborts with the reference's text;
    ``route_rows`` is checked as the reference's."""
    assert FAIL_ROUTE == JFAIL_ROUTE
    assert decode_fail(FAIL_ROUTE) == jdecode_fail(JFAIL_ROUTE)
    cfg = CheckConfig(bounds=Bounds(2, 1, 2, 0, 2), spec="election",
                      invariants=("NoTwoLeaders",), chunk=64)
    eng = DDDEngine(cfg, DDDCapacities(block=256, table=1 << 12,
                                       seg_rows=1 << 12, route_rows=3),
                    device="cpu")
    with pytest.raises(RuntimeError) as e:
        eng.check()
    assert f"DDD search aborted: {decode_fail(FAIL_ROUTE)} " in str(e.value)
    with pytest.raises(ValueError, match="route_rows=-1 must be >= 0"):
        DDDCapacities(route_rows=-1)
