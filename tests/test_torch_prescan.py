"""The prescan of the port's plain step (``ops/kernels.orbit_fp_prescan``,
``RAFT_TLA_PRESCAN``, ``--prescan``) against the reference's
``_orbit_fp_prescan`` and its gated XLA step, on the same inputs: reachable
states of the reference interpreter (``_reach``), repeated to take each
rung (N/4, N/2, the full N lanes), with all-ones sentinel lanes.  K1's
prescan is held to the same keys on the card (``test_torch_gpu.py``,
``chip_smoke.py`` phase 17a).  Tolerance: bit-exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.ops import fingerprint as jfpr
from raft_tla_tpu.ops import kernels as jkernels
from raft_tla_tpu.ops import state as jst
from raft_tla_tpu.ops import symmetry as jsym

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import kernels
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym

from test_torch_symmetry import ELECT5, FULL3, _reach

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_prescan(jb, axes, N):
    """The reference's ``_orbit_fp_prescan`` over packed rows and raw keys,
    jitted once for the rung cases (the rung is chosen inside)."""
    jlay = jst.Layout.of(jb)
    orbit = jsym.build_orbit_fp(
        jb, axes, jnp.asarray(jfpr.lane_constants(jlay.width)), False)

    def keys(rows, rh, rl):
        flat = jax.vmap(lambda v: jst.unpack(v, jlay, jnp))(rows)
        return jkernels._orbit_fp_prescan(orbit, flat, rh, rl, N)

    return jax.jit(keys)


@pytest.fixture(scope="module")
def full3_rows():
    return _reach(JBounds(**FULL3), "full", 5, 48)


@pytest.mark.parametrize("uniq,rung", [(12, 16), (28, 32), (48, 64)],
                         ids=["N/4", "N/2", "full"])
def test_prescan_matches_jax_on_every_rung(full3_rows, uniq, rung):
    """64 lanes holding ``uniq`` distinct rows, every 9th lane a sentinel
    (all-ones raw key, as an invalid lane): the port's keys equal the
    reference's on every lane, sentinels included, and the lanes' distinct
    raw keys take the named rung."""
    jb, b = JBounds(**FULL3), Bounds(**FULL3)
    axes = ("Server", "Value")
    N = 64
    rows = full3_rows[np.arange(N) % uniq]
    lay = st.Layout.of(b)
    consts = fpr.torch_constants(lay.width, "cpu")
    rh, rl = fpr.fingerprint(torch.as_tensor(rows), consts)
    sent = np.arange(N) % 9 == 4
    rh[torch.as_tensor(sent)] = -1
    rl[torch.as_tensor(sent)] = -1
    n_uniq = len({(int(h), int(lo)) for h, lo in zip(rh, rl)})
    assert (rung // 2 if rung < N else N // 2) < n_uniq <= rung
    got = kernels.orbit_fp_prescan(
        sym.build_orbit_fp(b, axes, consts),
        st.unpack(torch.as_tensor(rows), lay), rh, rl)
    want = _jax_prescan(jb, axes, N)(
        jnp.asarray(rows), jnp.asarray(rh.numpy().view(np.uint32)),
        jnp.asarray(rl.numpy().view(np.uint32)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))
    # and the prescan's keys are the full scan's wherever the raw key is a
    # row's own (the sentinel lanes share their group's representative)
    full = sym.build_orbit_fp(b, axes, consts)(
        st.unpack(torch.as_tensor(rows), lay))
    assert torch.equal(got[0][~torch.as_tensor(sent)],
                       full[0][~torch.as_tensor(sent)])


def test_prescan_step_matches_gated_xla_step(monkeypatch):
    """The port's plain step with the prescan against the reference's XLA
    step with ``RAFT_TLA_PRESCAN=on`` (Server, the deadvotes view):
    ``valid`` on every lane, the keys on every lane (0 where invalid),
    everything else where valid."""
    monkeypatch.setenv("RAFT_TLA_PRESCAN", "on")
    kw, spec, axes, view = FULL3, "full", ("Server",), "deadvotes"
    jb, b = JBounds(**kw), Bounds(**kw)
    rows = _reach(jb, spec, 5, 24)
    step = kernels.build_step(b, spec, ("NoTwoLeaders",), axes, view)
    got = step(torch.as_tensor(rows))
    want = jax.jit(jkernels.build_step(jb, spec, ("NoTwoLeaders",), axes,
                                       view, megakernel=False))(
        jnp.asarray(rows))
    val = np.asarray(want["valid"])
    assert np.array_equal(got["valid"].numpy(), val)
    for k in ("fp_hi", "fp_lo"):
        assert np.array_equal(got[k].numpy().view(np.uint32),
                              np.asarray(want[k]))
    for k in ("svecs", "inv_ok", "con_ok", "overflow"):
        diff = got[k].numpy() != np.asarray(want[k])
        if diff.ndim > 2:
            diff = diff.reshape(diff.shape[:2] + (-1,)).any(-1)
        assert not (diff & val).any(), k


def test_prescan_gate_follows_the_reference(monkeypatch):
    """``prescan_enabled`` on the CPU is the reference's
    ``_prescan_enabled`` for every setting; the card's auto rule depends on
    |G| alone."""
    for kw in (FULL3, ELECT5):
        jb, b = JBounds(**kw), Bounds(**kw)
        for env in ("auto", "on", "off", "bogus"):
            monkeypatch.setenv("RAFT_TLA_PRESCAN", env)
            for axes in ((), ("Server",), ("Server", "Value")):
                assert kernels.prescan_enabled(b, axes) == \
                    jkernels._prescan_enabled(jb, axes), (kw, env, axes)
    monkeypatch.setenv("RAFT_TLA_PRESCAN", "auto")
    for kw, axes in ((FULL3, ("Server",)), (FULL3, ("Server", "Value")),
                     (ELECT5, ("Server",))):
        b = Bounds(**kw)
        P, Q = sym.group_sizes(b, axes)
        assert kernels.prescan_enabled(b, axes, "cuda") == \
            (P * Q >= kernels.PRESCAN_MIN_GROUP)
    monkeypatch.setenv("RAFT_TLA_PRESCAN", "on")
    assert kernels.prescan_enabled(Bounds(**FULL3), ("Server",), "cuda")
    assert not kernels.prescan_enabled(Bounds(**FULL3), (), "cuda")
