"""Sig-prune in the port (``ops/symmetry.build_orbit_fp(prune=True)``,
``RAFT_TLA_SIGPRUNE``, ``--sig-prune``) against the reference's
``build_orbit_fp(prune=True)`` and its helpers, on the same reachable
states of the reference interpreter (``_reach``): |G| = 6, Server x
Value, faithful mode, the deadvotes view, and the two adversarial poles of
``tests/test_sigprune.py`` (every server alike: one kept permutation;
every server distinct: the whole group).  K1's sig-prune is held to the
same keys on the card.  Tolerance: bit-exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.models import interp as jinterp
from raft_tla_tpu.models import views as jviews
from raft_tla_tpu.ops import fingerprint as jfpr
from raft_tla_tpu.ops import state as jst
from raft_tla_tpu.ops import symmetry as jsym

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import interp, views
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym

from test_torch_symmetry import FULL3, _reach

torch.set_num_threads(1)

ELECT5_1V = dict(n_servers=5, n_values=1, max_term=2, max_log=0, max_msgs=2)


@functools.lru_cache(maxsize=None)
def _jax_pruned(jb, axes, view):
    """The reference's pruned orbit key of packed rows, jitted once per
    layout, group and view."""
    jlay = jst.Layout.of(jb)
    orbit = jsym.build_orbit_fp(
        jb, axes, jnp.asarray(jfpr.lane_constants(jlay.width)), jb.history,
        prune=True)

    def keys(rows):
        js = jax.vmap(lambda v: jst.unpack(v, jlay, jnp))(rows)
        if view:
            js = jax.vmap(jviews.jnp_view(view, jb))(js)
        return orbit(js)

    return jax.jit(keys)


def _both(jb, b, rows, axes, view=None):
    """(port keys, reference keys) of ``rows`` under pruned orbit scans,
    as uint32 arrays, after ``view``."""
    lay = st.Layout.of(b)
    s = st.unpack(torch.as_tensor(rows), lay)
    if view:
        s = views.torch_view(view)(s)
    got = sym.build_orbit_fp(b, axes, fpr.torch_constants(lay.width, "cpu"),
                             prune=True)(s)
    want = _jax_pruned(jb, axes, view)(jnp.asarray(rows))
    return ([g.numpy().view(np.uint32) for g in got],
            [np.asarray(w) for w in want])


def test_sigprune_tables_and_signature_match_jax():
    """The probe tables, the pair-less table and the server signature."""
    for kw in (FULL3, ELECT5_1V):
        jb, b = JBounds(**kw), Bounds(**kw)
        assert sym._transposition_pairs(b) == jsym._transposition_pairs(jb)
        assert sym._value_transposition_pairs(b) == \
            jsym._value_transposition_pairs(jb)
        pairs = sym._transposition_pairs(b)
        assert np.array_equal(
            sym._pair_less_lut(sym.permutations(b), pairs),
            jsym._pair_less_lut(jsym.permutations(jb), pairs))
    jb, b = JBounds(**FULL3), Bounds(**FULL3)
    rows = _reach(jb, "full", 5, 40)
    got = sym._server_sig(st.unpack(torch.as_tensor(rows), st.Layout.of(b)))
    jlay = jst.Layout.of(jb)
    want = jsym._server_sig(jax.vmap(lambda v: jst.unpack(v, jlay, jnp))(
        jnp.asarray(rows)), jnp)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


FULL2 = dict(n_servers=2, n_values=2, max_term=2, max_log=1, max_msgs=1)


@pytest.mark.parametrize("kw,faithful,axes,view", [
    (FULL3, False, ("Server",), None),
    (FULL3, False, ("Server", "Value"), "deadvotes"),
    (FULL2, True, ("Server", "Value"), None),
], ids=["Server", "ServerxValue-deadvotes", "faithful-ServerxValue"])
def test_pruned_orbit_key_matches_jax(kw, faithful, axes, view):
    """The pruned keys equal the reference's pruned keys and the port's
    full scan on reachable states."""
    hist = dict(history=True, max_elections=2) if faithful else {}
    jb, b = JBounds(**kw, **hist), Bounds(**kw, **hist)
    rows = _reach(jb, "full", 5, 24 if faithful else 40)
    got, want = _both(jb, b, rows, axes, view)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    lay = st.Layout.of(b)
    s = st.unpack(torch.as_tensor(rows), lay)
    if view:
        s = views.torch_view(view)(s)
    full = sym.build_orbit_fp(b, axes, fpr.torch_constants(lay.width, "cpu"))(s)
    assert all(np.array_equal(g, f.numpy().view(np.uint32))
               for g, f in zip(got, full))


def test_adversarial_all_servers_identical():
    """Every transposition verifies on the initial state of 5 servers: one
    server permutation of 120 is kept, and the key is still the full
    scan's and the reference's."""
    jb, b = JBounds(**ELECT5_1V), Bounds(**ELECT5_1V)
    rows = np.stack([jinterp.to_vec(jinterp.init_state(jb), jb)] * 4)
    got, want = _both(jb, b, rows, ("Server",))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    lay = st.Layout.of(b)
    s = st.unpack(torch.as_tensor(rows), lay)
    images = sym.group_images(b, ("Server",), "cpu")
    keep = sym.keep_mask(b, ("Server",), s, images)
    assert keep.sum(1).tolist() == [1] * 4 and bool(keep[:, 0].all())


def test_adversarial_all_servers_distinct_keeps_the_group():
    """No transposition verifies (distinct roles and terms): the whole
    group is kept, and the key (not the identity's) equals the
    reference's."""
    jb, b = JBounds(**FULL3), Bounds(**FULL3)
    s = interp.init_state(b)._replace(role=(0, 1, 2), term=(1, 2, 2),
                                      votedFor=(0, 2, 3))
    rows = np.repeat(interp.to_vec(s, b)[None, :], 40, axis=0)
    got, want = _both(jb, b, rows, ("Server",))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    lay = st.Layout.of(b)
    struct = st.unpack(torch.as_tensor(rows[:1]), lay)
    sig = sym._server_sig(struct)[0]
    assert len(set(sig.tolist())) == 3
    keep = sym.keep_mask(b, ("Server",), struct,
                         sym.group_images(b, ("Server",), "cpu"))
    assert bool(keep.all())
    ih, il = fpr.fingerprint(torch.as_tensor(rows[:1]),
                             fpr.torch_constants(lay.width, "cpu"))
    assert (int(ih[0]), int(il[0])) != (int(got[0][0].view(np.int32)),
                                        int(got[1][0].view(np.int32)))
