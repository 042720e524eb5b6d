"""The port's dedup-key stage (SYMMETRY and VIEW) against the JAX reference.

The plain batched orbit key (``raft_tla_tpu_torch.ops.symmetry
.build_orbit_fp``), which K1's orbit stage (``csrc/step.cu``) is held to on
the card, is compared with the reference's ``build_orbit_fp`` (its scan) and
``orbit_fingerprint`` (one state, NumPy); the host key of the initial state
with ``init_fingerprint`` (the plain step with ``symmetry``/``view``:
``test_torch_symmetry_step.py``).  Inputs are reachable states of the
reference interpreter.  Tolerance: bit-exact (uint32 key bits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import interp as jinterp
from raft_tla_tpu.models import spec as JS
from raft_tla_tpu.models import views as jviews
from raft_tla_tpu.ops import fingerprint as jfpr
from raft_tla_tpu.ops import msgbits as jmb
from raft_tla_tpu.ops import state as jst
from raft_tla_tpu.ops import symmetry as jsym

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.models import interp, views
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

FULL3 = dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2)
ELECT2 = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
ELECT4 = dict(n_servers=4, n_values=1, max_term=2, max_log=0, max_msgs=1)
ELECT5 = dict(n_servers=5, n_values=2, max_term=2, max_log=0, max_msgs=2)


def _reach(b, spec, depth, cap, lane_cap=40):
    """Up to ``cap`` reachable states of the reference interpreter, from
    BFS levels 0..depth (at most ``lane_cap`` kept per level)."""
    frontier = [jinterp.init_state(b)]
    seen = list(frontier)
    for _ in range(depth):
        nxt = []
        for s in frontier:
            if jinterp.constraint_ok(s, b):
                nxt += [t for _i, t in jinterp.successors(s, b, spec=spec)]
        frontier = nxt[::max(1, len(nxt) // lane_cap)][:lane_cap]
        seen += frontier
    return np.stack([jinterp.to_vec(s, b) for s in seen[-cap:]])


def _u32(t):
    return fpr.as_uint32(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t).astype(np.uint32)


# (bounds, spec, axes, depth): |G| = 6, 2, 12, 2, 24, 120
KEY_CASES = {
    "3s2v-Server": (FULL3, "full", ("Server",), 6),
    "3s2v-Value": (FULL3, "full", ("Value",), 6),
    "3s2v-ServerxValue": (FULL3, "full", ("Server", "Value"), 6),
    "2s-election-Server": (ELECT2, "election", ("Server",), 8),
    "4s-election-Server": (ELECT4, "election", ("Server",), 7),
    "5s2v-election-Server": (ELECT5, "election", ("Server",), 6),
}


@pytest.mark.parametrize("name", list(KEY_CASES))
def test_plain_orbit_key_matches_jax(name):
    """With and without the deadvotes view: the port's plain batched key
    equals the reference's scan on every row, and the reference's and the
    port's one-state NumPy keys on the first rows."""
    kw, spec, axes, depth = KEY_CASES[name]
    jb, b = JBounds(**kw), Bounds(**kw)
    rows = _reach(jb, spec, depth, 64)
    lay = jst.Layout.of(jb)
    jstruct = jax.vmap(lambda v: jst.unpack(v, lay, jnp))(jnp.asarray(rows))
    consts = jnp.asarray(jfpr.lane_constants(lay.width))
    jorbit = jax.jit(jsym.build_orbit_fp(jb, axes, consts, False))
    jview = jax.vmap(jviews.jnp_view("deadvotes", jb))
    tstruct = st.unpack(torch.as_tensor(rows), st.Layout.of(b))
    orbit = sym.build_orbit_fp(b, axes, fpr.torch_constants(lay.width, "cpu"))
    for view in (None, "deadvotes"):
        js = jview(jstruct) if view else jstruct
        ts = views.torch_view(view)(tstruct) if view else tstruct
        want = [np.asarray(k) for k in jorbit(js)]
        got = [_u32(k) for k in orbit(ts)]
        assert np.array_equal(got[0], want[0]) and \
            np.array_equal(got[1], want[1]), view
        assert len(set(zip(want[0], want[1]))) > 8      # keys that differ
        hconsts = jfpr.lane_constants(lay.width)
        for r in range(4):
            one = {f: np.asarray(a[r]) for f, a in js.items()}
            jh, jl = jsym.orbit_fingerprint(one, jb, hconsts, np, axes)
            assert (int(jh), int(jl)) == (int(want[0][r]), int(want[1][r]))
            assert sym.orbit_fingerprint(one, b, hconsts, axes) == \
                (int(jh), int(jl))


@pytest.mark.parametrize("kw,axes,view", [
    (FULL3, ("Server",), None),
    (FULL3, ("Server", "Value"), "deadvotes"),
    (FULL3, ("Value",), None),
    (ELECT2, (), "deadvotes"),
    (ELECT2, (), None),
])
def test_init_fingerprint_matches_jax(kw, axes, view):
    """The host key of Init and of a crafted start state (a candidate with
    vote sets, a message in flight)."""
    jb = JBounds(**kw)
    jcfg = JConfig(bounds=jb, spec="full", invariants=(), symmetry=axes,
                   view=view)
    cfg = CheckConfig(bounds=Bounds(**kw), spec="full", invariants=(),
                      symmetry=axes, view=view)
    n = jb.n_servers
    crafted = jinterp.init_state(jb)._replace(
        role=(JS.FOLLOWER,) * (n - 1) + (JS.CANDIDATE,),
        term=(2,) * n, votedFor=(0,) * (n - 1) + (n,),
        vResp=(1,) + (0,) * (n - 2) + (0b11,),
        vGrant=(1,) + (0,) * (n - 2) + (0b10,),
        msgs=((jmb.rv_response(2, 1, 0, n - 1), 1),))
    for js in (jinterp.init_state(jb), crafted):
        ps = interp.PyState(**{f: getattr(js, f)
                               for f in interp.PyState.__dataclass_fields__})
        want = tuple(int(x) for x in jsym.init_fingerprint(
            jcfg, js, jinterp.to_vec(js, jb)))
        assert sym.init_fingerprint(cfg, ps, interp.to_vec(ps, cfg.bounds)) \
            == want
