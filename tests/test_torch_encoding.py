"""The port's state encoding and fingerprint against the JAX reference.

Same inputs (reachable rows from the reference interpreter, or numpy-seeded
rows) through ``raft_tla_tpu`` and ``raft_tla_tpu_torch``; tolerance
bit-exact, since every value is int32 or uint32 bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.models import interp as jinterp
from raft_tla_tpu.ops import fingerprint as jfpr
from raft_tla_tpu.ops import pallas_fp as jpallas_fp
from raft_tla_tpu.ops import state as jst
from raft_tla_tpu.utils import native

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import interp
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import pallas_fp
from raft_tla_tpu_torch.ops import state as st

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

KW = dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2)


def _reach(kw, spec="full", depth=4, cap=200):
    b = JBounds(**kw)
    frontier = [jinterp.init_state(b)]
    seen = list(frontier)
    for _ in range(depth):
        nxt = []
        for s in frontier:
            if jinterp.constraint_ok(s, b):
                nxt += [t for _i, t in jinterp.successors(s, b, spec=spec)]
        frontier = nxt[:80]
        seen += frontier
    return np.stack([jinterp.to_vec(s, b) for s in seen[:cap]]), seen[:cap]


def _shuffled_bags(rows, lay, seed):
    """Rows with their message slots permuted and empty slots dirtied, so
    canonicalize has work to do."""
    rng = np.random.default_rng(seed)
    s = jst.unpack(rows.copy(), lay, np)
    for f in ("msgHi", "msgLo", "msgCount"):
        s[f] = s[f].copy()
    for r in range(rows.shape[0]):
        p = rng.permutation(lay.S)
        for f in ("msgHi", "msgLo", "msgCount"):
            s[f][r] = s[f][r][p]
        empty = s["msgCount"][r] == 0
        s["msgHi"][r][empty] = rng.integers(0, 1 << 20, int(empty.sum()))
    return s


def test_layout_and_pack_roundtrip_match_reference():
    rows, states = _reach(KW)
    b = Bounds(**KW)
    lay, jlay = st.Layout.of(b), jst.Layout.of(JBounds(**KW))
    assert (lay.width, lay.shapes) == (jlay.width, jlay.shapes) \
        and lay.width == 60
    # the interpreter copy packs every state exactly as the reference does
    assert np.array_equal(
        np.stack([interp.to_vec(interp.PyState(**{
            f: getattr(s, f) for f in interp.PyState.__dataclass_fields__}),
            b) for s in states]), rows)
    for x in (rows, torch.as_tensor(rows)):
        s = st.unpack(x, lay)
        back = st.pack(s)
        assert np.array_equal(np.asarray(back), rows)
        j = jst.unpack(rows, jlay, np)
        for f in st.STATE_FIELDS:
            assert np.array_equal(np.asarray(s[f]), j[f]), f


def test_canonicalize_and_constraint_match_reference():
    rows, _ = _reach(KW, depth=5)
    jlay = jst.Layout.of(JBounds(**KW))
    s = _shuffled_bags(rows, jlay, seed=7)
    want = jst.canonicalize({k: jnp.asarray(v) for k, v in s.items()}, jnp)
    got_t = st.canonicalize({k: torch.as_tensor(v) for k, v in s.items()})
    got_n = st.canonicalize({k: v.copy() for k, v in s.items()})
    for f in ("msgHi", "msgLo", "msgCount"):
        assert np.array_equal(got_t[f].numpy(), np.asarray(want[f])), f
        assert np.array_equal(got_n[f], np.asarray(want[f])), f
    canon = {k: np.asarray(v) for k, v in want.items()}
    for kw in (KW, dict(KW, max_term=1, max_msgs=1)):
        jb, b = JBounds(**kw), Bounds(**kw)
        jok = np.array([bool(jst.constraint_ok({k: v[r] for k, v in
                                                canon.items()}, jb, np))
                        for r in range(rows.shape[0])])
        ok = st.constraint_ok({k: torch.tensor(v)
                               for k, v in canon.items()}, b)
        assert np.array_equal(ok.numpy(), jok)
        assert 0 < jok.sum() or kw is not KW


@pytest.mark.parametrize("W", [39, 60])
def test_plain_fingerprint_matches_reference(W):
    rng = np.random.default_rng(W)
    rows = rng.integers(-2**31, 2**31, size=(1500, W),
                        dtype=np.int64).astype(np.int32)
    rows[:4] = 0
    rows[4] = -1
    c = jfpr.lane_constants(W)
    assert np.array_equal(fpr.lane_constants(W), c)
    jh, jl = jfpr.fingerprint(jnp.asarray(rows), jnp.asarray(c), jnp)
    ph, pl = jpallas_fp.fingerprint_rows(rows, interpret=True)
    th, tl = fpr.fingerprint(torch.as_tensor(rows),
                             fpr.torch_constants(W, "cpu"))
    for want_h, want_l in ((jh, jl), (ph, pl),
                           jfpr.fingerprint(rows, c, np),
                           fpr.fingerprint_np(rows, c)):
        assert np.array_equal(fpr.as_uint32(th), np.asarray(want_h))
        assert np.array_equal(fpr.as_uint32(tl), np.asarray(want_l))
    # the kernel's wrapper takes the plain version for a CPU tensor
    kh, kl = pallas_fp.fingerprint_rows(torch.as_tensor(rows))
    assert torch.equal(kh, th) and torch.equal(kl, tl)


def test_plain_fingerprint_matches_native_host_store():
    if not native.HAS_NATIVE:
        pytest.skip("native host store library not built here")
    rows, _ = _reach(KW)
    nh, nl = native.fingerprint_rows(rows)
    th, tl = fpr.fingerprint(torch.as_tensor(rows),
                             fpr.torch_constants(rows.shape[1], "cpu"))
    assert np.array_equal(fpr.as_uint32(th), nh)
    assert np.array_equal(fpr.as_uint32(tl), nl)
