"""Faithful mode (the history variables) in the port against the JAX reference.

Same inputs through ``raft_tla_tpu`` and ``raft_tla_tpu_torch`` with
``Bounds(history=True)``: the log universe over its whole range, the layout
and encoding, the interpreter's successors, the three ``*Hist``
invariants, and the plain step (every output, under the step contract of
tests/test_torch_step.py) with and without SYMMETRY and VIEW.  The orbit
key, the engine and checkpoints are in tests/test_torch_history_engine.py.
Inputs are reachable states of the reference interpreter, or numpy-seeded
history fields written over them.  Tolerance: bit-exact.

The JAX steps are built with ``RAFT_TLA_PRESCAN=off``: its prescan ladder
gives the same keys bit for bit and only lengthens the CPU compile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import interp as jinterp, invariants as jinv
from raft_tla_tpu.ops import kernels as jkernels, state as jst
from raft_tla_tpu.ops import pallas_step as jpallas_step
from raft_tla_tpu.ops.loguniv import LogUniverse as JLogUniverse
from raft_tla_tpu.utils import render as jrender

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.models import interp, invariants as inv_mod
from raft_tla_tpu_torch.ops import kernels, pallas_step, state as st
from raft_tla_tpu_torch.ops.loguniv import LogUniverse
from raft_tla_tpu_torch.utils import render

from test_torch_step import assert_step_contract

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

FULL2 = dict(n_servers=2, n_values=2, max_term=2, max_log=1, max_msgs=2,
             history=True, max_elections=4)
INV_H = ("NoTwoLeaders", "LogMatching", "LeaderCompleteness",
         "ElectionSafetyHist", "LeaderCompletenessHist", "AllLogsPrefixClosed")


def _reach(kw, spec="full", depth=8, cap=160, lane_cap=60):
    """Reachable states of the reference interpreter, breadth first."""
    b = JBounds(**kw)
    frontier = [jinterp.init_state(b)]
    seen = list(frontier)
    for _ in range(depth):
        nxt = []
        for s in frontier:
            if jinterp.constraint_ok(s, b):
                nxt += [t for _i, t in jinterp.successors(s, b, spec=spec)]
        frontier = nxt[:lane_cap]
        seen += frontier
    return seen[:cap]


def _rows(kw, spec="full", **k):
    b = JBounds(**kw)
    return np.stack([jinterp.to_vec(s, b) for s in _reach(kw, spec, **k)])


def _scramble(rows, kw, seed):
    """Rows with numpy-seeded history fields: several (some equal) election
    records in any slot order, voterLog entries, allLogs bits."""
    rng = np.random.default_rng(seed)
    lay = jst.Layout.of(JBounds(**kw))
    U = JLogUniverse.of(JBounds(**kw)).size
    s = {k: v.copy() for k, v in jst.unpack(rows, lay, np).items()}
    B, n, E = rows.shape[0], lay.n, lay.E
    occ = rng.random((B, E)) < 0.6
    s["eTerm"] = np.where(occ, rng.integers(1, 4, (B, E)), 0)
    s["eLeader"] = np.where(occ, rng.integers(0, n, (B, E)), 0)
    s["eLog"] = np.where(occ, rng.integers(0, U, (B, E)), 0)
    s["eVotes"] = np.where(occ, rng.integers(0, 1 << n, (B, E)), 0)
    s["eVLog"] = np.where(occ[..., None] & (rng.random((B, E, n)) < 0.5),
                          rng.integers(0, U + 1, (B, E, n)), 0)
    s["eTerm"][:, 1] = np.where(rng.random(B) < 0.3, s["eTerm"][:, 0],
                                s["eTerm"][:, 1])
    s["vLog"] = np.where(rng.random((B, n, n)) < 0.5,
                         rng.integers(0, U + 1, (B, n, n)), 0)
    bits = rng.random((B, U)) < 0.3
    words = np.zeros((B, lay.Wa), np.uint64)
    for r in range(U):
        words[:, r // 32] |= bits[:, r].astype(np.uint64) << np.uint64(r % 32)
    s["allLogs"] = words.astype(np.uint32).view(np.int32)
    return np.concatenate(
        [s[f].reshape(B, -1) for f in lay.fields], -1).astype(np.int32)


# -- the log universe and the encoding -----------------------------------------

@pytest.mark.parametrize("kw", [
    FULL2, dict(n_servers=3, n_values=2, max_term=2, max_log=2, max_msgs=2)],
    ids=["U43", "U259"])
def test_log_universe_matches_reference(kw):
    j, u = JLogUniverse.of(JBounds(**kw)), LogUniverse.of(Bounds(**kw))
    assert (u.T, u.V, u.L, u.R, u.offsets, u.size, u.mask_words) == \
        (j.T, j.V, j.L, j.R, j.offsets, j.size, j.mask_words)
    rs = np.arange(j.size, dtype=np.int32)
    logs = [j.tuple_of_id(int(r)) for r in rs]
    assert [u.tuple_of_id(int(r)) for r in rs] == logs
    assert [u.id_of_tuple(lg) for lg in logs] == list(range(j.size))
    lt, lv, ln = (np.asarray(x) for x in j.decode(rs, np))
    for x in (rs, torch.as_tensor(rs)):
        got = [np.asarray(a) for a in u.decode(x)]
        assert all(np.array_equal(g, w) for g, w in zip(got, (lt, lv, ln)))
        assert np.array_equal(np.asarray(u.prefix_id(x)),
                              j.prefix_id(rs, np))
        assert np.array_equal(np.asarray(u.log_len_of(x)), ln)
    assert np.array_equal(u.log_id(lt, lv, ln), rs)
    assert np.array_equal(u.log_id(torch.as_tensor(lt), torch.as_tensor(lv),
                                   torch.as_tensor(ln)).numpy(), rs)


def test_faithful_layout_init_pack_and_canonicalize_match_reference():
    b, jb = Bounds(**FULL2), JBounds(**FULL2)
    lay, jlay = st.Layout.of(b), jst.Layout.of(jb)
    assert (lay.n, lay.L, lay.S, lay.E, lay.Wa) == \
        (jlay.n, jlay.L, jlay.S, jlay.E, jlay.Wa) == (2, 2, 3, 4, 2)
    assert lay.shapes == jlay.shapes and lay.fields == jlay.fields
    assert lay.width == jlay.width == 69
    assert np.array_equal(st.pack(st.init_struct(b)),
                          jst.pack(jst.init_struct(jb, np), np))
    rows = _rows(FULL2)
    for r in rows[::17]:
        assert np.array_equal(st.pack(st.unpack(r, lay)), r)
    # canonicalize over shuffled election slots and message slots
    rng = np.random.default_rng(11)
    rows = _scramble(rows, FULL2, 12)
    s = jst.unpack(rows, jlay, np)
    for r in range(rows.shape[0]):
        pe, pm = rng.permutation(lay.E), rng.permutation(lay.S)
        for f in ("eTerm", "eLeader", "eLog", "eVotes", "eVLog"):
            s[f][r] = s[f][r][pe]
        for f in ("msgHi", "msgLo", "msgCount"):
            s[f][r] = s[f][r][pm]
    want = np.stack([jst.pack(jst.canonicalize(
        {f: a[r] for f, a in s.items()}, np), np)
        for r in range(rows.shape[0])])
    assert np.array_equal(st.pack(st.canonicalize(s)), want)
    got = st.pack(st.canonicalize({f: torch.as_tensor(a)
                                   for f, a in s.items()}))
    assert np.array_equal(got.numpy(), want)


def test_interp_successors_render_and_roundtrip_match_reference():
    jb, b = JBounds(**FULL2), Bounds(**FULL2)
    n = 0
    for js in _reach(FULL2, depth=9, cap=400):
        vec = jinterp.to_vec(js, jb)
        s = interp.from_struct(st.unpack(vec, st.Layout.of(b)), b)
        assert np.array_equal(interp.to_vec(s, b), vec)
        assert render.render_state(s, b) == jrender.render_state(js, jb)
        want = [(i, jinterp.to_vec(t, jb))
                for i, t in jinterp.successors(js, jb)]
        got = [(i, interp.to_vec(t, b)) for i, t in interp.successors(s, b)]
        assert [i for i, _ in got] == [i for i, _ in want]
        assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))
        n += len(got)
    assert n > 2000


# -- the three *Hist invariants ------------------------------------------------

def _seeded(jb):
    """The seeded cases of the JAX package's tests/test_history.py:126-175."""
    s = jinterp.init_state(jb)
    ent = (1, 1)
    two = tuple(sorted([(2, 0, (), 0b11, ((), ())),
                        (2, 1, (), 0b11, ((), ()))],
                       key=jinterp._election_key))
    return [
        s._replace(elections=two),
        s._replace(allLogs=tuple(sorted([(), ((1, 1), (1, 2))],
                                        key=jinterp._log_key))),
        s._replace(allLogs=tuple(sorted([(), ((1, 1),), ((1, 1), (1, 2))],
                                        key=jinterp._log_key))),
        s._replace(log=((ent,), ()), commitIndex=(1, 0), term=(1, 1),
                   elections=((2, 1, (), 0b11, ((), ())),)),
        s._replace(log=((ent,), ()), commitIndex=(1, 0), term=(1, 1),
                   elections=((2, 1, (ent,), 0b11, ((), ())),)),
    ]


def test_history_invariants_match_reference():
    jb, b = JBounds(**FULL2), Bounds(**FULL2)
    lay = st.Layout.of(b)
    states = _seeded(jb) + _reach(FULL2, depth=9, cap=300)
    vecs = np.stack([jinterp.to_vec(s, jb) for s in states])
    tstruct = st.unpack(torch.as_tensor(vecs), lay)
    for nm in ("ElectionSafetyHist", "LeaderCompletenessHist",
               "AllLogsPrefixClosed"):
        jpy, jfn = jinv.py_invariant(nm), jinv.jnp_invariant(nm, jb)
        want = [bool(jpy(s, jb)) for s in states]
        jit = jax.jit(jax.vmap(jfn))
        assert [bool(x) for x in jit(
            {k: jnp.asarray(v) for k, v in
             jst.unpack(vecs, jst.Layout.of(jb), np).items()})] == want
        port = [inv_mod.py_invariant(nm)(
            interp.from_struct(st.unpack(v, lay), b), b) for v in vecs]
        assert port == want
        assert inv_mod.torch_invariant(nm, b)(tstruct).tolist() == want
        assert not all(want[:4]), nm           # a seeded case fires


def test_history_invariants_need_faithful_mode():
    for nm in ("ElectionSafetyHist", "AllLogsPrefixClosed"):
        kw = dict(bounds=Bounds(n_servers=2), invariants=(nm,))
        with pytest.raises(ValueError) as mine:
            CheckConfig(**kw)
        with pytest.raises(ValueError) as theirs:
            JConfig(bounds=JBounds(n_servers=2), invariants=(nm,))
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError) as mine:
        Bounds(n_servers=2, n_values=3, max_term=4, max_log=3, history=True)
    with pytest.raises(ValueError) as theirs:
        JBounds(n_servers=2, n_values=3, max_term=4, max_log=3, history=True)
    assert str(mine.value) == str(theirs.value)


# -- the plain step --------------------------------------------------------------

STEP_CASES = {
    "full": (FULL2, "full", (), None),
    "full-Server": (FULL2, "full", ("Server",), None),
    "full-ServerxValue": (FULL2, "full", ("Server", "Value"), None),
    "election-Server-deadvotes": (dict(FULL2, max_msgs=1), "election",
                                  ("Server",), "deadvotes"),
}


@pytest.mark.parametrize("name", [
    "full", pytest.param("full-Server", marks=pytest.mark.slow),
    "full-ServerxValue", "election-Server-deadvotes"])
def test_plain_faithful_step_matches_xla_step(name, monkeypatch):
    """|G| = 1, 2, 4 and 2 with deadvotes: every output on reachable rows
    and on rows with seeded history fields.  Each case is one JAX compile
    of several seconds, so the Server case (covered with deadvotes) runs
    in the slow tier."""
    monkeypatch.setenv("RAFT_TLA_PRESCAN", "off")
    kw, spec, axes, view = STEP_CASES[name]
    rows = _rows(kw, spec, depth=9, cap=96)
    rows = np.concatenate([rows, _scramble(rows[::3], kw, 5)])
    got = kernels.build_step(Bounds(**kw), spec, INV_H, axes, view)(
        torch.as_tensor(rows))
    xla = jax.jit(jkernels.build_step(JBounds(**kw), spec, INV_H, axes, view,
                                      megakernel=False))
    assert assert_step_contract(got, xla(jnp.asarray(rows))) > rows.shape[0]


def test_faithful_step_stays_inside_fused_write_surface():
    b = Bounds(**FULL2)
    rows = torch.as_tensor(_rows(FULL2, depth=9, cap=120))
    lay = st.Layout.of(b)
    for spec in ("full", "election", "replication"):
        out = kernels.build_step(b, spec, ())(rows)
        succ, par = st.unpack(out["svecs"], lay), st.unpack(rows[:, None], lay)
        val = out["valid"]
        written = {f for f in lay.fields
                   if ((succ[f] != par[f]).reshape(val.shape + (-1,))
                       .any(-1) & val).any()}
        assert written <= set(pallas_step.FUSED_WRITES[spec])
        assert spec != "full" or "allLogs" in written
        assert set(pallas_step.FUSED_WRITES[spec]) == \
            set(jpallas_step.FUSED_WRITES[spec])
