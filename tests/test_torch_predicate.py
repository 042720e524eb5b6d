"""The port's expression invariants against the JAX reference.

A cfg's whole-line INVARIANT expression (frontend/predicate.py) is checked
by three port evaluators: the batched torch evaluator the plain step runs
(``Predicate.ev_torch``), the flat program K1 interprets and its plain
evaluator (ops/predprog.py), and the numpy path of the host's Init check.
Each is held, bit-exact, to the reference's ``jax.numpy`` predicate
vmapped over the same states, as the JAX step evaluates it: on reachable
rows and on seeded rows whose values drive the indexing rules (a negative
index wraps once, then every index clamps) and int32 wrap-around.  The
parser's errors are the reference's, column included, and the plain step
with expressions beside registry invariants equals the JAX step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.frontend import predicate as jpred
from raft_tla_tpu.models import interp as jinterp
from raft_tla_tpu.models import invariants as jinv
from raft_tla_tpu.ops import kernels as jkernels
from raft_tla_tpu.ops import state as jst

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.frontend import predicate as tpred
from raft_tla_tpu_torch.models import interp
from raft_tla_tpu_torch.models import invariants as inv_mod
from raft_tla_tpu_torch.ops import kernels, predprog
from raft_tla_tpu_torch.ops import state as st

from test_torch_step import _reach, assert_step_contract

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

FULL3 = dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2)
FAITHFUL2 = dict(n_servers=2, n_values=2, max_term=2, max_log=1, max_msgs=2,
                 history=True, max_elections=4)

# Every operator and reducer; indices that wrap (votedFor - 1 is -1 for
# Nil), clamp (logLen indexes one past the log) and broadcast
# (logTerm[logLen] is [n, n]); int32 wrap-around (2^30 * 4 = 0).
EXPRS = (
    "count(role = 2) <= 1",
    "commitIndex <= logLen",
    "term[votedFor - 1] >= 1 \\/ votedFor = 0",
    "logTerm[logLen] <= max(term) /\\ min(logVal) >= 0",
    "term * 1073741824 * 4 = 0 => ~any(msgCount > 1)",
    "-term[0] - count(TRUE) < nextIndex[matchIndex + 7]",
    "logVal[term] /= 3 /\\ all(vResp >= vGrant) => FALSE",
    "msgHi * msgLo - msgCount * 3 /= 17 \\/ msgLo > msgHi",
    "term[min(role) * 7 - 3] + term[-1] > term[5] - term[-9]",
    "(1 + 2) * 3 = 9 /\\ count(TRUE) = 1 /\\ max(5) < min(6)",
)

# Malformed invariants: each raises the reference's ValueError, verbatim.
BAD = (
    "\\A i : role[i] <= 2", "role[", "role = ", "count(role)",
    "any(term)", "role /\\ term", "~term", "term + (role = 2) > 0",
    "nosuch = 1", "role = 2 )", "term[role = 1] = 0", "min(role = 2) = 0",
    "-TRUE = 1", "3 + 4", "role @ 2",
)


def _jax_ok(text, rows, jlay):
    """The reference's predicate of every row, as the JAX step runs it."""
    pred = jinv._expression(text)
    struct = jst.unpack(jnp.asarray(rows), jlay, jnp)
    return np.asarray(jax.vmap(lambda s: pred.ev(s, jnp))(struct))


def _port_ok(text, rows, lay):
    """``(torch evaluator, K1's program on its plain evaluator)``."""
    pred = inv_mod._expression(text)
    t = torch.as_tensor(rows)
    prog = predprog.compile_program(pred, lay)
    return (pred.ev_torch(st.unpack(t, lay), t.shape[0]).numpy(),
            predprog.evaluate(prog, t).numpy())


def _seeded_rows(rows, seed):
    """Reachable rows with random small and random full-range int32
    values written over their fields."""
    rng = np.random.default_rng(seed)
    small = rng.integers(-9, 9, size=rows.shape).astype(np.int32)
    big = rng.integers(-2**31, 2**31, size=(8, rows.shape[1]),
                       dtype=np.int64).astype(np.int32)
    return np.concatenate([rows, small, big])


def test_parse_and_type_errors_match_the_reference():
    for text in BAD:
        with pytest.raises(ValueError) as want:
            jpred.compile_predicate(text, fields=st.STATE_FIELDS)
        with pytest.raises(ValueError) as got:
            tpred.compile_predicate(text, fields=st.STATE_FIELDS)
        assert str(got.value) == str(want.value), text
    for text in EXPRS:
        assert tpred.is_expression(text) and jpred.is_expression(text)
    assert not tpred.is_expression("NoTwoLeaders")


@pytest.mark.parametrize("kw", [FULL3, FAITHFUL2], ids=["parity",
                                                        "faithful"])
def test_evaluators_match_the_jax_predicate(kw):
    """The torch evaluator and the program equal the JAX predicate on
    reachable and seeded rows."""
    lay = st.Layout.of(Bounds(**kw))
    jlay = jst.Layout.of(JBounds(**kw))
    rows = _seeded_rows(_reach(JBounds(**kw), "full", 6, 160), seed=7)
    mixed = 0
    for text in EXPRS:
        want = _jax_ok(text, rows, jlay)
        ev, prog = _port_ok(text, rows, lay)
        assert np.array_equal(ev, want), text
        assert np.array_equal(prog, want), text
        mixed += 0 < want.sum() < want.size
    assert mixed >= 7          # the rows tell the expressions' cases apart


def test_constants_and_overflow_follow_jax():
    """Constant subtrees fold as Python ints; one that meets an int32 array
    must fit int32 (OverflowError otherwise, as in JAX); a constant index
    out of range clamps as a traced one does."""
    lay, jlay = st.Layout.of(Bounds(**FULL3)), jst.Layout.of(JBounds(**FULL3))
    rows = _reach(JBounds(**FULL3), "full", 3, 40)
    for text in ("term < 1073741824 * 4", "min(2147483648) = 0",
                 "term = 3000000000 - 1"):
        with pytest.raises(OverflowError):
            _jax_ok(text, rows, jlay)
        with pytest.raises(OverflowError):
            _port_ok(text, rows, lay)
    for text in ("term[3] = term[2] /\\ term[-4] = term[0]",
                 "2147483647 + 1 > 0", "min(2147483647) + 1 < 0"):
        want = _jax_ok(text, rows, jlay)
        assert want.all(), text
        for got in _port_ok(text, rows, lay):
            assert np.array_equal(got, want), text


def test_init_check_matches_the_reference_numpy_path():
    """``py_invariant`` of an expression on interpreter states equals the
    reference's, and an index past a field raises IndexError in both (the
    numpy path does not clamp)."""
    jb, b = JBounds(**FULL3), Bounds(**FULL3)
    states = [jinterp.init_state(jb)]
    for _ in range(3):
        states += [t for s in states[-12:] for _i, t in
                   jinterp.successors(s, jb)][:40]
    for text in EXPRS[:4]:
        jfn, fn = jinv.py_invariant(text), inv_mod.py_invariant(text)
        for s in states:
            port = interp.PyState(**{f: getattr(s, f) for f in
                                     interp.PyState.__dataclass_fields__})
            assert fn(port, b) == jfn(s, jb), text
    with pytest.raises(IndexError):
        jinv.py_invariant("term[3] = 0")(states[0], jb)
    with pytest.raises(IndexError):
        inv_mod.py_invariant("term[3] = 0")(interp.init_state(b), b)


def test_plain_step_with_expressions_matches_the_jax_step(monkeypatch):
    """Ten invariants, registry and expression interleaved in CheckConfig
    order, through the plain step and the JAX step: every output on
    reachable rows (one JAX compile)."""
    monkeypatch.setenv("RAFT_TLA_PRESCAN", "off")
    invs = ("NoTwoLeaders", EXPRS[0], "LogMatching", EXPRS[2], EXPRS[3],
            "CommittedWithinLog", EXPRS[1], EXPRS[4], "LeaderCompleteness",
            EXPRS[8])
    kw = dict(FULL3, max_msgs=1)
    rows = _reach(JBounds(**kw), "full", 5, 96)
    got = kernels.build_step(Bounds(**kw), "full", invs)(
        torch.as_tensor(rows))
    xla = jax.jit(jkernels.build_step(JBounds(**kw), "full", invs,
                                      megakernel=False))
    want = xla(jnp.asarray(rows))
    assert assert_step_contract(got, want) > rows.shape[0]
    inv_ok = got["inv_ok"][got["valid"]]
    assert inv_ok.shape[1] == 10
    # The expression twin of a registry invariant agrees with it.
    assert torch.equal(inv_ok[:, 6], inv_ok[:, 5])


def test_kernel_tables_lay_out_every_invariant():
    """Registry codes and expression programs in CheckConfig order, with no
    cap on the number of invariants."""
    b = Bounds(**FULL3)
    invs = EXPRS + ("NoTwoLeaders",) + EXPRS[:2]
    codes, prog = predprog.kernel_tables(invs, b)
    assert codes.size == 13 and codes[10] == inv_mod.CODES["NoTwoLeaders"]
    lay = st.Layout.of(b)
    rows = torch.as_tensor(_reach(JBounds(**FULL3), "full", 4, 60))
    for k, text in enumerate(invs):
        if codes[k] >= 0:
            continue
        one = prog[-1 - codes[k]:].reshape(-1)
        want = predprog.evaluate(
            predprog.compile_program(inv_mod._expression(text), lay), rows)
        assert torch.equal(predprog.evaluate(one, rows), want), text


def test_evaluators_keep_the_rows_device():
    """Every tensor the evaluators make lies on the rows' device (here the
    ``meta`` device, which checks devices and shapes without data), so the
    plain step runs unchanged on the card."""
    b = Bounds(**FULL3)
    lay = st.Layout.of(b)
    rows = torch.zeros((7, lay.width), dtype=torch.int32, device="meta")
    for text in EXPRS + ("TRUE",):
        got = inv_mod.torch_invariant(text, b)(st.unpack(rows, lay))
        assert got.device.type == "meta" and got.shape == (7,), text
        prog = predprog.compile_program(inv_mod._expression(text), lay)
        assert predprog.evaluate(prog, rows).device.type == "meta", text
