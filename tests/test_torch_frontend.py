"""The port's spec frontend (``raft_tla_tpu_torch/frontend/``) against the
JAX reference's, on the CPU.

- schemas: pack/unpack and ``check_schema``'s findings equal to JAX's, for
  the twophase schema, the Raft schema (whose layout is ``ops/state``'s)
  and an invalid schema;
- the IR-compiled Raft step: ``ir-full``/``ir-election``/``ir-replication``
  bit-identical to the port's hand-written plain step on every lane, and
  ``ir-election`` to the JAX IR step (one JAX compile, at toy bounds);
- the width twins generated from the IR equal the port's hand twins;
- ``resolve_model``'s names and its did-you-mean text;
- ``ir-election`` through the host engine equal to ``election``, in counts
  and in the trace of a seeded violation; the card's refusal of the IR
  Raft under SYMMETRY.

Inputs are reachable rows from Init.  Tolerance: bit-exact.
"""

import numpy as np
import pytest
import torch

import jax

from raft_tla_tpu.config import Bounds as JBounds
from raft_tla_tpu.frontend import raft_ir as jraft_ir
from raft_tla_tpu.frontend import raft_schema as jraft_schema
from raft_tla_tpu.frontend import registry as jregistry
from raft_tla_tpu.frontend import schema as jschema
from raft_tla_tpu.frontend import twophase as jtp
from raft_tla_tpu.ops import kernels as jkernels

from raft_tla_tpu_torch.analysis import intervals as iv
from raft_tla_tpu_torch.analysis import widthcheck as wc
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.engine import Engine
from raft_tla_tpu_torch.frontend import raft_ir, raft_schema, registry
from raft_tla_tpu_torch.frontend import schema, twophase as tp
from raft_tla_tpu_torch.models import interp, spec as SP
from raft_tla_tpu_torch.ops import kernels, msgbits as mb
from raft_tla_tpu_torch.ops import state as st

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=1, max_msgs=2)
FULL3 = dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2)
INVS = ("NoTwoLeaders", "LogMatching")


def _levels(step, vecs, depth, cap=256):
    """Yield ``(rows, step(rows))`` over ``depth`` BFS levels from
    ``vecs`` (distinct successors, at most ``cap`` a level)."""
    for _ in range(depth):
        out = step(vecs)
        yield vecs, out
        keep = out["valid"] & ~out["overflow"]
        nxt = torch.unique(out["svecs"][keep], dim=0)
        if not len(nxt):
            return
        vecs = nxt[torch.linspace(0, len(nxt) - 1, min(cap, len(nxt)))
                   .long()]


def _init_rows(b, start=None):
    s = start if start is not None else interp.init_state(b)
    return torch.as_tensor(interp.to_vec(s, b))[None]


def _leader_start(b):
    """A preset leader (the replication subset's start)."""
    return interp.init_state(b)._replace(
        role=(SP.LEADER,) + (SP.FOLLOWER,) * (b.n_servers - 1))


def test_schemas_pack_and_findings_match_jax():
    rng = np.random.default_rng(3)
    cases = [(tp.SCHEMA, jtp.SCHEMA, dict(n_servers=4, n_values=1)),
             (raft_schema.RAFT_SCHEMA, jraft_schema.RAFT_SCHEMA, FULL3)]
    for sch, jsch, kw in cases:
        b, jb = Bounds(**kw), JBounds(**kw)
        lay, jlay = sch.layout(b), jsch.layout(jb)
        assert (lay.shapes, lay.width) == (jlay.shapes, jlay.width)
        rows = rng.integers(-5, 50, size=(3, 2, lay.width), dtype=np.int32)
        jstruct = jlay.unpack(rows, np)
        struct = lay.unpack(torch.as_tensor(rows))
        for f in lay.fields:
            assert np.array_equal(struct[f].numpy(), jstruct[f]), f
        assert np.array_equal(lay.pack(struct).numpy(), rows)
        assert np.array_equal(lay.pack(jstruct), rows)
        init = lay.init_struct()
        assert all(np.array_equal(init[f], np.asarray(v))
                   for f, v in jlay.init_struct(np).items())
        assert schema.check_schema(sch, b) == [] == \
            jschema.check_schema(jsch, jb)
    assert raft_schema.RAFT_SCHEMA.layout(Bounds(**FULL3)).shapes == \
        st.Layout.of(Bounds(**FULL3)).shapes
    assert {f.name: f.hi for f in raft_schema.RAFT_SCHEMA.fields
            if isinstance(f.hi, (int, str))} == \
        {f.name: f.hi for f in jraft_schema.RAFT_SCHEMA.fields
         if isinstance(f.hi, (int, str))}
    env = schema.envelope(tp.SCHEMA, Bounds(n_servers=3))
    jenv = jschema.envelope(jtp.SCHEMA, JBounds(n_servers=3))
    assert {k: v.as_tuple() for k, v in env.items()} == \
        {k: v.as_tuple() for k, v in jenv.items()}
    # an invalid schema: every finding of the reference, text for text
    fields = [("x", ("n",), 0, 2, 0), ("y", (), 5, 2, 5),
              ("z", ("n",), 0, 1 << 31, 0), ("w", (), 0, 3, 7),
              ("v", ("n", 0), 0, 1, 0)]
    bad = schema.Schema("bad", tuple(schema.Field(*f) for f in fields))
    jbad = jschema.Schema("bad", tuple(jschema.Field(*f) for f in fields))
    got = [f.format() for f in schema.check_schema(bad, Bounds(n_servers=2))]
    want = [f.format() for f in jschema.check_schema(jbad,
                                                     JBounds(n_servers=2))]
    assert got == want and len(got) == 5
    with pytest.raises(ValueError, match="duplicate field 'x'"):
        schema.Schema("dup", (schema.Field("x"), schema.Field("x")))


@pytest.mark.parametrize("spec", ["full", "election", "replication"])
def test_ir_plain_step_equals_hand_plain_step(spec):
    """Every output of every lane, over BFS levels from Init (the
    replication subset from a preset leader)."""
    b = Bounds(**FULL3)
    hand = kernels.build_step(b, spec, INVS)
    made = registry.resolve_model(f"ir-{spec}").build_step(
        CheckConfig(bounds=b, spec=f"ir-{spec}", invariants=INVS), "cpu")
    start = _leader_start(b) if spec == "replication" else None
    n = 0
    for rows, want in _levels(hand, _init_rows(b, start), 6):
        got = made(rows)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (spec, k)
        n += int(want["valid"].sum())
    assert n > 200


def test_ir_step_equals_jax_ir_step():
    """``ir-election`` at toy bounds against the reference's IR step on the
    same rows: every output on every lane."""
    jb, b = JBounds(**TOY), Bounds(**TOY)
    jstep = jax.jit(jkernels.build_step(
        jb, "election", invariants=INVS,
        family_kernels=jraft_ir.family_kernels(jb)))
    made = registry.resolve_model("ir-election").build_step(
        CheckConfig(bounds=b, spec="ir-election", invariants=INVS), "cpu")
    B, n = 16, 0
    for rows, _out in _levels(made, _init_rows(b), 6, cap=B):
        pad = torch.cat([rows, rows[:1].expand(B - len(rows), -1)])
        got = made(pad)
        want = {k: np.asarray(v) for k, v in jstep(pad.numpy()).items()}
        val = want["valid"]
        for k in ("svecs", "valid", "overflow", "fp_hi", "fp_lo", "inv_ok",
                  "con_ok"):
            g = got[k].numpy()
            if k.startswith("fp"):
                g = g.view(np.uint32)
            assert np.array_equal(g, want[k]), k
        n += int(val.sum())
    assert n > 50


def test_generated_twins_equal_hand_twins():
    gen = raft_ir.transfers()
    assert set(gen) == set(wc.TRANSFERS) == set(jraft_ir.transfers())
    for kw in ({}, TOY, dict(n_servers=5, n_values=2, max_term=4,
                             max_log=2, max_msgs=3, max_dup=2)):
        b = Bounds(**kw)
        env = iv.expansion_envelope(b)
        menv = wc.message_envelope(b, env, wc.TRANSFERS)
        assert wc.message_envelope(b, env, gen) == menv
        for fam in wc.TRANSFERS:
            hand = wc.TRANSFERS[fam](b, env, menv)
            made = gen[fam](b, env, menv)
            assert (made.writes, made.sends) == (hand.writes, hand.sends), \
                fam
        for spec in ("full", "election", "replication"):
            assert wc.check_widths(b, spec, transfers=gen) == [], spec


def test_resolve_model_names_and_did_you_mean():
    assert registry.known_specs() == jregistry.known_specs()
    for name in registry.known_specs():
        m, jm = registry.resolve_model(name), jregistry.resolve_model(name)
        assert (m.name, m.sub, m.use_ir, m.is_raft, m.engines) == \
            (jm.name, jm.sub, jm.use_ir, jm.is_raft, jm.engines), name
        assert len(m.action_table(Bounds(**TOY))) == \
            len(jm.action_table(JBounds(**TOY)))
    for typo in ("twophse", "electoin", "ir-ful", "bogus"):
        with pytest.raises(ValueError) as got:
            registry.resolve_model(typo)
        with pytest.raises(ValueError) as want:
            jregistry.resolve_model(typo)
        assert str(got.value) == str(want.value)
    from raft_tla_tpu_torch import frontend
    assert isinstance(frontend.resolve_model("twophase"),
                      registry.TwoPhaseModel)
    assert frontend.is_expression("~any(rmState = 2)")
    assert frontend.compile_predicate("all(rmState <= 3)").text


def _bag(*ms):
    return tuple(sorted((m, 1) for m in ms))


def test_ir_election_host_engine_equals_election():
    """Counts at toy bounds, then the trace of the seeded NaiveNoTwoLeaders
    violation; and the IR Raft under SYMMETRY: the plain orbit key on the
    CPU (hand and IR equal), refused on the card."""
    out = {}
    for spec in ("election", "ir-election"):
        cfg = CheckConfig(bounds=Bounds(**TOY), spec=spec,
                          invariants=("NoTwoLeaders",), chunk=256)
        out[spec] = Engine(cfg, device="cpu").check()
    h, m = out["election"], out["ir-election"]
    assert (h.n_states, h.diameter, h.n_transitions, h.levels,
            h.coverage) == (m.n_states, m.diameter, m.n_transitions,
                            m.levels, m.coverage)
    assert (h.n_states, h.diameter, h.n_transitions) == (3014, 17, 5274)
    b = Bounds(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)
    start = interp.init_state(b)._replace(
        role=(SP.LEADER, SP.FOLLOWER, SP.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=_bag(mb.rv_response(3, 1, 1, 2)))
    for spec in ("election", "ir-election"):
        cfg = CheckConfig(bounds=b, spec=spec, chunk=256,
                          invariants=("NaiveNoTwoLeaders",))
        out[spec] = Engine(cfg, device="cpu").check(init_override=start)
    vh, vm = out["election"].violation, out["ir-election"].violation
    assert vh is not None and vh.invariant == "NaiveNoTwoLeaders"
    assert (vh.state, vh.trace) == (vm.state, vm.trace)
    assert out["election"].n_states == out["ir-election"].n_states
    sym = {}
    for spec in ("election", "ir-election"):
        cfg = CheckConfig(bounds=Bounds(**TOY), spec=spec, chunk=256,
                          invariants=("NoTwoLeaders",), symmetry=("Server",))
        r = Engine(cfg, device="cpu").check()
        sym[spec] = (r.n_states, r.diameter, r.n_transitions)
    assert sym["election"] == sym["ir-election"] == (1514, 17, 2675)
    with pytest.raises(ValueError, match="ROADMAP.md queue A: item 10"):
        registry.resolve_model("ir-election").build_step(cfg, "cuda")
