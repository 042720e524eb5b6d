"""The IR compiler: ActionDefs -> batched per-family kernels; the port of
``raft_tla_tpu/frontend/actions.py``.

:func:`compile_kernels` lowers a spec's :class:`~raft_tla_tpu_torch.
frontend.expr.ActionDef` table to kernels with the
``(bounds, s, *params) -> (out, valid, ovf)`` contract of
``ops/kernels.grouped_dispatch`` (fields ``[B, K, ...]``, parameters
``[1, K]``), so an IR-defined spec (or Raft itself, via
``frontend/raft_ir``) rides the plain step's dispatch.  The lowering calls
the hand-written helper layer of ``ops/kernels`` (``_set1``/``_set_row``/
``_set2``/``bag_add``/``bag_remove``/``reply``/``_tree_select``) rather than
re-deriving it: equal IR semantics then give bit-identical lanes.

:func:`build_schema_step` is the step of a spec declared purely as a schema
and IR (no hand kernels): the same step dict as ``kernels.build_step``,
with the successor rows keyed by K2 (``ops/pallas_fp.fingerprint_rows``:
the CUDA kernel for rows on the card, the plain fingerprint for rows on the
CPU), batched predicate invariants, identity canonicalization and an
all-true constraint.  The reference compiles this step to XLA; here it is
torch ops, and K2 is the one hand-written kernel on its path.
"""

from __future__ import annotations

import functools

import torch

from raft_tla_tpu_torch.frontend import expr as E
from raft_tla_tpu_torch.ops import kernels as K

I32 = torch.int32

# Calls of a schema step (chip_smoke.py holds K2's launches to them).
calls = 0


def _as_bool(ctx, v):
    """A Python bool (a Lit(True) validity) as a 0-dim tensor, so the
    dispatch can broadcast it like the hand kernels' constant masks."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(bool(v), device=ctx.device)


def _lift_to(c, a):
    """A per-lane condition ``[.., K]`` broadcastable against ``a``."""
    return c.reshape(c.shape + (1,) * (a.dim() - c.dim()))


def _apply_update(ctx, out, u):
    """One field write on the branch struct; values read the pre-state
    through ``ctx`` (the hand kernels' functional idiom)."""
    arr = out[u.field]
    if isinstance(u, E.Set1):
        written = K._set1(arr, E.index(ctx, u.i.ev(ctx)), u.val.ev(ctx))
    elif isinstance(u, E.SetRow):
        return K._set_row(arr, E.index(ctx, u.i.ev(ctx)), u.val.ev(ctx))
    elif isinstance(u, E.Set2):
        written = K._set2(arr, E.index(ctx, u.i.ev(ctx)),
                          E.index(ctx, u.j.ev(ctx)), u.val.ev(ctx))
    else:
        raise TypeError(f"unknown update node {type(u).__name__}")
    cond = getattr(u, "cond", None)
    if cond is None:
        return written
    c = cond.ev(ctx)
    return torch.where(_lift_to(c, written), written, arr)


def _pack_words(ctx, msg):
    """Evaluate a PackMsg into the (hi, lo) packed int32 words —
    value-identical to the ``ops/msgbits`` constructors (same shifts,
    OR-composition of non-negative subfields)."""
    from raft_tla_tpu_torch.ops import msgbits as mb
    vals = {"mtype": msg.mtype}
    for name, e in msg.fields:
        v = e.ev(ctx)
        if isinstance(v, torch.Tensor) and v.dtype == torch.bool:
            v = v.to(I32)
        vals[name] = v
    words = []
    for table in (mb.HI_FIELDS, mb.LO_FIELDS):
        w = 0
        for name, (shift, _width) in table.items():
            v = vals.get(name)
            if v is None:
                continue
            w = w | ((v << shift) if shift else v)
        words.append(E.index(ctx, w).to(I32))
    return words[0], words[1]


def _branch_effects(ctx, s, br):
    """Apply one branch: field updates, then bag ops in order.  Returns
    (out_struct, ovf_or_None)."""
    out = dict(s)
    for u in br.updates:
        out[u.field] = _apply_update(ctx, out, u)
    ovf = None
    for op in br.ops:
        if isinstance(op, E.BagAdd):
            hi, lo = _pack_words(ctx, op.msg)
            out, o = K.bag_add(out, hi, lo)
        elif isinstance(op, E.BagRemove):
            mhi, mlo = ctx.msg_words()
            out = K.bag_remove(out, mhi, mlo)
            continue
        elif isinstance(op, E.Reply):
            hi, lo = _pack_words(ctx, op.msg)
            mhi, mlo = ctx.msg_words()
            out, o = K.reply(out, hi, lo, mhi, mlo)
        else:
            raise TypeError(f"unknown bag op {type(op).__name__}")
        ovf = o if ovf is None else (ovf | o)
    if br.overflow is not None:
        o = br.overflow.ev(ctx)
        ovf = o if ovf is None else (ovf | o)
    return out, ovf


def _compile_action(adef):
    """ActionDef -> kernel(bounds, s, *params) with the grouped_dispatch
    contract."""

    def kern(bounds, s, *args):
        ctx = E.Ctx(bounds, s, dict(zip(adef.params, args)))
        valid = _as_bool(ctx, adef.valid.ev(ctx))
        if len(adef.branches) == 1 and adef.branches[0].guard is None:
            out, total = _branch_effects(ctx, s, adef.branches[0])
        else:
            pairs, guards, total = [], [], None
            for br in adef.branches:
                g = br.guard.ev(ctx)
                b_out, contrib = _branch_effects(ctx, s, br)
                pairs.append((g, b_out))
                guards.append(g)
                if contrib is not None:
                    t = g & contrib
                    total = t if total is None else (total | t)
            out = K._tree_select(pairs, s)
            if adef.any_guard_valid:
                valid = valid & functools.reduce(torch.logical_or, guards)
        ovf = torch.zeros((), dtype=torch.bool, device=ctx.device) \
            if total is None else (valid & total)
        return out, valid, ovf

    kern.__name__ = f"ir_{adef.family.lower()}"
    return kern


def compile_kernels(defs):
    """IR table -> ``{family: (kernel, params)}``, the shape
    ``grouped_dispatch(..., family_kernels=...)`` consumes."""
    return {adef.family: (_compile_action(adef), adef.params)
            for adef in defs}


def build_schema_expand(schema, defs, table, bounds):
    """``expand(struct[B, ...]) -> (succs[B, A, ...], valid[B, A],
    ovf[B, A])`` in action_table order — the same contract as
    ``kernels.build_expand``, without canonicalization (a schema spec
    declares no slot permutation)."""
    fam_kernels = compile_kernels(defs)
    groups = K.group_instances(table)

    def expand(s):
        succs, valids, ovfs = K.grouped_dispatch(
            bounds, s, groups, family_kernels=fam_kernels)
        return ({f: torch.cat([g[f] for g in succs], dim=1)
                 for f in succs[0]},
                torch.cat(valids, 1), torch.cat(ovfs, 1))

    return expand


def build_schema_step(schema, defs, table, bounds, predicates=(),
                      keys: bool = True):
    """The step of a schema-declared spec: ``step(vecs int32[B, W]) ->
    dict`` with the key set and shapes of ``kernels.build_step``: svecs
    ``[B, A, W]``, valid, overflow, fp_hi/fp_lo (int32 holding the uint32
    bits), inv_ok ``[B, A, n_inv]`` and con_ok.  ``predicates`` are the
    compiled invariant predicates (order = CheckConfig.invariants).  Runs
    on the device of ``vecs``; the keys come from K2 on a CUDA device (a
    failed launch raises) and from the plain fingerprint on the CPU.
    ``keys=False`` leaves the keys out (the walker engines, which sample
    one lane and dedup nothing)."""
    from raft_tla_tpu_torch.ops import pallas_fp
    lay = schema.layout(bounds)
    W = lay.width
    expand = build_schema_expand(schema, defs, table, bounds)

    def step(vecs):
        global calls
        calls += 1
        succs, valid, ovf = expand(lay.unpack(vecs.to(I32)))
        B, A = valid.shape
        svecs = lay.pack(succs)
        out = {"svecs": svecs, "valid": valid, "overflow": ovf}
        if keys:
            hi, lo = pallas_fp.fingerprint_rows(svecs.reshape(B * A, W))
            out["fp_hi"], out["fp_lo"] = hi.reshape(B, A), lo.reshape(B, A)
        if predicates:
            flat = {f: a.reshape((B * A,) + a.shape[2:])
                    for f, a in succs.items()}
            out["inv_ok"] = torch.stack(
                [p.ev_torch(flat, B * A, vecs.device).reshape(B, A)
                 for p in predicates], dim=-1)
        else:
            out["inv_ok"] = torch.ones((B, A, 0), dtype=torch.bool,
                                       device=vecs.device)
        out["con_ok"] = torch.ones_like(valid)
        return out

    return step
