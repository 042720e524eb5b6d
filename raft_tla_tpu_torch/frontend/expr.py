"""The action-definition IR — guards, per-field updates, bag ops; the port
of ``raft_tla_tpu/frontend/expr.py``.

An :class:`ActionDef` describes one action family of a spec as data:
scalar guard/value expressions over the state struct, one-hot field
updates, and message-bag operations.  Two consumers compile it:

- ``frontend/actions.py`` lowers it to a batched kernel with the
  ``(bounds, s, *params) -> (out, valid, ovf)`` contract of
  ``ops/kernels.grouped_dispatch``.  The lowering calls the same helpers the
  hand-written plain step uses (``_set1``/``_set2``/``bag_add``/
  ``_tree_select``/msgbits accessors), so equal IR semantics give
  bit-identical lanes.
- ``frontend/widthgen.py`` abstract-interprets the same tree over the
  interval domain (``analysis/intervals``) to generate the width pass's
  transfer twins.

Batched evaluation.  The reference evaluates an expression on one state and
``jax.vmap``s it over instances and rows.  Here :class:`Ctx` holds the
struct broadcast to ``[B, K, ...]`` (K instances of one family) and each
parameter as a ``[1, K]`` index tensor, so an expression's value is a
Python scalar (a constant subtree), a ``[1, K]`` tensor (parameters only)
or a ``[B, K]`` tensor; a field read with an index gathers along the
field's own axes per lane (``ops/kernels._get``, clamped like a JAX gather
with a traced index).  :class:`Intrinsic` functions take the batched
struct and reduce over the field's trailing axes.
"""

from __future__ import annotations

import dataclasses

import torch

from raft_tla_tpu_torch.analysis import intervals as iv

BOOL, INT = "bool", "int"


class Infeasible(Exception):
    """Raised during interval evaluation when a branch cannot execute
    under the current message envelope / guard refinement (e.g. a
    MsgField read of an mtype no creation site produces).  widthgen skips
    the branch — mirroring the hand twins' ``if rec is not None``
    structure."""


def index(ctx, v):
    """An index value as a tensor on the struct's device (a Python int
    becomes a 0-dim tensor)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(int(v), dtype=torch.int32, device=ctx.device)


class Ctx:
    """Concrete evaluation context: K instances of one family on B rows
    (fields ``[B, K, ...]``, parameters ``[1, K]``)."""

    __slots__ = ("bounds", "s", "params", "device", "_msg")

    def __init__(self, bounds, s, params):
        self.bounds, self.s, self.params = bounds, s, params
        self.device = next(iter(s.values())).device
        self._msg = None

    def msg_words(self):
        """(msgHi[slot], msgLo[slot]) of the instance's ``slot`` param."""
        if self._msg is None:
            from raft_tla_tpu_torch.ops.kernels import _get
            slot = self.params["slot"]
            self._msg = (_get(self.s["msgHi"], slot),
                         _get(self.s["msgLo"], slot))
        return self._msg


class IvCtx:
    """Abstract evaluation context for widthgen: the expansion envelope,
    the message envelope, per-param declared intervals, and the active
    branch's mtype scope for MsgField reads."""

    __slots__ = ("bounds", "env", "menv", "param_iv", "mtype")

    def __init__(self, bounds, env, menv, param_iv, mtype=None):
        self.bounds = bounds
        self.env = env
        self.menv = menv
        self.param_iv = param_iv
        self.mtype = mtype


# ---------------------------------------------------------------------------
# Scalar expressions


@dataclasses.dataclass(frozen=True)
class Lit:
    v: object                     # int or bool

    def ev(self, ctx):
        return self.v

    def iv(self, ictx):
        if isinstance(self.v, bool):
            return iv.BOOL if self.v else iv.const(0)
        return iv.const(self.v)


@dataclasses.dataclass(frozen=True)
class Dim:
    """A bounds-derived static integer (``n_servers``, ``log_cap``, ...);
    evaluates to a Python int."""
    name: str

    def ev(self, ctx):
        return int(getattr(ctx.bounds, self.name))

    def iv(self, ictx):
        return iv.const(int(getattr(ictx.bounds, self.name)))


@dataclasses.dataclass(frozen=True)
class Param:
    name: str

    def ev(self, ctx):
        return ctx.params[self.name]

    def iv(self, ictx):
        return ictx.param_iv[self.name]


@dataclasses.dataclass(frozen=True)
class Get:
    """State read ``s[field][idx...]`` (0, 1 or 2 scalar indices)."""
    field: str
    idx: tuple = ()

    def ev(self, ctx):
        from raft_tla_tpu_torch.ops.kernels import _get, _get_row
        a = ctx.s[self.field]
        if not self.idx:
            return a
        if len(self.idx) == 1:
            return _get(a, index(ctx, self.idx[0].ev(ctx)))
        i, j = (index(ctx, e.ev(ctx)) for e in self.idx)
        return _get(_get_row(a, i), j)

    def iv(self, ictx):
        return ictx.env[self.field]


def _where(c, a, b):
    """``where`` whose result stays int32 when both arms are Python ints
    (JAX's weak typing; torch would widen to int64)."""
    out = torch.where(c, a, b)
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor) \
            and out.dtype == torch.int64:
        out = out.to(torch.int32)
    return out


def _minimum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return a.clamp(max=b)
    if isinstance(b, torch.Tensor):
        return b.clamp(max=a)
    return min(a, b)


def _maximum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    if isinstance(a, torch.Tensor):
        return a.clamp(min=b)
    if isinstance(b, torch.Tensor):
        return b.clamp(min=a)
    return max(a, b)


# evaluator / interval-transfer tables per op code; "and"/"or" are the
# logical forms (BOOL), "band"/"bor" the bitwise forms (value intervals)
_EV = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "band": lambda a, b: a & b,
    "bor": lambda a, b: a | b,
    "<<": lambda a, b: a << b,
    ">>": lambda a, b: a >> b,
}

_IV = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: iv.Interval(a.lo * b.lo, a.hi * b.hi),
    "band": lambda a, b: iv.Interval(0, min(a.hi, b.hi)),
    "bor": lambda a, b: a.or_(b),
    "<<": lambda a, b: iv.Interval(a.lo << b.lo, a.hi << b.hi),
    ">>": lambda a, b: iv.Interval(a.lo >> b.hi, a.hi >> b.lo),
}


@dataclasses.dataclass(frozen=True)
class Bin:
    op: str
    a: object
    b: object

    def ev(self, ctx):
        return _EV[self.op](self.a.ev(ctx), self.b.ev(ctx))

    def iv(self, ictx):
        if self.op in ("==", "!=", "<", "<=", ">", ">=", "and", "or"):
            return iv.BOOL
        return _IV[self.op](self.a.iv(ictx), self.b.iv(ictx))


@dataclasses.dataclass(frozen=True)
class Not:
    a: object

    def ev(self, ctx):
        return ~self.a.ev(ctx)

    def iv(self, ictx):
        return iv.BOOL


@dataclasses.dataclass(frozen=True)
class Where:
    c: object
    a: object
    b: object

    def ev(self, ctx):
        return _where(self.c.ev(ctx), self.a.ev(ctx), self.b.ev(ctx))

    def iv(self, ictx):
        return self.a.iv(ictx).join(self.b.iv(ictx))


@dataclasses.dataclass(frozen=True)
class Clip:
    a: object
    lo: object
    hi: object

    def ev(self, ctx):
        return _minimum(_maximum(self.a.ev(ctx), self.lo.ev(ctx)),
                        self.hi.ev(ctx))

    def iv(self, ictx):
        a = self.a.iv(ictx)
        lo, hi = self.lo.iv(ictx), self.hi.iv(ictx)
        return iv.Interval(max(a.lo, lo.lo), min(a.hi, hi.hi))


@dataclasses.dataclass(frozen=True)
class MinE:
    a: object
    b: object

    def ev(self, ctx):
        return _minimum(self.a.ev(ctx), self.b.ev(ctx))

    def iv(self, ictx):
        return self.a.iv(ictx).min_(self.b.iv(ictx))


@dataclasses.dataclass(frozen=True)
class MaxE:
    a: object
    b: object

    def ev(self, ctx):
        return _maximum(self.a.ev(ctx), self.b.ev(ctx))

    def iv(self, ictx):
        return self.a.iv(ictx).max_(self.b.iv(ictx))


@dataclasses.dataclass(frozen=True)
class Popcount:
    a: object

    def ev(self, ctx):
        from raft_tla_tpu_torch.ops.kernels import _popcount
        return _popcount(self.a.ev(ctx))

    def iv(self, ictx):
        return iv.Interval(0, max(self.a.iv(ictx).hi.bit_length(), 1))


@dataclasses.dataclass(frozen=True)
class LastTerm:
    """``LastTerm(log[i])`` (raft.tla:102) — a builtin: 0 on an empty
    log, else the stored tail term."""
    i: object

    def ev(self, ctx):
        from raft_tla_tpu_torch.ops.kernels import _last_term
        return _last_term(ctx.s, index(ctx, self.i.ev(ctx)))

    def iv(self, ictx):
        return ictx.env["logTerm"].join(0)


@dataclasses.dataclass(frozen=True)
class MsgField:
    """Subfield read of the current ``slot``'s packed message words.

    Abstractly this reads the message envelope: scoped to the enclosing
    branch's ``mtype`` when set, else joined across every record that
    carries the subfield (the UpdateTerm shape).  No carrying record =>
    the branch is infeasible under this envelope."""
    name: str

    def ev(self, ctx):
        from raft_tla_tpu_torch.ops import msgbits as mb
        hi, lo = ctx.msg_words()
        acc = {"mtype": (mb.mtype, 0), "mterm": (mb.mterm, 0),
               "a": (mb.fa, 0), "b": (mb.fb, 0), "src": (mb.src, 0),
               "dst": (mb.dst, 0), "c": (mb.fc, 1), "d": (mb.fd, 1),
               "e": (mb.fe, 1), "f": (mb.ff, 1), "g": (mb.fg, 1)}
        fn, word = acc[self.name]
        return fn(lo if word else hi)

    def iv(self, ictx):
        if ictx.mtype is not None:
            rec = ictx.menv.get(ictx.mtype)
            if rec is None or self.name not in rec:
                raise Infeasible(self.name)
            return rec[self.name]
        vals = [rec[self.name] for rec in ictx.menv.values()
                if self.name in rec]
        if not vals:
            raise Infeasible(self.name)
        out = vals[0]
        for v in vals[1:]:
            out = out.join(v)
        return out


@dataclasses.dataclass(frozen=True)
class Intrinsic:
    """Compiler builtin: an aggregation the scalar IR cannot express,
    with a declared interval transfer (widthgen uses ``ivfn(bounds, env)``
    verbatim).  ``fn(bounds, s, params)`` takes the batched struct
    (``[B, K, ...]``) and returns one value per lane."""
    name: str
    fn: object        # (bounds, s, params) -> value [B, K]
    ivfn: object      # (bounds, env) -> Interval

    def ev(self, ctx):
        return self.fn(ctx.bounds, ctx.s, ctx.params)

    def iv(self, ictx):
        return self.ivfn(ictx.bounds, ictx.env)


# ---------------------------------------------------------------------------
# Field updates (array effects; values read the PRE-state, like the
# functional hand kernels)


@dataclasses.dataclass(frozen=True)
class Set1:
    """``field[i] := val`` (optionally only when ``cond``); the hand
    kernels' ``_set1``/conditional-``_set1`` idiom."""
    field: str
    i: object
    val: object
    cond: object = None


@dataclasses.dataclass(frozen=True)
class SetRow:
    """``field[i][*] := val`` — whole row to a scalar (``_set_row``)."""
    field: str
    i: object
    val: object


@dataclasses.dataclass(frozen=True)
class Set2:
    """``field[i][j] := val`` (optionally only when ``cond``) — one cell
    of a 2-D field (``_set2``; the log writes use j = a log index)."""
    field: str
    i: object
    j: object
    val: object
    cond: object = None


# ---------------------------------------------------------------------------
# Bag / message ops (applied after the field updates, in order)


@dataclasses.dataclass(frozen=True)
class PackMsg:
    """One packed-record creation site.  ``fields`` maps msgbits
    subfield names to scalar exprs (missing names pack as 0); ``facts``
    declares relational facts ((name, (bounds, env, menv) -> Interval))
    that join into the message envelope but are not packed — e.g. the
    AppendEntriesRequest ``a+c`` bound; ``overrides`` replaces a
    subfield's *derived* interval with an envelope fact by name (the
    done-reply's ``b`` echoes ``a+c``)."""
    mtype: int
    fields: tuple                 # ((name, Expr), ...)
    facts: tuple = ()             # ((name, fn), ...)
    overrides: tuple = ()         # ((field, fact_name_in_menv), ...)


@dataclasses.dataclass(frozen=True)
class BagAdd:
    msg: PackMsg


@dataclasses.dataclass(frozen=True)
class BagRemove:
    """Remove the current ``slot``'s message (WithoutMessage)."""


@dataclasses.dataclass(frozen=True)
class Reply:
    """Remove the current ``slot``'s message, add the response
    (``kernels.reply``: remove-first, overflow on the final bag)."""
    msg: PackMsg


# ---------------------------------------------------------------------------
# Branches and actions


@dataclasses.dataclass(frozen=True)
class Branch:
    """One guarded alternative.  ``guard=None`` only in single-branch
    actions (updates apply unconditionally; validity masks downstream).
    ``mtype`` scopes MsgField reads for widthgen; ``refines`` declares
    guard-implied envelope refinements ((field, lo, hi) meets — an
    empty meet marks the branch infeasible); ``overflow`` is an extra
    overflow condition OR'd with the branch's bag overflows."""
    guard: object = None
    updates: tuple = ()
    ops: tuple = ()
    overflow: object = None
    mtype: object = None
    refines: tuple = ()


@dataclasses.dataclass(frozen=True)
class ActionDef:
    """One action family: parameter names (kernel argument order),
    validity, and ordered branches (``_tree_select`` order — guards must
    be exclusive).  ``any_guard_valid`` AND-joins ``valid`` with "some
    branch fired" (the Receive shape).  ``param_iv`` declares per-param
    intervals for widthgen ((name, fn(bounds) -> Interval))."""
    family: str
    params: tuple
    valid: object
    branches: tuple
    param_iv: tuple = ()
    any_guard_valid: bool = False

    def __post_init__(self):
        if len(self.branches) > 1:
            for br in self.branches:
                if br.guard is None:
                    raise ValueError(
                        f"{self.family}: multi-branch actions need a "
                        "guard on every branch")
