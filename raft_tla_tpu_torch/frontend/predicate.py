"""Quantifier-free boolean predicate compiler over a state schema — the
port's copy of ``raft_tla_tpu/frontend/predicate.py``.

A cfg's INVARIANT stanza may name a registered invariant OR write an
expression directly.  The tokenizer, the parser, the typing and the error
messages are the reference's, verbatim, so a bad expression fails with the
reference's message, column included.  Each node evaluates in two ways:

- ``ev(struct, xp)``, the reference's per-state evaluator, here with
  ``xp = numpy`` only: the host's Init check (models/invariants.py);
- :meth:`Predicate.ev_torch`, a batched torch evaluator over a struct whose
  fields carry one leading batch axis: the plain step (ops/kernels.py).
  The reference vmaps the per-state function with ``jax.numpy``; here the
  per-state axes of two operands are right-aligned behind the batch axis,
  reductions run over every axis but the batch axis, and an index reads
  the last axis per batch row with JAX's rules (see :func:`_tev`).

K1 (csrc/step.cu) evaluates the same predicates as a flat program that
ops/predprog.py compiles from the typed tree.

Grammar (TLA+ ASCII operators, loosest to tightest):

    expr   :=  impl
    impl   :=  or  ("=>" or)*                  -- right-associative
    or     :=  and ("\\/" and)*
    and    :=  not ("/\\" not)*
    not    :=  "~" not | cmp
    cmp    :=  sum (("=" | "/=" | "<=" | ">=" | "<" | ">") sum)?
    sum    :=  term (("+" | "-") term)*
    term   :=  unary ("*" unary)*
    unary  :=  "-" unary | atom
    atom   :=  INT | TRUE | FALSE | NAME | NAME "[" expr "]"
            |  ("any" | "all" | "count" | "min" | "max") "(" expr ")"
            |  "(" expr ")"

NAME reads a schema field elementwise; comparisons and arithmetic
broadcast; a non-scalar boolean result is implicitly universally
quantified (``xp.all``) at the top — the quantifier-free reading of
TLA+'s ``\\A i \\in Server: P(i)``.  ``count`` sums a boolean array.

Everything is statically typed (BOOL vs INT) so malformed invariants
fail at admission with a position-carrying ValueError, never inside a
step.
"""

from __future__ import annotations

import dataclasses
import re

BOOL, INT = "bool", "int"

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<int>\d+)
    | (?P<name>[A-Za-z_]\w*)
    | (?P<op>=>|\\/|/\\|/=|<=|>=|[~=<>+\-*()\[\]])
    )""", re.VERBOSE)

_REDUCERS = ("any", "all", "count", "min", "max")
_CMP = {"=", "/=", "<", "<=", ">", ">="}

_IDENT = re.compile(r"[A-Za-z_]\w*\Z")


def is_expression(text: str) -> bool:
    """A bare identifier is a registered-invariant NAME; anything else
    (operators, brackets, digits-leading, ...) is an expression for this
    compiler.  One definition shared by cfgparse, cfglint, invariants,
    and serve admission so they can never disagree."""
    return _IDENT.match(text.strip()) is None


def _tokenize(text: str):
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == m.start():
            rest = text[pos:].lstrip()
            if not rest:
                break
            raise ValueError(
                f"predicate syntax error at column {pos + 1}: "
                f"unexpected {rest[:10]!r}")
        if m.lastgroup is not None:
            toks.append((m.lastgroup, m.group(m.lastgroup), m.start()))
        pos = m.end()
    toks.append(("end", "", len(text)))
    return toks


# ---------------------------------------------------------------------------
# AST — each node evaluates against a struct of arrays with xp = numpy
# (the batched torch form is _tev below) and reports its static type and
# field reads.

@dataclasses.dataclass(frozen=True)
class Lit:
    v: int
    kind: str = INT

    def ev(self, struct, xp):
        return self.v

    def reads(self):
        return frozenset()


@dataclasses.dataclass(frozen=True)
class Name:
    field: str
    kind: str = INT

    def ev(self, struct, xp):
        return struct[self.field]

    def reads(self):
        return frozenset((self.field,))


@dataclasses.dataclass(frozen=True)
class Index:
    field: str
    idx: object
    kind: str = INT

    def ev(self, struct, xp):
        return struct[self.field][..., self.idx.ev(struct, xp)]

    def reads(self):
        return frozenset((self.field,)) | self.idx.reads()


@dataclasses.dataclass(frozen=True)
class Neg:
    a: object
    kind: str = INT

    def ev(self, struct, xp):
        return -self.a.ev(struct, xp)

    def reads(self):
        return self.a.reads()


@dataclasses.dataclass(frozen=True)
class Not:
    a: object
    kind: str = BOOL

    def ev(self, struct, xp):
        return xp.logical_not(self.a.ev(struct, xp))

    def reads(self):
        return self.a.reads()


_BIN_EV = {
    "+": lambda a, b, xp: a + b,
    "-": lambda a, b, xp: a - b,
    "*": lambda a, b, xp: a * b,
    "=": lambda a, b, xp: a == b,
    "/=": lambda a, b, xp: a != b,
    "<": lambda a, b, xp: a < b,
    "<=": lambda a, b, xp: a <= b,
    ">": lambda a, b, xp: a > b,
    ">=": lambda a, b, xp: a >= b,
    "/\\": lambda a, b, xp: xp.logical_and(a, b),
    "\\/": lambda a, b, xp: xp.logical_or(a, b),
    "=>": lambda a, b, xp: xp.logical_or(xp.logical_not(a), b),
}


@dataclasses.dataclass(frozen=True)
class Bin:
    op: str
    a: object
    b: object
    kind: str = INT

    def ev(self, struct, xp):
        return _BIN_EV[self.op](self.a.ev(struct, xp),
                                self.b.ev(struct, xp), xp)

    def reads(self):
        return self.a.reads() | self.b.reads()


@dataclasses.dataclass(frozen=True)
class Reduce:
    fn: str
    a: object
    kind: str = INT

    def ev(self, struct, xp):
        v = self.a.ev(struct, xp)
        if self.fn == "any":
            return xp.any(v)
        if self.fn == "all":
            return xp.all(v)
        if self.fn == "count":
            # sum of a boolean array; int32 keeps it on the state dtype
            return xp.sum(xp.asarray(v, dtype="int32"))
        if self.fn == "min":
            return xp.min(v)
        return xp.max(v)

    def reads(self):
        return self.a.reads()


class _Parser:
    def __init__(self, text: str, fields=None):
        self.text = text
        self.toks = _tokenize(text)
        self.i = 0
        self.fields = None if fields is None else tuple(fields)

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def err(self, msg, tok=None):
        tok = tok or self.peek()
        return ValueError(f"predicate syntax error at column "
                          f"{tok[2] + 1}: {msg} (in {self.text!r})")

    def expect(self, op):
        t = self.next()
        if t[0] != "op" or t[1] != op:
            raise self.err(f"expected {op!r}, got {t[1] or 'end'!r}", t)

    def want_bool(self, node, ctx):
        if node.kind != BOOL:
            raise self.err(f"{ctx} needs a boolean operand")
        return node

    def want_int(self, node, ctx):
        if node.kind != INT:
            raise self.err(f"{ctx} needs an integer operand")
        return node

    def parse(self):
        node = self.impl()
        t = self.peek()
        if t[0] != "end":
            raise self.err(f"trailing input {t[1]!r}")
        return node

    def impl(self):
        left = self.or_()
        if self.peek()[:2] == ("op", "=>"):
            self.next()
            right = self.impl()                     # right-associative
            return Bin("=>", self.want_bool(left, "'=>'"),
                       self.want_bool(right, "'=>'"), BOOL)
        return left

    def or_(self):
        node = self.and_()
        while self.peek()[:2] == ("op", "\\/"):
            self.next()
            rhs = self.and_()
            node = Bin("\\/", self.want_bool(node, "'\\/'"),
                       self.want_bool(rhs, "'\\/'"), BOOL)
        return node

    def and_(self):
        node = self.not_()
        while self.peek()[:2] == ("op", "/\\"):
            self.next()
            rhs = self.not_()
            node = Bin("/\\", self.want_bool(node, "'/\\'"),
                       self.want_bool(rhs, "'/\\'"), BOOL)
        return node

    def not_(self):
        if self.peek()[:2] == ("op", "~"):
            self.next()
            return Not(self.want_bool(self.not_(), "'~'"))
        return self.cmp()

    def cmp(self):
        left = self.sum()
        t = self.peek()
        if t[0] == "op" and t[1] in _CMP:
            self.next()
            right = self.sum()
            return Bin(t[1], self.want_int(left, f"{t[1]!r}"),
                       self.want_int(right, f"{t[1]!r}"), BOOL)
        return left

    def sum(self):
        node = self.term()
        while self.peek()[0] == "op" and self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            rhs = self.term()
            node = Bin(op, self.want_int(node, f"{op!r}"),
                       self.want_int(rhs, f"{op!r}"), INT)
        return node

    def term(self):
        node = self.unary()
        while self.peek()[:2] == ("op", "*"):
            self.next()
            rhs = self.unary()
            node = Bin("*", self.want_int(node, "'*'"),
                       self.want_int(rhs, "'*'"), INT)
        return node

    def unary(self):
        if self.peek()[:2] == ("op", "-"):
            self.next()
            return Neg(self.want_int(self.unary(), "unary '-'"))
        return self.atom()

    def atom(self):
        t = self.next()
        if t[0] == "int":
            return Lit(int(t[1]))
        if t[0] == "name":
            name = t[1]
            if name == "TRUE":
                return Lit(True, BOOL)
            if name == "FALSE":
                return Lit(False, BOOL)
            if name in _REDUCERS:
                self.expect("(")
                arg = self.impl()
                self.expect(")")
                if name in ("any", "all"):
                    return Reduce(name, self.want_bool(arg, name), BOOL)
                if name == "count":
                    return Reduce(name, self.want_bool(arg, name), INT)
                return Reduce(name, self.want_int(arg, name), INT)
            if self.fields is not None and name not in self.fields:
                raise self.err(
                    f"unknown field {name!r}; schema fields: "
                    f"{', '.join(self.fields)}", t)
            if self.peek()[:2] == ("op", "["):
                self.next()
                idx = self.sum()
                self.expect("]")
                return Index(name, self.want_int(idx, "index"))
            return Name(name)
        if t[:2] == ("op", "("):
            node = self.impl()
            self.expect(")")
            return node
        raise self.err(f"unexpected {t[1] or 'end of input'!r}", t)


@dataclasses.dataclass(frozen=True)
class Predicate:
    """A compiled predicate: ``ev(struct, xp)`` -> scalar bool (numpy or
    traced jnp), ``reads`` for the vacuity pass, ``text`` for display."""
    text: str
    node: object
    reads: frozenset

    def ev(self, struct, xp):
        v = self.node.ev(struct, xp)
        # implicit universal quantification over any residual axes
        return xp.all(v)

    def ev_torch(self, struct, batch: int, device="cpu"):
        """bool[batch]: the predicate of each of ``batch`` states, whose
        fields in ``struct`` are torch tensors ``[batch, *shape]`` on
        ``device``."""
        v = _as_batch(_tev(self.node, struct, batch, device), batch, device)
        return v.reshape(batch, -1).all(1)


def parse(text: str, fields=None):
    """Parse to an AST; ``fields`` (optional) enables unknown-field
    errors at compile time instead of KeyErrors at probe time."""
    return _Parser(text, fields).parse()


def compile_predicate(text: str, fields=None) -> Predicate:
    node = parse(text, fields)
    if node.kind != BOOL:
        raise ValueError(
            f"predicate {text!r} is arithmetic, not boolean — an "
            "invariant must evaluate to TRUE/FALSE (wrap it in a "
            "comparison)")
    return Predicate(text, node, frozenset(node.reads()))


# ---------------------------------------------------------------------------
# The batched torch evaluator.  A value is a Python int or bool (a constant
# subtree, folded as the reference's Python arithmetic folds it) or a
# tensor [B, *shape] of int32 or bool, ``shape`` the per-state shape.  The
# JAX semantics it reproduces, per state:
#
# - int32 arithmetic wraps (``+``, ``-``, ``*``, unary ``-``);
# - a Python int that meets an int32 array must fit int32 (JAX raises
#   OverflowError otherwise; so does this);
# - in ``f[e]`` each index first wraps once if negative, then clamps into
#   range (JAX's gather, for a constant e as for an array e; the numpy path
#   raises IndexError instead), and ``f[e]`` has shape
#   ``f.shape[:-1] + e.shape``;
# - a reducer over a constant yields an int32 or bool array, so what
#   follows it computes in int32.

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _check_i32(v):
    if not isinstance(v, bool) and not _I32_MIN <= v <= _I32_MAX:
        raise OverflowError(f"Python int {v} too large to convert to int32")
    return v


def _wrap32(x):
    """int64 tensor -> int32 tensor, modulo 2^32 (two's complement)."""
    import torch
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _as_batch(v, batch: int, device):
    """A value as a tensor [batch, ...] on ``device``."""
    import torch
    if isinstance(v, torch.Tensor):
        return v
    dtype = torch.bool if isinstance(v, bool) else torch.int32
    return torch.full((batch,), _check_i32(v), dtype=dtype, device=device)


def _align(a, b):
    """Right-align the per-state axes of two batched tensors."""
    if a.dim() < b.dim():
        a = a.reshape(a.shape[:1] + (1,) * (b.dim() - a.dim()) + a.shape[1:])
    elif b.dim() < a.dim():
        b = b.reshape(b.shape[:1] + (1,) * (a.dim() - b.dim()) + b.shape[1:])
    return a, b


def _binary(op: str, a, b):
    import torch
    ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if not (ta or tb):
        return _PY_LOGIC[op](a, b) if op in _PY_LOGIC \
            else _BIN_EV[op](a, b, None)
    if not ta:
        a = _check_i32(a)
    if not tb:
        b = _check_i32(b)
    if ta and tb:
        a, b = _align(a, b)
    if op in ("+", "-", "*"):
        a64 = a.to(torch.int64) if ta else a
        b64 = b.to(torch.int64) if tb else b
        return _wrap32(_BIN_EV[op](a64, b64, None))
    if op in _PY_LOGIC:
        if not ta:
            a = torch.full_like(b, bool(a), dtype=torch.bool)
        if not tb:
            b = torch.full_like(a, bool(b), dtype=torch.bool)
        if op == "/\\":
            return torch.logical_and(a, b)
        if op == "\\/":
            return torch.logical_or(a, b)
        return torch.logical_or(torch.logical_not(a), b)
    return _BIN_EV[op](a, b, None)


_PY_LOGIC = {
    "/\\": lambda a, b: bool(a) and bool(b),
    "\\/": lambda a, b: bool(a) or bool(b),
    "=>": lambda a, b: (not a) or bool(b),
}


def _index(x, i):
    """``x[..., i]`` per batch row (x: [B, *shape])."""
    import torch
    n = x.shape[-1]
    if not isinstance(i, torch.Tensor):
        return x[..., min(max(i + n if i < 0 else i, 0), n - 1)]
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1).to(torch.int64)
    B, outer, inner = x.shape[0], x.shape[1:-1], i.shape[1:]
    xf = x.reshape(B, -1, n)
    idx = i.reshape(B, 1, -1).expand(B, xf.shape[1], -1)
    return torch.gather(xf, 2, idx).reshape((B,) + outer + inner)


def _tev(node, struct, batch: int, device):
    """The batched value of ``node`` (see the block comment above)."""
    import torch
    if isinstance(node, Lit):
        return node.v
    if isinstance(node, Name):
        return struct[node.field]
    if isinstance(node, Index):
        return _index(struct[node.field],
                      _tev(node.idx, struct, batch, device))
    if isinstance(node, Neg):
        a = _tev(node.a, struct, batch, device)
        return _wrap32(-a.to(torch.int64)) if isinstance(a, torch.Tensor) \
            else -a
    if isinstance(node, Not):
        a = _tev(node.a, struct, batch, device)
        return torch.logical_not(a) if isinstance(a, torch.Tensor) \
            else not a
    if isinstance(node, Bin):
        return _binary(node.op, _tev(node.a, struct, batch, device),
                       _tev(node.b, struct, batch, device))
    v = _as_batch(_tev(node.a, struct, batch, device), batch,
                  device).reshape(batch, -1)
    if node.fn == "any":
        return v.any(1)
    if node.fn == "all":
        return v.all(1)
    if node.fn == "count":
        return v.to(torch.int32).sum(1, dtype=torch.int32)
    if node.fn == "min":
        return v.amin(1)
    return v.amax(1)
