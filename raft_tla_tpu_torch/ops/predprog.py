"""Expression invariants as the flat program K1 runs, and its plain
evaluator.

This module has no counterpart in the reference.  There, an expression
invariant (frontend/predicate.py) is a ``jax.numpy`` function that XLA and
the Pallas megakernel trace with the rest of the step.  K1
(``csrc/step.cu``) is compiled once per layout and knows no expression, so
the host lowers each one to a straight-line program of scalar operations
over the packed row, and K1's expression stage interprets it.

Shapes are static, so :func:`compile_program` resolves every broadcast,
index and reduction on the host: each array value is a lazy element
function, elementwise work is emitted per element at the reduction or the
final ``all`` that consumes it, and a reducer's result is computed once
into a register of its own.  The semantics are the reference's, per state
(frontend/predicate._tev lists them): int32 arithmetic wraps, a Python int
that meets an array must fit int32, an index wraps once if negative and
then clamps.

A program is int32 words, five per instruction ``(op, dst, a, b, c)``;
registers are int32 (booleans 0 or 1), at most :data:`MAX_REGS` of them,
reused once dead.  The ops (:data:`OPS`):

- ``CONST d, k``: r[d] = k;
- ``LOAD d, off``: r[d] = row[off];
- ``LOADIX d, base, n, i``: r[d] = row[base + clamp(wrap(r[i], n), 0, n-1)]
  with wrap(x, n) = x + n for x < 0;
- ``NEG``, ``NOT`` (unary); ``ADD SUB MUL`` modulo 2^32; ``EQ NE LT LE GT
  GE``; ``AND OR IMPL`` on booleans; ``MIN MAX``;
- ``RET a``: the predicate is r[a] != 0.

:func:`evaluate` runs a program over a batch of rows in torch: the plain
version K1's stage is held to (on the CPU against the batched evaluator
``Predicate.ev_torch``, on the card against K1).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from raft_tla_tpu_torch.frontend import predicate as P
from raft_tla_tpu_torch.ops import state as st

OPS = ("CONST", "LOAD", "LOADIX", "NEG", "NOT", "ADD", "SUB", "MUL", "EQ",
       "NE", "LT", "LE", "GT", "GE", "AND", "OR", "IMPL", "MIN", "MAX", "RET")
OP = {name: k for k, name in enumerate(OPS)}
MAX_REGS = 64        # csrc/step.cu kExprRegs
_BIN_OP = {"+": "ADD", "-": "SUB", "*": "MUL", "=": "EQ", "/=": "NE",
           "<": "LT", "<=": "LE", ">": "GT", ">=": "GE", "/\\": "AND",
           "\\/": "OR", "=>": "IMPL"}
_REDUCE_OP = {"any": "OR", "all": "AND", "count": "ADD", "min": "MIN",
              "max": "MAX"}


class _Arr:
    """A lazy int32 or bool array of per-state ``shape``: ``elem(index)``
    emits the code of one element and returns ``(register, owned)``; an
    owned register is a temporary the consumer frees."""

    def __init__(self, shape: tuple, elem):
        self.shape = tuple(shape)
        self.elem = elem


class _Emitter:
    def __init__(self):
        self.code: list = []
        self.free: list = []
        self.n_regs = 0
        self.consts: dict = {}

    def reg(self) -> int:
        if self.free:
            return self.free.pop()
        if self.n_regs >= MAX_REGS:
            raise ValueError(f"expression needs more than {MAX_REGS} "
                             "registers in K1's expression stage")
        self.n_regs += 1
        return self.n_regs - 1

    def release(self, r: int, owned: bool) -> None:
        if owned:
            self.free.append(r)

    def instr(self, op: str, a: int = 0, b: int = 0, c: int = 0,
              operands=()) -> int:
        """Emit ``op`` into a new register after freeing ``operands`` (the
        interpreter reads its operands before it writes)."""
        for r, owned in operands:
            self.release(r, owned)
        d = self.reg()
        self.code.append((OP[op], d, a, b, c))
        return d

    def const(self, v) -> tuple:
        """A pinned register holding the constant ``v``."""
        v = int(P._check_i32(v))
        if v not in self.consts:
            self.consts[v] = self.instr("CONST", v)
        return self.consts[v], False


def _bshape(sa: tuple, sb: tuple) -> tuple:
    """numpy's broadcast of two per-state shapes."""
    try:
        return tuple(np.broadcast_shapes(sa, sb))
    except ValueError:
        raise ValueError(f"shapes {sa} and {sb} do not broadcast") from None


def _sub(idx: tuple, shape: tuple) -> tuple:
    """The index into an operand of ``shape`` broadcast to ``idx``."""
    tail = idx[len(idx) - len(shape):] if shape else ()
    return tuple(0 if d == 1 else i for i, d in zip(tail, shape))


def _elements(shape: tuple):
    return itertools.product(*(range(d) for d in shape))


class _Compiler:
    def __init__(self, lay: st.Layout):
        self.e = _Emitter()
        self.shapes = lay.shapes
        self.offsets, off = {}, 0
        for f, shape in self.shapes.items():
            self.offsets[f] = off
            off += int(np.prod(shape))

    def operand(self, v) -> _Arr:
        """A value as an array (a constant becomes a pinned scalar)."""
        if isinstance(v, _Arr):
            return v
        reg = self.e.const(v)
        return _Arr((), lambda idx: reg)

    def flat(self, field: str, idx: tuple) -> int:
        return self.offsets[field] + int(np.ravel_multi_index(
            idx, self.shapes[field]))

    def value(self, node):
        """A Python constant or an :class:`_Arr` for ``node``."""
        e = self.e
        if isinstance(node, P.Lit):
            return node.v
        if isinstance(node, P.Name):
            f = node.field
            return _Arr(self.shapes[f], lambda idx: (
                e.instr("LOAD", self.flat(f, idx)), True))
        if isinstance(node, P.Index):
            return self.index(node.field, self.value(node.idx))
        if isinstance(node, P.Neg):
            a = self.value(node.a)
            if not isinstance(a, _Arr):
                return -a
            return _Arr(a.shape, lambda idx: (
                self._unary("NEG", a.elem(idx)), True))
        if isinstance(node, P.Not):
            a = self.value(node.a)
            if not isinstance(a, _Arr):
                return not a
            return _Arr(a.shape, lambda idx: (
                self._unary("NOT", a.elem(idx)), True))
        if isinstance(node, P.Bin):
            return self.binary(node.op, self.value(node.a),
                               self.value(node.b))
        return self.reduce(node.fn, self.value(node.a))

    def _unary(self, op: str, ra: tuple) -> int:
        return self.e.instr(op, ra[0], operands=(ra,))

    def index(self, field: str, i):
        shape = self.shapes[field]
        n = shape[-1]
        if not isinstance(i, _Arr):
            c = min(max(i + n if i < 0 else i, 0), n - 1)
            return _Arr(shape[:-1], lambda idx: (
                self.e.instr("LOAD", self.flat(field, idx + (c,))), True))
        outer = len(shape) - 1

        def elem(idx):
            ri = i.elem(idx[outer:])
            base = self.flat(field, idx[:outer] + (0,))
            return self.e.instr("LOADIX", base, n, ri[0],
                                operands=(ri,)), True

        return _Arr(shape[:-1] + i.shape, elem)

    def binary(self, op: str, a, b):
        if not isinstance(a, _Arr) and not isinstance(b, _Arr):
            return P._binary(op, a, b)
        a, b = self.operand(a), self.operand(b)
        shape = _bshape(a.shape, b.shape)

        def elem(idx):
            ra = a.elem(_sub(idx, a.shape))
            rb = b.elem(_sub(idx, b.shape))
            return self.e.instr(_BIN_OP[op], ra[0], rb[0],
                                operands=(ra, rb)), True

        return _Arr(shape, elem)

    def fold(self, op: str, a: _Arr) -> tuple:
        """``op`` over every element of ``a``, left to right."""
        acc = None
        for idx in _elements(a.shape):
            r = a.elem(idx)
            acc = r if acc is None else (
                self.e.instr(op, acc[0], r[0], operands=(acc, r)), True)
        return acc

    def reduce(self, fn: str, a) -> _Arr:
        """A reducer's result, computed now into a pinned register."""
        r = self.fold(_REDUCE_OP[fn], self.operand(a))
        return _Arr((), lambda idx: (r[0], False))

    def program(self, pred: P.Predicate) -> np.ndarray:
        top = self.value(pred.node)
        r = self.fold("AND", self.operand(top))
        self.e.code.append((OP["RET"], 0, r[0], 0, 0))
        return np.asarray(self.e.code, np.int32).reshape(-1)


def compile_program(pred: P.Predicate, lay: st.Layout) -> np.ndarray:
    """The flat int32 program of ``pred`` for rows of layout ``lay``."""
    return _Compiler(lay).program(pred)


def evaluate(prog: np.ndarray, rows: torch.Tensor) -> torch.Tensor:
    """bool[B]: the program over ``rows`` int32[B, W] (the plain version of
    K1's expression stage)."""
    I64 = torch.int64
    regs = {}
    rows = rows.to(I64)
    B = rows.shape[0]
    for op, d, a, b, c in np.asarray(prog).reshape(-1, 5).tolist():
        name = OPS[op]
        if name == "RET":
            return regs[a] != 0
        if name == "CONST":
            v = torch.full((B,), a, dtype=I64, device=rows.device)
        elif name == "LOAD":
            v = rows[:, a]
        elif name == "LOADIX":
            i = regs[c]
            i = torch.where(i < 0, i + b, i).clamp(0, b - 1)
            v = rows.gather(1, (a + i).unsqueeze(1)).squeeze(1)
        elif name == "NEG":
            v = P._wrap32(-regs[a]).to(I64)
        elif name == "NOT":
            v = (regs[a] == 0).to(I64)
        else:
            x, y = regs[a], regs[b]
            v = {
                "ADD": lambda: P._wrap32(x + y).to(I64),
                "SUB": lambda: P._wrap32(x - y).to(I64),
                "MUL": lambda: P._wrap32(x * y).to(I64),
                "EQ": lambda: (x == y).to(I64),
                "NE": lambda: (x != y).to(I64),
                "LT": lambda: (x < y).to(I64),
                "LE": lambda: (x <= y).to(I64),
                "GT": lambda: (x > y).to(I64),
                "GE": lambda: (x >= y).to(I64),
                "AND": lambda: ((x != 0) & (y != 0)).to(I64),
                "OR": lambda: ((x != 0) | (y != 0)).to(I64),
                "IMPL": lambda: ((x == 0) | (y != 0)).to(I64),
                "MIN": lambda: torch.minimum(x, y),
                "MAX": lambda: torch.maximum(x, y),
            }[name]()
        regs[d] = v
    raise ValueError("program without RET")


def kernel_tables(invariants: tuple, bounds) -> tuple:
    """K1's invariant tables for ``invariants``: ``(codes, prog)`` int32.
    A registry invariant's code is its ``models/invariants.CODES`` entry; an
    expression's is ``-1 - start``, its program at word ``start`` of
    ``prog`` (programs concatenated in CheckConfig order)."""
    from raft_tla_tpu_torch.models import invariants as inv_mod
    lay = st.Layout.of(bounds)
    codes, progs, start = [], [], 0
    for nm in invariants:
        if nm in inv_mod.CODES:
            codes.append(inv_mod.CODES[nm])
            continue
        prog = compile_program(inv_mod._expression(nm), lay)
        codes.append(-1 - start)
        progs.append(prog)
        start += prog.size
    prog = np.concatenate(progs) if progs else np.zeros(5, np.int32)
    return np.asarray(codes, np.int32), prog.astype(np.int32)
