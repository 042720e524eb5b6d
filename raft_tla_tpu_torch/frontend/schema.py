"""Declared tensor state schemas — the port of
``raft_tla_tpu/frontend/schema.py``.

A :class:`Schema` is the declaration a spec makes about its state: a tuple
of small-int tensor fields with symbolic shapes and value ranges.
Resolving it against a :class:`~raft_tla_tpu_torch.config.Bounds` yields a
:class:`SchemaLayout`, which duck-types ``ops/state.Layout`` (``shapes`` /
``fields`` / ``width``) and carries the generic pack/unpack between the
struct-of-arrays form the steps use and the flat ``[W]`` int32 row the
engines dedup and store.  Pack and unpack take torch tensors (the step) or
numpy arrays (the host side) with any leading batch dimensions.

:func:`envelope` hands the width analyzer an interval per field straight
from the declaration, and :func:`check_schema` is the admission-time
validity gate for non-Raft specs (shape sanity, range sanity, int32
headroom), with the reference's finding codes and texts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

I32 = np.int32

# Symbolic dimension / bound names resolve against Bounds attributes;
# the short forms mirror the letters ops/state.Layout uses.
_DIM_ALIASES = {"n": "n_servers", "L": "log_cap", "S": "msg_cap",
                "E": "elections_cap", "V": "n_values"}


def _resolve(sym, bounds) -> int:
    """An int stands for itself; a string names a Bounds attribute
    (aliases above); a callable is evaluated on bounds."""
    if isinstance(sym, int):
        return sym
    if callable(sym):
        return int(sym(bounds))
    return int(getattr(bounds, _DIM_ALIASES.get(sym, sym)))


@dataclasses.dataclass(frozen=True)
class Field:
    """One state variable: a small-int tensor with a declared shape and
    value range.

    ``shape`` entries are ints or symbolic dimension names (``"n"`` =
    ``n_servers``, ``"L"`` = ``log_cap``, ``"S"`` = ``msg_cap``); an empty
    shape is a scalar carried as one row word.  ``lo``/``hi`` declare the
    inclusive value range (``hi`` may be symbolic), and ``init`` is the
    uniform initial value.
    """
    name: str
    shape: tuple = ()
    lo: int = 0
    hi: object = 0
    init: int = 0


@dataclasses.dataclass(frozen=True)
class Schema:
    """A named tuple of fields; the unit the frontend compiles against."""
    name: str
    fields: tuple

    def __post_init__(self):
        seen = set()
        for f in self.fields:
            if f.name in seen:
                raise ValueError(
                    f"schema {self.name!r}: duplicate field {f.name!r}")
            seen.add(f.name)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"schema {self.name!r} has no field {name!r}")

    @property
    def field_names(self) -> tuple:
        return tuple(f.name for f in self.fields)

    def layout(self, bounds) -> "SchemaLayout":
        return SchemaLayout(self, bounds)


def _size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


class SchemaLayout:
    """Schema resolved against concrete bounds: a ``shapes`` dict (field ->
    concrete shape, declaration order), a ``fields`` tuple, and the flat
    row ``width``."""

    def __init__(self, schema: Schema, bounds):
        self.schema = schema
        self.bounds = bounds
        self.shapes = {f.name: tuple(_resolve(d, bounds) for d in f.shape)
                       for f in schema.fields}

    @property
    def fields(self) -> tuple:
        return tuple(self.shapes)

    @property
    def width(self) -> int:
        return sum(_size(s) for s in self.shapes.values())

    def init_struct(self) -> dict:
        """The (single) initial state as a struct of numpy arrays."""
        return {f.name: np.full(self.shapes[f.name], f.init, dtype=I32)
                for f in self.schema.fields}

    def pack(self, struct):
        """Struct of arrays -> flat int32 row(s).  Arrays may carry
        leading batch dims; trailing dims must match the declared shapes
        (a scalar takes one word)."""
        parts = []
        for name, shp in self.shapes.items():
            a = struct[name]
            lead = tuple(a.shape[:a.ndim - len(shp)])
            parts.append(a.reshape(lead + (_size(shp),)))
        if isinstance(parts[0], torch.Tensor):
            return torch.cat([p.to(torch.int32) for p in parts], dim=-1)
        return np.concatenate(parts, axis=-1).astype(I32)

    def unpack(self, vec) -> dict:
        """Flat int32 row(s) -> struct of arrays (leading batch dims kept),
        the inverse of :meth:`pack`."""
        out, off = {}, 0
        lead = tuple(vec.shape[:-1])
        for name, shp in self.shapes.items():
            k = _size(shp)
            out[name] = vec[..., off:off + k].reshape(lead + shp)
            off += k
        return out


def envelope(schema: Schema, bounds) -> dict:
    """Field -> declared value interval — the width analyzer's input for
    schema-declared specs."""
    from raft_tla_tpu_torch.analysis.intervals import Interval
    return {f.name: Interval(f.lo, _resolve(f.hi, bounds))
            for f in schema.fields}


def check_schema(schema: Schema, bounds) -> list:
    """Admission-time validity findings for a schema at these bounds (a
    list of ``analysis.report.Finding``, empty = clean): shape positivity,
    range sanity and int32 headroom, so a declared range the row words
    cannot carry is rejected before any device time."""
    from raft_tla_tpu_torch.analysis import report
    findings = []
    lay = schema.layout(bounds)
    for f in schema.fields:
        shp = lay.shapes[f.name]
        if any(d <= 0 for d in shp):
            findings.append(report.Finding(
                report.WIDTH, report.ERROR, "schema-empty-dim",
                f"field {f.name!r} resolves to shape {shp} at these "
                f"bounds", field=f.name))
        hi = _resolve(f.hi, bounds)
        if hi < f.lo:
            findings.append(report.Finding(
                report.WIDTH, report.ERROR, "schema-empty-range",
                f"field {f.name!r} declares empty range "
                f"[{f.lo}, {hi}]", field=f.name))
        if f.lo < -(1 << 31) or hi > (1 << 31) - 1:
            findings.append(report.Finding(
                report.WIDTH, report.ERROR, "schema-i32-overflow",
                f"field {f.name!r} range [{f.lo}, {hi}] exceeds the "
                f"int32 state words", field=f.name))
        if not (f.lo <= f.init <= hi):
            findings.append(report.Finding(
                report.WIDTH, report.ERROR, "schema-init-range",
                f"field {f.name!r} init {f.init} outside declared "
                f"range [{f.lo}, {hi}]", field=f.name))
    return findings
