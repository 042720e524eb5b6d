"""Spec-generic frontend — the port of ``raft_tla_tpu/frontend/``: bounded
TLA+ subsets compiled to the engines' step, not just Raft.

- ``schema``      — declared tensor state schemas (fields, shapes, ranges)
- ``predicate``   — the quantifier-free predicate compiler of INVARIANT
                    stanzas (numpy per state, torch batched)
- ``expr``        — the action-definition IR: guards, per-field updates,
                    bag/message ops over a schema, evaluated batched
- ``actions``     — the IR compiler: IR -> per-family kernels with the
                    ``ops/kernels.grouped_dispatch`` contract, and the
                    schema step for non-Raft specs (keys by K2 on the card)
- ``widthgen``    — width-pass transfer twins generated from the IR
- ``raft_schema`` — the Raft state schema beside its encodings
- ``raft_ir``     — Raft transcribed into the IR, bit-identical to the
                    hand-written kernels
- ``twophase``    — the second bundled spec: bounded two-phase commit, with
                    its own pure-Python oracle
- ``registry``    — ``resolve_model(spec)``: one name -> model adapter
"""

from raft_tla_tpu_torch.frontend.predicate import compile_predicate, is_expression


def resolve_model(spec: str):
    """Deferred re-export of :func:`raft_tla_tpu_torch.frontend.registry.
    resolve_model`: the registry reaches the kernel layer, which imports
    this package (``ops/predprog``), so an eager import here would cycle."""
    from raft_tla_tpu_torch.frontend.registry import resolve_model as _resolve
    return _resolve(spec)


__all__ = ["compile_predicate", "is_expression", "resolve_model"]
