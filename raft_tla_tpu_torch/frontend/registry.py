"""``resolve_model(spec)`` — one spec name, one model adapter; the port of
``raft_tla_tpu/frontend/registry.py``, cut to Raft.

The walker engines (``simulate.py``, ``fleet/``) never hard-code a
protocol; they ask the registry for a *model adapter* and go through its
simulation surface:

- ``sim_codec`` / ``init_py`` / ``to_vec`` / ``py_invariant`` — the packed
  row's width, the initial state and its row, the host invariant probe of
  Init;
- ``sim_step(config, device)`` — the fused step a walker step runs: K1
  (``ops/pallas_step.build_step``) on a CUDA device, the plain torch step
  on the CPU, with no symmetry and no view (a walk replays concrete
  states);
- ``action_table`` / ``host_apply`` — the lanes, and the host interpreter
  one lane at a time, for the exact replay of a violating walk;
  ``render_trace`` for the report.

Raft resolves to :class:`RaftModel` for the three Next subsets, the only
specs ``CheckConfig`` accepts; the IR-compiled Raft specs and the
two-phase-commit spec are ROADMAP.md queue A item 10.
"""

from __future__ import annotations

import dataclasses

from raft_tla_tpu_torch.config import CheckConfig


@dataclasses.dataclass(frozen=True)
class RaftModel:
    """The built-in Raft model; ``sub`` is the Next-subset family table
    name (``full``/``election``/``replication``)."""

    sub: str

    def action_table(self, bounds):
        from raft_tla_tpu_torch.models import spec as S
        return S.action_table(bounds, self.sub)

    def init_py(self, bounds):
        from raft_tla_tpu_torch.models import interp
        return interp.init_state(bounds)

    def to_vec(self, py, bounds):
        from raft_tla_tpu_torch.models import interp
        return interp.to_vec(py, bounds)

    def py_invariant(self, name):
        from raft_tla_tpu_torch.models import invariants as inv_mod
        return inv_mod.py_invariant(name)

    def render_trace(self, violation, bounds):
        from raft_tla_tpu_torch.utils import render
        return render.render_trace(violation, bounds)

    # -- simulation surface (walker engines) --------------------------------

    def sim_step(self, config: CheckConfig, device):
        from raft_tla_tpu_torch.ops import pallas_step
        return pallas_step.build_step(config.bounds, self.sub,
                                      tuple(config.invariants), device)

    def sim_codec(self, bounds):
        from raft_tla_tpu_torch.ops import state as st
        lay = st.Layout.of(bounds)
        return lay.width, st.pack, lambda v: st.unpack(v, lay)

    def host_apply(self, py, inst, bounds):
        from raft_tla_tpu_torch.models import interp
        return interp.apply_action(py, inst, bounds)


_RAFT_SUBS = ("full", "election", "replication")


def resolve_model(spec: str) -> RaftModel:
    """Spec name -> model adapter."""
    if spec not in _RAFT_SUBS:
        raise ValueError(f"unknown spec {spec!r}; known: "
                         f"{', '.join(sorted(_RAFT_SUBS))}")
    return RaftModel(spec)
