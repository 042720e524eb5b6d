"""``resolve_model(spec)`` — one spec name, one model adapter; the port of
``raft_tla_tpu/frontend/registry.py``.

The engines, admission and the CLI never hard-code a protocol; they ask the
registry for a *model adapter* and go through its uniform surface:

- ``layout(bounds)`` / ``action_table(bounds)`` / ``build_step(config,
  device)`` — the step (the same dict for every model);
- ``init_py`` / ``to_vec`` / ``from_vec`` / ``init_fingerprint`` /
  ``constraint_ok`` / ``py_invariant`` — the host half of the BFS (roots,
  trace decoding, the Init invariant probe);
- ``sim_step`` / ``sim_codec`` / ``host_apply`` — the simulation surface
  (``"simulate" in engines``): the step a walker step runs, the row width
  and codec, and the host interpreter one lane at a time for the exact
  replay of a violating walk;
- ``render_state`` / ``render_trace`` — violation reporting;
- ``check_widths(bounds)`` — the admission-time width/validity gate;
- ``resolve_check_config(cfg, opts, path)`` — cfg -> CheckConfig for
  models that own their cfg mapping (non-Raft specs).

Raft resolves to :class:`RaftModel`: K1 (``ops/pallas_step``) on a CUDA
device and the plain step on the CPU.  ``ir-full`` / ``ir-election`` /
``ir-replication`` are the same model stepped through the
``frontend/raft_ir``-compiled family kernels instead: torch ops whose rows
K2 keys on a CUDA device (the reference's XLA path), or, under SYMMETRY or
a VIEW, the orbit-key entry of K1's library (ops/orbit_key.py, K1's
dedup-key stage on given rows); the plain fingerprint or orbit key on the
CPU.  ``twophase``
resolves to the bundled two-phase-commit spec, compiled entirely from
frontend declarations.

Everything heavy imports inside methods, so module level stays light.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tla_tpu_torch.config import Bounds, CheckConfig


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but torch sees no GPU; "
                           "pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no step for device {device}")
    return device


@dataclasses.dataclass(frozen=True)
class RaftModel:
    """The built-in Raft model; ``sub`` is the Next-subset family table
    name (``full``/``election``/``replication``), ``use_ir`` swaps the
    hand-written family kernels for the IR-compiled ones."""

    name: str
    sub: str
    use_ir: bool = False
    is_raft: bool = True
    engines: tuple = ("device", "host", "ref", "simulate")

    def layout(self, bounds):
        from raft_tla_tpu_torch.ops import state as st
        return st.Layout.of(bounds)

    def action_table(self, bounds):
        from raft_tla_tpu_torch.models import spec as S
        return S.action_table(bounds, self.sub)

    def build_step(self, config: CheckConfig, device="cuda"):
        """The fused step for ``device``: K1, or with ``use_ir`` the
        IR-compiled torch step keyed by K2 (by the orbit-key kernel under
        SYMMETRY or a VIEW), on a CUDA device; the plain step (hand or IR
        kernels) on the CPU."""
        b, invs = config.bounds, tuple(config.invariants)
        device = _cuda_device(device)
        if not self.use_ir:
            from raft_tla_tpu_torch.ops import pallas_step
            return pallas_step.build_step(
                b, self.sub, invs, device, symmetry=tuple(config.symmetry),
                view=config.view)
        from raft_tla_tpu_torch.frontend import raft_ir
        from raft_tla_tpu_torch.ops import kernels, pallas_fp
        fk = raft_ir.family_kernels(b)
        if device.type == "cpu":
            return kernels.build_step(b, self.sub, invs,
                                      tuple(config.symmetry), config.view,
                                      family_kernels=fk)
        axes = tuple(config.symmetry)
        if axes or config.view:
            from raft_tla_tpu_torch.ops import orbit_key
            keyer = orbit_key.build_keyer(b, axes, config.view)
        else:
            keyer = pallas_fp.fingerprint_rows
        return kernels.build_step(b, self.sub, invs, axes, config.view,
                                  family_kernels=fk, keyer=keyer)

    def init_py(self, bounds):
        from raft_tla_tpu_torch.models import interp
        return interp.init_state(bounds)

    def to_vec(self, py, bounds):
        from raft_tla_tpu_torch.models import interp
        return interp.to_vec(py, bounds)

    def from_vec(self, vec, bounds):
        from raft_tla_tpu_torch.models import interp
        from raft_tla_tpu_torch.ops import state as st
        return interp.from_struct(st.unpack(vec, st.Layout.of(bounds)),
                                  bounds)

    def init_fingerprint(self, config, init_py, init_vec):
        from raft_tla_tpu_torch.ops import symmetry as sym_mod
        return sym_mod.init_fingerprint(config, init_py, init_vec)

    def constraint_ok(self, py, bounds) -> bool:
        from raft_tla_tpu_torch.models import interp
        return bool(interp.constraint_ok(py, bounds))

    def py_invariant(self, name):
        from raft_tla_tpu_torch.models import invariants as inv_mod
        return inv_mod.py_invariant(name)

    def render_state(self, py, bounds, indent="    "):
        from raft_tla_tpu_torch.utils import render
        return render.render_state(py, bounds, indent)

    def render_trace(self, violation, bounds):
        from raft_tla_tpu_torch.utils import render
        return render.render_trace(violation, bounds)

    def check_widths(self, bounds):
        from raft_tla_tpu_torch.analysis import widthcheck
        return widthcheck.check_widths(bounds, self.sub)

    # -- simulation surface (walker engines) --------------------------------

    def sim_step(self, config: CheckConfig, device):
        """The step a walker step runs: no symmetry and no view (a walk
        replays concrete states)."""
        return self.build_step(dataclasses.replace(
            config, symmetry=(), view=None), device)

    def sim_codec(self, bounds):
        from raft_tla_tpu_torch.ops import state as st
        lay = st.Layout.of(bounds)
        return lay.width, st.pack, lambda v: st.unpack(v, lay)

    def host_apply(self, py, inst, bounds):
        from raft_tla_tpu_torch.models import interp
        return interp.apply_action(py, inst, bounds)


class TwoPhaseModel:
    """Bounded two-phase commit, compiled from frontend declarations
    (``frontend/twophase``): schema layout, IR-built step, predicate
    invariants.  ``bounds.n_servers`` is the RM count; the other bound
    knobs are inert for this state space."""

    name = "twophase"
    sub = "twophase"
    is_raft = False
    use_ir = True
    engines = ("host", "simulate")

    def _mod(self):
        from raft_tla_tpu_torch.frontend import twophase
        return twophase

    def _predicate(self, name: str):
        from raft_tla_tpu_torch.frontend.predicate import (compile_predicate,
                                                           is_expression)
        tp = self._mod()
        text = tp.INVARIANTS.get(name)
        if text is None:
            if not is_expression(name):
                raise ValueError(
                    f"unknown twophase invariant {name!r} (known: "
                    f"{', '.join(sorted(tp.INVARIANTS))}; or write a "
                    "predicate expression over the state fields)")
            text = name
        return compile_predicate(text, fields=tp.SCHEMA.field_names)

    def layout(self, bounds):
        return self._mod().SCHEMA.layout(bounds)

    def action_table(self, bounds):
        return self._mod().action_table(bounds)

    def _step(self, config: CheckConfig, device, keys: bool):
        from raft_tla_tpu_torch.frontend import actions
        _cuda_device(device)
        tp = self._mod()
        preds = tuple(self._predicate(nm) for nm in config.invariants)
        return actions.build_schema_step(
            tp.SCHEMA, tp.ACTIONS, tp.action_table(config.bounds),
            config.bounds, predicates=preds, keys=keys)

    def build_step(self, config: CheckConfig, device="cuda"):
        """The schema step: torch ops compiled from the IR, its rows keyed
        by K2 on a CUDA device and the plain fingerprint on the CPU."""
        return self._step(config, device, keys=True)

    def init_py(self, bounds):
        return self._mod().init_state(bounds)

    def to_vec(self, py, bounds):
        return self._mod().to_vec(py, bounds)

    def from_vec(self, vec, bounds):
        return self._mod().from_vec(vec, bounds)

    def init_fingerprint(self, config, init_py, init_vec):
        # symmetry/view are rejected at config time, so this always takes
        # the plain lane-constants branch — the key the schema step gives.
        from raft_tla_tpu_torch.ops import symmetry as sym_mod
        return sym_mod.init_fingerprint(config, init_py, init_vec)

    def constraint_ok(self, py, bounds) -> bool:
        return True      # the state space is finite with no constraint

    def py_invariant(self, name):
        tp = self._mod()
        pred = self._predicate(name)

        def check(py, bounds) -> bool:
            lay = tp.SCHEMA.layout(bounds)
            struct = lay.unpack(tp.to_vec(py, bounds))
            return bool(pred.ev(struct, np))

        return check

    def render_state(self, py, bounds, indent="    "):
        return self._mod().render_state(py, bounds, indent)

    def render_trace(self, violation, bounds):
        return self._mod().render_trace(violation, bounds)

    def check_widths(self, bounds):
        from raft_tla_tpu_torch.frontend.schema import check_schema
        return check_schema(self._mod().SCHEMA, bounds)

    # -- simulation surface (walker engines) --------------------------------

    def sim_step(self, config: CheckConfig, device):
        """The schema step without keys: a walker samples one lane and
        dedups nothing."""
        return self._step(config, device, keys=False)

    def sim_codec(self, bounds):
        lay = self._mod().SCHEMA.layout(bounds)
        return lay.width, lay.pack, lay.unpack

    def host_apply(self, py, inst, bounds):
        return self._mod().apply_instance(py, inst, bounds)

    def emit_tla(self, out_dir, bounds, invariants=()):
        return self._mod().emit_tla(out_dir, bounds, invariants)

    def resolve_check_config(self, cfg, opts, path=None):
        """TLC cfg -> (CheckConfig, properties) for the twophase model —
        the non-Raft face of ``serve/jobs.resolve_check_config``."""
        tp = self._mod()
        where = path or "cfg"
        if cfg.specification not in (None, "Spec"):
            raise ValueError(
                f"{where}: twophase checks SPECIFICATION Spec only "
                f"(got {cfg.specification!r})")
        if cfg.init not in (None, "Init") or cfg.next not in (None, "Next"):
            raise ValueError(
                f"{where}: twophase supports INIT Init / NEXT Next only")
        if cfg.properties:
            raise ValueError(
                f"{where}: temporal properties are not supported for "
                "twophase")
        if cfg.constraints:
            raise ValueError(
                f"{where}: twophase is finite; CONSTRAINT is not supported")
        if cfg.symmetry or opts.symmetry:
            raise ValueError("symmetry reduction is not supported for "
                             "twophase")
        if cfg.view or opts.view:
            raise ValueError("views are not supported for twophase")
        if opts.faithful:
            raise ValueError("faithful mode (history variables) is "
                             "Raft-specific")
        rms = cfg.constants.get("RM", cfg.constants.get("Server"))
        if not isinstance(rms, list) or not rms:
            raise ValueError(
                f"{where}: twophase needs CONSTANT RM = {{r1, ...}} "
                "(a nonempty finite set)")
        invariants = tuple(cfg.invariants) or (tp.DEFAULT_INVARIANT,)
        for nm in invariants:        # parse/validate now, fail loudly here
            self._predicate(nm)
        bounds = Bounds(n_servers=len(rms), n_values=1)
        config = CheckConfig(
            bounds=bounds, spec="twophase", invariants=invariants,
            symmetry=(), chunk=opts.chunk, check_deadlock=opts.deadlock,
            view=None)
        return config, ()


_RAFT_SUBS = ("full", "election", "replication")


def known_specs() -> tuple:
    return _RAFT_SUBS + tuple(f"ir-{s}" for s in _RAFT_SUBS) + (
        "raft", "twophase")


def is_raft_spec(spec: str) -> bool:
    """A Raft spec name (hand or IR, or the ``raft`` alias)."""
    return spec in _RAFT_SUBS or spec == "raft" or (
        spec.startswith("ir-") and spec[3:] in _RAFT_SUBS)


def resolve_model(spec: str):
    """Spec name -> model adapter.  Unknown names raise with a
    did-you-mean, mirroring the cfg-name diagnostics."""
    if spec in _RAFT_SUBS:
        return RaftModel(spec, spec)
    if spec == "raft":
        return RaftModel("raft", "full")
    if spec.startswith("ir-") and spec[3:] in _RAFT_SUBS:
        return RaftModel(spec, spec[3:], use_ir=True)
    if spec == "twophase":
        return TwoPhaseModel()
    from raft_tla_tpu_torch.utils import cfgparse
    hints = cfgparse.suggest(spec, known_specs())
    hint_txt = f" (did you mean: {', '.join(hints)}?)" if hints else ""
    raise ValueError(
        f"unknown spec {spec!r}{hint_txt}; known: "
        f"{', '.join(sorted(known_specs()))}")
