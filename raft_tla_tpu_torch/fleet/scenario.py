"""Scenario matrices: fault-intensity sweeps over one walker fleet; the
port's copy of ``raft_tla_tpu/fleet/scenario.py`` (pure Python).

A scenario is a named vector of action-family sampling weights.  For
Raft the interesting axis is fault intensity — how often the fleet
injects Restart / DuplicateMessage / DropMessage relative to protocol
progress — and :func:`fault_matrix` builds that sweep.  Weights are
sampling policy only: enabledness (and therefore the reachable state
space and deadlock detection) is untouched, and recorded lanes replay
exactly regardless of how they were sampled.

:func:`run_matrix` reuses ONE :class:`~raft_tla_tpu_torch.fleet.
engine.FleetSimulator` across all scenarios (weights are a per-run
input, so the fused step is built once).
"""

from __future__ import annotations

import dataclasses


# Raft's fault-action families (models/spec); plain strings so the
# module imports nothing heavy.
RESTART = "Restart"
DUPLICATE = "DuplicateMessage"
DROP = "DropMessage"
FAULT_FAMILIES = (RESTART, DUPLICATE, DROP)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the matrix: a display name plus family->weight."""

    name: str
    fault_weights: dict

    def describe(self) -> str:
        if not self.fault_weights:
            return f"{self.name}: uniform"
        ws = ", ".join(f"{k}={v:g}"
                       for k, v in sorted(self.fault_weights.items()))
        return f"{self.name}: {ws}"


def fault_matrix(intensities=(0.0, 0.5, 2.0),
                 families=FAULT_FAMILIES) -> list:
    """The standard sweep: uniform baseline plus one scenario per fault
    intensity (all fault families scaled together).  ``0.0`` is the
    fault-free arm — fault lanes are never sampled (but still count as
    enabled, so no false deadlocks)."""
    out = [Scenario("uniform", {})]
    for w in intensities:
        if w == 1.0:
            continue         # identical to uniform
        out.append(Scenario(f"faults-x{w:g}", {f: float(w)
                                               for f in families}))
    return out


def run_matrix(sim, scenarios, n_behaviors: int, **run_kw) -> list:
    """Run every scenario on one fleet; returns ``[(scenario, result)]``
    in input order.  The simulator's (seed, walkers, depth) stay fixed
    across cells, so two cells differ only by sampling policy."""
    out = []
    for sc in scenarios:
        res = sim.run(n_behaviors, fault_weights=sc.fault_weights,
                      **run_kw)
        out.append((sc, res))
    return out
