"""Result types of a check — the port of the ``EngineResult`` and
``Violation`` of ``raft_tla_tpu/engine.py``, and ``DEADLOCK`` of
``raft_tla_tpu/models/refbfs.py``."""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

DEADLOCK = "Deadlock"      # Violation.invariant sentinel (TLC -deadlock)


@dataclasses.dataclass
class Violation:
    invariant: str          # registry name, or DEADLOCK
    state: object           # models/interp.PyState
    # Trace from Init: [(action_label | None, PyState)]; replayable by interp.
    trace: list


@dataclasses.dataclass
class EngineResult:
    n_states: int          # distinct states found (incl. constraint-violating)
    diameter: int          # BFS levels past Init that produced new states
    n_transitions: int     # enabled (state, action) pairs explored
    coverage: Counter      # action family -> distinct new states produced
    violation: Optional[Violation]
    levels: list           # new-state count per level (levels[0] = 1)
    wall_s: float
    complete: bool = True  # False: stopped before exhaustion (resumable)
