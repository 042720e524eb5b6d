"""Walker fleets on one card — the port of ``raft_tla_tpu/fleet/``.

``FleetSimulator`` advances a fleet of walkers with per-walker streams
folded from one root seed, coverage steering and scenario weights, one
host copy per dispatch (``engine``); ``scenario`` holds the
fault-intensity matrices and their runner.  A fleet over more than one
device is ROADMAP.md queue A item 11.
"""

from raft_tla_tpu_torch.fleet.engine import FleetResult, FleetSimulator
from raft_tla_tpu_torch.fleet.scenario import (Scenario, fault_matrix,
                                              run_matrix)

__all__ = ["FleetResult", "FleetSimulator", "Scenario", "fault_matrix",
           "run_matrix"]
