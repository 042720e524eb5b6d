"""campaign/ — preemption-tolerant campaign supervision; the port's copy
of ``raft_tla_tpu/campaign/``.

A campaign outlives any single process: the :class:`Supervisor` spawns
``raft_tla_tpu_torch.check`` children it is allowed to lose, watches their
event logs for unhealth, drives the lossless-stop contract, verifies
every snapshot before resuming it (quarantining corrupt families —
never the same poison twice), and retries with bounded backoff until the
check reaches a verdict.  :mod:`~raft_tla_tpu_torch.campaign.chaos` is the
fault harness that proves it: kill, truncate — finals identical to an
uninterrupted run.  The port's mesh is one card: resharding between mesh
sizes waits for ROADMAP.md queue A item 11 (b).
"""

from raft_tla_tpu_torch.campaign.integrity import (  # noqa: F401
    CheckpointCorrupt,
    snapshot_family,
    verify_snapshot,
)
from raft_tla_tpu_torch.campaign.supervisor import (  # noqa: F401
    CampaignPolicy,
    CampaignResult,
    CampaignSpec,
    HealthMonitor,
    Supervisor,
)
