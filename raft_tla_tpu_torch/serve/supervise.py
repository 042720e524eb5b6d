"""Worker supervision primitives for the fault-isolated serve pool; the
port of ``raft_tla_tpu/serve/supervise.py``.

serve/pool.py dispatches admitted jobs to child worker processes; this
module holds the *decisions* the pool makes about those children, kept
free of process trees so every rule is unit-testable:

- :class:`PoolPolicy` — the knobs: poison-quarantine threshold K
  (``max_job_deaths``), the global respawn budget, SIGINT->SIGKILL
  grace, retry backoff, and the degradation floor for OOM chunk
  halving.
- :func:`classify_death` — map a worker's exit (returncode + captured
  stderr/stdout tail) to a death kind: ``oom`` / ``killed`` /
  ``segfault`` / ``signal`` / ``crashed``.  The kind picks the recovery
  path: OOM degrades (respawn at half dispatch width), everything else
  blames the worker's unfinished jobs and bisects toward the poison.
- :class:`WorkerHealth` — one worker's liveness view, built from the
  campaign supervisor's pieces verbatim: a
  :class:`~raft_tla_tpu_torch.obs.collect.LogTail` per assigned
  tenant event log feeding one
  :class:`~raft_tla_tpu_torch.campaign.supervisor.HealthMonitor` (heartbeat
  staleness from segment cadence, session wall budget).  The campaign
  proved these rules against checkpointed solo children; the pool
  reuses them unchanged against lane-packed workers — same verdict
  tuple, same injectable clock.
"""

from __future__ import annotations

import dataclasses
import signal
import time

from raft_tla_tpu_torch.campaign.supervisor import (CampaignPolicy,
                                                    HealthMonitor)
from raft_tla_tpu_torch.obs.collect import LogTail


@dataclasses.dataclass(frozen=True)
class PoolPolicy:
    """When to quarantine, how long to wait, how far to degrade."""

    max_job_deaths: int = 3              # K: a job blamed for K worker
    #                                      deaths (the last one solo) is
    #                                      quarantined, never re-run
    max_respawns: int = 16               # global respawn budget — the
    #                                      give-up backstop against a
    #                                      systematically failing fleet
    grace_s: float = 10.0                # preempt SIGINT -> SIGKILL
    poll_s: float = 0.05                 # supervision loop period
    stale_after_s: float | None = None   # heartbeat threshold; None =
    #                                      HealthMonitor's cadence rule
    session_wall_s: float | None = None  # per-worker-attempt wall budget
    backoff_base_s: float = 0.25         # requeue delay (decorrelated
    backoff_cap_s: float = 10.0          #   jitter, campaign/'s class)
    backoff_jitter_seed: int | None = None
    min_chunk: int = 32                  # OOM degradation floor: chunk
    #                                      halves per OOM down to this;
    #                                      an OOM *at* the floor is
    #                                      treated as a poison death

    def health_policy(self) -> CampaignPolicy:
        """The CampaignPolicy slice HealthMonitor reads (stale + wall);
        campaign-only fields stay at their defaults, unused here."""
        return CampaignPolicy(stale_after_s=self.stale_after_s,
                              session_wall_s=self.session_wall_s)


# Allocator failures surface differently per layer: Python raises
# MemoryError; torch's caching allocator raises torch.OutOfMemoryError
# ("CUDA out of memory. Tried to allocate ..."); a kernel launch or copy
# that the driver cannot back returns cudaErrorMemoryAllocation ("CUDA
# error: out of memory"); the C++ runtime throws bad_alloc; and a host
# OOM-kill leaves only SIGKILL (classified by returncode below, with the
# marker scan catching the logged cases).
_OOM_MARKERS = ("MemoryError", "OutOfMemoryError", "CUDA out of memory",
                "out of memory", "Out of memory", "std::bad_alloc",
                "cudaErrorMemoryAllocation")


def classify_death(returncode: int, out_text: str = "") -> tuple:
    """``(kind, detail)`` for a worker that exited abnormally.

    ``kind`` is one of ``oom`` (degrade: respawn at half width),
    ``killed`` (SIGKILL — external killer or the host OOM reaper),
    ``segfault``, ``signal`` (any other fatal signal), or ``crashed``
    (nonzero exit with no better evidence).  The output scan wins over
    the returncode: an uncaught MemoryError or torch.OutOfMemoryError
    exits 1, a CUDA allocation failure may abort — all are OOM for recovery
    purposes (blaming a job for the pool's own memory pressure would
    quarantine innocents).
    """
    text = out_text or ""
    if any(m in text for m in _OOM_MARKERS):
        return ("oom", "worker output shows an out-of-memory failure")
    if returncode < 0:
        sig = -returncode
        try:
            name = signal.Signals(sig).name
        except ValueError:
            name = f"signal {sig}"
        if sig == signal.SIGKILL:
            return ("killed", f"{name}: external kill or host OOM reaper")
        if sig == signal.SIGSEGV:
            return ("segfault", name)
        return ("signal", name)
    return ("crashed", f"exit code {returncode}")


class WorkerHealth:
    """Health view over one worker attempt's assigned tenant logs.

    Tails each ``OUT/<job_id>.events`` (byte-offset, torn-line-safe,
    truncation-aware — requeue rotation shrinks files under us) and
    feeds every parsed event into one HealthMonitor, so a worker is
    "alive" as long as *any* of its lanes heartbeats.  ``verdict()``
    is the campaign tuple: ``None`` or ``(reason, detail)``.
    """

    def __init__(self, policy: PoolPolicy, event_paths: list,
                 clock=time.time):
        self.monitor = HealthMonitor(policy.health_policy(), clock=clock)
        self.tails = [LogTail(p) for p in event_paths]

    def start(self, now: float) -> None:
        self.monitor.spawned_at = now

    def poll(self) -> list:
        """Drain all tails into the monitor; returns the new events."""
        events: list = []
        for tail in self.tails:
            events.extend(tail.poll())
        if events:
            self.monitor.observe(events)
        return events

    def verdict(self):
        return self.monitor.verdict()
