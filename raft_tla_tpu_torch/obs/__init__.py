"""obs/ — run-event telemetry for the port's device and DDD engines; the
port's copy of ``raft_tla_tpu/obs/``.

- ``events``  — the versioned JSONL run-event log (``run_start`` /
  ``segment`` / ``level_end`` / ``checkpoint`` / ``violation`` /
  ``stop_requested`` / ``run_end``), the shared ``ProgressRecord``
  payload and the ``RunTelemetry`` facade the engines drive.
- ``phases``  — device-sync-aware phase timers (off by default so the
  engines' asynchronous pipelining is untouched).
- ``trace`` / ``collect`` / ``perfetto`` / ``tracecli`` — schema-v8
  spans, the merged timeline, its Chrome trace export and the wall
  attribution report.
- ``history`` — the fiducial drift policy the campaign health check
  uses.

The reference's ``monitor``, ``metrics``, ``openmetrics`` and ``regress``
are not ported yet (ROADMAP.md queue A item 12).
"""

from raft_tla_tpu_torch.obs.events import (  # noqa: F401
    SCHEMA_VERSION,
    EventLog,
    ProgressRecord,
    ProgressTracker,
    RunTelemetry,
    append_event,
    validate_event,
)
from raft_tla_tpu_torch.obs.phases import PhaseTimers  # noqa: F401
