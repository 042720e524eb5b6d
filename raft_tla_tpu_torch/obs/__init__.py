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
- ``history`` / ``regress`` — the fiducial drift policy (the campaign
  health check's), the history store and the regression sentinel CLI
  (``raft-tla-regress-torch``).
- ``metrics`` / ``openmetrics`` — the live metrics layer: streaming
  reducers over the event logs and the OpenMetrics endpoint
  (``--metrics-port``).
- ``monitor`` — the one-line heartbeat over a log or a directory of logs
  (``raft-tla-monitor-torch``).
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
