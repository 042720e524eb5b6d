"""Multi-tenant check service on the card — the port of
``raft_tla_tpu/serve/``.

One process, many bounded check jobs, their device dispatches amortized
across tenants:

- :mod:`raft_tla_tpu_torch.serve.jobs` — the :class:`CheckJob` spec (cfg
  text + bounds + invariants + engine options), the shared cfg ->
  CheckConfig builder ``resolve_check_config`` and speclint-gated
  :func:`admit` (width-unsafe or vacuous configs are rejected with the
  lint findings as the error payload, before any device time is spent).
- :mod:`raft_tla_tpu_torch.serve.batch` — the lane-packed batch executor:
  admitted jobs are binned by step signature and lane-tagged into shared
  step launches (K1 for a Raft bin, the schema step keyed by K2 for a
  twophase bin), so one launch advances N independent BFS frontiers,
  with per-lane completion, per-lane invariant verdicts and lane
  backfill as jobs finish (continuous batching).  Each completing lane's
  counts equal a solo ``engine.Engine`` run of the same cfg.
- :mod:`raft_tla_tpu_torch.serve.sched` — the pipelined dispatch
  scheduler: ``depth`` tickets in flight, FIFO harvest, pinned staging,
  bin builds on background threads, deficit-round-robin packing.
- :mod:`raft_tla_tpu_torch.serve.service` — the front:
  ``raft-tla-serve-torch`` / ``python -m raft_tla_tpu_torch.serve``
  consumes a JSONL job manifest or a job-queue directory and emits one
  obs/ event log per job plus ``results.jsonl``.
- :mod:`raft_tla_tpu_torch.serve.pool` +
  :mod:`raft_tla_tpu_torch.serve.supervise` — fault-isolated serving
  (``--workers N``): supervised worker processes, death classification,
  poison-job bisection and quarantine, OOM chunk halving and bounded
  respawns.  :mod:`raft_tla_tpu_torch.serve.chaos` is the fault-injection
  harness holding the pool's artifacts to an unsupervised pass.
"""

from raft_tla_tpu_torch.serve.jobs import (Admission, CheckJob, JobOptions,
                                           admit, resolve_check_config)

__all__ = ["Admission", "CheckJob", "JobOptions", "admit",
           "resolve_check_config"]
