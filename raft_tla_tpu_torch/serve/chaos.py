"""Chaos harness for the serve worker pool (serve/pool.py); the port of
``raft_tla_tpu/serve/chaos.py``.

The pool's acceptance bar is byte-equivalence under faults: SIGKILL a
worker mid-dispatch, poison one job so it kills every host it rides,
tear the results tail — and every *non-poison* job's final results
record and tenant event log must still be identical (modulo wall-clock
fields) to an unsupervised in-process :func:`run_service` pass over the
same jobs.  This module provides:

- :class:`PoolChaos` — a ``spawn_hook`` fault injector.  Two fault
  schedules, composable: ``kill_after_events=N`` SIGKILLs the first
  spawned worker once its tenants' event logs have shown N ``segment``
  events (a mid-dispatch hard loss); ``poison=JOB_ID`` stalks every
  worker assigned that job and SIGKILLs it as soon as the poison job's
  event log first shows life (a job that reliably kills its host —
  the pool must bisect to it and quarantine it in <= K deaths).
- :func:`canon_record` / :func:`canon_events` — canonical forms for
  the byte-equivalence comparison: volatile fields (timings, rates,
  pids, paths, timestamps) are stripped; everything that describes the
  *model-checking result* (counts, levels, verdicts, outcomes) is
  kept verbatim.
- a CLI (``python -m raft_tla_tpu_torch.serve.chaos CFG --workdir DIR``)
  that runs the solo reference, then the pool under a scheduled
  worker kill, and verifies the equivalence end to end (on the card
  unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from raft_tla_tpu_torch.obs.collect import LogTail


class PoolChaos:
    """Fault injector riding :func:`run_pool`'s ``spawn_hook``.

    Each scheduled fault runs as a stalker thread that tails the
    victim worker's tenant event logs (the same ``LogTail`` the
    supervisor uses) and delivers SIGKILL when its trigger condition
    is met — so kills land *mid-run*, anchored to observed progress,
    not at a wall-clock guess.  ``kills`` records ``(worker_id,
    trigger)`` pairs for assertions.
    """

    def __init__(self, kill_after_events: int | None = None,
                 poison: str | None = None,
                 max_kills: int | None = None, poll_s: float = 0.02):
        self.kill_after_events = kill_after_events
        self.poison = poison
        self.max_kills = max_kills
        self.poll_s = poll_s
        self.kills: list = []
        self._first_armed = False
        self._lock = threading.Lock()

    def spawn_hook(self, worker) -> None:
        jobs = [pj.job_id for pj in worker.group.pending_jobs()]
        if self.poison is not None and self.poison in jobs:
            with self._lock:
                if self.max_kills is not None \
                        and len(self.kills) >= self.max_kills:
                    return
            path = [t.path for t in worker.health.tails
                    if t.path.endswith(f"{os.sep}{self.poison}.events")]
            self._stalk(worker, path or
                        [t.path for t in worker.health.tails],
                        need=1, events=None, trigger="poison")
            return
        if self.kill_after_events is not None and not self._first_armed:
            self._first_armed = True
            self._stalk(worker, [t.path for t in worker.health.tails],
                        need=self.kill_after_events,
                        events=("segment",), trigger="kill-after-events")

    def _stalk(self, worker, paths: list, need: int, events,
               trigger: str) -> None:
        def run() -> None:
            tails = [LogTail(p) for p in paths]
            seen = 0
            while worker.proc.poll() is None:
                for t in tails:
                    for e in t.poll():
                        if events is None or e.get("event") in events:
                            seen += 1
                if seen >= need:
                    with self._lock:
                        self.kills.append((worker.wid, trigger))
                    try:
                        worker.proc.kill()
                    except OSError:
                        pass
                    return
                time.sleep(self.poll_s)

        threading.Thread(target=run, daemon=True,
                         name=f"chaos-{trigger}-{worker.wid}").start()


# --------------------------------------------------------------------------
# canonical forms for byte-equivalence

# Result-record fields that legitimately differ between two runs of the
# same job: timings, rates, and the artifact path.
_VOLATILE_RECORD = frozenset({"admission_s", "wall_s", "states_per_sec",
                              "events"})

# Per event type, the fields that describe the checking RESULT — kept
# for comparison; everything else (ts, v, pid, wall_s, rates, phase
# timings, scheduler attribution like bin/inflight/chunk) is volatile.
_EVENT_KEEP = {
    "run_start": ("event", "engine", "universe", "spec", "invariants",
                  "resumed", "bounds", "symmetry", "view"),
    "segment": ("event", "n_states", "level", "n_transitions",
                "dedup_hit_rate", "since_resume"),
    "level_end": ("event", "level", "n_states"),
    "violation": ("event", "invariant", "kind"),
    "stop_requested": ("event", "reason", "source"),
    "run_end": ("event", "n_states", "n_transitions", "complete",
                "outcome", "diameter", "levels"),
}


def canon_record(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in _VOLATILE_RECORD}


def canon_events(path: str) -> list:
    """The stable projection of a tenant event log: same BFS, same
    chunk => identical list, whether the run was solo or survived a
    pool worker kill and a lossless re-run."""
    out = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().split("\n")
    except OSError:
        return out
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            e = json.loads(line)
        except ValueError:
            continue                     # torn tail
        keep = _EVENT_KEEP.get(e.get("event"))
        if keep:
            out.append({k: e[k] for k in keep if k in e})
    return out


def last_records(out_dir: str) -> dict:
    """Last results.jsonl record per job id (a requeued job's drained
    record is superseded by its re-run's)."""
    from raft_tla_tpu_torch.serve.service import read_results

    last: dict = {}
    for r in read_results(out_dir):
        last[r.get("job_id")] = r
    return last


# --------------------------------------------------------------------------
# CLI smoke: solo reference vs pool-under-fire


def _toy_jobs(cfg_path: str, n: int, max_msgs: int) -> list:
    """n election-subset jobs over one cfg, alternating symmetry so the
    batch spans two step-signature bins (two worker groups)."""
    from raft_tla_tpu_torch.serve.jobs import CheckJob, JobOptions

    return [CheckJob(f"j{i}",
                     JobOptions(spec="election", max_term=2, max_log=0,
                                max_msgs=max_msgs, symmetry=bool(i % 2)),
                     cfg_path=cfg_path)
            for i in range(n)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raft_tla_tpu_torch.serve.chaos",
        description="Serve-pool chaos smoke: run N toy jobs solo "
                    "(reference), then through the supervised worker "
                    "pool with a scheduled mid-dispatch worker SIGKILL, "
                    "and verify every job's final results record and "
                    "event log are identical to the reference.")
    p.add_argument("cfg", help="toy cfg path (election subset)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--max-msgs", type=int, default=1)
    p.add_argument("--kill-after-segments", type=int, default=2,
                   metavar="N",
                   help="SIGKILL the first worker after N segment "
                        "events across its lanes (default 2)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the steps run (default: cuda)")
    p.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.cpu:
        p.error("--cpu is spelled --device cpu in raft_tla_tpu_torch")

    from raft_tla_tpu_torch.serve.pool import run_pool
    from raft_tla_tpu_torch.serve.service import run_service
    from raft_tla_tpu_torch.serve.supervise import PoolPolicy

    ref_dir = os.path.join(args.workdir, "ref")
    pool_dir = os.path.join(args.workdir, "pool-out")
    jobs = _toy_jobs(args.cfg, args.jobs, args.max_msgs)

    ref_recs = run_service(jobs, ref_dir, chunk=args.chunk,
                           quiet=args.quiet, device=args.device)
    chaos = PoolChaos(kill_after_events=args.kill_after_segments)
    run_pool(jobs, pool_dir, workers=args.workers, chunk=args.chunk,
             quiet=args.quiet, device=args.device,
             policy=PoolPolicy(backoff_base_s=0.05, backoff_cap_s=0.2,
                               backoff_jitter_seed=1),
             spawn_hook=chaos.spawn_hook)

    if not chaos.kills:
        print("serve-chaos: FAIL — scheduled worker kill never fired",
              file=sys.stderr)
        return 1
    ref_by = {r["job_id"]: r for r in ref_recs}
    pool_by = last_records(pool_dir)
    bad = []
    for job in jobs:
        jid = job.job_id
        a, b = ref_by.get(jid), pool_by.get(jid)
        if a is None or b is None or b.get("status") != "completed":
            bad.append(f"{jid}: missing/uncompleted pool record "
                       f"({None if b is None else b.get('status')})")
            continue
        if canon_record(a) != canon_record(b):
            bad.append(f"{jid}: results record diverged")
        ev_a = canon_events(os.path.join(ref_dir, f"{jid}.events"))
        ev_b = canon_events(os.path.join(pool_dir, f"{jid}.events"))
        if ev_a != ev_b:
            bad.append(f"{jid}: event log diverged "
                       f"({len(ev_a)} vs {len(ev_b)} canonical events)")
    if bad:
        print("serve-chaos: FAIL\n  " + "\n  ".join(bad),
              file=sys.stderr)
        return 1
    print(f"serve-chaos: OK — {len(jobs)} job(s) byte-identical to the "
          f"solo reference through {len(chaos.kills)} worker "
          f"SIGKILL(s) ({', '.join(w for w, _ in chaos.kills)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
