"""The service front — ``raft-tla-serve-torch`` / ``python -m
raft_tla_tpu_torch.serve``; the port of ``raft_tla_tpu/serve/service.py``.

One-pass multi-tenant driver: read a job source (JSONL manifest or a
queue directory of per-job JSON files), admit every job through the
speclint gate (``jobs.admit``), run all admitted jobs through the
lane-packed :class:`~raft_tla_tpu_torch.serve.batch.BatchExecutor` on the
card (``--device cpu`` asks for the CPU), and leave behind per-tenant
artifacts:

- ``OUT/<job_id>.events`` — one obs/ versioned event log per job,
  so ``raft-tla-monitor-torch OUT/<job_id>.events`` renders any tenant's run
  unchanged.  Rejected jobs get a three-event log (``run_start``,
  ``stop_requested`` with the admission reason, ``run_end`` outcome
  ``rejected``) so end-state attribution is uniform: a tenant's log
  always says completed / rejected-at-admission / stopped.
- ``OUT/results.jsonl`` — one record per job with the job's content
  digest (:meth:`CheckJob.digest` — cfg text + options), verdict, counts
  and findings.  The digest is the tenant-isolation tag: two jobs'
  outputs can never be conflated, and a client can verify the result it
  reads answers the exact model it submitted.

Exit code: 0 when every admitted job reached a verdict (including
violation/deadlock verdicts — finding a counterexample is the service
working); 1 when any lane was stopped by a runtime failure or the job
source itself was unreadable.  Admission rejects do not fail the
service — they are per-tenant client errors, reported in the results.
A bin whose kernel build fails stops its lanes with the build's error in
their records, so the service exits 1; nothing falls back to another
step or to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time


_JOB_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def load_jobs(source: str, skipped: list | None = None,
              only: list | None = None) -> list:
    """Read :class:`CheckJob` entries from a JSONL manifest file or a
    queue directory of ``*.json`` job files (sorted name order — the
    queue convention: producers write ``NNN-name.json``).  ``only``
    restricts a queue-dir scan to the named files (the daemon's
    incremental intake; an empty restricted scan is then not an error).

    Queue-dir intake is race-tolerant: a producer writing a job file the
    moment the service scans the directory must not poison the whole
    pass, so a file that fails to read or parse gets one short-delay
    retry and is then SKIPPED (recorded as ``(name, error)`` in the
    optional ``skipped`` list) while the rest of the queue proceeds.
    Manifest files stay strict — a manifest is one artifact written by
    one producer, so a bad line is a bad manifest.

    Job ids must be path-safe (``[A-Za-z0-9._-]``, no leading dot) since
    they name the per-tenant event logs; duplicates are a hard error —
    two tenants sharing a log would be the conflation the digests exist
    to prevent.
    """
    from raft_tla_tpu_torch.serve.jobs import CheckJob

    entries: list[tuple[str | None, dict]] = []
    if os.path.isdir(source):
        names = sorted(n for n in os.listdir(source) if n.endswith(".json"))
        if only is not None:
            names = [n for n in names if n in set(only)]
            if not names:
                return []
        elif not names:
            raise ValueError(f"queue directory {source!r} has no *.json jobs")
        for n in names:
            path = os.path.join(source, n)
            d = None
            for attempt in (0, 1):
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        d = json.load(f)
                    break
                except (OSError, ValueError) as e:
                    if attempt:             # second failure: skip, not fail
                        if skipped is not None:
                            skipped.append((n, str(e)))
                    else:
                        time.sleep(0.05)    # writer may be mid-write
            if d is not None:
                entries.append((n[:-len(".json")], d))
        if not entries:
            raise ValueError(
                f"queue directory {source!r}: all {len(names)} job "
                "file(s) unreadable")
    else:
        with open(source, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    d = json.loads(line)
                except ValueError as e:
                    raise ValueError(
                        f"{source}:{lineno}: not JSON: {e}") from e
                entries.append((None, d))

    # Relative cfg paths resolve against the job source's own directory —
    # a manifest is self-contained wherever the service runs from.
    base = source if os.path.isdir(source) else os.path.dirname(source)
    jobs, seen = [], set()
    for default_id, d in entries:
        if d.get("cfg") and not os.path.isabs(d["cfg"]):
            d = dict(d, cfg=os.path.join(base, d["cfg"]))
        job = CheckJob.from_dict(d, job_id=default_id)
        if not _JOB_ID_RE.match(job.job_id):
            raise ValueError(
                f"job id {job.job_id!r} is not path-safe "
                "([A-Za-z0-9._-], no leading punctuation, <= 64 chars)")
        if job.job_id in seen:
            raise ValueError(f"duplicate job id {job.job_id!r}")
        seen.add(job.job_id)
        jobs.append(job)
    return jobs


def _events_path(out_dir: str, job_id: str) -> str:
    return os.path.join(out_dir, f"{job_id}.events")


def _reject_events(path: str, job, reason: str) -> None:
    """The rejected-tenant event log: same schema, same monitor, explicit
    attribution — a log is never silent about why a run has no states."""
    from raft_tla_tpu_torch.obs import append_event

    append_event(path, "run_start", engine="serve", universe={}, spec="",
                 invariants=[], resumed=False, pid=os.getpid())
    append_event(path, "stop_requested",
                 reason=f"rejected-at-admission: {reason}",
                 source="admission", pid=os.getpid())
    # One zero segment so the monitor's heartbeat (which needs a segment
    # timeline) renders the rejection attribution instead of "no data".
    append_event(path, "segment", wall_s=0.0, n_states=0, level=0,
                 n_transitions=0, dedup_hit_rate=0.0, states_per_sec=0.0,
                 inc_states_per_sec=0.0, since_resume=True)
    append_event(path, "run_end", n_states=0, n_transitions=0,
                 complete=False, outcome="rejected")


def run_service(jobs, out_dir: str, chunk: int = 1024,
                max_states: int | None = None, quiet: bool = False,
                depth: int = 2, compile_async: bool = True,
                stop=None, device="cuda", stats: dict | None = None) -> list:
    """Admit + execute + record: returns the results.jsonl records.

    Split from the CLI so tests (and later fronts — a socket server, an
    elastic-fleet supervisor) drive the same path with in-memory jobs.
    ``depth``/``compile_async`` configure the async dispatch scheduler
    (serve/sched.py; depth 1 + sync compile = the PR 6 synchronous
    executor); ``stop`` is a zero-arg callable the executor polls at
    dispatch boundaries — the daemon's SIGINT drain hook: when it turns
    truthy, in-flight dispatches are harvested and every unfinished lane
    gets an attributed "stop requested (drain)" record.  ``device`` is
    where the steps run (``cuda`` raises without a GPU); ``stats``, when
    given, receives the scheduler's stats (dispatches, peak in flight,
    builds and per-bin step time).
    """
    from raft_tla_tpu_torch.obs import RunTelemetry
    from raft_tla_tpu_torch.frontend.registry import _cuda_device
    from raft_tla_tpu_torch.serve.batch import BatchExecutor
    from raft_tla_tpu_torch.serve.jobs import admit

    device = _cuda_device(device)
    os.makedirs(out_dir, exist_ok=True)

    def say(msg: str) -> None:
        if not quiet:
            print(msg, flush=True)

    # Admission first, for the whole intake — host-only, so a manifest
    # full of junk costs zero device time and the rejects are reported
    # before the first compile.
    records: list[dict] = []
    admitted = []
    for job in jobs:
        t_adm = time.monotonic()
        adm = admit(job)
        try:
            digest = job.digest()
        except (OSError, ValueError):
            digest = None               # unreadable cfg: admission rejects
        rec = {"job_id": job.job_id, "digest": digest,
               "admission_s": round(time.monotonic() - t_adm, 3),
               "events": _events_path(out_dir, job.job_id)}
        if not adm.admitted:
            rec.update(status="rejected", reason=adm.reason,
                       findings=adm.findings_text())
            _reject_events(rec["events"], job, adm.reason)
            say(f"[{job.job_id}] rejected at admission ({adm.reason}); "
                f"{len(adm.findings)} finding(s)")
            records.append(rec)
            continue
        if adm.properties:
            rec.update(status="rejected", reason="property-unsupported",
                       findings=[f"PROPERTY {list(adm.properties)}: "
                                 "liveness needs a dedicated exhaustive "
                                 "run (raft-tla-check-torch --property); the "
                                 "batched service checks invariants only"])
            _reject_events(rec["events"], job, "property-unsupported")
            say(f"[{job.job_id}] rejected at admission "
                "(property-unsupported)")
            records.append(rec)
            continue
        admitted.append((job, adm, rec))
        records.append(rec)

    # One telemetry facade per tenant, each with its own explicit events
    # path (never the RAFT_TLA_EVENTS fallback — that one env var would
    # merge every lane into a single log).
    telemetry = {}
    for job, adm, rec in admitted:
        telemetry[job.job_id] = RunTelemetry(
            "serve", config=adm.config, events=rec["events"])

    outcomes = {}
    if admitted:
        say(f"serving {len(admitted)} admitted job(s) "
            f"({len(jobs) - len(admitted)} rejected) — chunk {chunk}, "
            f"pipeline depth {depth}")
        # Scheduler-level spans (dispatch/harvest/compile/ticket) are
        # cross-lane, so they get their own per-process log — pid-keyed
        # because pool workers share one out_dir.  The collector merges
        # it with the tenant logs of the same pid into one track set.
        from raft_tla_tpu_torch.obs import EventLog
        from raft_tla_tpu_torch.obs.trace import (SpanTracer, clock_anchor,
                                            host_context, trace_enabled)
        tracer = None
        sched_log = None
        if trace_enabled():
            sched_log = EventLog(os.path.join(
                out_dir, f"sched-{os.getpid()}.events"))
            sched_log.emit("run_start", engine="sched", universe={},
                           spec="", invariants=[], resumed=False,
                           pid=os.getpid(), anchor=clock_anchor(),
                           host=host_context())
            tracer = SpanTracer(sched_log.emit)
        ex = BatchExecutor(chunk=chunk, max_states=max_states,
                           depth=depth, compile_async=compile_async,
                           stop=stop, tracer=tracer, device=device)
        budgets = {job.job_id: job.options.wall_s
                   for job, adm, rec in admitted
                   if job.options.wall_s is not None}
        try:
            outcomes = ex.run([(job.job_id, adm.config)
                               for job, adm, rec in admitted],
                              telemetry=telemetry, budgets=budgets)
        finally:
            if sched_log is not None:
                sched_log.close()
        if stats is not None and ex.last_stats is not None:
            stats.update(ex.last_stats)

    for job, adm, rec in admitted:
        oc = outcomes[job.job_id]
        rec["status"] = oc.status
        if oc.error:
            rec["error"] = oc.error
        if adm.findings:                 # admitted-with-warnings
            rec["findings"] = adm.findings_text()
        if oc.result is not None:
            r = oc.result
            rec.update(n_states=r.n_states, diameter=r.diameter,
                       n_transitions=r.n_transitions,
                       levels=list(r.levels),
                       complete=bool(r.complete),
                       wall_s=round(r.wall_s, 3),
                       states_per_sec=round(r.states_per_sec, 1),
                       # the run's final duplicate rate — same formula
                       # as the segment stream's dedup_hit_rate
                       # (obs ProgressTracker.record), so result records
                       # stop under-reporting it as absent/0.0
                       dedup_hit_rate=round(
                           1.0 - r.n_states / max(1, r.n_transitions),
                           4))
            if r.violation is not None:
                rec["violation"] = r.violation.invariant
        say(f"[{job.job_id}] {rec['status']}: "
            f"{rec.get('n_states', 0):,} states, "
            f"diameter {rec.get('diameter', 0)}, "
            f"{rec.get('wall_s', 0.0):.2f}s")

    _append_records(out_dir, records)
    return records


def _append_records(out_dir: str, records: list) -> None:
    """Crash-safe results append: every record is ONE whole-line write,
    flushed (and fsynced) before the next — a worker SIGKILLed between
    records can tear at most the final line, never interleave two
    records, and O_APPEND keeps concurrent pool workers' lines whole.
    The torn-tail case is the reader's to forgive (:func:`read_results`),
    exactly the queue-dir intake contract."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.jsonl"), "a",
              encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())


def read_results(out_dir: str) -> list:
    """Read ``OUT/results.jsonl`` tolerating a torn tail: a crash (or
    SIGKILLed pool worker) mid-append leaves at most one partial final
    line, which is dropped — same forgiveness the queue-dir intake
    extends to producers caught mid-write.  A non-JSON line anywhere
    else is skipped too (the stream is append-only; one bad line must
    not hide the records around it).  Missing file = no records."""
    path = os.path.join(out_dir, "results.jsonl")
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().split("\n")
    except OSError:
        return []
    records = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            d = json.loads(line)
        except ValueError:
            continue                     # torn/garbled line
        if isinstance(d, dict) and "job_id" in d:
            records.append(d)
    return records


# Statuses that settle a job for good: re-running the same digest can
# only reproduce them (BFS is deterministic), so a daemon restart or a
# pool requeue never re-runs these — the seed of the digest-keyed result
# cache (ROADMAP item 7).  A plain drained "stopped" is NOT terminal
# (the stop was the service's, not the job's); a budget/cap stop IS (the
# same budget would stop the re-run at the same place).
def record_is_terminal(rec: dict) -> bool:
    status = rec.get("status")
    if status in ("completed", "violation", "deadlock", "rejected",
                  "quarantined"):
        return True
    if status == "stopped":
        err = rec.get("error") or ""
        return err.startswith("budget-exceeded") \
            or err.startswith("state count exceeded")
    return False


def run_daemon(source: str, out_dir: str, chunk: int = 1024,
               max_states: int | None = None, quiet: bool = False,
               depth: int = 2, poll_s: float = 2.0,
               max_idle_polls: int | None = None, workers: int = 0,
               device="cuda") -> int:
    """The long-running front: ``raft-tla-serve-torch QUEUE_DIR --watch``.

    Continuous intake atop the one-pass queue-dir code path: every poll
    picks up job files not yet processed and runs them as one executor
    batch (so cross-bin interleaving spans the whole arrival burst).
    Each job file is parsed in isolation — a malformed file is retried
    across a few polls (a producer may be mid-write) and then recorded
    as a rejected result instead of poisoning the loop; a job id already
    served this daemon's lifetime is rejected as ``duplicate-id``
    *without* touching the original tenant's event log (conflation is
    the thing the digests exist to prevent).

    Restart dedup (the result cache's seed): at startup the daemon reads
    the existing ``results.jsonl`` (torn-tail tolerant) and any intake
    whose content digest already has a *terminal* record is skipped, not
    re-run — a restarted daemon never re-bills device time for work it
    already finished.  ``workers > 0`` routes every batch through the
    fault-isolated worker pool (:func:`raft_tla_tpu_torch.serve.pool.run_pool`)
    instead of executing in-process.  ``device`` is where the steps run.

    Stop contract (the campaign supervisor's, reused): the FIRST SIGINT
    stops intake and drains — the executor finishes in-flight dispatches
    and every unfinished lane gets an attributed "stop requested (drain)"
    results.jsonl record, so nothing the daemon accepted ever exits
    silently.  A SECOND SIGINT aborts raw.  ``max_idle_polls`` bounds
    the idle loop for smoke tests (None = run until signalled).
    """
    import signal
    import threading

    if not os.path.isdir(source):
        print(f"Error: --watch needs a queue directory, got {source!r}",
              file=sys.stderr)
        return 1

    def say(msg: str) -> None:
        if not quiet:
            print(msg, flush=True)

    stop = threading.Event()
    prev = signal.getsignal(signal.SIGINT)

    def handler(_signum, _frame):
        if stop.is_set():
            signal.signal(signal.SIGINT, prev)
            raise KeyboardInterrupt
        stop.set()
        print("SIGINT: draining — in-flight lanes get attributed "
              "records (SIGINT again aborts raw)", file=sys.stderr,
              flush=True)

    main_thread = threading.current_thread() is threading.main_thread()
    if main_thread:
        signal.signal(signal.SIGINT, handler)
    try:
        done: set[str] = set()          # file names fully handled
        attempts: dict[str, int] = {}   # unreadable-file retry counts
        served_ids: set[str] = set()
        # restart dedup: digest-keyed terminal records survive restarts
        prior = [r for r in read_results(out_dir)
                 if record_is_terminal(r)]
        done_digests = {r["digest"] for r in prior if r.get("digest")}
        if prior:
            say(f"restart: {len(done_digests)} terminal digest(s) in "
                f"{out_dir}/results.jsonl will not be re-run")
        idle = 0
        say(f"watching {source} (poll {poll_s:g}s) -> "
            f"{out_dir}/results.jsonl")
        while not stop.is_set():
            try:
                fresh = sorted(n for n in os.listdir(source)
                               if n.endswith(".json") and n not in done)
            except OSError as e:
                print(f"Error: queue directory unreadable: {e}",
                      file=sys.stderr)
                return 1
            batch, extra_records = [], []
            for name in fresh:
                if stop.is_set():
                    break               # drain: no new intake
                skipped: list = []
                try:
                    jobs = load_jobs(source, skipped=skipped, only=[name])
                except (OSError, ValueError) as e:
                    # structurally bad (unsafe id, ...): reject for good
                    done.add(name)
                    extra_records.append(
                        {"job_id": name[:-len(".json")],
                         "status": "rejected", "reason": "bad-job-file",
                         "error": str(e)})
                    continue
                if skipped:             # torn read: retry a few polls
                    attempts[name] = attempts.get(name, 0) + 1
                    if attempts[name] >= 3:
                        done.add(name)
                        extra_records.append(
                            {"job_id": name[:-len(".json")],
                             "status": "rejected",
                             "reason": "unreadable-job-file",
                             "error": skipped[0][1]})
                    continue
                done.add(name)
                for job in jobs:
                    if job.job_id in served_ids:
                        extra_records.append(
                            {"job_id": job.job_id, "status": "rejected",
                             "reason": "duplicate-id",
                             "error": "job id already served by this "
                                      "daemon; events log belongs to "
                                      "the first submission"})
                        continue
                    served_ids.add(job.job_id)
                    try:
                        dg = job.digest()
                    except (OSError, ValueError):
                        dg = None       # unreadable cfg: admission rejects
                    if dg is not None and dg in done_digests:
                        say(f"[{job.job_id}] cached: digest {dg} already "
                            "has a terminal record (not re-run)")
                        continue
                    batch.append(job)
            if extra_records:
                for rec in extra_records:
                    say(f"[{rec['job_id']}] rejected ({rec['reason']})")
                _append_records(out_dir, extra_records)
            if batch:
                idle = 0
                if workers:
                    from raft_tla_tpu_torch.serve.pool import run_pool
                    recs = run_pool(batch, out_dir, workers=workers,
                                    chunk=chunk, max_states=max_states,
                                    quiet=quiet, depth=depth, device=device,
                                    stop=stop.is_set)
                else:
                    recs = run_service(batch, out_dir, chunk=chunk,
                                       max_states=max_states, quiet=quiet,
                                       depth=depth, stop=stop.is_set,
                                       device=device)
                done_digests |= {r["digest"] for r in recs
                                 if record_is_terminal(r)
                                 and r.get("digest")}
                continue                # re-scan immediately after a batch
            if stop.is_set():
                break
            idle += 1
            if max_idle_polls is not None and idle >= max_idle_polls:
                say(f"idle for {idle} poll(s) — exiting (--max-idle-polls)")
                break
            # sleep in small increments so SIGINT turns around fast
            deadline = time.monotonic() + poll_s
            while time.monotonic() < deadline and not stop.is_set():
                time.sleep(min(0.05, poll_s))
        say(f"daemon exit: {len(served_ids)} job(s) served"
            + (" (drained on SIGINT)" if stop.is_set() else ""))
        return 0
    finally:
        if main_thread:
            signal.signal(signal.SIGINT, prev)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raft-tla-serve-torch",
        description="Multi-tenant bounded-check service: admit N jobs "
                    "through the speclint gate and pack them into shared "
                    "batched device dispatches (lane-packed continuous "
                    "batching), one event log per tenant.")
    p.add_argument("source",
                   help="job source: a JSONL manifest (one job object "
                        "per line) or a queue directory of *.json job "
                        "files; each job: {'id', 'cfg' | 'cfg_text', "
                        "+ JobOptions fields (spec, max_term, ...)}")
    p.add_argument("--out", default="serve-out", metavar="DIR",
                   help="output directory: <id>.events per job + "
                        "results.jsonl (default: serve-out)")
    p.add_argument("--chunk", type=int, default=1024,
                   help="shared dispatch width B — a dispatch launches "
                        "its bin's step on at most B rows, packed from all "
                        "of the bin's lanes (default 1024)")
    p.add_argument("--max-states", type=int, default=None,
                   help="per-lane distinct-state cap; an exceeding lane "
                        "is stopped (attributed in its event log), the "
                        "other tenants keep running")
    p.add_argument("--depth", type=int, default=2,
                   help="dispatch pipeline depth: how many fused steps "
                        "may be in flight while earlier harvests run on "
                        "the host (1 = sequential; default 2)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="persistent kernel-library directory: the nvcc "
                        "builds of the bins' kernels land there, named by "
                        "source hash (also via RAFT_TLA_COMPILE_CACHE; "
                        "default build/torch_kernels); warm-starts bin "
                        "builds across service restarts")
    p.add_argument("--watch", action="store_true",
                   help="daemon mode: SOURCE must be a queue directory; "
                        "keep polling it for new *.json job files and "
                        "serve each arrival burst as one interleaved "
                        "batch; first SIGINT drains losslessly, second "
                        "aborts")
    p.add_argument("--poll", type=float, default=2.0, metavar="SECS",
                   help="--watch poll interval (default 2.0)")
    p.add_argument("--max-idle-polls", type=int, default=None,
                   metavar="N",
                   help="--watch: exit 0 after N consecutive empty "
                        "polls (smoke-test bound; default: run until "
                        "SIGINT)")
    p.add_argument("--workers", type=int, default=0, metavar="N",
                   help="fault-isolated mode: dispatch admitted jobs to "
                        "up to N supervised worker child processes "
                        "(serve/pool.py) — a poison job, OOM or segfault "
                        "kills one worker, not the service; 0 (default) "
                        "executes in-process")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the steps run (default: cuda; cuda without "
                        "a GPU is an error)")
    p.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--trace", action="store_true",
                   help="emit schema-v8 trace spans (RAFT_TLA_TRACE): "
                        "per-tenant engine phases into each tenant log "
                        "plus scheduler dispatch/harvest/compile/ticket "
                        "spans into OUT/sched-<pid>.events; merge with "
                        "raft-tla-trace-torch")
    p.add_argument("--metrics-port", type=int, default=None, metavar="P",
                   help="expose a live OpenMetrics endpoint on "
                        "127.0.0.1:P (0 = ephemeral port; also via "
                        "RAFT_TLA_METRICS): per-tenant p50/p95/p99 "
                        "admission-to-result latency, queue depth, "
                        "per-bin inflight and pool-worker gauges, "
                        "snapshotted into OUT/metrics.events")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-job progress lines")
    p.add_argument("--drain-on-sigint", action="store_true",
                   help="one-pass mode: first SIGINT drains losslessly "
                        "(in-flight dispatches harvested, unfinished "
                        "lanes get attributed 'stopped' records) instead "
                        "of aborting — how pool workers are spawned, so "
                        "a supervisor preempt never loses finished work")
    return p


def main(argv=None) -> int:
    p = build_argparser()
    args = p.parse_args(argv)
    if args.cpu:
        p.error("--cpu is spelled --device cpu in raft_tla_tpu_torch")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("Error: device='cuda' asked for, but torch sees no GPU; "
                  "pass --device cpu to run on the CPU", file=sys.stderr)
            return 1
    if args.trace:
        # Process-wide so pool worker children (plain serve CLIs spawned
        # with the inherited environment) trace too — the gate pattern
        # every RAFT_TLA_* knob follows.
        from raft_tla_tpu_torch.obs.trace import ENV_TRACE
        os.environ[ENV_TRACE] = "1"
    from raft_tla_tpu_torch.serve.sched import enable_compile_cache
    cache_dir = enable_compile_cache(args.compile_cache)
    if cache_dir and not args.quiet:
        print(f"compile cache: {cache_dir}")
    from raft_tla_tpu_torch.obs.metrics import metrics_port
    mport = metrics_port(args.metrics_port)
    mserver = None
    if mport is not None:
        # The endpoint lives in THIS supervising process and only READS
        # the out dir's event logs (each scrape tails the new bytes) —
        # the engines' off-path cost is untouched (tel.active
        # discipline).
        from raft_tla_tpu_torch.obs.openmetrics import MetricsServer
        os.makedirs(args.out, exist_ok=True)
        mserver = MetricsServer(
            args.out, port=mport,
            snapshot_path=os.path.join(args.out, "metrics.events"))
        print(f"metrics endpoint: {mserver.url}", flush=True)
    try:
        return _run_front(args)
    finally:
        if mserver is not None:
            mserver.close()
        if args.device == "cuda" and not args.workers:
            # the kernels' launches in this process (a pool's workers
            # print their own), as the check CLI ends on the card
            from raft_tla_tpu_torch.ops import pallas_fp, pallas_step
            print(f"Kernel launches: step {pallas_step.launches}, "
                  f"fingerprint {pallas_fp.launches}", file=sys.stderr)


def _run_front(args) -> int:
    if args.watch:
        return run_daemon(args.source, args.out, chunk=args.chunk,
                          max_states=args.max_states, quiet=args.quiet,
                          depth=args.depth, poll_s=args.poll,
                          max_idle_polls=args.max_idle_polls,
                          workers=args.workers, device=args.device)
    skipped: list = []
    try:
        jobs = load_jobs(args.source, skipped=skipped)
    except (OSError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    for name, err in skipped:
        print(f"Warning: skipped unreadable job file {name}: {err}",
              file=sys.stderr)
    stop = None
    prev_sigint = None
    if args.drain_on_sigint:
        import signal
        import threading
        drain = threading.Event()

        def _handler(_signum, _frame):
            if drain.is_set():
                signal.signal(signal.SIGINT, prev_sigint)
                raise KeyboardInterrupt
            drain.set()
            print("SIGINT: draining — unfinished lanes get attributed "
                  "records (SIGINT again aborts raw)", file=sys.stderr,
                  flush=True)

        if threading.current_thread() is threading.main_thread():
            prev_sigint = signal.getsignal(signal.SIGINT)
            signal.signal(signal.SIGINT, _handler)
        stop = drain.is_set
    if args.workers:
        from raft_tla_tpu_torch.serve.pool import run_pool
        records = run_pool(jobs, args.out, workers=args.workers,
                           chunk=args.chunk, max_states=args.max_states,
                           quiet=args.quiet, depth=args.depth,
                           device=args.device, stop=stop)
    else:
        records = run_service(jobs, args.out, chunk=args.chunk,
                              max_states=args.max_states, quiet=args.quiet,
                              depth=args.depth, stop=stop,
                              device=args.device)
    n_by = {}
    for rec in records:
        n_by[rec["status"]] = n_by.get(rec["status"], 0) + 1
    if not args.quiet:
        print("serve: " + ", ".join(f"{v} {k}"
                                    for k, v in sorted(n_by.items()))
              + f" -> {args.out}/results.jsonl")
    return 1 if n_by.get("stopped") else 0


def entry() -> None:
    """Console-script entry point (pyproject ``raft-tla-serve-torch``)."""
    sys.exit(main())


if __name__ == "__main__":
    entry()
