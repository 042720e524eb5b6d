"""Fault-isolated serving: the supervised worker pool; the port of
``raft_tla_tpu/serve/pool.py``.

:func:`run_service` executes every admitted lane in one process — one
poison cfg that segfaults the step compiler, one lane that OOMs the
device, and every tenant in the batch dies with it.  ``run_pool`` is
the same contract (same admission gate, same per-tenant event logs,
same results.jsonl records) with a blast radius of one worker:

- Admitted jobs are partitioned by step-signature bin
  (:func:`~raft_tla_tpu_torch.serve.batch.bin_key`) into up to ``workers``
  groups, each dispatched to a child process running the ordinary
  serve CLI (``python -m raft_tla_tpu_torch.serve MANIFEST --out OUT
  --drain-on-sigint --device DEV``, so each worker opens its own CUDA
  context on the card) over a self-contained manifest of
  :meth:`CheckJob.to_dict` lines.  Workers write the per-tenant
  ``<id>.events`` logs and crash-safe ``results.jsonl`` records
  themselves — artifacts are byte-compatible with the in-process path.
- A supervision loop tails every worker's tenant logs
  (:class:`~raft_tla_tpu_torch.serve.supervise.WorkerHealth`, built on
  ``obs/collect.LogTail`` and the campaign supervisor's
  ``HealthMonitor``) and reaps
  exits.  A lost worker's death is classified
  (:func:`~raft_tla_tpu_torch.serve.supervise.classify_death`) and its
  *unfinished* jobs — terminal results.jsonl records are the ground
  truth — are requeued with decorrelated-jitter backoff.
- Poison bisection: every unfinished job of a dead worker takes one
  blame point; a blamed group is split in half, a job one death short
  of the threshold runs solo, and a job whose K-th death was solo is
  QUARANTINED — an attributed ``quarantined`` results record plus
  tenant-log attribution, and (being terminal) it is never re-run,
  not even across daemon restarts.  Innocent cellmates are re-run
  losslessly (BFS is deterministic: the re-run reproduces the same
  counts, so completed artifacts stay byte-identical to a solo run).
- Graceful degradation: an OOM-classified death takes no blame —
  the group respawns with its dispatch width halved (down to
  ``PoolPolicy.min_chunk``; an OOM at the floor is treated as poison).
  A global respawn budget bounds the whole recovery effort.

Supervision telemetry lands in ``OUT/pool.events`` (obs schema v7:
``worker_spawn`` / ``worker_lost`` / ``job_retry`` / ``quarantine``,
plus campaign-style ``preempt``) so ``raft-tla-monitor-torch`` renders pool
attribution rows with no new tooling.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

from raft_tla_tpu_torch.obs import append_event
from raft_tla_tpu_torch.obs.metrics import ENV_METRICS
from raft_tla_tpu_torch.campaign.supervisor import DecorrelatedBackoff
from raft_tla_tpu_torch.serve import supervise
from raft_tla_tpu_torch.serve.service import (_append_records, _events_path,
                                        _reject_events, read_results,
                                        record_is_terminal)
from raft_tla_tpu_torch.serve.supervise import PoolPolicy, WorkerHealth


class _PoolJob:
    """One admitted job's pool-side state: blame count + base record."""

    def __init__(self, job, rec: dict):
        self.job = job
        self.rec = rec                   # admission-time base record
        self.deaths = 0                  # worker deaths blamed on it
        self.attempts = 0                # times handed to a worker
        self.done = False                # has a terminal results record

    @property
    def job_id(self) -> str:
        return self.job.job_id


class _Group:
    """A unit of dispatch: jobs that ride one worker process."""

    def __init__(self, jobs: list, chunk: int, retry: bool = False,
                 not_before: float = 0.0):
        self.jobs = jobs
        self.chunk = chunk
        self.retry = retry
        self.not_before = not_before

    def pending_jobs(self) -> list:
        return [pj for pj in self.jobs if not pj.done]


class _Worker:
    """One live child process + its health view."""

    def __init__(self, wid: str, group: _Group, proc, out_path: str,
                 health: WorkerHealth):
        self.wid = wid
        self.group = group
        self.proc = proc
        self.out_path = out_path
        self.health = health
        self.preempt: tuple | None = None   # (reason, detail) once signaled
        self.signaled_at: float | None = None
        self.killed = False
        self.draining = False
        self.t0_mono = time.monotonic()     # lifetime span start (tracing)
        self.signal_mono: float | None = None  # SIGINT sent (drain span)

    def out_tail(self, n: int = 4096) -> str:
        try:
            with open(self.out_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""


def _ensure_newline(path: str) -> None:
    """Guard an append onto a possibly torn tail (a SIGKILLed worker's
    half-written line): the attribution events must start on their own
    line so the reader drops only the torn fragment, never our record."""
    try:
        with open(path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() == 0:
                return
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                f.write(b"\n")
    except OSError:
        pass


def _attribute_stop(path: str, reason: str, outcome: str) -> None:
    """End-state attribution in a tenant's event log — a log is never
    silent about why its run has no verdict.  Appends onto an existing
    (possibly torn) log, or writes a fresh three-event log when the
    job never reached a worker at all."""
    if os.path.exists(path):
        _ensure_newline(path)
    else:
        append_event(path, "run_start", engine="serve", universe={},
                     spec="", invariants=[], resumed=False,
                     pid=os.getpid())
    append_event(path, "stop_requested", reason=reason, source="pool",
                 pid=os.getpid())
    append_event(path, "run_end", n_states=0, n_transitions=0,
                 complete=False, outcome=outcome)


def _partition(admitted: list, workers: int, device="cuda") -> list:
    """Group (job, adm, rec) triples into up to ``workers`` worker
    assignments: same-bin jobs stay together (one compiled step serves
    the whole lane pack), bins round-robin across workers, and when
    there are fewer bins than workers the largest groups split so the
    pool is actually a pool (fault isolation beats compile sharing
    once jobs < workers would otherwise share one blast radius)."""
    from raft_tla_tpu_torch.serve.batch import bin_key

    by_bin: dict = {}
    order: list = []
    for job, adm, rec in admitted:
        key = bin_key(adm.config, device)
        if key not in by_bin:
            by_bin[key] = []
            order.append(key)
        by_bin[key].append(_PoolJob(job, rec))
    lists = [by_bin[k] for k in order]
    total = sum(len(l) for l in lists)
    while len(lists) < min(workers, total):
        biggest = max(lists, key=len)
        if len(biggest) < 2:
            break
        lists.remove(biggest)
        mid = (len(biggest) + 1) // 2
        lists += [biggest[:mid], biggest[mid:]]
    slots = min(workers, len(lists)) or 1
    assigned: list = [[] for _ in range(slots)]
    for i, l in enumerate(lists):
        assigned[i % slots].extend(l)
    return [a for a in assigned if a]


def run_pool(jobs, out_dir: str, *, workers: int = 2, chunk: int = 1024,
             max_states: int | None = None, quiet: bool = False,
             depth: int = 2, device: str = "cuda",
             policy: PoolPolicy | None = None, spawn_hook=None,
             stop=None, clock=time.time, sleep=time.sleep) -> list:
    """Serve ``jobs`` through the supervised worker pool; returns the
    final results.jsonl record per job (last record wins — a requeued
    job's drained ``stopped`` record is superseded by its re-run).

    ``spawn_hook(worker)`` is the chaos seam, called after every child
    spawn with the live :class:`_Worker` (serve/chaos.py kills through
    it); ``stop`` is the daemon's drain hook — when truthy, active
    workers are SIGINTed (they drain losslessly) and undispatched jobs
    get attributed ``stopped`` records.  ``clock``/``sleep`` are
    injectable for tests.  ``device`` is where the workers' steps run
    (``cuda`` raises here, before any spawn, without a GPU).
    """
    from raft_tla_tpu_torch.frontend.registry import _cuda_device
    from raft_tla_tpu_torch.serve.jobs import admit

    device = _cuda_device(device)
    policy = policy or PoolPolicy()
    os.makedirs(out_dir, exist_ok=True)
    pool_dir = os.path.join(out_dir, "pool")
    os.makedirs(pool_dir, exist_ok=True)
    pool_events = os.path.join(out_dir, "pool.events")
    # v8 tracing: worker lifetimes and SIGINT->exit drains become spans
    # in pool.events, and the anchored run_start lets the collector put
    # the supervisor on the same wall axis as its children.  Gated so an
    # untraced pool log is byte-compatible with v7 consumers.
    from raft_tla_tpu_torch.obs.trace import NULL_TRACER, anchored_run_start, \
        trace_enabled, tracer_for
    tracer = NULL_TRACER
    if trace_enabled():
        anchored_run_start(pool_events, "pool")
        tracer = tracer_for(pool_events)

    def say(msg: str) -> None:
        if not quiet:
            print(msg, flush=True)

    # Admission in the parent — host-only, and rejects must not burn a
    # worker spawn.  Workers re-admit their (admitted) manifests; that
    # repeat is cheap and keeps the worker the ordinary serve CLI.
    records: list = []
    admitted: list = []
    for job in jobs:
        t_adm = time.monotonic()
        adm = admit(job)
        try:
            digest = job.digest()
        except (OSError, ValueError):
            digest = None
        rec = {"job_id": job.job_id, "digest": digest,
               "admission_s": round(time.monotonic() - t_adm, 3),
               "events": _events_path(out_dir, job.job_id)}
        if not adm.admitted or adm.properties:
            reason = adm.reason if not adm.admitted \
                else "property-unsupported"
            findings = adm.findings_text() if adm.findings else \
                [f"PROPERTY {list(adm.properties)}: liveness needs a "
                 "dedicated exhaustive run (raft-tla-check-torch --property); "
                 "the batched service checks invariants only"]
            rec.update(status="rejected", reason=reason,
                       findings=findings)
            _reject_events(rec["events"], job, reason)
            say(f"[{job.job_id}] rejected at admission ({reason})")
            records.append(rec)
            continue
        admitted.append((job, adm, rec))
    if records:
        _append_records(out_dir, records)

    pool_jobs: list = []
    pending: list = []
    if admitted:
        groups = _partition(admitted, workers, device)
        for g in groups:
            pool_jobs.extend(g)
            pending.append(_Group(g, chunk))
        say(f"pool: {len(pool_jobs)} admitted job(s) across "
            f"{len(groups)} worker group(s) "
            f"({len(jobs) - len(pool_jobs)} rejected) — chunk {chunk}, "
            f"up to {workers} worker(s)")

    backoff = DecorrelatedBackoff(policy.backoff_base_s,
                                  policy.backoff_cap_s,
                                  seed=policy.backoff_jitter_seed)
    active: list = []
    wseq = 0
    respawns = 0
    draining = False

    def refresh_done() -> dict:
        """results.jsonl is the ground truth for completion: map every
        job id to its LAST record and mark terminal ones done."""
        last = {}
        for r in read_results(out_dir):
            last[r.get("job_id")] = r
        for pj in pool_jobs:
            r = last.get(pj.job_id)
            if r is not None and record_is_terminal(r):
                pj.done = True
        return last

    def spawn(group: _Group) -> None:
        nonlocal wseq
        wid = f"w{wseq}"
        wseq += 1
        todo = group.pending_jobs()
        # Requeue rotation: a prior attempt's partial event log moves
        # aside so the re-run's log reads exactly like a solo run (and
        # the health tail starts from byte 0 of fresh content).
        for pj in todo:
            pj.attempts += 1
            path = _events_path(out_dir, pj.job_id)
            if pj.attempts > 1 and os.path.exists(path):
                try:
                    os.replace(path, f"{path}.retry{pj.attempts - 1}")
                except OSError:
                    pass
        manifest = os.path.join(pool_dir, f"{wid}.jobs.jsonl")
        with open(manifest, "w", encoding="utf-8") as f:
            for pj in todo:
                f.write(json.dumps(pj.job.to_dict(), sort_keys=True)
                        + "\n")
        argv = [sys.executable, "-m", "raft_tla_tpu_torch.serve", manifest,
                "--out", out_dir, "--chunk", str(group.chunk),
                "--depth", str(depth), "--quiet", "--drain-on-sigint"]
        if max_states is not None:
            argv += ["--max-states", str(max_states)]
        argv += ["--device", device.type]
        out_path = os.path.join(pool_dir, f"{wid}.out")
        out_f = open(out_path, "wb")
        # Workers inherit the environment EXCEPT the metrics gate: the
        # pool's supervising process owns the one endpoint over out_dir
        # (it already sees every tenant log the workers write), and a
        # child re-binding the same port would die at startup.
        child_env = dict(os.environ)
        child_env.pop(ENV_METRICS, None)
        try:
            proc = subprocess.Popen(argv, stdout=out_f,
                                    stderr=subprocess.STDOUT,
                                    stdin=subprocess.DEVNULL,
                                    env=child_env)
        finally:
            out_f.close()
        health = WorkerHealth(
            policy, [_events_path(out_dir, pj.job_id) for pj in todo],
            clock=clock)
        health.start(clock())
        w = _Worker(wid, group, proc, out_path, health)
        active.append(w)
        append_event(pool_events, "worker_spawn", worker=wid,
                     pid=proc.pid, jobs=[pj.job_id for pj in todo],
                     chunk=group.chunk, respawn=group.retry,
                     attempt=max(pj.attempts for pj in todo))
        say(f"pool: spawned {wid} (pid {proc.pid}) for "
            f"{len(todo)} job(s)"
            + (f" [retry, chunk {group.chunk}]" if group.retry else ""))
        if spawn_hook is not None:
            spawn_hook(w)

    def give_up(reason: str) -> None:
        """Respawn budget exhausted: every unfinished job gets an
        attributed (non-terminal — a restart may retry) record."""
        recs = []
        for pj in pool_jobs:
            if pj.done:
                continue
            pj.done = True
            _attribute_stop(_events_path(out_dir, pj.job_id),
                            f"pool gave up: {reason}", "stopped")
            recs.append(dict(pj.rec, status="stopped",
                             error=f"pool gave up: {reason}"))
        pending.clear()
        if recs:
            _append_records(out_dir, recs)
            say(f"pool: gave up on {len(recs)} job(s) ({reason})")

    def quarantine(pj: _PoolJob, w: _Worker, detail: str) -> None:
        pj.done = True
        append_event(pool_events, "quarantine", job_id=pj.job_id,
                     reason="poison-job", deaths=pj.deaths, worker=w.wid,
                     detail=detail)
        path = _events_path(out_dir, pj.job_id)
        _attribute_stop(
            path,
            f"quarantined after {pj.deaths} worker death(s): {detail}",
            "quarantined")
        rec = dict(pj.rec, status="quarantined", reason="poison-job",
                   deaths=pj.deaths,
                   error=f"poison-job: blamed for {pj.deaths} worker "
                         f"death(s); last: {detail}")
        _append_records(out_dir, [rec])
        say(f"[{pj.job_id}] QUARANTINED after {pj.deaths} worker "
            f"death(s) ({detail})")

    def requeue(suspects: list, w: _Worker, kind: str,
                detail: str) -> None:
        """Blame-and-bisect: each suspect takes a death; a lone suspect
        at K deaths is quarantined; survivors one short of K go solo
        (so their K-th death, if it comes, is unambiguous); the rest
        bisect.  OOM and session-wall arrive here via their own
        no-blame paths."""
        nonlocal respawns
        K = policy.max_job_deaths
        blame = kind not in ("session-wall", "oom", "drain")
        if blame:
            for pj in suspects:
                pj.deaths += 1
        survivors = []
        for pj in suspects:
            if blame and len(suspects) == 1 and pj.deaths >= K:
                quarantine(pj, w, detail)
            else:
                survivors.append(pj)
        if not survivors:
            return
        solos = [pj for pj in survivors if blame and pj.deaths >= K - 1]
        rest = [pj for pj in survivors if pj not in solos]
        new_lists = [[pj] for pj in solos]
        if len(rest) > 1 and blame:
            mid = (len(rest) + 1) // 2
            new_lists += [rest[:mid], rest[mid:]]
        elif rest:
            new_lists += [rest]
        new_chunk = w.group.chunk
        if kind == "oom":
            new_chunk = max(policy.min_chunk, new_chunk // 2)
        if respawns + len(new_lists) > policy.max_respawns:
            give_up(f"respawn budget ({policy.max_respawns}) "
                    f"exhausted; last death: {kind}: {detail}")
            return
        respawns += len(new_lists)
        delay = backoff.next()
        nb = clock() + delay
        for lst in new_lists:
            pending.append(_Group(lst, new_chunk, retry=True,
                                  not_before=nb))
            for pj in lst:
                append_event(pool_events, "job_retry", job_id=pj.job_id,
                             attempt=pj.attempts, worker=w.wid,
                             backoff_s=round(delay, 3), reason=kind)
        say(f"pool: requeued {sum(len(l) for l in new_lists)} job(s) "
            f"from {w.wid} in {len(new_lists)} group(s) "
            f"(death: {kind}; backoff {delay:.2f}s"
            + (f"; chunk -> {new_chunk}" if kind == "oom" else "") + ")")

    def reap(w: _Worker, rc: int) -> None:
        active.remove(w)
        if tracer.enabled:
            now_mono = time.monotonic()
            tracer.emit_span("worker", w.t0_mono, now_mono - w.t0_mono,
                             thread="workers", worker=w.wid,
                             pid=w.proc.pid, exit_code=rc)
            if w.signal_mono is not None:
                # SIGINT->exit: how much of the grace window the drain
                # actually used (nests inside the worker lifetime).
                tracer.emit_span("drain", w.signal_mono,
                                 now_mono - w.signal_mono,
                                 thread="workers", worker=w.wid)
        last = refresh_done()
        unfinished = w.group.pending_jobs()
        if w.draining:
            kind, detail = "drain", "pool drain (stop requested)"
        elif w.preempt is not None:
            kind, detail = w.preempt
        elif rc in (0, 1):
            # Clean exit: a job whose record is non-terminal "stopped"
            # was attributed by the worker itself (a runtime lane
            # failure — exactly what in-process run_service reports
            # without retrying), so it is settled, not requeued; only
            # jobs with NO record at all count as lost with the worker.
            for pj in unfinished:
                if pj.job_id in last:
                    pj.done = True
            unfinished = [pj for pj in unfinished
                          if pj.job_id not in last]
            if not unfinished:
                backoff.reset()
                say(f"pool: {w.wid} finished cleanly "
                    f"({len(w.group.jobs)} job(s) settled)")
                return
            kind, detail = supervise.classify_death(rc, w.out_tail())
        else:
            kind, detail = supervise.classify_death(rc, w.out_tail())
        append_event(pool_events, "worker_lost", worker=w.wid,
                     kind=kind, pid=w.proc.pid, exit_code=rc,
                     jobs=[pj.job_id for pj in unfinished],
                     detail=detail)
        say(f"pool: lost {w.wid} ({kind}: {detail}; exit {rc}; "
            f"{len(unfinished)} job(s) unfinished)")
        if kind == "drain" or not unfinished:
            return
        if kind == "oom" and w.group.chunk <= policy.min_chunk:
            # Degradation floor reached: this is not memory pressure we
            # can shrink away — treat as a poison death.
            kind = "crashed"
            detail += f" (chunk already at floor {policy.min_chunk})"
        requeue(unfinished, w, kind, detail)

    while active or pending:
        now = clock()
        if stop is not None and stop() and not draining:
            draining = True
            # Undispatched jobs never reached a worker — attribute now;
            # active workers drain losslessly via their own SIGINT path.
            recs = []
            for g in pending:
                for pj in g.pending_jobs():
                    pj.done = True
                    _attribute_stop(
                        _events_path(out_dir, pj.job_id),
                        "stop requested (drain; job never reached a "
                        "worker)", "stopped")
                    recs.append(dict(
                        pj.rec, status="stopped",
                        error="stop requested (drain; job never "
                              "reached a worker)"))
            pending.clear()
            if recs:
                _append_records(out_dir, recs)
            for w in active:
                w.draining = True
                w.signaled_at = now
                w.signal_mono = time.monotonic()
                try:
                    w.proc.send_signal(signal.SIGINT)
                except OSError:
                    pass
            say(f"pool: draining — {len(active)} active worker(s) "
                f"signaled, {len(recs)} undispatched job(s) attributed")
        if not draining:
            ready = [g for g in pending if g.not_before <= now]
            while ready and len(active) < workers:
                g = ready.pop(0)
                pending.remove(g)
                if not g.pending_jobs():
                    continue
                spawn(g)
        for w in list(active):
            w.health.poll()
            rc = w.proc.poll()
            if rc is None:
                if w.signaled_at is None:
                    bad = w.health.verdict()
                    if bad is not None:
                        reason, detail = bad
                        w.preempt = bad
                        w.signaled_at = now
                        w.signal_mono = time.monotonic()
                        append_event(pool_events, "preempt",
                                     reason=reason, detail=detail,
                                     pid=w.proc.pid)
                        say(f"pool: preempting {w.wid} "
                            f"({reason}: {detail})")
                        try:
                            w.proc.send_signal(signal.SIGINT)
                        except OSError:
                            pass
                elif not w.killed and now - w.signaled_at > policy.grace_s:
                    w.killed = True
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
                continue
            reap(w, rc)
        if active or pending:
            sleep(policy.poll_s)

    # Final sweep: anything still unfinished (shouldn't happen — every
    # path above settles or requeues) gets an attributed record so the
    # pool never returns silence for an accepted job.
    last = refresh_done()
    tail_recs = []
    for pj in pool_jobs:
        if pj.job_id not in last and not pj.done:
            _attribute_stop(_events_path(out_dir, pj.job_id),
                            "pool exit with no worker verdict", "stopped")
            tail_recs.append(dict(pj.rec, status="stopped",
                                  error="pool exit with no worker "
                                        "verdict"))
    if tail_recs:
        _append_records(out_dir, tail_recs)
        last = refresh_done()

    out = []
    for job in jobs:
        rec = last.get(job.job_id)
        if rec is None:                  # parent-side reject (appended
            for r in records:            # before any worker ran)
                if r["job_id"] == job.job_id:
                    rec = r
                    break
        if rec is not None:
            out.append(rec)
    n_by: dict = {}
    for rec in out:
        n_by[rec["status"]] = n_by.get(rec["status"], 0) + 1
    say("pool: " + ", ".join(f"{v} {k}"
                             for k, v in sorted(n_by.items()))
        + f" ({respawns} respawn(s))")
    return out
