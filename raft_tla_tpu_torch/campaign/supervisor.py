"""Preemption-tolerant campaign supervisor — the port's copy of
``raft_tla_tpu/campaign/supervisor.py``.

A *campaign* is one exhaustive check too big (or too preemptible) to
finish in one process lifetime.  The :class:`Supervisor` runs it as a
child process it is allowed to lose:

- **watch** — tail the tenant's own event log (the one obs/ already
  writes) and declare the child unhealthy on heartbeat staleness,
  fiducial drift, a session wall-clock policy, or an external
  preemption notice (:meth:`Supervisor.request_preempt`, SIGUSR1 from
  the CLI);
- **stop losslessly** — append ``stop_requested`` to the tenant log
  (the same contract ``campaign_stop.sh`` documents), send SIGINT, and
  give the child a grace window to flush a boundary snapshot before
  SIGKILL;
- **verify, quarantine, resume** — structurally verify the snapshot
  family (:mod:`raft_tla_tpu_torch.campaign.integrity`) before every
  resume; a corrupt family is moved to ``quarantine/`` (never resumed
  twice) and the newest good *generation copy* restored in its place.
  The global window ``W`` is the campaign invariant (``block = W //
  ndev``); the port's mesh is one card, so a mesh plan above 1 and a
  reshard refuse with a ValueError naming ROADMAP.md queue A item 11 (b)
  (``ddd-shard``), never falling back to one card silently;
- **retry bounded** — exponential backoff between resume attempts,
  reset whenever an attempt makes state-count progress, hard-capped at
  ``max_resumes``.

The supervisor's own actions are an event log too
(``supervisor.events``: schema-v2 ``preempt`` / ``reshard`` /
``resume_attempt`` lines), so ``raft-tla-monitor`` renders the
campaign's control history with the same tooling as the run itself.

Admission is the serve/ gate (:func:`raft_tla_tpu_torch.serve.jobs.admit`:
the width pass and the cfg lint):
a campaign that would be rejected as a service job — width-unsafe,
vacuous, property-carrying — is rejected before the first child spawn,
for the same reasons.

The child is always a fresh ``python -m raft_tla_tpu_torch.check ...
--engine ddd`` process (``--device cpu`` when the campaign runs on the
CPU), on the card unless asked.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import time

from raft_tla_tpu_torch.campaign.integrity import (CheckpointCorrupt,
                                                   snapshot_family,
                                                   verify_snapshot)
from raft_tla_tpu_torch.obs import append_event
from raft_tla_tpu_torch.obs.collect import LogTail as _LogTail
from raft_tla_tpu_torch.obs.history import _DRIFT_EXEMPT, fiducial_drift

# check.py's exit contract (mirrored, not imported: the supervisor must
# not pay the check-CLI import just to read four integers)
EXIT_OK, EXIT_DEADLOCK, EXIT_VIOLATION, EXIT_LIVENESS = 0, 11, 12, 13
EXIT_STOPPED = 14
_TERMINAL = {EXIT_OK: "ok", EXIT_DEADLOCK: "deadlock",
             EXIT_VIOLATION: "violation", EXIT_LIVENESS: "liveness"}


@dataclasses.dataclass(frozen=True)
class CampaignPolicy:
    """The supervisor's health + retry policy — everything that decides
    *when* to preempt and *whether* to resume, none of it about the
    model being checked."""

    checkpoint_every_s: float = 120.0    # child's --checkpoint-every
    stale_after_s: float | None = None   # None: 10x segment cadence,
    #                                      clamped to [30s, 1h] (the
    #                                      obs/monitor auto threshold)
    session_wall_s: float | None = None  # preempt the child past this
    #                                      wall (also the child's own
    #                                      --deadline at ndev == 1)
    drift_max: float | None = None       # fiducial ratio vs. the
    #                                      campaign's first-run baseline
    max_resumes: int = 8                 # bounded unattended retries
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 30.0
    backoff_jitter_seed: int | None = None
    #   decorrelated-jitter RNG seed; None derives one from the pid so
    #   co-located supervisors never retry in lockstep, an explicit int
    #   makes the whole delay sequence reproducible (tests pin it)
    grace_s: float = 20.0                # SIGINT -> SIGKILL window
    poll_s: float = 0.25                 # supervisor loop period
    retain_generations: int = 2          # known-good snapshot copies


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """What to check and at what shape.  ``window`` is the campaign's
    global frontier window W — the one number that must survive every
    reshard (each mesh runs ``block = W // ndev``)."""

    cfg_path: str
    spec: str = "full"
    window: int = 1 << 20
    chunk: int = 1024
    levels: int = 256
    cap: int = 1 << 20
    options: dict = dataclasses.field(default_factory=dict)
    #   extra JobOptions fields (max_term, faithful, ...) — forwarded
    #   both to admission and to the child CLI
    cpu: bool = False                    # children run --device cpu
    extra_args: tuple = ()               # raw extra child CLI args


@dataclasses.dataclass
class CampaignResult:
    outcome: str          # ok|deadlock|violation|liveness|gave-up|
    #                       rejected|error
    exit_code: int
    n_states: int | None
    n_transitions: int | None
    attempts: int         # child spawns, total
    preempts: int
    reshards: int
    quarantined: list     # (path, reason) pairs
    events_path: str = ""
    checkpoint: str = ""
    detail: str = ""


# _LogTail and _DRIFT_EXEMPT live in obs/collect.py and obs/history.py,
# as in the reference; re-imported above for the chaos harness.


def _median(xs: list) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class DecorrelatedBackoff:
    """Seedable decorrelated-jitter retry delays (the AWS-architecture
    variant: ``next = min(cap, uniform(base, prev * 3))``).

    Pure exponential backoff retries co-located supervisors (and the
    serve worker pool's respawns) in lockstep — every failed host wakes
    at the same instants and thunders the shared allocation together.
    Decorrelated jitter spreads the wakeups while keeping the same mean
    growth; seeding it makes the *whole sequence* deterministic, so the
    anti-herd behavior itself is testable (and two supervisors seeded
    differently provably diverge).  ``seed=None`` derives one from the
    pid: distinct processes get distinct sequences by default.
    """

    def __init__(self, base_s: float, cap_s: float,
                 seed: int | None = None):
        self.base_s = base_s
        self.cap_s = cap_s
        if seed is None:
            seed = os.getpid()
        self._seed = seed
        self._rng = random.Random(seed)
        self._prev = base_s

    def reset(self) -> None:
        """Progress was made: the next failure backs off from base
        again (the RNG stream keeps advancing — only the window resets)."""
        self._prev = self.base_s

    def next(self) -> float:
        self._prev = min(self.cap_s,
                         self._rng.uniform(self.base_s, self._prev * 3.0))
        return self._prev


class HealthMonitor:
    """Pure health-decision logic for one child attempt.

    Feed it the attempt's parsed events (:meth:`observe`); ask
    :meth:`verdict` whether the child should be preempted and why.
    No I/O, injectable clock — unit-testable without a process tree.
    """

    def __init__(self, policy: CampaignPolicy, clock=time.time,
                 fiducial_baseline: dict | None = None):
        self.policy = policy
        self.clock = clock
        self.spawned_at: float | None = None
        self.fiducial_baseline = fiducial_baseline
        self.fiducials_seen: dict | None = None
        self._last_ts: float | None = None
        self._seg_ts: list = []

    def observe(self, events: list) -> None:
        for e in events:
            ts = e.get("ts")
            if isinstance(ts, (int, float)):
                self._last_ts = ts
                if e.get("event") == "segment":
                    self._seg_ts.append(ts)
                    del self._seg_ts[:-10]
            if e.get("event") == "run_start" and e.get("fiducials"):
                self.fiducials_seen = dict(e["fiducials"])

    def last_event_age(self, now: float) -> float | None:
        anchor = self._last_ts if self._last_ts is not None \
            else self.spawned_at
        return None if anchor is None else max(0.0, now - anchor)

    def stale_threshold(self) -> float:
        """Explicit policy wins; otherwise 10x the observed segment
        cadence clamped to [30s, 1h] (same rule as obs/monitor), else a
        flat 300s before the first cadence sample exists."""
        if self.policy.stale_after_s is not None:
            return self.policy.stale_after_s
        gaps = [b - a for a, b in zip(self._seg_ts, self._seg_ts[1:])
                if b >= a]
        if not gaps:
            return 300.0
        return min(3600.0, max(30.0, 10.0 * _median(gaps)))

    def _drift(self) -> tuple | None:
        base, cur = self.fiducial_baseline, self.fiducials_seen
        if not self.policy.drift_max or not base or not cur:
            return None
        # The one drift policy (shared with raft-tla-regress): first
        # offending key in sorted order, one-sided growth ratio,
        # _DRIFT_EXEMPT honored.
        return fiducial_drift(base, cur, self.policy.drift_max)

    def verdict(self) -> tuple | None:
        """None = healthy, else ``(reason, detail)`` with reason one of
        ``session-wall`` / ``fiducial-drift`` / ``heartbeat-stale``."""
        now = self.clock()
        wall = self.policy.session_wall_s
        if wall is not None and self.spawned_at is not None \
                and now - self.spawned_at > wall:
            return ("session-wall",
                    f"child past {wall:.0f}s session budget")
        drift = self._drift()
        if drift is not None:
            key, ratio = drift
            return ("fiducial-drift",
                    f"{key} {ratio:.2f}x vs campaign baseline "
                    f"(threshold {self.policy.drift_max:.2f}x)")
        age = self.last_event_age(now)
        if age is not None and age > self.stale_threshold():
            return ("heartbeat-stale",
                    f"last event {age:.0f}s ago "
                    f"(threshold {self.stale_threshold():.0f}s)")
        return None


class Supervisor:
    """Drive one campaign to a verdict across any number of child
    lifetimes.  See the module docstring for the loop contract.

    ``mesh_plan``: None (one card: the port's mesh), a list of mesh sizes
    indexed by attempt (last entry repeats), or a callable ``attempt ->
    ndev``; any size above 1 is refused (ROADMAP.md queue A item 11 (b)).

    ``spawn_hook(sup, proc, attempt)`` / ``pre_verify_hook(sup,
    attempt)`` are the chaos seams: fault injection attaches here, the
    production path never notices.
    """

    def __init__(self, spec: CampaignSpec, workdir: str,
                 policy: CampaignPolicy | None = None, mesh_plan=None,
                 spawn_hook=None, pre_verify_hook=None,
                 quiet: bool = False, clock=time.time, sleep=time.sleep):
        if spec.window % spec.chunk:
            raise ValueError(
                f"campaign window {spec.window} is not a multiple of "
                f"chunk {spec.chunk}")
        self.spec = spec
        self.policy = policy or CampaignPolicy()
        self.workdir = workdir
        self.mesh_plan = mesh_plan
        self.spawn_hook = spawn_hook
        self.pre_verify_hook = pre_verify_hook
        self.quiet = quiet
        self.clock = clock
        self.sleep = sleep
        os.makedirs(workdir, exist_ok=True)
        self.ckpt = os.path.join(workdir, "campaign.ckpt")
        self.events_path = os.path.join(workdir, "run.events")
        self.sup_events = os.path.join(workdir, "supervisor.events")
        self.quarantine_dir = os.path.join(workdir, "quarantine")
        self.gen_dir = os.path.join(workdir, "gen")
        self._state_path = os.path.join(workdir, "campaign.json")
        self._state = self._load_state()
        self._external: tuple | None = None
        self.config = None
        self.quarantined: list = []
        self._jitter = DecorrelatedBackoff(
            self.policy.backoff_base_s, self.policy.backoff_cap_s,
            seed=self.policy.backoff_jitter_seed)
        self._last_backoff_s = 0.0
        # v8 tracing (RAFT_TLA_TRACE, inherited by the child): child
        # attempt lifetimes and preempt->exit drains become spans in
        # supervisor.events; the anchored run_start puts the supervisor
        # on the same wall axis as the child's engine spans.  Gated so
        # untraced supervisor logs stay byte-compatible with v2 readers.
        from raft_tla_tpu_torch.obs.trace import (NULL_TRACER,
                                                  anchored_run_start,
                                                  trace_enabled, tracer_for)
        self.tracer = NULL_TRACER
        if trace_enabled():
            anchored_run_start(self.sup_events, "campaign")
            self.tracer = tracer_for(self.sup_events)

    # ---------------------------------------------------------------- util

    def _say(self, msg: str) -> None:
        if not self.quiet:
            print(f"[campaign] {msg}", flush=True)

    def _load_state(self) -> dict:
        try:
            with open(self._state_path, "r", encoding="utf-8") as f:
                d = json.load(f)
            return d if isinstance(d, dict) else {}
        except (OSError, ValueError):
            return {}

    def _save_state(self, **updates) -> None:
        """Supervisor restart journal: the snapshot's mesh format lives
        here (``ndev``) — the one fact a fresh supervisor cannot re-probe
        from the family itself without trying every digest."""
        self._state.update(updates)
        tmp = self._state_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._state, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path)

    def request_preempt(self, reason: str = "external-preempt",
                        detail: str = "") -> None:
        """External preemption notice (scheduler eviction, SIGUSR1):
        the next supervisor poll drives the lossless-stop contract."""
        self._external = (reason, detail)

    # ----------------------------------------------------------- admission

    def _admit(self):
        from raft_tla_tpu_torch.serve.jobs import CheckJob, admit
        job = CheckJob.from_dict(
            {"id": "campaign", "cfg": self.spec.cfg_path,
             "spec": self.spec.spec, "chunk": self.spec.chunk,
             **self.spec.options})
        adm = admit(job)
        if adm.admitted and adm.properties:
            return adm, ("property-unsupported: liveness needs a "
                         "dedicated exhaustive run (raft-tla-check "
                         "--property); campaigns check invariants")
        if not adm.admitted:
            return adm, "; ".join(adm.findings_text()) or adm.reason
        return adm, None

    # ---------------------------------------------------------------- mesh

    def _mesh_for(self, attempt: int) -> int:
        plan = self.mesh_plan
        if plan is None:
            nd = 1                       # the port's mesh is one card
        elif callable(plan):
            nd = int(plan(attempt))
        else:
            nd = int(plan[min(attempt, len(plan) - 1)])
        if nd < 1 or self.spec.window % nd \
                or (self.spec.window // nd) % self.spec.chunk:
            raise ValueError(
                f"mesh plan ndev={nd} does not divide window "
                f"{self.spec.window} into chunk-aligned "
                f"({self.spec.chunk}) blocks")
        if nd > 1:
            raise ValueError(
                f"mesh plan ndev={nd}: raft_tla_tpu_torch runs a campaign "
                "on one card; the ddd-shard engine is not ported yet "
                "(ROADMAP.md queue A: item 11 (b), the DDD shard engine "
                "and CP lanes)")
        return nd

    def _reshard(self, ndev_src: int, ndev_dst: int) -> dict:
        raise ValueError(
            f"reshard {ndev_src} -> {ndev_dst} devices: the ddd-shard "
            "engine and its reshard are not ported to raft_tla_tpu_torch "
            "yet (ROADMAP.md queue A: item 11 (b), the DDD shard engine "
            "and CP lanes)")

    # ----------------------------------------- verify / quarantine / gens

    def _generations(self) -> list:
        try:
            names = sorted(n for n in os.listdir(self.gen_dir)
                           if n.startswith("g"))
        except OSError:
            return []
        return [os.path.join(self.gen_dir, n) for n in names]

    def _copy_family(self, dst_dir: str) -> None:
        os.makedirs(dst_dir, exist_ok=True)
        for p in snapshot_family(self.ckpt):
            shutil.copy2(p, os.path.join(dst_dir, os.path.basename(p)))

    def _maybe_save_generation(self, info: dict) -> None:
        """Keep ``retain_generations`` known-good copies of the verified
        family, deduped on state count — the fallback when a later
        snapshot turns out torn."""
        gens = self._generations()
        last_meta = {}
        if gens:
            try:
                with open(os.path.join(gens[-1], "meta.json"),
                          encoding="utf-8") as f:
                    last_meta = json.load(f)
            except (OSError, ValueError):
                pass
        if last_meta.get("n_states") == info["n_states"] \
                and last_meta.get("ndev") == self._state.get("ndev"):
            return                       # no progress since last copy
        seq = self._state.get("gen_seq", 0)
        gdir = os.path.join(self.gen_dir, f"g{seq:06d}")
        self._copy_family(gdir)
        with open(os.path.join(gdir, "meta.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"n_states": info["n_states"],
                       "ndev": self._state.get("ndev")}, f)
        self._save_state(gen_seq=seq + 1)
        for old in self._generations()[:-self.policy.retain_generations]:
            shutil.rmtree(old, ignore_errors=True)

    def _quarantine(self, what: str, reason: str, members: list) -> None:
        seq = self._state.get("quarantine_seq", 0)
        qdir = os.path.join(self.quarantine_dir, f"q{seq:06d}-{what}")
        os.makedirs(qdir, exist_ok=True)
        for p in members:
            os.replace(p, os.path.join(qdir, os.path.basename(p)))
        with open(os.path.join(qdir, "reason.txt"), "w",
                  encoding="utf-8") as f:
            f.write(reason + "\n")
        self._save_state(quarantine_seq=seq + 1)
        self.quarantined.append((qdir, reason))
        self._say(f"quarantined {what} -> {qdir}: {reason}")

    def _verify_or_recover(self, attempt: int) -> bool:
        """True = the live family is verified and resumable.  A corrupt
        family is quarantined (poison guarantee: it is *moved*, so the
        same bytes are never resumed twice) and the newest good
        generation restored; with none left, fall back to fresh start.
        """
        try:
            info = verify_snapshot(self.ckpt)
        except FileNotFoundError:
            return False
        except CheckpointCorrupt as e:
            self._quarantine("live", str(e), snapshot_family(self.ckpt))
        else:
            self._maybe_save_generation(info)
            return True
        for gdir in reversed(self._generations()):
            for n in os.listdir(gdir):
                if n != "meta.json":
                    shutil.copy2(os.path.join(gdir, n),
                                 os.path.join(self.workdir, n))
            try:
                info = verify_snapshot(self.ckpt)
            except CheckpointCorrupt as e:
                members = [p for p in snapshot_family(self.ckpt)]
                self._quarantine(os.path.basename(gdir), str(e), members)
                shutil.rmtree(gdir, ignore_errors=True)
                continue
            try:
                with open(os.path.join(gdir, "meta.json"),
                          encoding="utf-8") as f:
                    self._save_state(ndev=json.load(f).get("ndev"))
            except (OSError, ValueError):
                pass
            self._say(f"restored generation {os.path.basename(gdir)} at "
                      f"{info['n_states']:,} states")
            return True
        self._say("no good generation left; campaign restarts fresh")
        return False

    # --------------------------------------------------------------- child

    def _child_argv(self, ndev: int, resume: bool) -> list:
        spec = self.spec
        argv = [sys.executable, "-m", "raft_tla_tpu_torch.check",
                spec.cfg_path,
                "--spec", spec.spec, "--chunk", str(spec.chunk),
                "--levels", str(spec.levels), "--cap", str(spec.cap),
                "--block", str(spec.window // ndev),
                "--checkpoint", self.ckpt,
                "--checkpoint-every", str(self.policy.checkpoint_every_s),
                "--events", self.events_path, "--no-trace"]
        argv += ["--engine", "ddd"]
        if self.policy.session_wall_s is not None:
            # belt to the supervisor's suspenders: the engine stops
            # itself losslessly at the deadline even if the supervisor
            # dies with it
            argv += ["--deadline", str(self.policy.session_wall_s)]
        if resume:
            argv += ["--resume", self.ckpt]
        if spec.cpu:
            argv += ["--device", "cpu"]
        for k, v in sorted(spec.options.items()):
            flag = "--" + k.replace("_", "-")
            if isinstance(v, bool):
                if v:
                    argv.append(flag)
            else:
                argv += [flag, str(v)]
        argv += list(spec.extra_args)
        return argv

    def _preempt(self, proc, reason: str, detail: str,
                 hm: HealthMonitor) -> None:
        extra = {}
        if detail:
            extra["detail"] = detail
        age = hm.last_event_age(self.clock())
        if age is not None:
            extra["stale_s"] = round(age, 3)
        append_event(self.sup_events, "preempt", reason=reason,
                     pid=proc.pid, **extra)
        # the documented lossless-stop contract: the notice lands in the
        # tenant's log first, so the run's own history attributes the stop
        append_event(self.events_path, "stop_requested",
                     reason=f"supervisor: {reason}", source="supervisor",
                     pid=proc.pid)
        self._say(f"preempting pid {proc.pid}: {reason}"
                  + (f" ({detail})" if detail else ""))
        try:
            proc.send_signal(signal.SIGINT)
        except ProcessLookupError:
            pass

    def _attempt(self, attempt: int, ndev: int, resume: bool) -> tuple:
        """One child lifetime: spawn, tail, health-check, (maybe)
        preempt, reap.  Returns ``(returncode, events, preempted)``."""
        argv = self._child_argv(ndev, resume)
        out_path = os.path.join(self.workdir, f"attempt{attempt:03d}.out")
        hm = HealthMonitor(self.policy, clock=self.clock,
                           fiducial_baseline=self._state.get("fiducials"))
        tail = _LogTail(self.events_path)
        tail.seek_end()                  # only this attempt's heartbeat
        with open(out_path, "ab") as out:
            proc = subprocess.Popen(argv, stdout=out,
                                    stderr=subprocess.STDOUT)
        t0_mono = time.monotonic()       # attempt span start (tracing)
        drain_mono = None                # preempt signal sent (drain span)
        hm.spawned_at = self.clock()
        self._say(f"attempt {attempt}: pid {proc.pid}, ndev {ndev}, "
                  + ("resume" if resume else "fresh start"))
        if self.spawn_hook:
            self.spawn_hook(self, proc, attempt)
        events: list = []
        preempted_at = None
        killed = False
        while True:
            rc = proc.poll()
            evs = tail.poll()
            events.extend(evs)
            hm.observe(evs)
            if rc is not None:
                break
            if preempted_at is None:
                bad = self._external or hm.verdict()
                self._external = None
                if bad:
                    self._preempt(proc, bad[0], bad[1], hm)
                    preempted_at = self.clock()
                    drain_mono = time.monotonic()
            elif not killed and \
                    self.clock() - preempted_at > self.policy.grace_s:
                self._say(f"grace window ({self.policy.grace_s:.0f}s) "
                          "expired; SIGKILL")
                try:
                    proc.kill()
                except ProcessLookupError:
                    pass
                killed = True
            self.sleep(self.policy.poll_s)
        events.extend(tail.poll())       # drain the post-exit flush
        if self.tracer.enabled:
            now_mono = time.monotonic()
            self.tracer.emit_span(
                "attempt", t0_mono, now_mono - t0_mono,
                thread="children", attempt=attempt, pid=proc.pid,
                ndev=ndev, exit_code=rc,
                preempted=preempted_at is not None)
            if drain_mono is not None:
                # preempt-signal -> child-exit: the lossless-stop drain
                # (SIGKILL included when the grace window expired).
                self.tracer.emit_span(
                    "preempt_drain", drain_mono, now_mono - drain_mono,
                    thread="children", attempt=attempt, killed=killed)
        if hm.fiducials_seen and not self._state.get("fiducials"):
            self._save_state(fiducials=hm.fiducials_seen)
        return rc, events, preempted_at is not None

    @staticmethod
    def _classify(rc: int, events: list) -> tuple:
        """(outcome-or-None, last run_end event-or-None): None outcome
        means the attempt is recoverable (stopped or crashed)."""
        ends = [e for e in events if e.get("event") == "run_end"]
        end = ends[-1] if ends else None
        if rc in _TERMINAL:
            if rc == EXIT_OK and end is None:
                # exited clean with no run_end in the log: torn log or
                # impostor exit — treat as a crash, the checkpoint decides
                return None, None
            return _TERMINAL[rc], end
        return None, end                 # stopped (14) or crashed

    @staticmethod
    def _progress(events: list) -> int:
        n = -1
        for e in events:
            if e.get("event") in ("segment", "checkpoint", "run_end"):
                n = max(n, int(e.get("n_states", -1)))
        return n

    # ----------------------------------------------------------------- run

    def run(self) -> CampaignResult:
        adm, reject = self._admit()
        if reject is not None:
            self._say(f"rejected at admission: {reject}")
            return CampaignResult("rejected", 1, None, None, 0, 0, 0,
                                  [], self.events_path, self.ckpt,
                                  detail=reject)
        self.config = adm.config
        attempt = int(self._state.get("attempt", 0))
        spawns = preempts = reshards = 0
        backoff_k = 0
        progress_mark = -1
        last_end = None
        last_rc = 1
        while True:
            resume = False
            if os.path.exists(self.ckpt) or snapshot_family(self.ckpt):
                if self.pre_verify_hook:
                    self.pre_verify_hook(self, attempt)
                resume = self._verify_or_recover(attempt)
                if not resume:
                    # fresh start: no partial family may shadow it
                    for p in snapshot_family(self.ckpt):
                        os.remove(p)
            ndev = self._mesh_for(attempt)
            ndev_have = self._state.get("ndev")
            if resume and ndev_have is not None and ndev != ndev_have:
                try:
                    self._reshard(ndev_have, ndev)
                except CheckpointCorrupt as e:
                    # damage the structural pass could not see; same
                    # poison contract — quarantine, re-enter recovery
                    self._quarantine("live", str(e),
                                     snapshot_family(self.ckpt))
                    continue
                reshards += 1
            self._save_state(ndev=ndev, attempt=attempt)
            if spawns:
                extra = {"path": self.ckpt, "ndev": ndev}
                if backoff_k:
                    extra["backoff_s"] = round(self._last_backoff_s, 3)
                if self.quarantined:
                    extra["quarantined"] = self.quarantined[-1][0]
                append_event(self.sup_events, "resume_attempt",
                             attempt=attempt, **extra)
            rc, events, preempted = self._attempt(attempt, ndev, resume)
            spawns += 1
            preempts += int(preempted)
            last_rc = rc
            outcome, end = self._classify(rc, events)
            last_end = end or last_end
            if outcome is not None:
                self._say(f"campaign verdict: {outcome} after "
                          f"{spawns} attempt(s)")
                return self._result(outcome, rc, last_end, spawns,
                                    preempts, reshards)
            if rc == 1 and not events and not resume \
                    and not os.path.exists(self.ckpt):
                # died before emitting a single event on a fresh start:
                # argv/config error, a retry re-runs the same failure
                return self._result(
                    "error", rc, last_end, spawns, preempts, reshards,
                    detail=f"child exited {rc} before its run started "
                           f"(see attempt{attempt:03d}.out)")
            n_now = self._progress(events)
            if n_now > progress_mark:
                progress_mark = n_now
                backoff_k = 0
            else:
                backoff_k += 1
            attempt += 1
            if spawns > self.policy.max_resumes:
                self._say(f"giving up after {spawns} attempt(s) "
                          f"(max_resumes={self.policy.max_resumes})")
                return self._result("gave-up", last_rc, last_end, spawns,
                                    preempts, reshards)
            delay = self._backoff(backoff_k)
            if delay > 0:
                self._say(f"retrying in {delay:.1f}s "
                          f"(attempt {attempt}, rc {rc})")
                self.sleep(delay)

    def _backoff(self, k: int) -> float:
        """Delay before retry ``k`` of the current no-progress streak:
        0 resets the jitter window (progress was made), k >= 1 draws the
        next decorrelated-jitter delay.  Stateful — call once per retry
        decision; the drawn value is kept in ``_last_backoff_s`` for the
        resume_attempt event."""
        if k <= 0:
            self._jitter.reset()
            self._last_backoff_s = 0.0
            return 0.0
        self._last_backoff_s = self._jitter.next()
        return self._last_backoff_s

    def _result(self, outcome: str, rc: int, end, spawns: int,
                preempts: int, reshards: int,
                detail: str = "") -> CampaignResult:
        code = {"ok": EXIT_OK, "deadlock": EXIT_DEADLOCK,
                "violation": EXIT_VIOLATION,
                "liveness": EXIT_LIVENESS}.get(outcome, 1)
        return CampaignResult(
            outcome, code,
            int(end["n_states"]) if end else None,
            int(end["n_transitions"]) if end else None,
            spawns, preempts, reshards, list(self.quarantined),
            self.events_path, self.ckpt, detail=detail)
