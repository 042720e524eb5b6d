"""Run the 5-server election (elect5) as a supervised campaign on the card.

    python3 tools/campaign_run.py [--workdir DIR] [--logs DIR]

Runs ``runs/MC5s2v.cfg`` (election, MaxTerm 2, MaxLogLen 0, MaxMsgs 2,
SYMMETRY Server, |G| = 120) through ``raft_tla_tpu_torch.campaign``'s
supervisor: each child is ``python -m raft_tla_tpu_torch.check ... --engine
ddd --retention frontier --chunk 4096`` on the card, with a snapshot every
140 s and a session-wall policy of 420 s a child (then a lossless stop and
a resume).  The chaos harness SIGKILLs the second child after its second
checkpoint event; after two resumes the supervisor gives up, which ends
the run: three child lifetimes.  The campaign's admission gate rejects the
cfg's second invariant, ``CommittedWithinLog``, as vacuous on the election
spec (it reads only fields no election action writes), so the tool checks
a copy of the cfg with ``NoTwoLeaders`` alone; invariants do not change
the counts.

At the end it prints, for every completed BFS level, the cumulative orbit
count, whether it equals the last line of that level in
``runs/elect5ddd.stats`` (the JAX package's campaign; levels past its last
complete one have no reference) and the orbits/s over the level (epoch
time, restarts included); then each child's exit, the time from its spawn
to its ``run_start`` (a resume's reload included), the states redone after
each stop (at most: the lost child's furthest count, which includes keys
still pending dedup, less the count the next child resumed at), the
deepest completed level, the kernel launches each child reported (a
killed child reports none), the largest child's peak host RSS and the
card's name and power limit.  Exits non-zero if a level differs or
the run ended in anything but a give-up or a verdict.  Imports no JAX.

Disk: frontier retention writes each state's packed row (11 words at
this width) and key once, and the supervisor copies the verified snapshot
family (the key log and the two live level files) at every resume; a
child of 420 s writes some 10-20 GiB at the deeper
levels, which bounds how long a run may be where the disk is metered.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CFG = ROOT / "runs" / "MC5s2v.cfg"
REFERENCE = ROOT / "runs" / "elect5ddd.stats"
OPTIONS = {"max_term": 2, "max_log": 0, "max_msgs": 2}
SESSION_WALL_S = 420.0       # a child's lifetime before its lossless stop
EVERY_S = 140.0              # seconds between a child's snapshots
KILL = {1: ("kill", 2)}      # SIGKILL the second child at its 2nd checkpoint
MAX_RESUMES = 2              # three children in all


def level_ends(records) -> dict:
    """level -> (cumulative orbits, ts) of the last record of each level
    that a later level follows (a completed level)."""
    last = {}
    for d in records:
        last[d["level"]] = (d["n_states"], d.get("ts", d.get("wall_s")))
    return {lv: v for lv, v in last.items() if lv + 1 in last}


class Progress:
    """Prints the run's ``level_end`` and ``checkpoint`` events as the
    children log them."""

    def __init__(self, events_path: str):
        from raft_tla_tpu_torch.obs.collect import LogTail
        self._tail = LogTail(events_path)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while not self._stop.wait(2.0):
            for e in self._tail.poll():
                if e.get("event") in ("level_end", "checkpoint"):
                    print(f"  {e['event']} level {e.get('level', '-')} "
                          f"n_states {e.get('n_states')} ts {e['ts']}",
                          flush=True)

    def close(self) -> None:
        self._stop.set()
        self._t.join()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=str(ROOT / "build" / "campaign"))
    ap.add_argument("--logs", default=None, metavar="DIR",
                    help="copy the campaign's two event logs here")
    args = ap.parse_args()
    os.chdir(ROOT)              # the children run python -m raft_tla_tpu_torch
    import torch
    if not torch.cuda.is_available():
        print("campaign_run: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    from raft_tla_tpu_torch.campaign.chaos import ChaosMonkey, child_launches
    from raft_tla_tpu_torch.campaign.supervisor import (CampaignPolicy,
                                                        CampaignSpec,
                                                        Supervisor)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    cfg = work / "MC5s2v-NoTwoLeaders.cfg"
    cfg.write_text(CFG.read_text().replace(
        "INVARIANTS NoTwoLeaders CommittedWithinLog",
        "INVARIANTS NoTwoLeaders"))
    spec = CampaignSpec(cfg_path=str(cfg), spec="election", chunk=4096,
                        options=OPTIONS,
                        extra_args=("--retention", "frontier"))
    policy = CampaignPolicy(checkpoint_every_s=EVERY_S,
                            session_wall_s=SESSION_WALL_S,
                            max_resumes=MAX_RESUMES,
                            backoff_base_s=0.0, grace_s=120.0,
                            stale_after_s=600.0)
    monkey = ChaosMonkey(kills=KILL)
    spawned = {}

    def on_spawn(sup, proc, attempt):
        spawned[proc.pid] = (attempt, time.time())
        monkey.spawn_hook(sup, proc, attempt)

    sup = Supervisor(spec, str(work), policy=policy, spawn_hook=on_spawn,
                     pre_verify_hook=monkey.pre_verify_hook)
    progress = Progress(sup.events_path)
    t0 = time.monotonic()
    res = sup.run()
    wall = time.monotonic() - t0
    progress.close()
    # the largest reaped child's peak resident set (KiB on Linux)
    peak_rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    if args.logs:
        Path(args.logs).mkdir(parents=True, exist_ok=True)
        for name in ("run.events", "supervisor.events"):
            shutil.copy2(work / name, Path(args.logs) / name)

    evs = [json.loads(ln) for ln in open(sup.events_path)]
    ref = level_ends(json.loads(ln) for ln in REFERENCE.read_text()
                     .splitlines() if ln.startswith("{"))
    got = level_ends(e for e in evs if e["event"] == "segment")
    bad = 0
    prev = None
    print(f"{'level':>5} {'orbits':>12} {'= JAX':>6} {'orbits/s':>10}")
    for lv in sorted(got):
        n, ts = got[lv]
        same = "-" if lv not in ref else str(ref[lv][0] == n)
        bad += same == "False"
        rate = (n - prev[0]) / max(ts - prev[1], 1e-9) if prev else 0.0
        print(f"{lv:>5} {n:>12} {same:>6} {rate:>10.0f}")
        prev = (n, ts)
    lives, cur = [], None
    for e in evs:
        if e["event"] == "run_start":
            cur = {"pid": e["pid"], "resumed_at": e.get("n_states", 1),
                   "start_s": e["ts"] - spawned[e["pid"]][1],
                   "reached": e.get("n_states", 1), "end": None}
            lives.append(cur)
        elif cur is not None and e["event"] in ("segment", "checkpoint"):
            cur["reached"] = max(cur["reached"], e.get("n_states", 0))
        elif cur is not None and e["event"] == "run_end":
            cur["end"] = e["outcome"]
    launches = child_launches(str(work))
    for k, life in enumerate(lives):
        redone = lives[k - 1]["reached"] - life["resumed_at"] if k else 0
        print(f"child {k} (pid {life['pid']}): resumed at "
              f"{life['resumed_at']} orbits, spawn to run_start "
              f"{life['start_s']:.1f} s, reached {life['reached']}, run_end "
              f"{life['end']}, states redone from the previous child at "
              f"most {redone}, kernel launches "
              f"{launches[k] if k < len(launches) else None}")
    print(f"campaign {res.outcome} after {res.attempts} children "
          f"({res.preempts} preempted, kills {monkey.fired}); deepest "
          f"completed level {max(got) if got else 0}; wall {wall:.1f} s; "
          f"K1 launches of the children that reported "
          f"{sum(n['step'] for n in launches if n)}; "
          f"peak child RSS {peak_rss / 2**20:.2f} GiB; on {card}")
    ok_end = res.outcome in ("gave-up", "ok")
    return 1 if bad or not ok_end or not monkey.fired else 0


if __name__ == "__main__":
    sys.exit(main())
