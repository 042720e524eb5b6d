"""Fault injection for the campaign supervisor — the chaos harness; the
port's copy of ``raft_tla_tpu/campaign/chaos.py``.

:class:`ChaosMonkey` plugs into the two seams :class:`Supervisor`
exposes and injects the faults a real campaign meets:

- **kills** — a watcher thread tails the tenant event log and, on the
  k-th ``checkpoint`` event of a chosen attempt, SIGKILLs the child
  (``"kill"``) or races a SIGINT with an almost-immediate SIGKILL
  (``"int-race"``: the graceful path starts but never finishes).
  Keying on checkpoint events makes the kill point deterministic in
  *state space position* — with ``checkpoint_every_s=0`` the engines
  snapshot at every window boundary, so "die after the k-th snapshot"
  is reproducible regardless of wall-clock jitter.
- **truncations** — before the supervisor's pre-resume verify of a
  chosen attempt, truncate one family member (the metadata npz or any
  stream) to a fraction of its size: the torn-snapshot shape a dying
  filesystem leaves behind.  The supervisor must detect it
  (:class:`CheckpointCorrupt`), quarantine it, and restore an earlier
  generation — without operator input.

Every kill point is also *classified* from the surviving snapshot
(``boundary``: the snapshot landed exactly on a completed level end;
``mid-level``: a partial next level is on disk), so a chaos test can
assert it exercised both resume shapes rather than hoping.

``python -m raft_tla_tpu_torch.campaign.chaos`` is the self-contained smoke:
run a toy campaign twice — uninterrupted, then with a SIGKILL mid-run —
and fail unless final ``n_states`` / ``n_transitions`` / verdict are
identical.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import signal
import sys
import threading
import time

import numpy as np

from raft_tla_tpu_torch.campaign.supervisor import (CampaignPolicy,
                                                    CampaignSpec,
                                                    Supervisor, _LogTail)


class ChaosMonkey:
    """Deterministic fault schedule for one campaign.

    ``kills``: ``{attempt: (kind, when)}`` — on attempt *a*, fire at a
    ``checkpoint`` event; ``kind`` is ``"kill"`` (SIGKILL) or
    ``"int-race"`` (SIGINT then SIGKILL 50 ms later); ``when`` is an
    int (the n-th checkpoint) or ``"boundary"`` / ``"mid-level"`` (the
    first checkpoint whose state count does / does not sit exactly on
    the last completed level end — the two resume shapes).
    ``truncations``: ``{attempt: suffix}`` — before attempt *a*'s
    verify, truncate family member ``ckpt + suffix`` (``""`` = the
    metadata npz itself).
    """

    def __init__(self, kills: dict | None = None,
                 truncations: dict | None = None):
        self.kills = dict(kills or {})
        self.truncations = dict(truncations or {})
        self._lock = threading.Lock()    # guards `fired` (stalker threads)
        self.fired: list = []            # (attempt, kind, nth)
        self.observed: list = []         # (attempt, n_states, kind)
        self.truncated: list = []        # (attempt, path, new_size)

    # -- Supervisor seams ---------------------------------------------------

    def spawn_hook(self, sup: Supervisor, proc, attempt: int) -> None:
        plan = self.kills.pop(attempt, None)
        if plan is None:
            return
        kind, nth = plan
        t = threading.Thread(target=self._stalk, daemon=True,
                             args=(sup.events_path, proc, attempt,
                                   kind, nth))
        t.start()

    def pre_verify_hook(self, sup: Supervisor, attempt: int) -> None:
        self._observe(sup, attempt)
        suffix = self.truncations.pop(attempt, None)
        if suffix is None:
            return
        path = sup.ckpt + suffix
        size = os.path.getsize(path)
        new = max(1, size // 3)
        with open(path, "r+b") as f:
            f.truncate(new)
        self.truncated.append((attempt, path, new))

    # -- internals ----------------------------------------------------------

    def _stalk(self, events_path: str, proc, attempt: int, kind: str,
               when) -> None:
        tail = _LogTail(events_path)
        tail.seek_end()
        seen = 0
        level_end_n = None
        while proc.poll() is None:
            for e in tail.poll():
                ev = e.get("event")
                if ev == "level_end":
                    level_end_n = e.get("n_states")
                if ev != "checkpoint":
                    continue
                seen += 1
                if isinstance(when, int):
                    hit = seen >= when
                else:
                    at_boundary = (e.get("n_states") is not None
                                   and e.get("n_states") == level_end_n)
                    hit = at_boundary if when == "boundary" \
                        else not at_boundary
                if not hit:
                    continue
                try:
                    if kind == "int-race":
                        proc.send_signal(signal.SIGINT)
                        time.sleep(0.05)
                    proc.kill()
                except ProcessLookupError:
                    pass
                with self._lock:
                    self.fired.append((attempt, kind, seen))
                return
            time.sleep(0.02)

    def _observe(self, sup: Supervisor, attempt: int) -> None:
        """Classify the surviving snapshot's resume shape."""
        try:
            with np.load(sup.ckpt) as z:
                n_states = int(z["n_states"])
                ends = [int(x) for x in np.atleast_1d(z["level_ends"])]
        except Exception:
            return                       # torn npz: the verify will say so
        kind = "boundary" if ends and n_states == ends[-1] else "mid-level"
        self.observed.append((attempt, n_states, kind))

    def kill_kinds(self) -> set:
        """Resume shapes actually exercised (``boundary``/``mid-level``)."""
        return {kind for _, _, kind in self.observed}


def final_record(events_path: str) -> dict | None:
    """The last ``run_end`` of a tenant log — the comparable final."""
    tail = _LogTail(events_path)
    ends = [e for e in tail.poll() if e.get("event") == "run_end"]
    return ends[-1] if ends else None


def child_launches(workdir: str) -> list:
    """Per child, in spawn order: the kernel launches it reported at its
    end (the ``Kernel launches:`` line a run on the card writes to its
    output), or None for a child that left no report (one killed by a
    signal)."""
    out = []
    for f in sorted(glob.glob(os.path.join(workdir, "attempt*.out"))):
        with open(f, errors="replace") as fh:
            m = re.findall(r"^Kernel launches: step (\d+), fingerprint "
                           r"(\d+)$", fh.read(), re.M)
        out.append({"step": int(m[-1][0]), "fingerprint": int(m[-1][1])}
                   if m else None)
    return out


def run_reference(spec: CampaignSpec, workdir: str,
                  quiet: bool = True) -> dict:
    """One uninterrupted campaign (no chaos, single mesh) — the ground
    truth the chaos run must match byte-for-byte on finals."""
    sup = Supervisor(spec, workdir,
                     policy=CampaignPolicy(checkpoint_every_s=0.0,
                                           max_resumes=0),
                     quiet=quiet)
    res = sup.run()
    if res.outcome not in ("ok", "deadlock", "violation", "liveness"):
        raise RuntimeError(
            f"reference campaign did not finish: {res.outcome} "
            f"({res.detail})")
    end = final_record(sup.events_path)
    return {"outcome": res.outcome, "n_states": end["n_states"],
            "n_transitions": end["n_transitions"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raft_tla_tpu_torch.campaign.chaos",
        description="Chaos smoke: a toy campaign survives a SIGKILL "
                    "mid-run and lands on finals identical to an "
                    "uninterrupted run.")
    p.add_argument("cfg", help="TLC .cfg of a small model")
    p.add_argument("--workdir", required=True)
    p.add_argument("--spec", default="full")
    p.add_argument("--window", type=int, default=128)
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--cap", type=int, default=1 << 14)
    p.add_argument("--max-term", type=int, default=None)
    p.add_argument("--max-log", type=int, default=None)
    p.add_argument("--max-msgs", type=int, default=None)
    p.add_argument("--kill-after", type=int, default=2, metavar="K",
                   help="SIGKILL after the K-th checkpoint event "
                        "(default 2)")
    p.add_argument("--mesh-plan", default="1",
                   help="comma-separated ndev per attempt (default 1; "
                        "above 1 is refused, ROADMAP.md queue A item 11 "
                        "(b))")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the children run (default: cuda)")
    p.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.cpu:
        p.error("--cpu is spelled --device cpu in raft_tla_tpu_torch")
    try:
        plan = [int(x) for x in args.mesh_plan.split(",")]
    except ValueError:
        p.error(f"--mesh-plan {args.mesh_plan!r}: comma-separated integers")
    if any(n != 1 for n in plan):
        p.error(f"--mesh-plan {args.mesh_plan}: raft_tla_tpu_torch runs a "
                "campaign on one card; the ddd-shard engine is not ported "
                "yet (ROADMAP.md queue A: item 11 (b), the DDD shard engine "
                "and CP lanes)")

    options = {k: getattr(args, k)
               for k in ("max_term", "max_log", "max_msgs")
               if getattr(args, k) is not None}
    spec = CampaignSpec(cfg_path=args.cfg, spec=args.spec,
                        window=args.window, chunk=args.chunk,
                        cap=args.cap, options=options,
                        cpu=args.device == "cpu")
    ref = run_reference(spec, os.path.join(args.workdir, "ref"))
    print(f"reference: {ref['outcome']}, {ref['n_states']:,} states, "
          f"{ref['n_transitions']:,} transitions")

    monkey = ChaosMonkey(kills={0: ("kill", args.kill_after)})
    sup = Supervisor(spec, os.path.join(args.workdir, "chaos"),
                     policy=CampaignPolicy(checkpoint_every_s=0.0,
                                           backoff_base_s=0.0,
                                           grace_s=5.0, poll_s=0.05),
                     mesh_plan=plan, spawn_hook=monkey.spawn_hook,
                     pre_verify_hook=monkey.pre_verify_hook, quiet=False)
    res = sup.run()
    end = final_record(sup.events_path)
    got = {"outcome": res.outcome,
           "n_states": end["n_states"] if end else None,
           "n_transitions": end["n_transitions"] if end else None}
    print(f"chaos: {got['outcome']} after {res.attempts} attempt(s), "
          f"kills fired {monkey.fired}, kill points {monkey.observed}")
    if not monkey.fired:
        print("FAIL: the kill never fired (run too short for "
              f"--kill-after {args.kill_after}?)", file=sys.stderr)
        return 1
    if got != ref:
        print(f"FAIL: finals diverge: chaos {got} != reference {ref}",
              file=sys.stderr)
        return 1
    print("chaos smoke OK: finals identical to the uninterrupted run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
