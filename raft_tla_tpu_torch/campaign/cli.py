"""``raft-tla-campaign-torch`` (``python -m raft_tla_tpu_torch.campaign``)
— the unattended-campaign front; the port's copy of
``raft_tla_tpu/campaign/cli.py``.

One command supervises a whole check campaign: admission, child spawns,
health monitoring, lossless preemption, checkpoint verification,
quarantine and bounded resume — everything
:class:`~raft_tla_tpu_torch.campaign.supervisor.Supervisor` does, with the
policy knobs as flags.  SIGUSR1 to the supervisor is an external
preemption notice (a scheduler's eviction warning): the child is
stopped losslessly and the campaign resumes on the next allocation.

Exit codes mirror the check CLI's: 0 verdict-ok, 11 deadlock,
12 violation, 13 liveness, 1 rejected / gave up / error.  The reference's
``--cpu`` is ``--device cpu`` here.  ``--metrics-port`` exposes the live
OpenMetrics endpoint over the workdir's event logs (obs/openmetrics.py).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from raft_tla_tpu_torch.campaign.supervisor import (CampaignPolicy,
                                                    CampaignSpec,
                                                    Supervisor)

_OPTION_FLAGS = ("max_term", "max_log", "max_msgs", "max_dup",
                 "max_elections")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_tla_tpu_torch.campaign",
        description="Preemption-tolerant campaign supervisor: run one "
                    "exhaustive check across any number of child "
                    "process lifetimes.")
    p.add_argument("cfg", help="TLC .cfg model config")
    p.add_argument("--spec", default="full",
                   help="compiled spec variant (default: full)")
    p.add_argument("--workdir", required=True, metavar="DIR",
                   help="campaign state directory: checkpoint family, "
                        "run.events, supervisor.events, generations, "
                        "quarantine")
    p.add_argument("--window", type=int, default=1 << 20, metavar="W",
                   help="global frontier window rows — the campaign "
                        "invariant every mesh divides (default 2^20)")
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--levels", type=int, default=256)
    p.add_argument("--cap", type=int, default=1 << 20,
                   help="expected distinct-state total (table sizing)")
    for name in _OPTION_FLAGS:
        p.add_argument("--" + name.replace("_", "-"), type=int,
                       default=None, help=argparse.SUPPRESS)
    p.add_argument("--faithful", action="store_true",
                   help="faithful (full-history) fingerprinting")
    p.add_argument("--symmetry", action="store_true")
    p.add_argument("--deadlock", action="store_true")
    p.add_argument("--mesh-plan", default=None, metavar="N,M,...",
                   help="mesh size per resume attempt, last entry "
                        "repeats (default: one card; above 1 is refused, "
                        "ROADMAP.md queue A item 11 (b))")
    p.add_argument("--checkpoint-every", type=float, default=120.0,
                   metavar="S", help="child snapshot period; 0 = every "
                                     "window boundary (default 120)")
    p.add_argument("--session-wall", type=float, default=None,
                   metavar="S", help="preempt the child losslessly "
                                     "after S seconds of wall clock")
    p.add_argument("--stale-after", type=float, default=None,
                   metavar="S", help="declare the child unhealthy when "
                                     "its event log goes quiet for S "
                                     "seconds (default: 10x segment "
                                     "cadence, clamped to [30s, 1h])")
    p.add_argument("--drift-max", type=float, default=None, metavar="R",
                   help="preempt when a run_start fiducial exceeds R x "
                        "the campaign's first-run baseline")
    p.add_argument("--max-resumes", type=int, default=8,
                   help="bounded unattended retries (default 8)")
    p.add_argument("--grace", type=float, default=20.0, metavar="S",
                   help="SIGINT -> SIGKILL grace window (default 20)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the children run (default: cuda)")
    p.add_argument("--retention", default=None,
                   choices=("full", "frontier"),
                   help="the children's --retention (default: full)")
    p.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--metrics-port", type=int, default=None, metavar="P",
                   help="expose a live OpenMetrics endpoint on "
                        "127.0.0.1:P (0 = ephemeral port; also via "
                        "RAFT_TLA_METRICS) over the workdir's event "
                        "logs, snapshotted into WORKDIR/metrics.events")
    p.add_argument("--json", action="store_true",
                   help="print the final CampaignResult as JSON")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    p = build_argparser()
    args = p.parse_args(argv)
    if args.cpu:
        p.error("--cpu is spelled --device cpu in raft_tla_tpu_torch")
    options = {}
    for name in _OPTION_FLAGS:
        v = getattr(args, name)
        if v is not None:
            options[name] = v
    for name in ("faithful", "symmetry", "deadlock"):
        if getattr(args, name):
            options[name] = True
    spec = CampaignSpec(cfg_path=args.cfg, spec=args.spec,
                        window=args.window, chunk=args.chunk,
                        levels=args.levels, cap=args.cap,
                        options=options, cpu=args.device == "cpu",
                        extra_args=("--retention", args.retention)
                        if args.retention else ())
    policy = CampaignPolicy(checkpoint_every_s=args.checkpoint_every,
                            stale_after_s=args.stale_after,
                            session_wall_s=args.session_wall,
                            drift_max=args.drift_max,
                            max_resumes=args.max_resumes,
                            grace_s=args.grace)
    plan = None
    if args.mesh_plan:
        plan = [int(x) for x in args.mesh_plan.split(",")]
    sup = Supervisor(spec, args.workdir, policy=policy, mesh_plan=plan,
                     quiet=args.quiet)
    signal.signal(signal.SIGUSR1,
                  lambda *_: sup.request_preempt("preempt-signal",
                                                 "SIGUSR1"))
    from raft_tla_tpu_torch.obs.metrics import metrics_port
    mport = metrics_port(args.metrics_port)
    mserver = None
    if mport is not None:
        # Reads the campaign's own event logs (run.events, the children's
        # logs) from this supervising process; the children never see it.
        from raft_tla_tpu_torch.obs.openmetrics import MetricsServer
        os.makedirs(args.workdir, exist_ok=True)
        mserver = MetricsServer(
            args.workdir, port=mport,
            snapshot_path=os.path.join(args.workdir, "metrics.events"))
        print(f"metrics endpoint: {mserver.url}", flush=True)
    try:
        res = sup.run()
    finally:
        if mserver is not None:
            mserver.close()
    if args.json:
        print(json.dumps(res.__dict__, sort_keys=True))
    elif not args.quiet:
        print(f"campaign {res.outcome}: "
              f"{res.n_states if res.n_states is not None else '?'} "
              f"states across {res.attempts} attempt(s), "
              f"{res.preempts} preempt(s), {res.reshards} reshard(s), "
              f"{len(res.quarantined)} quarantined snapshot(s)")
    return res.exit_code


def entry() -> None:
    """Console-script entry point (pyproject ``raft-tla-campaign-torch``)."""
    sys.exit(main())


if __name__ == "__main__":
    entry()
