"""``raft-tla-trace-torch`` (``python -m raft_tla_tpu_torch.obs.tracecli``)
— merge, export, and analyze trace collections; the port's copy of
``raft_tla_tpu/obs/tracecli.py``.

Three subcommands over the logs a ``--trace`` run leaves behind:

- ``collect PATH...`` — merge the logs (files or directories, swept
  recursively for ``*.events``) and print the collection summary: which
  processes were found, whether each is anchored, span/instant counts,
  the cross-process skew bound.
- ``export PATH... -o trace.json`` — the same merge, written as Chrome
  ``trace_event`` JSON for ui.perfetto.dev / chrome://tracing.
- ``report PATH...`` — wall attribution: per process and thread, named-
  phase totals and idle gaps; per level, the critical-path summary.
  ``--json`` prints the machine form.

Typical flow after a traced campaign::

    python -m raft_tla_tpu_torch.campaign CFG --workdir runs/c1 ...
    python -m raft_tla_tpu_torch.obs.tracecli export runs/c1 -o trace.json
    python -m raft_tla_tpu_torch.obs.tracecli report runs/c1

(``RAFT_TLA_TRACE=1`` in the supervisor's environment traces it and its
children.)
"""

from __future__ import annotations

import argparse
import json
import sys

from raft_tla_tpu_torch.obs import collect as _collect
from raft_tla_tpu_torch.obs import perfetto as _perfetto


def _gather(paths: list) -> list:
    logs: list = []
    for p in paths:
        logs.extend(_collect.find_logs(p))
    # dedupe, keep order: a dir arg plus an explicit file inside it
    seen: set = set()
    out = []
    for p in logs:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def _summary(col: dict) -> str:
    lines = [f"collected {col['n_logs']} log(s): "
             f"{len(col['spans'])} spans, "
             f"{len(col['instants'])} instants, "
             f"{len(col['counters'])} counter samples"
             + (f", skew bound {col['skew_bound_s'] * 1e6:.0f}us"
                if col["skew_bound_s"] is not None else "")
             + (f"  [{col['n_invalid']} invalid lines]"
                if col["n_invalid"] else "")]
    for proc in col["processes"]:
        n = sum(1 for s in col["spans"] if s["pid"] == proc["pid"])
        clock = "anchored" if proc["anchored"] else "NO ANCHOR"
        lines.append(f"  {proc['label']} ({clock}): {n} spans on "
                     f"{len(proc['threads'])} thread track(s)")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raft_tla_tpu_torch.obs.tracecli",
        description="Merge --trace event logs into one clock-aligned "
                    "timeline; export to Perfetto or attribute the "
                    "wall.")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("collect",
                        help="merge logs; print the collection summary")
    pc.add_argument("paths", nargs="+", metavar="PATH",
                    help="event logs or directories (swept for "
                         "*.events)")
    pc.add_argument("--json", action="store_true",
                    help="print the full collection as JSON")

    px = sub.add_parser("export",
                        help="write Chrome trace_event JSON "
                             "(ui.perfetto.dev)")
    px.add_argument("paths", nargs="+", metavar="PATH")
    px.add_argument("-o", "--out", default="trace.json",
                    help="output path (default trace.json)")

    pr = sub.add_parser("report",
                        help="wall attribution: phases, gaps, per-level "
                             "critical path")
    pr.add_argument("paths", nargs="+", metavar="PATH")
    pr.add_argument("--json", action="store_true",
                    help="print the machine-readable report")

    args = p.parse_args(argv)
    logs = _gather(args.paths)
    if not logs:
        print("tracecli: no *.events logs found", file=sys.stderr)
        return 1
    col = _collect.collect(logs)

    if args.cmd == "collect":
        if args.json:
            print(json.dumps(col))
        else:
            print(_summary(col))
        return 0
    if args.cmd == "export":
        n = _perfetto.export(col, args.out)
        print(f"wrote {args.out}: {n} trace events from "
              f"{col['n_logs']} log(s)")
        return 0
    rep = _collect.report(col)
    if args.json:
        print(json.dumps(rep))
    else:
        print(_collect.render_report(rep))
    return 0


def entry() -> None:
    sys.exit(main())


if __name__ == "__main__":
    entry()
