"""``raft-tla-regress-torch`` — the cross-run regression sentinel CLI; the
port's copy of ``raft_tla_tpu/obs/regress.py``.

Three subcommands over :mod:`raft_tla_tpu_torch.obs.history`:

``ingest FILES... --history PATH``
    Seed/extend the history store from recorded artifacts:
    ``BENCH_r0*.json`` driver files, raw bench ``parsed`` JSON,
    ``*.events`` logs (``run_start`` fiducials + ``run_end`` summary),
    or a JSONL of history records.

``check FILE --history PATH [--drift-max R]``
    Compare one artifact against the per-field **median** baseline of
    its config key and emit a machine-readable verdict line.  Exit
    codes are the CI contract: 0 within tolerance, 3 no baseline for
    this key, 4 drift.

``ab FILE [--gate R]``
    Verdict an ``runs/*_ab.out`` harness summary directly: every
    ``*_over_off`` key (wall ratio — drift when > gate) and every
    ``on_vs_off_*`` key (rate ratio — drift when < 1/gate) found in
    the file's JSON lines, so the recorded RESULTS.md verdicts (e.g.
    the devdedup 0.44x warm-rate refutation) reproduce mechanically.

The drift policy is the shared one (:func:`obs.history.drift_report`,
``_DRIFT_EXEMPT`` honored) — the same comparison the campaign
supervisor's health watch runs live.
"""

from __future__ import annotations

import argparse
import json
import sys

from raft_tla_tpu_torch.obs.history import (HistoryStore, drift_report,
                                            history_path, ingest_file)

EXIT_OK = 0
EXIT_USAGE = 2
EXIT_NO_BASELINE = 3
EXIT_DRIFT = 4


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raft-tla-regress-torch",
        description="compare runs against recorded fiducial history")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("ingest", help="seed history from artifacts")
    pi.add_argument("files", nargs="+",
                    help="BENCH_*.json / *.events / record JSONL")
    pi.add_argument("--history", default=None,
                    help="history store path (default: RAFT_TLA_HISTORY)")

    pc = sub.add_parser("check", help="verdict one run vs baseline")
    pc.add_argument("file", help="artifact to check (not appended)")
    pc.add_argument("--history", default=None,
                    help="history store path (default: RAFT_TLA_HISTORY)")
    pc.add_argument("--drift-max", type=float, default=1.5,
                    help="tolerated regression ratio (default 1.5)")
    pc.add_argument("--json", action="store_true",
                    help="include the full per-key table in the verdict")

    pa = sub.add_parser("ab", help="verdict an A/B harness summary")
    pa.add_argument("file", help="runs/*_ab.out summary file")
    pa.add_argument("--gate", type=float, default=1.5,
                    help="tolerated ratio: wall keys drift above this, "
                         "rate keys below its inverse (default 1.5)")
    return p


def _emit(verdict: dict) -> None:
    sys.stdout.write(json.dumps(verdict, sort_keys=True) + "\n")


def _cmd_ingest(args) -> int:
    path = history_path(args.history)
    if path is None:
        sys.stderr.write("regress ingest: no history store "
                         "(--history or RAFT_TLA_HISTORY)\n")
        return EXIT_USAGE
    store = HistoryStore(path)
    n = 0
    for f in args.files:
        for rec in ingest_file(f):
            store.append(rec)
            n += 1
    _emit({"verdict": "ingested", "records": n,
           "files": len(args.files), "history": path})
    return EXIT_OK


def _cmd_check(args) -> int:
    path = history_path(args.history)
    if path is None:
        sys.stderr.write("regress check: no history store "
                         "(--history or RAFT_TLA_HISTORY)\n")
        return EXIT_USAGE
    recs = ingest_file(args.file)
    if not recs:
        sys.stderr.write(f"regress check: no record parseable from "
                         f"{args.file}\n")
        return EXIT_USAGE
    rec = recs[0]
    base = HistoryStore(path).baseline(rec["key"])
    if base is None:
        _emit({"verdict": "no-baseline", "key": rec["key"],
               "file": args.file, "history": path})
        return EXIT_NO_BASELINE
    rep = drift_report(base, rec.get("parsed") or {}, args.drift_max)
    verdict = {"verdict": "ok" if rep["ok"] else "drift",
               "key": rec["key"], "file": args.file,
               "drift_max": args.drift_max, "worst": rep["worst"],
               "n_keys": len(rep["keys"]),
               "drifted": sorted(k for k, v in rep["keys"].items()
                                 if v["drift"])}
    if args.json:
        verdict["keys"] = rep["keys"]
    _emit(verdict)
    return EXIT_OK if rep["ok"] else EXIT_DRIFT


def _walk_ratios(node, path: str, out: dict) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            sub = f"{path}.{k}" if path else str(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                if k.endswith("_over_off"):
                    out[sub] = ("wall", float(v))
                elif "on_vs_off" in k:
                    out[sub] = ("rate", float(v))
            else:
                _walk_ratios(v, sub, out)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _walk_ratios(v, f"{path}[{i}]", out)


def _cmd_ab(args) -> int:
    ratios: dict = {}
    with open(args.file, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            _walk_ratios(d, "", ratios)
    if not ratios:
        sys.stderr.write(f"regress ab: no *_over_off / on_vs_off_* "
                         f"ratio keys in {args.file}\n")
        return EXIT_USAGE
    keys = {}
    for k, (kind, v) in sorted(ratios.items()):
        # Orient so > 1 is a regression, same convention as check.
        oriented = v if kind == "wall" else (1.0 / v if v > 0
                                             else float("inf"))
        keys[k] = {"kind": kind, "ratio": v,
                   "oriented": round(oriented, 4),
                   "drift": oriented > args.gate}
    drifted = sorted(k for k, v in keys.items() if v["drift"])
    worst = max(keys.items(), key=lambda kv: kv[1]["oriented"])
    _emit({"verdict": "drift" if drifted else "ok", "file": args.file,
           "gate": args.gate, "n_keys": len(keys), "drifted": drifted,
           "worst": [worst[0], worst[1]["oriented"]], "keys": keys})
    return EXIT_DRIFT if drifted else EXIT_OK


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.cmd == "ingest":
        return _cmd_ingest(args)
    if args.cmd == "check":
        return _cmd_check(args)
    return _cmd_ab(args)


def entry() -> None:
    raise SystemExit(main())


if __name__ == "__main__":
    raise SystemExit(main())
