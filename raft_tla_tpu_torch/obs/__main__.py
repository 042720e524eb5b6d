"""``python -m raft_tla_tpu_torch.obs`` — external event emission and the
monitor; the port's copy of ``raft_tla_tpu/obs/__main__.py``.

``emit`` appends one schema-validated event to a run log from outside
the engine process — a stop script stamps ``stop_requested`` this way
before signaling, so a reader can attribute a clean stop vs a crash vs a
raw SIGINT.  ``monitor`` is an alias for ``raft-tla-monitor-torch``.
"""

from __future__ import annotations

import argparse
import sys

from raft_tla_tpu_torch.obs import events as _events


def _parse_field(kv: str):
    """k=v extra fields; values parse as JSON when possible, else str."""
    import json
    if "=" not in kv:
        raise argparse.ArgumentTypeError(f"expected k=v, got {kv!r}")
    k, v = kv.split("=", 1)
    try:
        return k, json.loads(v)
    except ValueError:
        return k, v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m raft_tla_tpu_torch.obs")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("emit", help="append one validated event to a log")
    pe.add_argument("path")
    pe.add_argument("event", help="event type (e.g. stop_requested)")
    pe.add_argument("--reason", help="stop_requested reason")
    pe.add_argument("--source", help="who emitted (e.g. campaign_stop.sh)")
    pe.add_argument("--pid", type=int, help="target process id")
    pe.add_argument("--field", action="append", type=_parse_field,
                    default=[], metavar="K=V",
                    help="extra schema field (JSON-parsed when possible)")

    pm = sub.add_parser("monitor", help="alias for raft-tla-monitor-torch")
    pm.add_argument("rest", nargs=argparse.REMAINDER)

    args = p.parse_args(argv)
    if args.cmd == "monitor":
        from raft_tla_tpu_torch.obs import monitor
        return monitor.main(args.rest)

    fields = dict(args.field)
    for k in ("reason", "source", "pid"):
        v = getattr(args, k)
        if v is not None:
            fields[k] = v
    try:
        _events.append_event(args.path, args.event, **fields)
    except ValueError as e:
        print(f"obs emit: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
