"""Chrome ``trace_event`` JSON export of a merged trace collection.

The output loads in Perfetto (ui.perfetto.dev) and legacy
``chrome://tracing``: one process row per event log, one track per
recorded thread (engine main thread, ``raft-tla-flush``,
``raft-tla-prefetch``, and the synthetic ``tickets`` / ``workers`` /
``children`` tracks), complete (``X``) events for spans, instant
(``i``) events for lifecycle marks, and counter (``C``) rows for the
per-tenant incremental state rate.

Timestamps are microseconds rebased to the collection's ``t_min`` —
Perfetto renders absolute epoch-µs fine, but rebasing keeps the
numbers readable and the JSON compact.  Thread *names* become stable
synthetic tids (per process, in first-seen order, main-ish tracks
first) because the format wants integers; the ``thread_name`` metadata
rows carry the real names.
"""

from __future__ import annotations

import json


def _us(ts: float, t_min: float) -> float:
    return round((ts - t_min) * 1e6, 1)


def _tid_map(threads: list) -> dict:
    """Thread name -> synthetic tid.  Main thread first (tid 1), then
    the rest in recorded order — stable across exports of one run."""
    names = sorted(threads,
                   key=lambda n: (n not in ("MainThread", "main"),
                                  threads.index(n)))
    return {name: i + 1 for i, name in enumerate(names)}


def to_trace_events(col: dict) -> list:
    """The ``traceEvents`` list for a collection (see module doc)."""
    t_min = col["t_min"]
    out: list = []
    tids: dict = {}
    for proc in col["processes"]:
        pid = proc["pid"]
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "args": {"name": proc["label"]}})
        tmap = _tid_map(proc["threads"])
        tids[pid] = tmap
        for tname, tid in sorted(tmap.items(), key=lambda kv: kv[1]):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
    for s in col["spans"]:
        tid = tids.get(s["pid"], {}).get(s["thread"], 0)
        ev = {"ph": "X", "name": s["name"], "pid": s["pid"],
              "tid": tid, "ts": _us(s["ts"], t_min),
              "dur": round(s["dur"] * 1e6, 1), "cat": "span"}
        if s["args"]:
            ev["args"] = s["args"]
        out.append(ev)
    for i in col["instants"]:
        out.append({"ph": "i", "name": i["name"], "pid": i["pid"],
                    "tid": 0, "ts": _us(i["ts"], t_min), "s": "p",
                    "cat": "lifecycle", "args": i["args"]})
    for c in col["counters"]:
        out.append({"ph": "C", "name": c["name"], "pid": c["pid"],
                    "tid": 0, "ts": _us(c["ts"], t_min),
                    "args": {c["name"]: c["value"]}})
    return out


def export(col: dict, path: str) -> int:
    """Write the collection as Chrome trace JSON; returns the event
    count.  ``displayTimeUnit: ms`` suits model-checker span scales."""
    events = to_trace_events(col)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(doc, fh, separators=(",", ":"))
        fh.write("\n")
    return len(events)
