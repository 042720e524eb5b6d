"""Merge per-process event logs into one clock-aligned timeline.

A traced run leaves a *set* of JSONL logs behind: one per tenant engine
(``{job_id}.events``), one per scheduler process (``sched-{pid}.events``),
plus the supervision logs (``pool.events`` / ``supervisor.events``).
Each process stamped a wall/monotonic anchor pair into its ``run_start``
(obs/trace.clock_anchor), and each span carries a *monotonic* ``t0``
valid only in its own process.  This module is the one place that knows
how to put them all on a single wall-clock axis:

    abs_ts = anchor.wall + (t0 - anchor.mono)

with the alignment error bounded by the recorded ``anchor.err_s`` (the
width of the anchor's wall read).  Logs written without an anchor (pre-v8
producers, or tracing layered onto an untraced resume) degrade to the
span event's own append timestamp: ``abs_ts = ts - dur`` — correct to
within the EventLog queue latency, and flagged in the collection so the
report can say which processes are on the degraded clock.

The collection is a plain dict (processes / spans / instants / counters)
consumed by obs/perfetto.py (Chrome ``trace_event`` export) and by
:func:`report` (wall attribution, device-idle gaps, per-level critical
path) — and by ``raft-tla-monitor``'s directory mode, which reuses
:func:`find_logs` to sweep a fleet.
"""

from __future__ import annotations

import json
import os

# Events rendered as instants on the merged timeline: the lifecycle
# marks worth seeing against the span tracks.
_INSTANTS = frozenset({
    "violation", "stop_requested", "checkpoint", "preempt",
    "resume_attempt", "worker_spawn", "worker_lost", "job_retry",
    "quarantine", "run_end",
})


def find_logs(root: str) -> list:
    """Every ``*.events`` file under ``root`` (sorted; recursive), or
    ``[root]`` itself when it is a file — the fleet sweep used by both
    the trace collector and the monitor's directory mode."""
    if os.path.isfile(root):
        return [root]
    found = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            if fn.endswith(".events"):
                found.append(os.path.join(dirpath, fn))
    return sorted(found)


class LogTail:
    """Incremental JSONL tailer: byte-offset resume, partial-line safe
    (a half-written line stays buffered until its newline lands), and
    truncation-aware — a log rewritten/rotated underneath us (file
    shrank below our offset) resets the tail to the start of the new
    content instead of reading from a stale offset forever.

    Grew up as ``campaign/supervisor._LogTail`` (the health watch);
    now shared with the serve supervision tails and the metrics
    aggregator's per-log reducers (obs/metrics.py), which is why it
    lives here next to :func:`find_logs`.
    """

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._buf = ""

    def seek_end(self) -> None:
        try:
            self._pos = os.path.getsize(self.path)
        except OSError:
            self._pos = 0
        self._buf = ""

    def poll(self) -> list:
        try:
            if os.path.getsize(self.path) < self._pos:
                self._pos = 0            # truncated under us: re-anchor
                self._buf = ""
            with open(self.path, "r", encoding="utf-8") as f:
                f.seek(self._pos)
                chunk = f.read()
                self._pos = f.tell()
        except OSError:
            return []
        if not chunk:
            return []
        self._buf += chunk
        out = []
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue                 # torn line: a crash mid-append
            if isinstance(d, dict):
                out.append(d)
        return out


def _read_events(path: str) -> tuple:
    """(events, n_invalid): parsed JSONL rows with an ``event`` field.

    Validation here is deliberately shallow (is it JSON, is it an event
    dict) — the collector must merge logs from MIXED schema versions
    (a v2 pool.events next to v8 tenant logs), so the strict per-version
    gate of ``validate_event`` is the producer's contract, not the
    reader's.
    """
    events, invalid = [], 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                invalid += 1
                continue
            if not isinstance(d, dict) or "event" not in d:
                invalid += 1
                continue
            events.append(d)
    return events, invalid


def collect(paths: list) -> dict:
    """Merge event logs into one clock-aligned collection.

    Returns::

        {"processes": [{"pid", "os_pid", "label", "log", "engine",
                        "anchored", "skew_bound_s",
                        "threads": [...]}, ...],
         "spans":     [{"pid", "thread", "name", "ts", "dur",
                        "span_id", "parent_id", "args"}, ...],
         "instants":  [{"pid", "name", "ts", "args"}, ...],
         "counters":  [{"pid", "name", "ts", "value"}, ...],
         "levels":    [{"pid", "level", "ts", "n_states"}, ...],
         "t_min", "t_max", "skew_bound_s", "n_invalid", "n_logs"}

    ``ts`` everywhere is absolute wall seconds; ``skew_bound_s`` is the
    worst recorded anchor error across anchored processes (cross-process
    ordering tighter than this is not meaningful).

    Each LOG becomes one timeline row: ``pid`` is a synthetic 1-based
    display id (unique per log — span/parent ids are per-producer, so
    two logs written by the same OS process must not share a rendered
    track space), and ``os_pid`` is the pid the log recorded (None for
    pre-v8 logs).  A serve worker therefore shows as two rows — its
    scheduler (``sched sched-1234.events``) and each tenant engine —
    sharing an ``os_pid``, which the label carries for correlation.
    """
    processes: list = []
    spans: list = []
    instants: list = []
    counters: list = []
    levels: list = []
    n_invalid = 0

    for path in paths:
        events, bad = _read_events(path)
        n_invalid += bad
        if not events:
            continue

        starts = [e for e in events if e["event"] == "run_start"]
        anchor = None
        engine = "?"
        os_pid = None
        for s in starts:
            engine = s.get("engine", engine)
            if s.get("pid") is not None:
                os_pid = int(s["pid"])
            if isinstance(s.get("anchor"), dict):
                anchor = s["anchor"]
        pid = len(processes) + 1
        label = f"{engine} {os.path.basename(path)}"
        if os_pid is not None:
            label += f" (os pid {os_pid})"
        proc = {"pid": pid, "os_pid": os_pid, "label": label,
                "log": path, "engine": engine,
                "anchored": anchor is not None,
                "skew_bound_s": (float(anchor["err_s"])
                                 if anchor else None),
                "threads": []}
        processes.append(proc)
        threads = proc["threads"]

        for e in events:
            ev = e["event"]
            if ev == "span":
                dur = float(e["dur"])
                if anchor is not None:
                    ts = (float(anchor["wall"])
                          + (float(e["t0"]) - float(anchor["mono"])))
                elif e.get("ts") is not None:
                    # degraded clock: the append stamp minus duration
                    ts = float(e["ts"]) - dur
                else:
                    continue  # unplaceable: no anchor, no append stamp
                thread = e.get("thread", "main")
                if thread not in threads:
                    threads.append(thread)
                spans.append({"pid": pid, "thread": thread,
                              "name": e["name"], "ts": ts, "dur": dur,
                              "span_id": e.get("span_id"),
                              "parent_id": e.get("parent_id"),
                              "args": e.get("args") or {}})
            elif ev in _INSTANTS and e.get("ts") is not None:
                args = {k: v for k, v in e.items()
                        if k not in ("v", "event", "ts")}
                instants.append({"pid": pid, "name": ev,
                                 "ts": float(e["ts"]), "args": args})
            elif ev == "segment" and e.get("ts") is not None:
                if e.get("inc_states_per_sec") is not None:
                    counters.append(
                        {"pid": pid, "name": "inc_states_per_sec",
                         "ts": float(e["ts"]),
                         "value": float(e["inc_states_per_sec"])})
            elif ev == "level_end" and e.get("ts") is not None:
                levels.append({"pid": pid, "level": int(e["level"]),
                               "ts": float(e["ts"]),
                               "n_states": int(e["n_states"])})

    stamps = ([s["ts"] for s in spans]
              + [s["ts"] + s["dur"] for s in spans]
              + [i["ts"] for i in instants])
    skews = [p["skew_bound_s"] for p in processes
             if p["skew_bound_s"] is not None]
    return {"processes": processes, "spans": spans,
            "instants": instants, "counters": counters,
            "levels": levels,
            "t_min": min(stamps) if stamps else 0.0,
            "t_max": max(stamps) if stamps else 0.0,
            "skew_bound_s": max(skews) if skews else None,
            "n_invalid": n_invalid, "n_logs": len(paths)}


# --------------------------------------------------------------------------
# analysis (``raft-tla-trace report``)


def _merge_intervals(ivals: list) -> list:
    """Coalesce overlapping (start, end) intervals — overlap-safe wall
    attribution (pipelined dispatch spans may interleave)."""
    out: list = []
    for s, e in sorted(ivals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _thread_report(tspans: list) -> dict:
    """Attribution for one (process, thread) track.

    Top-level spans (no parent) carve the track's wall into named work
    and the gaps between them; nested spans refine but never double-
    count.  ``attributed_frac`` is the acceptance metric: the share of
    the track's span wall (first start to last end) covered by named
    top-level spans, the remainder being reported as gaps — so
    attributed + gaps == 1.0 by construction, and the interesting
    number is how much of the wall the *named* side claims.
    """
    top = [s for s in tspans if s["parent_id"] is None]
    if not top:
        top = tspans  # manual-span tracks (tickets/workers) have no stack
    t0 = min(s["ts"] for s in top)
    t1 = max(s["ts"] + s["dur"] for s in top)
    wall = max(1e-9, t1 - t0)
    merged = _merge_intervals([[s["ts"], s["ts"] + s["dur"]] for s in top])
    covered = sum(e - s for s, e in merged)
    gaps = []
    prev = t0
    for s, e in merged:
        if s - prev > 0:
            gaps.append({"ts": prev, "dur": s - prev})
        prev = max(prev, e)
    phases: dict = {}
    counts: dict = {}
    for s in top:
        phases[s["name"]] = phases.get(s["name"], 0.0) + s["dur"]
        counts[s["name"]] = counts.get(s["name"], 0) + 1
    return {"wall_s": wall, "t0": t0, "t1": t1,
            "attributed_s": covered,
            "attributed_frac": covered / wall,
            "phases": {k: {"total_s": v, "n": counts[k],
                           "frac": v / wall}
                       for k, v in sorted(phases.items(),
                                          key=lambda kv: -kv[1])},
            "gap_s": wall - covered,
            "gap_frac": (wall - covered) / wall,
            "largest_gaps": sorted(gaps, key=lambda g: -g["dur"])[:5]}


def _level_critical_path(col: dict, proc: dict, threads: dict) -> list:
    """Per-level summary for one process: each level's wall (between
    consecutive ``level_end`` stamps) and its dominant main-track phase
    — the critical-path row the report prints per level."""
    marks = sorted((lv for lv in col["levels"]
                    if lv["pid"] == proc["pid"]),
                   key=lambda lv: lv["ts"])
    if not marks:
        return []
    main = threads.get("MainThread") or threads.get("main")
    tspans = main or []
    out = []
    prev_ts = min((s["ts"] for s in tspans), default=marks[0]["ts"])
    prev_n = 0
    for m in marks:
        window = [s for s in tspans
                  if prev_ts <= s["ts"] < m["ts"]
                  and s["parent_id"] is None]
        acc: dict = {}
        for s in window:
            acc[s["name"]] = acc.get(s["name"], 0.0) + s["dur"]
        dom = max(acc.items(), key=lambda kv: kv[1]) if acc else None
        out.append({"level": m["level"],
                    "wall_s": m["ts"] - prev_ts,
                    "new_states": m["n_states"] - prev_n,
                    "dominant_phase": dom[0] if dom else None,
                    "dominant_s": dom[1] if dom else 0.0})
        prev_ts, prev_n = m["ts"], m["n_states"]
    return out


def report(col: dict) -> dict:
    """Wall attribution over a collection: per process, per thread —
    named-phase totals, idle gaps, and the per-level critical path."""
    by_track: dict = {}
    for s in col["spans"]:
        by_track.setdefault(s["pid"], {}).setdefault(
            s["thread"], []).append(s)
    procs = []
    for proc in col["processes"]:
        threads = by_track.get(proc["pid"], {})
        procs.append({
            "pid": proc["pid"], "os_pid": proc["os_pid"],
            "label": proc["label"],
            "anchored": proc["anchored"],
            "skew_bound_s": proc["skew_bound_s"],
            "threads": {name: _thread_report(tspans)
                        for name, tspans in sorted(threads.items())},
            "levels": _level_critical_path(col, proc, threads),
        })
    return {"processes": procs,
            "t_min": col["t_min"], "t_max": col["t_max"],
            "wall_s": col["t_max"] - col["t_min"],
            "skew_bound_s": col["skew_bound_s"],
            "n_invalid": col["n_invalid"], "n_logs": col["n_logs"]}


def render_report(rep: dict) -> str:
    """The human rendering of :func:`report` (the CLI's default)."""
    lines = [f"trace: {rep['n_logs']} log(s), "
             f"wall {rep['wall_s']:.3f}s"
             + (f", cross-process skew bound "
                f"{rep['skew_bound_s'] * 1e6:.0f}us"
                if rep["skew_bound_s"] is not None else "")
             + (f"  [{rep['n_invalid']} invalid lines]"
                if rep["n_invalid"] else "")]
    for proc in rep["processes"]:
        clock = "" if proc["anchored"] else "  [degraded clock: no anchor]"
        lines.append(f"\n{proc['label']}{clock}")
        for tname, tr in proc["threads"].items():
            lines.append(
                f"  {tname}: {tr['wall_s']:.3f}s wall, "
                f"{100 * tr['attributed_frac']:.1f}% attributed, "
                f"{100 * tr['gap_frac']:.1f}% gaps")
            for pname, ph in tr["phases"].items():
                lines.append(
                    f"    {pname:<14} {ph['total_s']:8.3f}s "
                    f"{100 * ph['frac']:5.1f}%  x{ph['n']}")
            for g in tr["largest_gaps"][:3]:
                lines.append(f"    (gap)          {g['dur']:8.3f}s "
                             f"at +{g['ts'] - rep['t_min']:.3f}s")
        for lv in proc["levels"]:
            dom = (f"{lv['dominant_phase']} {lv['dominant_s']:.3f}s"
                   if lv["dominant_phase"] else "-")
            lines.append(f"  L{lv['level']}: {lv['wall_s']:.3f}s, "
                         f"+{lv['new_states']:,} states, "
                         f"critical: {dom}")
    return "\n".join(lines)
