"""Campaign monitor — read a run-event log and render a one-line
heartbeat (``raft-tla-monitor-torch``); the port's copy of
``raft_tla_tpu/obs/monitor.py``, which reads the logs of either package.  Point it at a DIRECTORY instead and
it renders the combined fleet view: one heartbeat per ``*.events`` log
found (obs/collect.find_logs does the sweep) plus the aggregate row —
summed incremental rate over live tenants, live/ended/crashed counts,
and the merged pool worker attribution.

The reader is the ONE place that knows how to turn an on-disk stream
into a clean timeline; ``runs/campaign_projection.py`` is a thin client
of :func:`load_stream` instead of carrying its own parsing.  Two stream
dialects are accepted:

- v1 event logs (obs/events.py): JSONL with ``event`` fields.
- legacy ``runs/*.stats`` streams (bare ``on_progress`` dicts, one JSON
  object per line, pre-obs campaigns): lifted to synthetic ``segment``
  events so recorded artifacts like ``elect5ddd_r4_final.stats`` keep
  working.  (The third historical dialect, the space-separated
  ``.telemetry`` columns, is retired — see README.)

Timeline normalisation (formerly campaign_projection.load):

- **wall rebasing** — each process restart resets ``wall_s`` to ~0; a
  drop in ``wall_s`` advances a cumulative offset so ``cum_wall_s`` is a
  single monotone clock across every resume in the file.
- **rollback dropping** — a checkpoint-rollback resume replays counts
  the surviving timeline already passed (r4 has one at L30); segments
  whose reported count sits below the running maximum are dropped from
  the ``segments`` timeline (kept in ``events``).

The heartbeat shows: level, states, incremental rate (trailing window),
ETA (to ``--target``, else to end-of-level from the frontier trend),
phase breakdown (when ``--phase-timers`` ran), fiducial drift vs the
first ``run_start``, heartbeat staleness (time since the last event vs
the run's own segment cadence), and the end-state attribution: a
``run_end`` outcome; else "live" when events are still arriving on
cadence; else "presumed-crashed" when the log has gone stale without a
``run_end`` (the crash signature); else "live?" when the stream carries
no timestamps to judge by (legacy .stats).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from raft_tla_tpu_torch.obs.events import validate_event


# --------------------------------------------------------------------------
# stream reading


def load_stream(path: str, drop_rollbacks: bool = True) -> dict:
    """Parse an event log (or legacy .stats stream) into a clean timeline.

    Returns ``{"events", "segments", "invalid", "legacy"}``: all valid
    events in file order; the normalised segment timeline (each dict
    gains ``cum_wall_s``, the resume-rebased cumulative clock); a list of
    ``(lineno, errors)`` for lines that failed validation; and whether
    any legacy (bare-dict) lines were lifted.
    """
    events: list = []
    invalid: list = []
    legacy = False
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError as e:
                invalid.append((lineno, [f"not JSON: {e}"]))
                continue
            if isinstance(d, dict) and "event" not in d:
                # legacy stats line: lift to a synthetic segment event
                if "n_states" in d and "wall_s" in d:
                    legacy = True
                    d = {"v": 0, "event": "segment", "ts": None, **d}
                else:
                    invalid.append((lineno, ["unrecognised legacy line"]))
                    continue
            else:
                errs = validate_event(d)
                if errs:
                    invalid.append((lineno, errs))
                    continue
            events.append(d)

    # wall rebasing: one cumulative clock across in-file resumes
    offset = prev = 0.0
    segments = []
    for e in events:
        if e["event"] != "segment":
            continue
        w = float(e["wall_s"])
        if w < prev:
            offset += prev
        prev = w
        seg = dict(e, cum_wall_s=w + offset)
        segments.append(seg)

    if drop_rollbacks:
        n_max, kept = -1, []
        for s in segments:
            if s["n_states"] >= n_max:
                kept.append(s)
                n_max = s["n_states"]
        segments = kept

    return {"events": events, "segments": segments,
            "invalid": invalid, "legacy": legacy}


# --------------------------------------------------------------------------
# summarising


def _trailing_rate(segments: list, window_s: float) -> float:
    """Incremental rate over the trailing window of the timeline."""
    if not segments:
        return 0.0
    w = segments[-1]["cum_wall_s"]
    tail = [s for s in segments if s["cum_wall_s"] >= w - window_s]
    if len(tail) >= 2:
        dt = tail[-1]["cum_wall_s"] - tail[0]["cum_wall_s"]
        if dt > 0:
            return (tail[-1]["n_states"] - tail[0]["n_states"]) / dt
    return float(segments[-1].get("inc_states_per_sec", 0.0))


def _level_sizes(events: list, segments: list) -> dict:
    """Per-level state-count increments from level boundaries.

    v1 logs carry explicit ``level_end`` events; legacy streams only
    have the level column, so boundaries are inferred from the first
    segment of each level.
    """
    boundary = {}  # level -> cumulative count at its end
    for e in events:
        if e["event"] == "level_end":
            boundary[e["level"]] = e["n_states"]
    if not boundary:
        seen_level = None
        for s in segments:
            if seen_level is not None and s["level"] > seen_level:
                boundary[s["level"] - 1] = s["n_states"]
            seen_level = s["level"]
    sizes = {}
    ks = sorted(boundary)
    for i, k in enumerate(ks):
        lo = boundary[ks[i - 1]] if i else 0
        sizes[k] = boundary[k] - lo
    return sizes


def _eta_s(summary: dict) -> float | None:
    """Seconds to the target count, else to end-of-level projected from
    the frontier trend (ratio of the last two completed level sizes)."""
    inc = summary["inc_states_per_sec"]
    if inc <= 0:
        return None
    if summary.get("target"):
        return max(0.0, summary["target"] - summary["n_states"]) / inc
    sizes = summary["level_sizes"]
    ks = sorted(sizes)
    if len(ks) < 2 or sizes[ks[-2]] <= 0:
        return None
    ratio = sizes[ks[-1]] / sizes[ks[-2]]
    projected = sizes[ks[-1]] * ratio        # expected size of current level
    boundary_n = sum(sizes[k] for k in ks)   # count at last boundary
    done_in_level = summary["n_states"] - boundary_n
    return max(0.0, projected - done_in_level) / inc


def _staleness(events: list, now: float,
               stale_after_s: float | None) -> tuple:
    """(last_event_age_s, segment_cadence_s, stale) for a timeline.

    ``stale`` is a tri-state: True/False when the stream carries wall
    timestamps to judge by, None when it does not (legacy .stats lines
    have ``ts: None`` — no basis for a verdict).  The threshold is
    ``stale_after_s`` when given, else derived from the run's OWN recent
    segment cadence (10x the median inter-segment gap, clamped to
    [30s, 1h]) so a slow deep level is not misread as a hang, falling
    back to 300s when fewer than two timestamped segments exist.
    """
    stamped = [e["ts"] for e in events if e.get("ts") is not None]
    if not stamped:
        return None, None, None
    age = max(0.0, now - stamped[-1])
    seg_ts = [e["ts"] for e in events
              if e["event"] == "segment" and e.get("ts") is not None]
    tail = seg_ts[-9:]
    gaps = sorted(g for g in
                  (b - a for a, b in zip(tail, tail[1:])) if g >= 0)
    cadence = gaps[len(gaps) // 2] if gaps else None
    if stale_after_s is None:
        stale_after_s = (min(3600.0, max(30.0, 10.0 * cadence))
                         if cadence is not None else 300.0)
    return age, cadence, age > stale_after_s


def _pool_counts(events: list) -> dict | None:
    """Aggregate the v7 worker-pool supervision lifecycle (pool.events):
    spawn/loss/retry/quarantine counters plus the last loss kind and the
    quarantined job ids — the pool's end-state attribution row."""
    spawns = [e for e in events if e["event"] == "worker_spawn"]
    losses = [e for e in events if e["event"] == "worker_lost"]
    retries = [e for e in events if e["event"] == "job_retry"]
    quar = [e for e in events if e["event"] == "quarantine"]
    if not (spawns or losses or retries or quar):
        return None
    pool = {"spawns": len(spawns), "losses": len(losses),
            "retries": len(retries),
            "quarantined": [e["job_id"] for e in quar]}
    if losses:
        pool["last_loss_kind"] = losses[-1]["kind"]
    return pool


def summarize(stream: dict, window_s: float = 600.0,
              target: int | None = None, now: float | None = None,
              stale_after_s: float | None = None) -> dict | None:
    """Distil a loaded stream into the heartbeat fields (None = no data)."""
    segments = stream["segments"]
    events = stream["events"]
    pool = _pool_counts(events)
    if not segments:
        if pool is not None:
            # A pure supervision log (serve pool.events) has no segment
            # timeline; the pool lifecycle IS the heartbeat.
            return {"pool": pool, "pool_only": True,
                    "n_invalid": len(stream["invalid"])}
        snaps = [e for e in events if e["event"] == "metrics_snapshot"]
        if snaps:
            # A metrics log (OUT/metrics.events, schema v10): the last
            # snapshot carries the endpoint's whole registry — latency
            # quantiles, queue depth — replayable without the endpoint.
            last = snaps[-1]
            return {"metrics": dict(last.get("metrics") or {}),
                    "metrics_ts": last.get("ts"),
                    "metrics_only": True,
                    "n_invalid": len(stream["invalid"])}
        return None
    cur = segments[-1]
    summary = {
        "level": cur["level"],
        "n_states": cur["n_states"],
        "cum_wall_s": cur["cum_wall_s"],
        "inc_states_per_sec": _trailing_rate(segments, window_s),
        "since_resume": cur.get("since_resume"),
        "route_peak": cur.get("route_peak"),
        "bin": cur.get("bin"),
        "inflight": cur.get("inflight"),
        "flush_backlog": cur.get("flush_backlog"),
        "dev_dedup_hits": cur.get("dev_dedup_hits"),
        "level_sizes": _level_sizes(events, segments),
        "target": target,
        "legacy": stream["legacy"],
        "n_invalid": len(stream["invalid"]),
        "pool": pool,
    }
    summary["eta_s"] = _eta_s(summary)

    # phase breakdown: aggregate phase_s across the trailing window
    acc: dict = {}
    w = cur["cum_wall_s"]
    for s in segments:
        if s["cum_wall_s"] >= w - window_s:
            for k, v in (s.get("phase_s") or {}).items():
                acc[k] = acc.get(k, 0.0) + v
    total = sum(acc.values())
    summary["phase_pct"] = (
        {k: 100.0 * v / total for k, v in acc.items()} if total > 0 else {})

    # fiducial drift: latest run_start's fiducials vs the first's
    fids = [e["fiducials"] for e in events
            if e["event"] == "run_start" and e.get("fiducials")]
    drift = {}
    if len(fids) >= 1:
        first, last = fids[0], fids[-1]
        for key in ("synthetic_step_ms", "copy_512mb_ms"):
            if first.get(key) and last.get(key):
                drift[key] = last[key] / first[key]
    summary["fiducial_drift"] = drift

    # heartbeat staleness: time since the last event vs segment cadence
    age, cadence, stale = _staleness(
        events, time.time() if now is None else now, stale_after_s)
    summary["last_event_age_s"] = age
    summary["segment_cadence_s"] = cadence
    summary["stale"] = stale

    # end-state attribution
    status = "live?"  # no run_end and no timestamps: can't judge
    for e in events:
        if e["event"] == "stop_requested":
            status = f"stop requested ({e['reason']})"
    for e in events:
        if e["event"] == "violation":
            status = f"VIOLATION {e['invariant']}"
    ended = any(e["event"] == "run_end" for e in events)
    if ended:
        status = [e for e in events if e["event"] == "run_end"][-1]["outcome"]
    elif stale:
        # the crash signature: the log went quiet without a run_end
        cad = f", cadence ~{cadence:.0f}s" if cadence is not None else ""
        status = f"presumed-crashed (last event {age:.0f}s ago{cad})"
    elif stale is False:
        status = f"live ({status})" if status != "live?" else "live"
    summary["status"] = status
    return summary


def _fmt_eta(s: float) -> str:
    if s < 90:
        return f"{s:.0f}s"
    if s < 5400:
        return f"{s / 60:.0f}m"
    return f"{s / 3600:.1f}h"


def _fmt_pool(pool: dict) -> str:
    tag = (f"pool: {pool['spawns']} spawn(s), {pool['losses']} lost, "
           f"{pool['retries']} retried")
    if pool.get("last_loss_kind"):
        tag += f" (last loss: {pool['last_loss_kind']})"
    if pool["quarantined"]:
        tag += f", QUARANTINED {','.join(pool['quarantined'])}"
    return tag


def _parse_series(key: str) -> tuple:
    """``name{k="v",...}`` -> (name, labels) for metrics_snapshot keys
    (the flat Prometheus-style names obs/metrics.py snapshots)."""
    if "{" not in key:
        return key, {}
    name, _, body = key.partition("{")
    labels = {}
    for part in body.rstrip("}").split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v.strip('"')
    return name, labels


def _metrics_rows(snap: dict, age_s: float | None) -> list:
    """The fleet metrics rows, one unit per row: per-tenant p99
    admission-to-result latency (ms), queue depth (jobs), and endpoint
    liveness (seconds since the last snapshot)."""
    p99: dict = {}
    depth = None
    for key, val in snap.items():
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            continue
        name, labels = _parse_series(key)
        if name == "raft_tla_latency_seconds" \
                and labels.get("quantile") == "0.99":
            p99[labels.get("tenant", "(all)")] = val
        elif name == "raft_tla_queue_depth":
            depth = val
    rows = [f"p99 latency {tenant}: {p99[tenant] * 1000.0:,.0f} ms"
            for tenant in sorted(p99)]
    if depth is not None:
        rows.append(f"queue depth: {depth:.0f} jobs")
    if age_s is not None:
        state = "live" if age_s <= 120.0 else "stale"
        rows.append(f"metrics endpoint: {state} "
                    f"(last snapshot {age_s:.0f} s ago)")
    return rows


def heartbeat(summary: dict | None) -> str:
    """Render the one-line heartbeat."""
    if summary is None:
        return "obs: no segments yet"
    if summary.get("pool_only"):
        line = _fmt_pool(summary["pool"])
        if summary["n_invalid"]:
            line += f"  [{summary['n_invalid']} invalid lines]"
        return line
    if summary.get("metrics_only"):
        age = None
        if isinstance(summary.get("metrics_ts"), (int, float)):
            age = max(0.0, time.time() - summary["metrics_ts"])
        rows = _metrics_rows(summary.get("metrics") or {}, age)
        line = " | ".join(rows) if rows else "metrics: empty snapshot"
        if summary["n_invalid"]:
            line += f"  [{summary['n_invalid']} invalid lines]"
        return line
    parts = [
        f"L{summary['level']}",
        f"{summary['n_states']:,} st",
        f"inc {summary['inc_states_per_sec']:,.0f}/s",
        f"wall {summary['cum_wall_s']:,.0f}s",
    ]
    if summary["eta_s"] is not None:
        tag = "target" if summary.get("target") else "level"
        parts.append(f"ETA {tag} ~{_fmt_eta(summary['eta_s'])}")
    if summary["phase_pct"]:
        parts.append(" ".join(
            f"{k} {v:.0f}%" for k, v in
            sorted(summary["phase_pct"].items(), key=lambda kv: -kv[1])))
    for key, short in (("synthetic_step_ms", "step"),
                       ("copy_512mb_ms", "copy")):
        if key in summary["fiducial_drift"]:
            parts.append(f"{short} drift {summary['fiducial_drift'][key]:.2f}x")
    if summary.get("route_peak") is not None:
        parts.append(f"route_peak {summary['route_peak']}")
    if summary.get("bin") is not None:
        # serve lanes: which compiled step signature this tenant rode, and
        # how deep the async scheduler's dispatch pipeline ran
        tag = f"bin {summary['bin']}"
        if summary.get("inflight") is not None:
            tag += f" (inflight {summary['inflight']})"
        parts.append(tag)
    if summary.get("flush_backlog") is not None:
        # ddd background host dedup: 1 = a sealed flush was overlapping
        # device compute at the segment boundary (depth-1 worker)
        parts.append(f"flush backlog {summary['flush_backlog']}")
    if summary.get("dev_dedup_hits") is not None:
        # ddd device dedup: rows the HBM-resident within-level set kept
        # off the d2h export path in this segment (schema v9)
        parts.append(f"dev dedup {summary['dev_dedup_hits']:,}")
    if summary.get("pool"):
        parts.append(_fmt_pool(summary["pool"]))
    if summary.get("last_event_age_s") is not None:
        parts.append(f"last ev {summary['last_event_age_s']:.0f}s ago")
    parts.append(summary["status"])
    line = " | ".join(parts)
    if summary["n_invalid"]:
        line += f"  [{summary['n_invalid']} invalid lines]"
    return line


# --------------------------------------------------------------------------
# fleet view (directory mode)


def fleet_view(root: str, window_s: float = 600.0,
               stale_after_s: float | None = None) -> tuple:
    """Summarize every ``*.events`` log under ``root`` (the collector's
    sweep — obs/collect.find_logs).  Returns ``(rows, totals)``: one
    ``(relpath, summary)`` per readable log, and the fleet aggregate —
    summed incremental rate and state count over live tenant timelines,
    live/ended/crashed attribution counts, and the merged pool counters
    (spawns/losses/retries/quarantines across supervision logs)."""
    import os

    from raft_tla_tpu_torch.obs.collect import find_logs

    rows = []
    for path in find_logs(root):
        try:
            stream = load_stream(path)
        except OSError:
            continue
        rows.append((os.path.relpath(path, root),
                     summarize(stream, window_s=window_s,
                               stale_after_s=stale_after_s)))
    totals = {"n_logs": len(rows), "inc_states_per_sec": 0.0,
              "n_states": 0, "live": 0, "ended": 0, "crashed": 0,
              "pool": {"spawns": 0, "losses": 0, "retries": 0,
                       "quarantined": []}}
    pooled = False
    metrics_summary = None
    for _name, s in rows:
        if s is None:
            continue
        if s.get("metrics_only"):
            # newest snapshot wins: one endpoint per fleet directory
            if metrics_summary is None or \
                    (s.get("metrics_ts") or 0) > \
                    (metrics_summary.get("metrics_ts") or 0):
                metrics_summary = s
            continue
        if s.get("pool"):
            pooled = True
            for k in ("spawns", "losses", "retries"):
                totals["pool"][k] += s["pool"][k]
            totals["pool"]["quarantined"].extend(s["pool"]["quarantined"])
        if s.get("pool_only"):
            continue
        totals["n_states"] += s["n_states"]
        status = s["status"]
        if status.startswith("live"):
            totals["live"] += 1
            totals["inc_states_per_sec"] += s["inc_states_per_sec"]
        elif status.startswith("presumed-crashed"):
            totals["crashed"] += 1
        else:
            totals["ended"] += 1
    if not pooled:
        totals["pool"] = None
    totals["metrics"] = metrics_summary
    return rows, totals


def _fleet_lines(rows: list, totals: dict) -> str:
    width = max((len(n) for n, _s in rows), default=0)
    lines = [f"{name:<{width}}  {heartbeat(s)}" for name, s in rows]
    agg = [f"fleet: {totals['n_logs']} log(s)",
           f"{totals['n_states']:,} st",
           f"inc {totals['inc_states_per_sec']:,.0f}/s",
           f"{totals['live']} live / {totals['ended']} ended / "
           f"{totals['crashed']} presumed-crashed"]
    if totals["pool"]:
        agg.append(_fmt_pool(totals["pool"]))
    lines.append(" | ".join(agg))
    ms = totals.get("metrics")
    if ms:
        age = None
        if isinstance(ms.get("metrics_ts"), (int, float)):
            age = max(0.0, time.time() - ms["metrics_ts"])
        for row in _metrics_rows(ms.get("metrics") or {}, age):
            lines.append(f"  {row}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# CLI


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="raft-tla-monitor-torch",
        description="One-line heartbeat over a run-event log "
                    "(or legacy .stats stream).")
    p.add_argument("path",
                   help="event log (JSONL) to read — or a DIRECTORY, "
                        "which is swept recursively for *.events and "
                        "rendered as a combined fleet view (one "
                        "heartbeat per log + the summed incremental "
                        "rate and pool attribution)")
    p.add_argument("--follow", action="store_true",
                   help="re-read and re-print every --interval seconds")
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument("--window", type=float, default=600.0,
                   help="trailing window for the incremental rate (s)")
    p.add_argument("--target", type=int, default=None,
                   help="ETA to this state count instead of end-of-level")
    p.add_argument("--stale-after", type=float, default=None,
                   help="flag the run presumed-crashed when the last "
                        "event is older than this many seconds and no "
                        "run_end was written (default: 10x the run's "
                        "own segment cadence)")
    p.add_argument("--json", action="store_true",
                   help="print the full summary as JSON instead")
    args = p.parse_args(argv)

    import os
    while True:
        if os.path.isdir(args.path):
            rows, totals = fleet_view(args.path, window_s=args.window,
                                      stale_after_s=args.stale_after)
            if args.json:
                print(json.dumps({"logs": dict(rows), "fleet": totals},
                                 default=str), flush=True)
            elif not rows:
                print(f"obs: no *.events under {args.path}", flush=True)
            else:
                print(_fleet_lines(rows, totals), flush=True)
            if not args.follow:
                return 0 if rows else 1
            time.sleep(args.interval)
            continue
        try:
            stream = load_stream(args.path)
        except FileNotFoundError:
            print(f"obs: waiting for {args.path}", flush=True)
            stream = None
        if stream is not None:
            summary = summarize(stream, window_s=args.window,
                                target=args.target,
                                stale_after_s=args.stale_after)
            if args.json:
                print(json.dumps(summary, default=str), flush=True)
            else:
                print(heartbeat(summary), flush=True)
        if not args.follow:
            return 0 if stream is not None else 1
        time.sleep(args.interval)


def entry() -> None:
    sys.exit(main())


if __name__ == "__main__":
    entry()
