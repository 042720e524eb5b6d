"""Cross-run fiducial history and the one drift policy; the port's copy of
``raft_tla_tpu/obs/history.py``.

- :func:`fiducial_drift` — the campaign supervisor's bracketing-fiducial
  comparison (one-sided ``current / baseline > drift_max`` on the sorted
  shared keys, :data:`_DRIFT_EXEMPT` honored);
  ``campaign.supervisor.HealthMonitor`` is its client.
- :func:`drift_report` — the regress CLI's richer form: every shared
  numeric key, with *rate-type* keys (states/s, orbits/s, warm rates)
  compared inverted (``baseline / current`` — slower is the
  regression) so one tolerance covers both walls and rates.
- :func:`bench_record` / :func:`run_record` / :func:`ingest_file` — history
  records from a bench ``parsed`` block, a run-event log (``run_start``
  fiducials plus the ``run_end`` summary) or a recorded artifact.
- :class:`HistoryStore` — an append-only JSONL store of run records keyed
  by a config digest, with per-field median baselines.  Records carry the
  ``parsed`` payload shape of the ``BENCH_r0*.json`` drivers, so those
  artifacts are ingestible as seed history.

Gate: ``--history`` / ``RAFT_TLA_HISTORY`` (resolved once, in
:func:`history_path`); unset means producers skip the write — evidence
channel, never the verdict.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

ENV_HISTORY = "RAFT_TLA_HISTORY"

# Fiducials excluded from the drift verdict: sub-microsecond timing
# pins (the trace off-path cost) are too noisy for a ratio test — a
# scheduler hiccup would read as 3x "drift" on a number measured in
# tenths of a microsecond.  They are pinned for the A/B record, not as
# a health signal.
_DRIFT_EXEMPT = frozenset({"trace_emit_overhead_us"})

# Keys whose value is a *rate* (bigger is better): the drift ratio is
# inverted so a regression reads > 1 for walls and rates alike.
_RATE_HINTS = ("per_sec", "_rate", "hit_rate")
_RATE_KEYS = frozenset({"value", "vs_baseline"})


def history_path(explicit: str | None = None) -> str | None:
    """The one resolution point for the HISTORY gate: an explicit path
    wins, else ``RAFT_TLA_HISTORY``, else None (no history store)."""
    return explicit or os.environ.get(ENV_HISTORY) or None


def fiducial_drift(baseline: dict, current: dict, drift_max: float,
                   exempt: frozenset = _DRIFT_EXEMPT) -> tuple | None:
    """First offending ``(key, ratio)`` in sorted key order, or None.

    Exactly the supervisor's health-watch semantics: one-sided —
    ``current / baseline > drift_max`` on keys both sides carry, with
    the exempt set removed.  Timing fiducials grow when the machine
    degrades, so only growth is drift here; the regress CLI's
    :func:`drift_report` adds the rate-direction handling.
    """
    if not drift_max or not baseline or not current:
        return None
    for key in sorted(set(baseline) & set(current) - exempt):
        a, b = baseline[key], current[key]
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                and a > 0 and b / a > drift_max:
            return key, b / a
    return None


def _is_rate_key(key: str) -> bool:
    return key in _RATE_KEYS or any(h in key for h in _RATE_HINTS)


def drift_report(baseline: dict, current: dict, drift_max: float,
                 exempt: frozenset = _DRIFT_EXEMPT) -> dict:
    """Every shared numeric key compared against tolerance.

    Returns ``{"ok", "worst": (key, ratio) | None, "keys": {key:
    {"baseline", "current", "ratio", "rate", "drift"}}}`` where
    ``ratio`` is oriented so > 1 is a regression: ``current /
    baseline`` for walls and costs, ``baseline / current`` for
    rate-type keys (:data:`_RATE_HINTS`)."""
    keys: dict = {}
    worst = None
    for key in sorted(set(baseline) & set(current) - exempt):
        a, b = baseline.get(key), current.get(key)
        if not isinstance(a, (int, float)) or isinstance(a, bool) \
                or not isinstance(b, (int, float)) or isinstance(b, bool):
            continue
        rate = _is_rate_key(key)
        num, den = (a, b) if rate else (b, a)
        if den <= 0 or num <= 0:
            continue
        ratio = num / den
        keys[key] = {"baseline": a, "current": b,
                     "ratio": round(ratio, 4), "rate": rate,
                     "drift": bool(drift_max) and ratio > drift_max}
        if worst is None or ratio > worst[1]:
            worst = (key, round(ratio, 4))
    return {"ok": not any(k["drift"] for k in keys.values()),
            "worst": worst, "keys": keys}


# --------------------------------------------------------------------------
# record construction / ingest


def _digest(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True).encode("utf-8")).hexdigest()[:12]


def _numeric(d: dict) -> dict:
    return {k: v for k, v in d.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def bench_record(parsed: dict, meta: dict | None = None,
                 ts: float | None = None) -> dict | None:
    """One history record from a bench ``parsed`` block (the exact
    payload shape bench.py emits and the ``BENCH_r0*.json`` drivers
    recorded).  Keyed by the metric identity (name + unit), so runs of
    a renamed flagship metric never silently compare."""
    if not _numeric(parsed):
        return None
    ident = {"metric": parsed.get("metric"), "unit": parsed.get("unit")}
    return {"kind": "bench", "key": "bench:" + _digest(ident),
            "ts": round(ts if ts is not None else time.time(), 3),
            "parsed": dict(parsed), "meta": dict(meta or {})}


def run_record(events: list, source: str = "") -> dict | None:
    """One history record from a parsed event log: the ``run_start``
    config identity (engine / universe / bounds / spec / invariants /
    symmetry / view / chunk) is the key, the fiducials plus ``run_end``
    summary are the payload."""
    start = next((e for e in events if e.get("event") == "run_start"),
                 None)
    if start is None:
        return None
    ident = {k: start.get(k) for k in
             ("engine", "universe", "bounds", "spec", "invariants",
              "symmetry", "view", "chunk")}
    parsed: dict = {}
    fid = start.get("fiducials")
    if isinstance(fid, dict):
        parsed.update(_numeric(fid))
    end = next((e for e in reversed(events)
                if e.get("event") == "run_end"), None)
    if end is not None:
        for k in ("n_states", "n_transitions", "wall_s"):
            v = end.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                parsed[k] = v
        wall = end.get("wall_s")
        if isinstance(wall, (int, float)) and wall and wall > 0:
            parsed["states_per_sec"] = round(end["n_states"] / wall, 1)
    if not parsed:
        return None
    host = start.get("host") if isinstance(start.get("host"), dict) \
        else None
    ts = end.get("ts") if end is not None else start.get("ts")
    return {"kind": "run", "key": "run:" + _digest(ident),
            "ts": round(float(ts), 3) if isinstance(ts, (int, float))
            else round(time.time(), 3),
            "parsed": parsed,
            "meta": {"source": source, "engine": start.get("engine"),
                     **({"host": host} if host else {})}}


def ingest_file(path: str) -> list:
    """Records from one artifact: a ``BENCH_*.json`` driver file, a raw
    bench ``parsed`` JSON, an ``*.events`` log, or a JSONL of history
    records (re-ingest).  Unknown shapes yield []."""
    records: list = []
    base = os.path.basename(path)
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = None
    if base.endswith(".events"):
        events = []
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                if isinstance(d, dict):
                    events.append(d)
        rec = run_record(events, source=base)
        return [rec] if rec else []
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        if isinstance(doc.get("kind"), str) and "parsed" in doc:
            return [doc]  # already a history record
        if "parsed" in doc:
            # driver shape (BENCH_r0*.json): the payload is "parsed";
            # a null/empty one (a failed round) yields no record
            parsed = doc["parsed"] if isinstance(doc["parsed"], dict) \
                else {}
        else:
            parsed = doc  # raw bench payload (bench.py's stdout line)
        meta = {"source": base}
        for k in ("n", "cmd", "rc"):
            if k in doc:
                meta[k] = doc[k]
        rec = bench_record(parsed, meta=meta, ts=mtime)
        return [rec] if rec else []
    # JSONL of history records
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict) and isinstance(d.get("kind"), str) \
                and "parsed" in d:
            records.append(d)
    return records


# --------------------------------------------------------------------------
# the store


def _median(xs: list) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class HistoryStore:
    """Append-only JSONL of history records (one object per line).

    The baseline for a key is the per-field **median** over every
    stored record with that key — robust to one bad run poisoning the
    reference, and exactly the statistic the A/B harnesses report."""

    def __init__(self, path: str):
        self.path = path

    def append(self, record: dict) -> None:
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(record, sort_keys=True) + "\n")

    def load(self) -> list:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                if isinstance(d, dict) and "parsed" in d:
                    out.append(d)
        return out

    def records(self, key: str) -> list:
        return [r for r in self.load() if r.get("key") == key]

    def baseline(self, key: str) -> dict | None:
        """Per-field median over the stored records for ``key``."""
        cols: dict = {}
        for r in self.records(key):
            for k, v in _numeric(r.get("parsed") or {}).items():
                cols.setdefault(k, []).append(v)
        if not cols:
            return None
        return {k: _median(vs) for k, vs in sorted(cols.items())}

