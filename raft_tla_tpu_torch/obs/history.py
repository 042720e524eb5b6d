"""The one fiducial drift policy — the part of
``raft_tla_tpu/obs/history.py`` the campaign health check needs.

- :func:`fiducial_drift` — the supervisor's bracketing-fiducial
  comparison (one-sided ``current / baseline > drift_max`` on the sorted
  shared keys, :data:`_DRIFT_EXEMPT` honored).
- :func:`drift_report` — the regress CLI's richer form: every shared
  numeric key, with *rate-type* keys (states/s, orbits/s, warm rates)
  compared inverted (``baseline / current`` — slower is the
  regression) so one tolerance covers both walls and rates.

The reference's ``HistoryStore`` and bench records wait for ROADMAP.md
queue A item 12 (``history`` and ``regress``).
"""

from __future__ import annotations

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
