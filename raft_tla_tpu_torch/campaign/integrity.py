"""Structural snapshot verification — the supervisor's gate before any
resume; the port's copy of ``raft_tla_tpu/campaign/integrity.py``.
The port's DDD snapshots are the reference's format, so either package's
verifier gives the same verdict on either package's files.

:func:`verify_snapshot` answers one question without loading a single
state row into memory: *is this DDD snapshot family internally
consistent enough that a resume could be lossless?*  It checks the
metadata npz (content digest via :func:`ckpt.load_npz_verified`), then
every stream file's header against its on-disk size and against the
metadata's ``n_states`` — the exact torn-snapshot shapes a SIGKILL
mid-``atomic_savez`` or a truncated copy leaves behind.  Everything is
host-side file inspection (headers are 16 bytes); a multi-GB campaign
checkpoint verifies in milliseconds.

It deliberately does NOT check the config digest: that is the *caller's*
identity claim, and the engines re-check it on resume anyway
(``ckpt.load_npz_checked``).  Integrity and identity are different
failures — a corrupt snapshot gets quarantined, a digest mismatch means
the operator pointed the campaign at the wrong model.

No torch import anywhere in this module: the supervisor process must stay
a pure host-side process so it never competes with its child for the
card.
"""

from __future__ import annotations

import os

import numpy as np

from raft_tla_tpu_torch.utils import ckpt
from raft_tla_tpu_torch.utils.ckpt import CheckpointCorrupt

# full-retention stream suffixes with their fixed widths (None = model
# dependent: .rows is the packed row width P, .links is 3, or 2 in
# pre-round-4 snapshots)
_FULL_STREAMS = ((".rows", None), (".links", (2, 3)), (".con", (1,)),
                 (".keys", (2,)))

_HDR_BYTES = 16                          # int64[2] = [n_rows, width]
_META_KEYS = ("n_states", "n_trans", "level_ends", "blocks_done",
              "config_digest")


def _check_stream(path: str, min_rows: int, widths=None) -> tuple:
    """One stream file: header readable, width sane, row count covers
    ``min_rows``, and the file is long enough to actually hold what the
    header claims.  Returns ``(n_rows, width)``."""
    if not os.path.exists(path):
        raise CheckpointCorrupt(
            f"checkpoint stream {path} is missing — incomplete snapshot "
            "family")
    size = os.path.getsize(path)
    if size < _HDR_BYTES:
        raise CheckpointCorrupt(
            f"checkpoint stream {path}: truncated header "
            f"({size} bytes) — torn snapshot")
    with open(path, "rb") as f:
        hdr = np.fromfile(f, dtype=np.int64, count=2)
    n_rows, width = int(hdr[0]), int(hdr[1])
    if width < 1 or n_rows < 0:
        raise CheckpointCorrupt(
            f"checkpoint stream {path}: nonsense header "
            f"[{n_rows}, {width}] — torn snapshot")
    if widths is not None and width not in widths:
        raise CheckpointCorrupt(
            f"checkpoint stream {path}: row width {width}, expected "
            f"{' or '.join(str(w) for w in widths)}")
    if n_rows < min_rows:
        raise CheckpointCorrupt(
            f"checkpoint stream {path} holds {n_rows} rows, metadata "
            f"expects {min_rows} — torn snapshot")
    if size < _HDR_BYTES + n_rows * width * 4:
        raise CheckpointCorrupt(
            f"checkpoint stream {path} is {size} bytes but its header "
            f"claims {n_rows} x {width} int32 rows — truncated file")
    return n_rows, width


def verify_snapshot(path: str, row_width: int | None = None) -> dict:
    """Verify one DDD snapshot family (full or frontier retention).

    Raises :class:`CheckpointCorrupt` on any structural damage, plain
    ``FileNotFoundError`` when the metadata npz itself is absent (no
    snapshot is not a *corrupt* snapshot).  Returns a summary dict
    (``n_states``, ``levels``, ``blocks_done``, ``retention``) for
    supervisor bookkeeping.

    ``row_width`` (the packed state row width P), when known, pins the
    ``.rows`` stream width; without it the width is only sanity-checked
    against the file size.
    """
    with ckpt.load_npz_verified(path) as z:
        names = set(z.files)
        missing = [k for k in _META_KEYS if k not in names]
        if missing:
            raise CheckpointCorrupt(
                f"checkpoint {path} is missing metadata field(s) "
                f"{missing} — torn snapshot")
        n_states = int(z["n_states"])
        level_ends = [int(x) for x in np.atleast_1d(z["level_ends"])]
        blocks_done = int(z["blocks_done"])
        frontier = "retention" in names
    if n_states < 0 or blocks_done < 0:
        raise CheckpointCorrupt(
            f"checkpoint {path}: negative counters (n_states={n_states}, "
            f"blocks_done={blocks_done}) — torn snapshot")
    if any(b > a for a, b in zip(level_ends, [0] + level_ends[:-1])):
        raise CheckpointCorrupt(
            f"checkpoint {path}: level_ends not monotone — torn snapshot")
    if level_ends and level_ends[-1] > n_states:
        raise CheckpointCorrupt(
            f"checkpoint {path}: last level end {level_ends[-1]} exceeds "
            f"n_states {n_states} — torn snapshot")

    rows_w = (row_width,) if row_width is not None else None
    if frontier:
        if not level_ends:
            raise CheckpointCorrupt(
                f"checkpoint {path}: frontier retention with no completed "
                "levels — torn snapshot")
        L = len(level_ends)
        lvl_lo = level_ends[-2] if L > 1 else 0
        lvl_hi = level_ends[-1]
        _check_stream(path + ".keys", n_states, (2,))
        # the frontier window lives in per-level stream files; the
        # loader trims overhang, so >= is the right relation here too
        _check_stream(f"{path}.rowsL{L}", lvl_hi - lvl_lo, rows_w)
        _check_stream(f"{path}.conL{L}", lvl_hi - lvl_lo, (1,))
        if n_states > lvl_hi:
            _check_stream(f"{path}.rowsL{L + 1}", n_states - lvl_hi,
                          rows_w)
            _check_stream(f"{path}.conL{L + 1}", n_states - lvl_hi, (1,))
    else:
        for suf, widths in _FULL_STREAMS:
            if suf == ".rows" and rows_w is not None:
                widths = rows_w
            _check_stream(path + suf, n_states, widths)
    return {"path": path, "n_states": n_states,
            "levels": len(level_ends), "blocks_done": blocks_done,
            "retention": "frontier" if frontier else "full"}


def snapshot_family(path: str) -> list:
    """Every on-disk member of the snapshot family rooted at ``path``
    (the metadata npz plus its ``.rows``/``.links``/``.con``/``.keys``
    and frontier ``.rowsL<k>``/``.conL<k>`` streams).  Used whole-sale:
    quarantine moves, generation copies, and fresh-start deletion all
    operate on the family, never on individual members."""
    import glob as _glob

    out = [path] if os.path.exists(path) else []
    for p in sorted(_glob.glob(_glob.escape(path) + ".*")):
        if p.endswith(".tmp"):
            continue                     # torn atomic_savez temp — not ours
        out.append(p)
    return out
