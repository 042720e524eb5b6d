"""Checkpoint machinery — the port's copy of the ``config_digest``,
``atomic_savez`` and ``load_npz_checked`` parts of
``raft_tla_tpu/utils/ckpt.py``.

- :func:`config_digest` pins the model identity (bounds, spec subset,
  invariants, symmetry, chunk, capacities) and the initial state's dedup
  key.  It is computed exactly as the reference computes it (the port's
  ``Bounds``, ``CheckConfig`` and ``Capacities`` keep the reference's class
  names, field names and defaults), so a checkpoint written by either
  package resumes in the other under the same config.
- :func:`atomic_savez` / :func:`load_npz_checked`: tmp + ``os.replace``
  atomic npz with an embedded content digest, and the config-digest check.
- The append-only row streams of the DDD snapshots (``stream_rows_out``,
  ``stream_rows_append``, ``stream_width``, ``trim_stream``, ``copy_stream``,
  ``stream_rows_in``): an int64 header ``[n_rows, width]``, then raw int32
  rows, the format of the reference's, so a DDD campaign moves between
  the packages in both directions.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zipfile

import numpy as np

_STREAM_ROWS = 1 << 20      # rows per streamed block


class CheckpointCorrupt(ValueError):
    """A checkpoint file is truncated, torn, or fails its content digest.

    Subclasses :class:`ValueError` so the engines' existing resume guards
    (and anything matching their messages) keep working unchanged, while
    a campaign supervisor can catch this type specifically and QUARANTINE
    the snapshot instead of retrying it — a corrupt file never
    deserializes into garbage state, and never gets resumed twice.
    """


def _stable(obj):
    """Canonical digest form of a config dataclass: (name, value) pairs in
    field order, OMITTING fields that sit at their declared default.

    Hashing ``repr(obj)`` instead would orphan every existing checkpoint
    each time a dataclass grows a new (defaulted) field — a lesson learned
    when adding ``Bounds.history`` invalidated a 30M-state snapshot mid-run.
    With default-valued fields excluded, old digests stay valid until a
    semantically different value is actually used.
    """
    pairs = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.default is not dataclasses.MISSING and v == f.default:
            continue
        if dataclasses.is_dataclass(v):
            v = _stable(v)
        pairs.append((f.name, v))
    return (type(obj).__name__, tuple(pairs))


def config_digest(config, caps, init_key: tuple) -> int:
    # check_deadlock / view join the identity only when set (default-
    # omission, like _stable): resuming a non-deadlock checkpoint under
    # --deadlock would silently skip dead states in the already-explored
    # region, and a view changes every dedup key.
    extras = (("check_deadlock", True),) if config.check_deadlock else ()
    if getattr(config, "view", None):
        extras += (("view", config.view),)
    key = repr((_stable(config.bounds), config.spec, config.invariants,
                config.symmetry, config.chunk, _stable(caps),
                init_key, *extras)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "big")


def content_digest(arrays) -> str:
    """Order-independent sha256 over every array's name, dtype, shape and
    bytes — the integrity seal :func:`atomic_savez` embeds (under the
    reserved key ``content_sha``) and :func:`load_npz_checked` verifies.
    Distinct from :func:`config_digest`, which pins model *identity*: a
    config mismatch is a caller error, a content mismatch is corruption."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.asarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        b = np.ascontiguousarray(a)
        # the bytes of tobytes(), hashed in place (no copy of a store)
        h.update(b.tobytes() if b.dtype.hasobject
                 else b.reshape(-1).view(np.uint8))
    return h.hexdigest()


def atomic_savez(path: str, **arrays) -> None:
    arrays["content_sha"] = content_digest(arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:      # file handle: savez adds no suffix
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())        # durable before it replaces the old
    os.replace(tmp, path)


def load_npz_verified(path: str):
    """``np.load`` with corruption classified, content digest verified,
    but NO config-digest comparison — for callers that derive the
    expected config digest from the file's own contents (resharders) or
    only need integrity (the campaign supervisor's snapshot verifier).

    Raises :class:`CheckpointCorrupt` (naming the file) when the archive
    is unreadable or fails its embedded content digest.  Snapshots
    predating the embedded digest (no ``content_sha`` key) still load;
    they simply get only the structural zip checks.
    """
    try:
        z = np.load(path)
    except FileNotFoundError:
        raise
    except (OSError, EOFError, ValueError, zipfile.BadZipFile) as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is not a readable npz archive ({e}) — "
            "truncated or corrupt snapshot") from e
    try:
        names = set(z.files)
        if "content_sha" in names:
            want = str(z["content_sha"])
            got = content_digest(
                {k: z[k] for k in names if k != "content_sha"})
            if got != want:
                z.close()
                raise CheckpointCorrupt(
                    f"checkpoint {path} failed its content digest "
                    f"(embedded {want[:12]}.., computed {got[:12]}..) — "
                    "truncated or corrupt snapshot")
    except CheckpointCorrupt:
        raise
    except (KeyError, OSError, EOFError, ValueError,
            zipfile.BadZipFile) as e:
        z.close()
        raise CheckpointCorrupt(
            f"checkpoint {path} could not be decoded ({e}) — truncated "
            "or corrupt snapshot") from e
    return z


def load_npz_checked(path: str, digest: int):
    """Returns the opened NpzFile.

    Raises :class:`CheckpointCorrupt` (naming the file) when the archive
    is unreadable or fails its embedded content digest, and a plain
    :class:`ValueError` when it is intact but belongs to a different
    model config — the two must stay distinguishable: a supervisor
    quarantines the former and refuses the latter.
    """
    z = load_npz_verified(path)
    try:
        cfg_digest = int(z["config_digest"])
    except (KeyError, OSError, EOFError, ValueError,
            zipfile.BadZipFile) as e:
        z.close()
        raise CheckpointCorrupt(
            f"checkpoint {path} could not be decoded ({e}) — truncated "
            "or corrupt snapshot") from e
    if cfg_digest != digest:
        z.close()
        raise ValueError(
            "checkpoint was written under a different model config or "
            "initial state (digest mismatch); resuming it here would be "
            "unsound")
    return z


def stream_rows_out(path: str, reader, n_rows: int, width: int) -> None:
    """Write ``n_rows`` int32 rows to ``path`` via ``reader(start, n)``,
    never holding more than one block in memory.  Atomic."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.array([n_rows, width], np.int64).tofile(f)
        start = 0
        while start < n_rows:
            n = min(_STREAM_ROWS, n_rows - start)
            np.ascontiguousarray(reader(start, n), np.int32).tofile(f)
            start += n
        # durability before the replace: os.replace of an unsynced file
        # can otherwise destroy the last good snapshot AND lose the new
        # one in a power cut
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def stream_rows_append(path: str, reader, end: int, width: int) -> None:
    """Extend an append-only row stream to ``end`` rows IN PLACE.

    The engines' host stores are append-only with stable prefixes, so a
    snapshot only ever needs to add the suffix since the previous one —
    a full :func:`stream_rows_out` rewrite costs minutes of idle device
    at 10^8-state scale (measured: the elect5 campaign's rewriting
    snapshots took ~10 min each at 50-90M orbits).

    Crash safety, by write order: the file is truncated to the header's
    row count (dropping any garbage from a previously torn append), the
    new rows are appended and fsynced, and the header's count is updated
    LAST — a crash at any point leaves a consistent prefix no shorter
    than the last completed snapshot, which is exactly the contract
    :func:`stream_rows_in` already relies on.  A width change or a
    missing file falls back to the full atomic rewrite.
    """
    if not os.path.exists(path):
        return stream_rows_out(path, reader, end, width)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        hdr = np.fromfile(f, np.int64, 2)
        if (hdr.shape[0] != 2 or int(hdr[1]) != width
                or size < 16 + int(hdr[0]) * width * 4):
            # width change, or a header vouching for more bytes than the
            # file holds (torn full write): nothing here is trustworthy —
            # full rewrite.  (truncate() would silently ZERO-FILL a short
            # file, so the size check must come first.)
            f.close()
            return stream_rows_out(path, reader, end, width)
        # the valid prefix: rows the header vouches for, capped at the
        # target (a longer stream can outlive an older metadata npz —
        # see stream_rows_in — and its prefix is still bit-identical)
        start = min(int(hdr[0]), end)
        f.truncate(16 + start * width * 4)
        f.seek(0, os.SEEK_END)
        while start < end:
            n = min(_STREAM_ROWS, end - start)
            np.ascontiguousarray(reader(start, n), np.int32).tofile(f)
            start += n
        f.flush()
        os.fsync(f.fileno())
        f.seek(0)
        np.array([end, width], np.int64).tofile(f)
        f.flush()
        os.fsync(f.fileno())


def stream_width(path: str) -> int:
    """Row width of an append-only stream (the one place that knows the
    header layout outside the readers/writers in this module)."""
    with open(path, "rb") as f:
        hdr = np.fromfile(f, np.int64, 2)
    if hdr.shape[0] != 2:
        raise CheckpointCorrupt(f"stream {path}: truncated header")
    return int(hdr[1])


def trim_stream(path: str, n_rows: int, width: int) -> None:
    """Cap an append-only stream's trusted prefix at ``n_rows`` (resume
    hygiene: rows beyond the restored metadata's count came from a
    superseded snapshot and must be re-written, not assumed identical)."""
    if not os.path.exists(path):
        return
    with open(path, "r+b") as f:
        hdr = np.fromfile(f, np.int64, 2)
        if hdr.shape[0] != 2 or int(hdr[1]) != width \
                or int(hdr[0]) <= n_rows:
            return
        f.truncate(16 + n_rows * width * 4)
        f.seek(0)
        np.array([n_rows, width], np.int64).tofile(f)
        f.flush()
        os.fsync(f.fileno())


def copy_stream(src: str, dst: str, n_rows: int, width: int) -> None:
    """Copy the first ``n_rows`` of an append-only stream to a new path
    (atomic; blockwise — used by checkpoint resharders, where the stream
    is mesh-independent history and moves verbatim)."""
    with open(src, "rb") as f:
        have, w = (int(x) for x in np.fromfile(f, np.int64, 2))
        if w != width:
            raise ValueError(
                f"stream {src} has row width {w}, expected {width}")
        if have < n_rows:
            raise ValueError(
                f"stream {src} holds {have} rows, need {n_rows}")

        def reader(start, n):
            f.seek(16 + start * width * 4)
            return np.fromfile(f, np.int32, n * width).reshape(n, width)

        stream_rows_out(dst, reader, n_rows, width)


def stream_rows_in(path: str, writer, limit: int,
                   expect_width: int | None = None) -> int:
    """Feed the first ``limit`` rows of ``path`` through ``writer(block)``.

    The stream may legitimately hold MORE rows than ``limit``: snapshots
    write the (append-only, stable-prefix) streams before the metadata
    npz, so a crash between the two leaves longer streams next to an older
    ``paged`` counter — the excess is simply ignored.  Fewer rows than
    ``limit`` means a genuinely torn snapshot and is an error.

    ``expect_width`` pins the caller's current row layout: the config
    digest does not cover the bit-pack schema, so a checkpoint written
    under an older packing must be rejected here, not resumed as silently
    corrupted rows.
    """
    with open(path, "rb") as f:
        hdr = np.fromfile(f, np.int64, 2)
        if hdr.shape[0] != 2:
            raise CheckpointCorrupt(f"stream {path}: truncated header")
        n_rows, width = (int(x) for x in hdr)
        if expect_width is not None and width != expect_width:
            raise ValueError(
                f"checkpoint stream {path} has row width {width}, this "
                f"build expects {expect_width} — the packed-row layout "
                "changed; the snapshot cannot be resumed")
        if n_rows < limit:
            raise CheckpointCorrupt(
                f"checkpoint stream {path} holds {n_rows} rows, "
                f"metadata expects {limit} — torn snapshot")
        start = 0
        while start < limit:
            n = min(_STREAM_ROWS, limit - start)
            raw = np.fromfile(f, np.int32, n * width)
            if raw.shape[0] != n * width:
                raise CheckpointCorrupt(
                    f"truncated checkpoint stream {path}")
            block = raw.reshape(n, width)
            writer(block)
            start += n
    return limit
