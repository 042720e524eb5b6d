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
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zipfile

import numpy as np


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
        h.update(np.ascontiguousarray(a).tobytes())
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
