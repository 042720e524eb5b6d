"""The device dedup set of the DDD engine (``--device-dedup``,
``RAFT_TLA_DEVDEDUP``) — the port of ``raft_tla_tpu/ops/devdedup.py``.

Every streamed candidate key, within-level re-sights included, crosses to
the host's master key set.  This set is the hot tier of a two-tier dedup:
an exact set, in the card's memory, of the keys already exported *this
level*, applied to each segment's output buffers before the export, so
that only the first occurrence of a key in a level is compacted and copied
to the host.  The host key set stays the cold tier and the only authority.

Dropping is sound: the set holds only keys that were kept, so a dropped
candidate is one the master would reject as a duplicate; first occurrences
survive in stream order, since the compaction keeps the relative order.
Counts, parents, levels, checkpoints and traces are the same with the set
on or off.  Every lossy path of the set (a probe that does not resolve, a
full sorted set, the all-ones sentinel key) streams the candidate: doubt
widens the stream and the host dedups exactly.

Two backends behind one ``filter_fn(state, key_hi, key_lo, n) -> (state,
keep, idx, new_n, hits)``:

- ``"hash"``: the bucketized open-addressing table of the device engine,
  through its insert-if-absent protocol (``device_engine.dedup_insert``:
  batch-first occurrences by a sort, the smallest lane wins a claim); a
  lane unresolved after its probes streams and is not inserted.
- ``"sort"``: a sorted array of keys: one stable sort of (set ++ batch) on
  the 64-bit key puts a set entry before equal batch lanes and the batch
  lanes in stream order, so "same as the previous key" marks exactly the
  duplicates; the union's first occurrences (the smallest ``capacity`` of
  them when they overflow) become the next set.

Keys are int32 tensors holding the uint32 words; a key of two all-ones
words is never inserted and always streams, in both backends.  The engine
resets the set at every level (a resume starts it empty) and keeps it out
of the checkpoint digest.  These are torch ops, as the reference's are
XLA's, not a hand kernel.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from raft_tla_tpu_torch.device_engine import (
    BUCKET, EMPTY, SyncCounter, dedup_insert)
from raft_tla_tpu_torch.ops import fingerprint as fpr

I32, I64 = torch.int32, torch.int64

ENV_DEVDEDUP = "RAFT_TLA_DEVDEDUP"

# The sort backend re-sorts (capacity + segment) keys every segment, so its
# set is clamped; overflowed keys just stream again.
_SORT_CAP = 1 << 17


def _auto_backend() -> str | None:
    """``auto``: off, as in the reference (its A/B found the export-row
    saving too small to pay for the filter pass; the card's is queued in
    ROADMAP.md)."""
    return None


def devdedup_backend(env: str | None = None) -> str | None:
    """The gate: None (off), ``"hash"`` or ``"sort"``.  ``on`` is the hash
    backend; ``auto`` (or unset) applies :func:`_auto_backend`."""
    v = (os.environ.get(ENV_DEVDEDUP, "") if env is None else env)
    v = v.strip().lower()
    if v in ("", "auto"):
        return _auto_backend()
    if v in ("0", "off", "false", "no"):
        return None
    if v in ("1", "on", "true", "yes", "hash"):
        return "hash"
    if v == "sort":
        return "sort"
    raise ValueError(
        f"{ENV_DEVDEDUP}={v!r}: expected auto, on, off, hash or sort")


class DevSet(NamedTuple):
    """The set between segments.  hash: ``hi``/``lo`` are the ``[capacity
    // BUCKET + 1, BUCKET]`` table words (``EMPTY`` a free slot; the last
    row is the insert's drop sink), ``n`` unused (0).  sort: ``hi``/``lo``
    are the ``[capacity]`` first-occurrence keys padded with ``EMPTY`` in
    ascending unsigned order, ``n`` the live entries."""

    hi: torch.Tensor
    lo: torch.Tensor
    n: torch.Tensor


def init_set(capacity: int, backend: str, device="cpu") -> DevSet:
    """An empty set on ``device``."""
    dev = torch.device(device)
    if backend == "hash":
        if capacity & (capacity - 1):
            raise ValueError(f"devdedup capacity {capacity} must be a "
                             "power of two (bucket-mask probe)")
        tb = max(capacity // BUCKET, 1)
        shape = (tb + 1, BUCKET)
    elif backend == "sort":
        shape = (min(capacity, _SORT_CAP),)
    else:
        raise ValueError(f"unknown devdedup backend {backend!r}")
    return DevSet(torch.full(shape, EMPTY, dtype=I32, device=dev),
                  torch.full(shape, EMPTY, dtype=I32, device=dev),
                  torch.zeros((), dtype=I32, device=dev))


def _compact(keep, lane):
    """The stream-order compaction gather: ``idx[:new_n]`` are the kept
    lanes in their order (the tail is never read)."""
    OC = keep.shape[0]
    kpos = torch.cumsum(keep.to(I32), 0) - 1
    idx = torch.zeros(OC + 1, dtype=I32, device=keep.device)
    idx[torch.where(keep, kpos, OC).long()] = lane
    return idx[:OC], keep.sum().to(I32)


def _hash_filter(state: DevSet, key_hi, key_lo, n, syncs=None):
    OC = key_hi.shape[0]
    lane = torch.arange(OC, dtype=I32, device=key_hi.device)
    valid = lane < n
    sent = (key_hi == EMPTY) & (key_lo == EMPTY)
    is_new, unres = dedup_insert(state.hi, state.lo, key_hi, key_lo,
                                 valid & ~sent, syncs or SyncCounter())
    # keep: first occurrence this level (inserted), the sentinel, or an
    # unresolved probe (not inserted: it streams now and again if seen
    # again); drop only lanes resolved as exact duplicates
    keep = valid & (sent | is_new | unres)
    hits = (valid & ~keep).sum().to(I32)
    idx, new_n = _compact(keep, lane)
    return state, keep, idx, new_n, hits


def _sort_filter(state: DevSet, key_hi, key_lo, n, syncs=None):
    OC = key_hi.shape[0]
    S = state.hi.shape[0]
    dev = key_hi.device
    lane = torch.arange(OC, dtype=I32, device=dev)
    valid = lane < n
    sent = (key_hi == EMPTY) & (key_lo == EMPTY)
    act = valid & ~sent
    # masked lanes sort into the all-ones padding run at the back; their
    # flags are overridden by valid/sent, and the padding key is left out
    # of the rebuilt set
    chi = torch.cat([state.hi, torch.where(act, key_hi, EMPTY)])
    clo = torch.cat([state.lo, torch.where(act, key_lo, EMPTY)])
    src = torch.cat([torch.full((S,), -1, dtype=I32, device=dev), lane])
    order = torch.sort(fpr.order_key(chi, clo), stable=True).indices
    shi, slo, ssrc = chi[order], clo[order], src[order]
    same = torch.zeros(S + OC, dtype=torch.bool, device=dev)
    same[1:] = (shi[1:] == shi[:-1]) & (slo[1:] == slo[:-1])
    dup = torch.zeros(OC + 1, dtype=torch.bool, device=dev)
    dup[torch.where(ssrc >= 0, ssrc, OC).long()] = same
    keep = valid & (sent | ~dup[:OC])
    hits = (valid & ~keep).sum().to(I32)
    # the next set: the union's first occurrences; on overflow the largest
    # keys fall out and stream again later
    pad = (shi == EMPTY) & (slo == EMPTY)
    uniq = ~same & ~pad
    upos = torch.cumsum(uniq.to(I32), 0) - 1
    tgt = torch.where(uniq & (upos < S), upos, S).long()
    nhi = torch.full((S + 1,), EMPTY, dtype=I32, device=dev)
    nlo = torch.full((S + 1,), EMPTY, dtype=I32, device=dev)
    nhi[tgt] = shi
    nlo[tgt] = slo
    nn = torch.clamp(uniq.sum(), max=S).to(I32)
    idx, new_n = _compact(keep, lane)
    return DevSet(nhi[:S], nlo[:S], nn), keep, idx, new_n, hits


def make_filter(backend: str):
    """The segment-output filter of ``backend``: ``filter_fn(state, key_hi,
    key_lo, n, syncs=None) -> (state, keep, idx, new_n, hits)``.  ``n`` is
    the segment's cursor (lanes from ``n`` on are stale and pass through
    masked); ``keep[lane]`` says whether the lane survives;
    ``idx``/``new_n`` are the order-preserving compaction gather; ``hits``
    counts the dropped rows.  The hash backend updates the table in place
    and reads the card once a probe round (``syncs`` counts the reads)."""
    if backend == "hash":
        return _hash_filter
    if backend == "sort":
        return _sort_filter
    raise ValueError(f"unknown devdedup backend {backend!r}")
