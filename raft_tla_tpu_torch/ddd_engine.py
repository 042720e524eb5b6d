"""Delayed-duplicate-detection engine — the port of
``raft_tla_tpu/ddd_engine.py`` (``--engine ddd``).

The device engine keeps the exact fingerprint set and every state row in
the card's memory, which caps a search at what 80 GB hold.  This engine
keeps the card out of the correctness path's storage entirely:

- **Card: expand and fingerprint.**  Each chunk unpacks a slice of the
  uploaded frontier block, runs the fused step (K1 on the card), and
  streams a *compacted* candidate list (key, packed row, parent, lane,
  constraint flag) into the segment's output buffers.  The only device
  state is a **lossy filter table**: a bucketized key cache probed in one
  gather, inserting with overwrite-on-full-bucket.  A filter hit proves the
  key already streamed (only streamed keys are inserted), so hits are
  dropped on the card; misses (new states and evicted re-sights) stream
  to the host.  The filter changes traffic, never the verdict: a resume
  starts it empty.
- **Host: exact dedup in first-occurrence stream order.**  Candidates
  buffer in a pending list; each flush keeps each key's first occurrence,
  anti-joins against the master key set (``utils/keyset``), appends the
  new states to the native store (``utils/native``) in stream order and
  merges their keys into the master.  Discovery order — counts, levels,
  coverage, traces — is therefore the oracle's and every other engine's.
- **Level-synchronous BFS**: new states join the next level only; the
  frontier streams host -> card block by block.

Capacity is host RAM: 8 B/state of master keys plus the packed rows (and
~16 B/state in frontier retention, where rows live in level files).

Violation semantics match refbfs exactly: the candidate stream is
truncated on the card at the first violating candidate (kept inclusively)
or the first deadlocked row (its successors excluded), so ``n_states`` and
``n_transitions`` stop where the oracle's do; after a forced flush the
violator is the last appended state (asserted by key).

The chunk loop is on the host.  Each chunk costs one host sync: a small
stats tensor (streamed count, transitions, the overflow bit, the violation
fields), which also tells the host where the chunk's streamed rows go and
how many to pack.  A segment is the run of chunks that fills one of two
ping-pong buffer sets; its rows go to pinned host memory on a copy stream
while the next segment runs, and the harvest waits for that copy, a second
host sync per segment (``stats["syncs"]`` counts both kinds).

Snapshots are the reference's four-stream format (``.rows``/``.links``/
``.con``/``.keys`` plus the metadata npz, or the frontier level files),
written and read by the same functions, with the same ``config_digest``:
a campaign moves between the two packages in both directions.

K1 leaves every output of an invalid lane unwritten
(``ops/pallas_step.py``): this engine reads each K1 output only under
the mask of the lanes it keeps.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import glob
import os
import shutil
import tempfile
import time
from collections import Counter, deque

import numpy as np
import torch

from raft_tla_tpu_torch.config import CheckConfig
from raft_tla_tpu_torch.device_engine import (
    BUCKET, EMPTY, FAIL_INDEX, FAIL_LEVEL, FAIL_WIDTH, SyncCounter,
    aggregate_coverage, decode_fail)
from raft_tla_tpu_torch.engine import DEADLOCK, EngineResult, Violation
from raft_tla_tpu_torch.models import interp, invariants as inv_mod, spec as S
from raft_tla_tpu_torch.obs.events import RunTelemetry
from raft_tla_tpu_torch.ops import bitpack, pallas_step
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym
from raft_tla_tpu_torch.utils import (ckpt, flushq, keyset, native, pacing,
                                      prefetch)

I32, I64 = torch.int32, torch.int64
BIG = np.iinfo(np.int32).max

# Discovery-index ceiling: ids are int64 end to end (store links,
# checkpoint streams, host flush; the card emits block-relative parents
# that always fit int32 and the host rebases them).  A loud absurdity
# check far past any host-RAM-feasible state count.
_IDX_CEIL = 1 << 62

# Per-call compacted-insert budget of the filter: a chunk streaming more
# keys than this simply drops the excess INSERTS — the keys still stream
# to the host, so exactness is untouched and the only cost is re-sighted
# traffic.
_S_INS = 1 << 14


def install_sigint_boundary_stop(eng, stack) -> None:
    """The first SIGINT sets ``eng._sigint``, which the harvest loop reads
    beside the deadline check, so the engine stops at the next segment
    — pending candidates flushed, a snapshot saved when a checkpoint path
    is configured, and a normal ``complete=False`` result returned.  A
    second SIGINT restores the previous handler and aborts raw
    (KeyboardInterrupt).  ``signal.signal`` is main-thread-only; off the
    main thread the flag stays False.  The previous handler is restored
    via ``stack`` on every exit."""
    import signal
    import sys
    import threading
    eng._sigint = False
    if threading.current_thread() is not threading.main_thread():
        return
    prev = signal.getsignal(signal.SIGINT)

    def handler(_signum, _frame):
        if eng._sigint:
            signal.signal(signal.SIGINT, prev)
            raise KeyboardInterrupt
        eng._sigint = True
        print("SIGINT: stopping at the next segment boundary "
              "(SIGINT again aborts raw)", file=sys.stderr, flush=True)

    signal.signal(signal.SIGINT, handler)
    stack.callback(signal.signal, signal.SIGINT, prev)


@dataclasses.dataclass(frozen=True)
class DDDCapacities:
    """Static shapes (the reference's, without the routed step).

    ``block``: frontier upload granularity (rows); ``table``: lossy filter
    slots (traffic only, not a state-count ceiling); ``seg_rows``: rows of
    one segment's output buffers (a segment stops early when the next chunk
    might not fit); ``flush``: pending candidates per host dedup pass;
    ``levels``: BFS-depth bound.  ``retention``: ``"full"`` keeps every
    state row and trace link in host RAM; ``"frontier"`` keeps the master
    keys in RAM and only the current and next level of rows, in disk-backed
    level files, with no trace links (a violation reports the state, or,
    with ``keep_levels``, a trace rebuilt by backward re-search over the
    retained level files: :func:`frontier_backtrace`)."""

    block: int = 1 << 20
    table: int = 1 << 22
    seg_rows: int = 1 << 19
    flush: int = 1 << 23
    levels: int = 1 << 12
    retention: str = "full"
    keep_levels: bool = False

    def __post_init__(self):
        if self.retention not in ("full", "frontier"):
            raise ValueError(f"retention={self.retention!r}")
        for nm in ("block", "table"):
            v = getattr(self, nm)
            if v & (v - 1):
                raise ValueError(f"{nm}={v} must be a power of two")
        if self.table < BUCKET:
            raise ValueError(
                f"table={self.table} must be >= one bucket ({BUCKET})")


@dataclasses.dataclass(frozen=True)
class _DigestCaps:
    """Checkpoint-identity view of DDDCapacities, named and defaulted as
    the reference's (the class name joins the digest): ``block``
    denominates ``blocks_done``, ``levels`` bounds the search; the filter,
    the buffers and the flush size cannot change a snapshot's meaning."""

    block: int = 1 << 20
    levels: int = 1 << 12


# -- snapshots (the reference's formats, one definition each) ---------------

def save_ddd_snapshot(path, host, constore, keystore, n_states, n_trans,
                      cov, level_ends, blocks_done, P, digest) -> None:
    """The DDD four-stream snapshot (.rows/.links/.con/.keys + metadata
    npz), byte for byte the reference's."""
    ckpt.stream_rows_append(path + ".rows", host.read, n_states, P)

    def links_reader(start, n):
        # int64 parents as (lo, hi) int32 words + lane: width-3 rows
        par, lan = host.read_links(start, n)
        pu = par.astype(np.int64).view(np.uint64)
        return np.stack(
            [(pu & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32),
             (pu >> np.uint64(32)).astype(np.uint32).view(np.int32),
             lan.astype(np.int32)], axis=1)

    ckpt.stream_rows_append(path + ".links", links_reader, n_states, 3)
    ckpt.stream_rows_append(path + ".con", constore.read, n_states, 1)
    ckpt.stream_rows_append(path + ".keys", keystore.read, n_states, 2)
    ckpt.atomic_savez(
        path,
        n_states=np.int64(n_states),
        n_trans=np.uint64(n_trans),
        cov=np.asarray(cov, np.int64),
        level_ends=np.asarray(level_ends, np.int64),
        blocks_done=np.int64(blocks_done),
        config_digest=np.uint64(digest))


def load_ddd_snapshot(path, P, digest):
    """Counterpart reader: rebuilds the native stores from the streams
    (the master keys are rebuilt by the caller)."""
    with ckpt.load_npz_checked(path, digest) as z:
        n_states = int(z["n_states"])
        n_trans = int(z["n_trans"])
        cov = np.asarray(z["cov"], np.int64).copy()
        level_ends = [int(x) for x in z["level_ends"]]
        blocks_done = int(z["blocks_done"])
    host = native.make_store(P)
    constore = native.make_store(1)
    keystore = native.make_store(2)
    ckpt.stream_rows_in(path + ".rows", host.append, n_states,
                        expect_width=P)

    def links_in(blk):
        par = (blk[:, 0].view(np.uint32).astype(np.uint64)
               | (blk[:, 1].view(np.uint32).astype(np.uint64)
                  << np.uint64(32))).view(np.int64)
        host.append_links(par, blk[:, 2])

    ckpt.stream_rows_in(path + ".links", links_in, n_states,
                        expect_width=3)
    ckpt.stream_rows_in(path + ".con", constore.append, n_states,
                        expect_width=1)
    ckpt.stream_rows_in(path + ".keys", keystore.append, n_states,
                        expect_width=2)
    return (host, constore, keystore, n_states, n_trans, cov, level_ends,
            blocks_done)


def save_frontier_snapshot(path, rows_ls, con_ls, keystore, n_states,
                           n_trans, cov, level_ends, blocks_done,
                           digest, keep_levels: bool = False) -> None:
    """Frontier-retention snapshots: the level files and the keys stream
    ARE the store, so a snapshot is three syncs, the metadata npz and the
    post-commit cleanup of pre-frontier level files (skipped under
    ``keep_levels``)."""
    rows_ls.sync()
    con_ls.sync()
    keystore.sync()
    ckpt.atomic_savez(
        path,
        n_states=np.int64(n_states),
        n_trans=np.uint64(n_trans),
        cov=np.asarray(cov, np.int64),
        level_ends=np.asarray(level_ends, np.int64),
        blocks_done=np.int64(blocks_done),
        retention=np.bytes_(b"frontier"),
        config_digest=np.uint64(digest))
    if not keep_levels:
        rows_ls.delete_old()
        con_ls.delete_old()


def load_frontier_snapshot(path, P, digest):
    """Open a frontier-format snapshot in place; a full-format one (no
    ``retention`` field in the npz) is migrated first
    (:func:`_migrate_full_to_frontier`)."""
    with ckpt.load_npz_checked(path, digest) as z:
        n_states = int(z["n_states"])
        n_trans = int(z["n_trans"])
        cov = np.asarray(z["cov"], np.int64).copy()
        level_ends = [int(x) for x in z["level_ends"]]
        blocks_done = int(z["blocks_done"])
        is_frontier = "retention" in z.files
    L = len(level_ends)
    lvl_lo = level_ends[-2] if L > 1 else 0
    lvl_hi = level_ends[-1]
    if not is_frontier:
        _migrate_full_to_frontier(path, P, n_states, n_trans, cov,
                                  level_ends, blocks_done, lvl_lo,
                                  lvl_hi, L, digest)
    else:
        # idempotent leftover cleanup: a crash between the migration's
        # npz commit and its stream deletions leaves full streams behind
        for suf in (".rows", ".links", ".con"):
            try:
                os.remove(path + suf)
            except FileNotFoundError:
                pass
    rows_ls = native.LevelStore(path + ".rows", P, L, lvl_lo, lvl_hi)
    con_ls = native.LevelStore(path + ".con", 1, L, lvl_lo, lvl_hi)
    keystore = native.FileStore(path + ".keys", 2, 0)
    if len(keystore) < n_states:
        raise ValueError(
            f"key stream holds {len(keystore)} rows, metadata expects "
            f"{n_states} — torn snapshot")
    # a crash between keystore.sync() and the npz commit leaves the key
    # stream longer than the metadata: truncate, or post-resume appends
    # land past a stale gap and every key row misaligns from its state
    keystore.trim(n_states)
    rows_ls.trim_next(n_states)
    con_ls.trim_next(n_states)
    if len(rows_ls.cur) != lvl_hi or len(rows_ls) != n_states:
        raise ValueError(
            f"frontier level files hold [{rows_ls.cur.base}, "
            f"{len(rows_ls.cur)}) + [{rows_ls.nxt.base}, {len(rows_ls)}),"
            f" metadata expects [{lvl_lo}, {lvl_hi}) + {n_states} — "
            "torn snapshot")
    return (rows_ls, con_ls, keystore, n_states, n_trans, cov,
            level_ends, blocks_done)


def _migrate_full_to_frontier(path, P, n_states, n_trans, cov,
                              level_ends, blocks_done, lvl_lo, lvl_hi,
                              L, digest):
    """One-way, one-time: slice the retained window out of a full-format
    snapshot's streams into level files, verify the copies, commit a
    frontier-format metadata npz, and only then delete the full
    ``.rows``/``.links``/``.con`` (the keys stream is format-identical and
    stays).  ``.links`` goes first: the frontier format never reads it.
    Every crash window re-runs safely."""
    try:
        os.remove(path + ".links")
    except FileNotFoundError:
        pass
    for prefix, width, reader_path in ((".rows", P, path + ".rows"),
                                       (".con", 1, path + ".con")):
        with open(reader_path, "rb") as f:
            have, w = (int(x) for x in np.fromfile(f, np.int64, 2))
            if w != width or have < n_states:
                raise ValueError(
                    f"{reader_path}: width {w} rows {have}, expected "
                    f"width {width} >= {n_states} rows")

            def slice_to(dst_path, base, end):
                fs = native.FileStore(dst_path, width, base, reset=True)
                step = 1 << 20
                for s0 in range(base, end, step):
                    n = min(step, end - s0)
                    f.seek(16 + s0 * width * 4)
                    fs.append(np.fromfile(f, np.int32, n * width)
                              .reshape(n, width))
                fs.sync()
                fs.close()

            slice_to(f"{path}{prefix}L{L}", lvl_lo, lvl_hi)
            slice_to(f"{path}{prefix}L{L + 1}", lvl_hi, n_states)

            # verify BEFORE the source streams are removed below
            rng = np.random.default_rng(0)
            for dst, base, end in ((f"{path}{prefix}L{L}", lvl_lo,
                                    lvl_hi),
                                   (f"{path}{prefix}L{L + 1}", lvl_hi,
                                    n_states)):
                fs = native.FileStore(dst, width, base)
                if len(fs) != end:
                    raise RuntimeError(
                        f"migration wrote {len(fs)} != {end} rows to "
                        f"{dst} — full streams left untouched")
                for s0 in ([base, max(base, end - 7)]
                           + [int(x) for x in rng.integers(
                               base, max(end - 7, base + 1), 8)]
                           if end > base else []):
                    n = min(7, end - s0)
                    f.seek(16 + s0 * width * 4)
                    want = np.fromfile(f, np.int32, n * width) \
                        .reshape(n, width)
                    if not np.array_equal(fs.read(s0, n), want):
                        raise RuntimeError(
                            f"migration verification mismatch at row "
                            f"{s0} of {dst} — full streams left "
                            "untouched")
                fs.close()
    ckpt.atomic_savez(
        path,
        n_states=np.int64(n_states),
        n_trans=np.uint64(n_trans),
        cov=np.asarray(cov, np.int64),
        level_ends=np.asarray(level_ends, np.int64),
        blocks_done=np.int64(blocks_done),
        retention=np.bytes_(b"frontier"),
        config_digest=np.uint64(digest))
    for suf in (".rows", ".links", ".con"):
        try:
            os.remove(path + suf)
        except FileNotFoundError:
            pass


def frontier_checkpoint_setup(resume, checkpoint, checkpoint_every_s,
                              cleanup, prefix):
    """The frontier checkpoint-path contract: resume in place, a tmpdir
    (removed on exit through ``cleanup``) when no checkpoint path is
    given, and resume == checkpoint enforced before anything is loaded.
    Returns ``(checkpoint, checkpoint_every_s, tmpdir)``."""
    tmpdir = None
    if resume and not checkpoint:
        checkpoint = resume              # frontier resumes in place
    if not checkpoint:
        tmpdir = tempfile.mkdtemp(prefix=prefix,
                                  dir=os.environ.get("TMPDIR", "."))
        cleanup.callback(
            lambda d=tmpdir: shutil.rmtree(d, ignore_errors=True))
        checkpoint_every_s = float("inf")
        checkpoint = os.path.join(tmpdir, "run")
    if resume and os.path.abspath(resume) != os.path.abspath(checkpoint):
        raise ValueError(
            "frontier mode resumes in place: --checkpoint must equal "
            "--resume (the level files are the store)")
    return checkpoint, checkpoint_every_s, tmpdir


def _mmap_rows(path: str, width: int):
    """Read-only view of a committed FileStore stream (never opened
    writable: FileStore's own open truncates to the header count)."""
    hdr = np.fromfile(path, np.int64, 2)
    if hdr.shape[0] != 2 or int(hdr[1]) != width:
        raise ValueError(f"{path}: not a width-{width} row stream")
    n = int(hdr[0])
    if n == 0:
        return np.zeros((0, width), np.int32)
    return np.memmap(path, np.int32, mode="r", offset=16,
                     shape=(n, width))


def frontier_backtrace(step, schema, lay, bounds, table, chunk, device,
                       prefix, level_ends, n_states, viol_g, keystore):
    """TLC-equivalent counterexample reconstruction in frontier mode.

    Re-expand level file L(t-1) through the same fused step the forward
    search ran (so keys match bit for bit, symmetry and view included),
    scanning for a predecessor of the current target key; repeat down to
    Init.  BFS level minimality makes the chain a shortest
    counterexample.  Needs the level files kept by
    ``DDDCapacities.keep_levels``; returns ``[(action_label, py_state),
    ...]`` from Init to the violator, or None when a level file is
    absent."""
    P = schema.P
    K = len(level_ends)

    def file_of(g):     # level file L{i} index holding global row g
        return bisect.bisect_right(level_ends, g) + 1

    def span_of(i):     # global [start, end) of level file L{i}
        lo = level_ends[i - 2] if i >= 2 else 0
        hi = level_ends[i - 1] if i - 1 < K else n_states
        return lo, hi

    tf = file_of(int(viol_g))
    if not all(os.path.exists(f"{prefix}.rowsL{i}")
               and os.path.exists(f"{prefix}.conL{i}")
               for i in range(1, tf + 1)):
        return None
    A = len(table)

    def unpack_state(fi, g):
        lo, _ = span_of(fi)
        rows = _mmap_rows(f"{prefix}.rowsL{fi}", P)
        row = schema.unpack(np.asarray(rows[g - lo]), np)
        return interp.from_struct(st.unpack(row, lay), bounds)

    rev = []                      # [(label_into_state, py)] backwards
    tgt_g = int(viol_g)
    while True:
        fi = file_of(tgt_g)
        py = unpack_state(fi, tgt_g)
        if fi == 1:
            rev.append((None, py))
            break
        kw = keystore.read(tgt_g, 1)[0]
        tgt_lo, tgt_hi = int(kw[0]), int(kw[1])     # int32 bit patterns
        plo, phi = span_of(fi - 1)
        rows = _mmap_rows(f"{prefix}.rowsL{fi - 1}", P)
        cons = _mmap_rows(f"{prefix}.conL{fi - 1}", 1)
        hitg = None
        for b in range(plo, phi, chunk):
            n = min(chunk, phi - b)
            blk = torch.as_tensor(np.array(rows[b - plo:b - plo + n]),
                                  device=device)
            con = torch.as_tensor(
                np.asarray(cons[b - plo:b - plo + n])[:, 0] != 0,
                device=device)
            out = step(schema.unpack(blk, torch))
            hit = (out["valid"] & con[:, None]).reshape(-1)
            hit &= (out["fp_hi"].reshape(-1) == tgt_hi) \
                & (out["fp_lo"].reshape(-1) == tgt_lo)
            found, idx = (int(x) for x in torch.stack(
                [hit.any().to(I64), hit.to(torch.uint8).argmax()]).tolist())
            if found:
                hitg = b + idx // A
                rev.append((table[idx % A].label(), py))
                break
        if hitg is None:
            raise RuntimeError(
                f"frontier backtrace: no predecessor of state {tgt_g} "
                f"in level file L{fi - 1} — level-file corruption or a "
                "kernel/dedup soundness bug")
        tgt_g = hitg
    rev.reverse()
    return rev


# -- the card's part: filter and segment ------------------------------------

def filter_insert(tbl_hi, tbl_lo, key_hi, key_lo, active):
    """Lossy one-gather filter probe + compacted insert, the reference's
    ``_filter_insert`` bit for bit.

    ``tbl_hi``/``tbl_lo`` are ``[TB + 1, BUCKET]`` int32 holding the uint32
    key bits (row ``TB`` is the sink for the reference's ``mode="drop"``)
    and are updated in place.  Returns ``(stream, rank)``: ``stream[c]``
    iff candidate c is active, is the first active candidate carrying its
    key in this batch (stable sort: ties keep stream order), and its key
    is not in the filter; ``rank`` is ``cumsum(stream) - 1``.

    Inserts: the first empty slot of bucket ``key_lo & (TB - 1)``
    (``argmax`` of the empty mask), else the slot ``key_hi % BUCKET``;
    only the first ``_S_INS`` streamed keys (stream order), and of those
    only the first to claim each (bucket, slot), so the hi and lo scatters
    never see a duplicate index.  Eviction, the budget and the claim only
    widen the stream (the host dedups exactly); they never drop a state.
    """
    BA = key_hi.shape[0]
    TB = tbl_hi.shape[0] - 1
    Sb = tbl_hi.shape[1]
    dev = key_hi.device
    kh64, kl64 = key_hi.to(I64), key_lo.to(I64)
    # one 64-bit key per candidate, a bijection of the (hi, lo) pair;
    # inactive lanes on the all-ones key, as the reference's sentinel
    skey = torch.where(active, kh64, -1) * (1 << 32) \
        + (torch.where(active, kl64, -1) & 0xFFFFFFFF)
    srt = torch.sort(skey, stable=True)
    perm, sk = srt.indices, srt.values
    pa = active[perm]
    same_as_prev = torch.zeros(BA, dtype=torch.bool, device=dev)
    same_as_prev[1:] = (sk[1:] == sk[:-1]) & pa[1:] & pa[:-1]
    first_of_key = torch.empty(BA, dtype=torch.bool, device=dev)
    first_of_key[perm] = ~same_as_prev
    probe = active & first_of_key

    bidx = kl64 & (TB - 1)
    row_hi, row_lo = tbl_hi[bidx], tbl_lo[bidx]          # [BA, Sb] gather
    seen = ((row_hi == key_hi[:, None]) & (row_lo == key_lo[:, None])).any(1)
    stream = probe & ~seen
    slot_empty = (row_hi == EMPTY) & (row_lo == EMPTY)
    has_empty = slot_empty.any(1)
    evict = kh64 & (Sb - 1)                  # uint32 key_hi % BUCKET
    wslot = torch.where(has_empty, slot_empty.to(torch.uint8).argmax(1),
                        evict)
    rank = torch.cumsum(stream, 0, dtype=I64) - 1

    # the first S streamed lanes, stream order (the reference's stable
    # argsort of ~stream cut to S; its other S - k slots only drop)
    S = min(_S_INS, BA)
    sel = torch.full((S + 1,), BA, dtype=I64, device=dev)
    sel.scatter_(0, torch.where(stream & (rank < S), rank, S),
                 torch.arange(BA, dtype=I64, device=dev))
    sel = sel[:S]
    ok = sel < BA
    selc = sel.clamp(max=BA - 1)
    wb = torch.where(ok, bidx[selc], TB)
    ws = wslot[selc]
    # in-batch (bucket, slot) dedup: the first claimant keeps the slot
    lin = wb * Sb + ws
    srt = torch.sort(lin, stable=True)
    dup = torch.zeros(S, dtype=torch.bool, device=dev)
    dup[1:] = srt.values[1:] == srt.values[:-1]
    keep = torch.empty(S, dtype=torch.bool, device=dev)
    keep[srt.indices] = ~dup
    wb = torch.where(keep, wb, TB)
    tbl_hi[wb, ws] = key_hi[selc]
    tbl_lo[wb, ws] = key_lo[selc]
    return stream, rank


class SegBufs:
    """One segment's candidate-stream output buffers on the device (and,
    on a CUDA device, their pinned host mirrors)."""

    FIELDS = ("okey_hi", "okey_lo", "orows", "opar", "olane", "ocon")

    def __init__(self, ocap: int, P: int, device):
        dev = torch.device(device)
        shapes = {"okey_hi": ((ocap,), I32), "okey_lo": ((ocap,), I32),
                  "orows": ((ocap, P), I32), "opar": ((ocap,), I32),
                  "olane": ((ocap,), I32), "ocon": ((ocap,), torch.bool)}
        self.dev = {k: torch.zeros(s, dtype=t, device=dev)
                    for k, (s, t) in shapes.items()}
        self.host = None if dev.type == "cpu" else {
            k: torch.empty(s, dtype=t, pin_memory=True)
            for k, (s, t) in shapes.items()}

    def row_bytes(self) -> int:
        return sum(t[0].numel() * t.element_size()
                   for t in self.dev.values())


class DDDEngine:
    """Exhaustive checker whose exact dedup lives on the host: distinct-
    state capacity is host RAM, with no device table in the correctness
    path."""

    SEG_TARGET_S = 8.0
    SEG_CLAMP_S = 25.0
    SEG_MIN, SEG_MAX = 4, 1 << 16

    def __init__(self, config: CheckConfig,
                 caps: DDDCapacities | None = None,
                 seg_chunks: int = 64, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no "
                               "GPU; pass device='cpu' to run on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.config = config
        self.bounds = config.bounds
        self.lay = st.Layout.of(self.bounds)
        self.table = S.action_table(self.bounds, config.spec)
        self.A = len(self.table)
        self.caps = caps or DDDCapacities()
        if self.caps.block < config.chunk:
            raise ValueError("block must be >= chunk")
        if self.caps.seg_rows < config.chunk * self.A:
            raise ValueError(
                f"seg_rows={self.caps.seg_rows} must be >= per-chunk "
                f"candidate rows = {config.chunk * self.A}")
        self.seg_chunks = seg_chunks
        self._digest_caps = _DigestCaps(block=self.caps.block,
                                        levels=self.caps.levels)
        self.schema = bitpack.BitSchema(self.bounds)
        # gates resolved once at construction, outside the digest (the
        # reference's RAFT_TLA_HOSTDEDUP and RAFT_TLA_PREFETCH)
        self._host_dedup = keyset.host_dedup_enabled()
        self._prefetch = prefetch.prefetch_enabled()
        self._merge_budget = max(1 << 16,
                                 (8 * self.caps.flush)
                                 // keyset.DEFAULT_PARTS)
        self.step = pallas_step.build_step(
            self.bounds, config.spec, tuple(config.invariants), self.device,
            symmetry=tuple(config.symmetry), view=config.view)
        self.stats = {}
        self._sigint = False
        self._syncs = SyncCounter()
        self._events = None

    def _new_master(self):
        return keyset.new_master(self._host_dedup,
                                 merge_budget=self._merge_budget)

    def new_filter(self) -> tuple:
        """An empty filter table ``(tbl_hi, tbl_lo)`` with its sink row."""
        TB = self.caps.table // BUCKET
        return tuple(torch.full((TB + 1, BUCKET), EMPTY, dtype=I32,
                                device=self.device) for _ in range(2))

    # -- one segment ------------------------------------------------------

    def _chunk(self, tbl, fbuf, fcon, r0: int, n: int):
        """Expand rows ``[r0, r0 + n)`` of the block: the step, the
        refbfs-exact truncation, the filter.  Returns the chunk's device
        tensors and its host stats ``(n_stream, n_valid, overflow,
        viol_kind, viol_inv, drow)`` read in one sync."""
        A, dev = self.A, self.device
        n_inv = len(self.config.invariants)
        ev = self._events
        if ev is not None:
            ev.append([torch.cuda.Event(enable_timing=True)
                       for _ in range(4)])
            ev[-1][0].record()
        out = self.step(self.schema.unpack(fbuf[r0:r0 + n], torch))
        if ev is not None:
            ev[-1][1].record()
        con = fcon[r0:r0 + n]
        NK = n * A
        fvalid = (out["valid"] & con[:, None]).reshape(-1)
        order = torch.arange(NK, dtype=I64, device=dev)
        # a fill, not torch.tensor(BIG, device=...): a blocking copy from
        # the host would wait for the stream, a second sync per chunk
        big = torch.full((), BIG, dtype=I64, device=dev)
        if n_inv:
            inv_ok = out["inv_ok"].reshape(NK, n_inv)
            inv_bad = fvalid & ~inv_ok.all(1)
            first_inv = torch.where(inv_bad, order, big).min()
        else:
            first_inv = big
        if self.config.check_deadlock:
            dead = con & ~out["valid"].any(1)
            drow = torch.where(dead, torch.arange(n, dtype=I64, device=dev),
                               big).min()
            dpos = torch.where(drow < BIG // A, drow * A, big)
        else:
            drow, dpos = big, big
        use_dead = dpos < first_inv
        has_inv = (first_inv < BIG) & ~use_dead
        cut_incl = torch.where(use_dead, dpos - 1, first_inv)
        kvalid = fvalid & (order <= cut_incl)
        ovf = (kvalid & out["overflow"].reshape(-1)).any()
        kh = torch.where(kvalid, out["fp_hi"].reshape(-1), EMPTY)
        kl = torch.where(kvalid, out["fp_lo"].reshape(-1), EMPTY)
        if ev is not None:
            ev[-1][2].record()
        stream, rank = filter_insert(tbl[0], tbl[1], kh, kl, kvalid)
        if ev is not None:
            ev[-1][3].record()
        viol_kind = torch.where(use_dead, 2, torch.where(has_inv, 1, 0))
        if n_inv:
            fi = first_inv.clamp(max=NK - 1)
            viol_inv = torch.where(
                has_inv, (~inv_ok[fi]).to(torch.uint8).argmax(), 0)
        else:
            viol_inv = torch.zeros((), dtype=I64, device=dev)
        stats = torch.stack([t.to(I64) for t in (
            rank[-1] + 1, kvalid.sum(), ovf, viol_kind, viol_inv, drow)])
        host = self._syncs.read(stats)
        return out, kh, kl, stream, rank, host

    def run_segment(self, tbl, bufs: SegBufs, fbuf, fcon, block_rows: int,
                    c0: int, budget: int):
        """One segment: chunks ``c0, c0 + 1, ...`` of the block, each
        chunk's streamed candidates compacted into ``bufs`` at a running
        cursor, until the block is done, the next chunk might not fit, a
        violation or failure is flagged, or ``budget`` chunks ran (the
        reference's ``_build_segment`` loop).  Returns ``(c, stats)``:
        the next chunk index and a dict of ``cursor``, ``n_valid``,
        ``fail``, ``viol_kind``, ``viol_inv``, ``dead_g`` (block-relative),
        ``steps`` and ``done``."""
        B, A, W = self.config.chunk, self.A, self.lay.width
        NK, OCAP = B * A, self.caps.seg_rows
        n_chunks = -(-block_rows // B)
        d = bufs.dev
        cursor = n_valid = fail = vk = vi = steps = 0
        dead_g = -1
        c = c0
        while (c < n_chunks and vk == 0 and fail == 0 and steps < budget
               and cursor + NK <= OCAP):
            r0 = c * B
            n = min(B, block_rows - r0)
            out, kh, kl, stream, rank, host = self._chunk(tbl, fbuf, fcon,
                                                          r0, n)
            k, nv, ovf, vk, vi, drow = host
            if k:
                sidx = torch.empty(n * A + 1, dtype=I64, device=self.device)
                sidx.scatter_(0, torch.where(stream, rank, n * A),
                              torch.arange(n * A, dtype=I64,
                                           device=self.device))
                sidx = sidx[:k]
                sl = slice(cursor, cursor + k)
                d["okey_hi"][sl] = kh[sidx]
                d["okey_lo"][sl] = kl[sidx]
                d["orows"][sl] = self.schema.pack(
                    out["svecs"].reshape(n * A, W)[sidx], torch)
                # block-relative parents (int32 at any depth); the
                # harvest rebases them to global int64 discovery indices
                d["opar"][sl] = (r0 + sidx // A).to(I32)
                d["olane"][sl] = (sidx % A).to(I32)
                d["ocon"][sl] = out["con_ok"].reshape(-1)[sidx]
            cursor += k
            n_valid += nv
            fail |= FAIL_WIDTH if ovf else 0
            if vk == 2:
                dead_g = r0 + min(drow, B - 1)
            c += 1
            steps += 1
        self.stats["chunks"] = self.stats.get("chunks", 0) + steps
        self.stats["segments"] = self.stats.get("segments", 0) + 1
        return c, dict(cursor=cursor, n_valid=n_valid, fail=fail,
                       viol_kind=vk, viol_inv=vi, dead_g=dead_g,
                       steps=steps, done=c >= n_chunks)

    def _export(self, bufs: SegBufs, n: int):
        """Start the copy of the first ``n`` rows of ``bufs`` to the host;
        returns ``(host tensors, event or None)``.  On a CUDA device the
        copy runs on the copy stream into the pinned mirrors, after the
        compute stream's work so far."""
        if n == 0:
            return None, None
        self.stats["d2h_bytes"] = self.stats.get("d2h_bytes", 0) \
            + n * bufs.row_bytes()
        if bufs.host is None:
            return bufs.dev, None
        cs = self._copy_stream
        cs.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(cs):
            for k in SegBufs.FIELDS:
                bufs.host[k][:n].copy_(bufs.dev[k][:n], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(cs)
        return bufs.host, ev

    # -- host dedup -------------------------------------------------------

    def _flush(self, pend, master, host, constore, keystore, cov) -> int:
        """Exact-dedup the pending candidate stream; append the new states
        in first-occurrence order.  Returns the number appended."""
        if not pend["keys"]:
            return 0
        t0 = time.perf_counter()
        keys = np.concatenate(pend["keys"])
        new_idx = master.dedup(keys)
        n_new = int(new_idx.size)
        if n_new:
            rows = np.concatenate(pend["rows"])[new_idx]
            lane = np.concatenate(pend["lane"])[new_idx]
            con = np.concatenate(pend["con"])[new_idx]
            host.append(rows)
            if self.caps.retention == "full":
                par = np.concatenate(pend["par"])[new_idx]
                host.append_links(par, lane)
            constore.append(con.astype(np.int32)[:, None])
            nk = keys[new_idx]
            keystore.append(np.stack(
                [(nk & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                 (nk >> np.uint64(32)).astype(np.uint32)],
                axis=1).view(np.int32))
            cov += np.bincount(lane, minlength=self.A)
        for lst in pend.values():
            lst.clear()
        self.stats["flush_s"] = self.stats.get("flush_s", 0.0) \
            + time.perf_counter() - t0
        return n_new

    # -- checkpoint / resume ----------------------------------------------

    def save_checkpoint(self, path: str, host, constore, keystore,
                        n_states: int, n_trans: int, cov, level_ends,
                        blocks_done: int, init_key) -> None:
        """Block-boundary snapshots with an empty pending buffer; every
        stream extends incrementally."""
        digest = ckpt.config_digest(self.config, self._digest_caps,
                                    init_key)
        if self.caps.retention == "frontier":
            save_frontier_snapshot(path, host, constore, keystore,
                                   n_states, n_trans, cov, level_ends,
                                   blocks_done, digest,
                                   keep_levels=self.caps.keep_levels)
        else:
            save_ddd_snapshot(path, host, constore, keystore, n_states,
                              n_trans, cov, level_ends, blocks_done,
                              self.schema.P, digest)

    def load_checkpoint(self, path: str, init_key):
        digest = ckpt.config_digest(self.config, self._digest_caps,
                                    init_key)
        load = load_frontier_snapshot \
            if self.caps.retention == "frontier" else load_ddd_snapshot
        (host, constore, keystore, n_states, n_trans, cov, level_ends,
         blocks_done) = load(path, self.schema.P, digest)
        kw = keystore.read(0, n_states).view(np.uint32)
        keys = keyset.pack_keys(kw[:, 1], kw[:, 0])
        master = keyset.master_from_keys(
            keys, source=path, partitioned=self._host_dedup,
            merge_budget=self._merge_budget)
        if len(master) != n_states:
            raise ValueError(
                f"checkpoint key log has {len(master)} distinct keys for "
                f"{n_states} states — stream corrupt")
        return (host, constore, keystore, master, n_states, n_trans, cov,
                level_ends, blocks_done)

    # -- main loop --------------------------------------------------------

    def check(self, init_override: interp.PyState | None = None,
              on_progress=None, checkpoint: str | None = None,
              checkpoint_every_s: float = 600.0,
              resume: str | None = None,
              deadline_s: float | None = None) -> EngineResult:
        """Run the search from Init (or ``init_override``, or a ``resume``
        snapshot of either package) to the end, or until ``deadline_s``
        seconds after the first harvest or a SIGINT (then ``complete`` is
        False and ``checkpoint``, if given, holds a snapshot).
        ``on_progress`` receives a stats dict after every host flush and
        at every level end."""
        with contextlib.ExitStack() as stack:
            install_sigint_boundary_stop(self, stack)
            return self._check_impl(init_override, on_progress, checkpoint,
                                    checkpoint_every_s, resume, deadline_s,
                                    stack)

    def _check_impl(self, init_override, on_progress, checkpoint,
                    checkpoint_every_s, resume, deadline_s,
                    _cleanup) -> EngineResult:
        t0 = time.monotonic()
        dev = self.device
        bounds = self.bounds
        init_py = init_override if init_override is not None \
            else interp.init_state(bounds)
        init_vec = interp.to_vec(init_py, bounds)
        hi0, lo0 = sym.init_fingerprint(self.config, init_py, init_vec)

        for nm in self.config.invariants:
            if not inv_mod.py_invariant(nm)(init_py, bounds):
                return EngineResult(
                    n_states=1, diameter=0, n_transitions=0,
                    coverage=Counter(),
                    violation=Violation(nm, init_py, [(None, init_py)]),
                    levels=[1], wall_s=time.monotonic() - t0)

        self._syncs = SyncCounter()
        self._events = deque() if dev.type == "cuda" else None
        self._copy_stream = torch.cuda.Stream(dev) \
            if dev.type == "cuda" else None
        self.stats = {"chunks": 0, "segments": 0, "d2h_bytes": 0,
                      "flush_s": 0.0, "flush_wait_s": 0.0}
        if self._events is not None:
            self.stats.update(step_s=0.0, filter_s=0.0)
        P = self.schema.P
        frontier = self.caps.retention == "frontier"
        tmpdir = None
        if frontier:
            checkpoint, checkpoint_every_s, tmpdir = \
                frontier_checkpoint_setup(resume, checkpoint,
                                          checkpoint_every_s, _cleanup,
                                          prefix="ddd_frontier_")
        # fresh run: stream files at the checkpoint path belong to some
        # other run — remove them before incremental appends trust them
        if checkpoint and not (resume and os.path.abspath(resume)
                               == os.path.abspath(checkpoint)):
            for suf in (".rows", ".links", ".con", ".keys"):
                try:
                    os.remove(checkpoint + suf)
                except FileNotFoundError:
                    pass
            for pat in (".rowsL*", ".conL*"):
                for pth in glob.glob(checkpoint + pat):
                    try:
                        os.remove(pth)
                    except OSError:
                        pass
        if resume:
            (host, constore, keystore, master, n_states, n_trans, cov,
             level_ends, blocks_done) = self.load_checkpoint(
                resume, (hi0, lo0))
            if checkpoint and os.path.abspath(resume) == \
                    os.path.abspath(checkpoint) and not frontier:
                for suf, w in ((".rows", P), (".links", 3), (".con", 1),
                               (".keys", 2)):
                    ckpt.trim_stream(checkpoint + suf, n_states, w)
        else:
            con0 = interp.constraint_ok(init_py, bounds)
            init_packed = self.schema.pack(np.asarray(init_vec, np.int32),
                                           np)
            if frontier:
                # level 1 = the init state alone; the next level opens empty
                host = native.LevelStore(checkpoint + ".rows", P, 1, 0, 1,
                                         reset=True)
                constore = native.LevelStore(checkpoint + ".con", 1, 1, 0,
                                             1, reset=True)
                keystore = native.FileStore(checkpoint + ".keys", 2, 0,
                                            reset=True)
                host.cur.append(init_packed[None, :])
                constore.cur.append(np.asarray([[con0]], np.int32))
            else:
                host = native.make_store(P)
                constore = native.make_store(1)
                keystore = native.make_store(2)
                host.append(init_packed[None, :])
                host.append_links(np.asarray([-1], np.int64),
                                  np.asarray([-1], np.int32))
                constore.append(np.asarray([[con0]], np.int32))
            master = self._new_master()
            master.seed(int(keyset.pack_keys(
                np.uint32(hi0)[None], np.uint32(lo0)[None])[0]))
            keystore.append(np.asarray(
                [[np.uint32(lo0), np.uint32(hi0)]],
                np.uint32).view(np.int32))
            n_states = 1
            n_trans = 0
            cov = np.zeros(self.A, np.int64)
            level_ends = [1]
            blocks_done = 0

        tbl = self.new_filter()           # filter != correctness: empty
        export_rows = 0
        bufsets = [SegBufs(self.caps.seg_rows, P, dev) for _ in range(2)]
        pend = {"keys": [], "rows": [], "par": [], "lane": [], "con": []}
        # Background dedup worker (RAFT_TLA_HOSTDEDUP): depth-1 ordered,
        # so flush i's new keys are in the master before flush i+1's dedup
        # starts; every reader of flush-mutated state drains first.
        worker = flushq.DedupWorker(
            lambda batch: self._flush(batch, master, host, constore,
                                      keystore, cov)) \
            if self._host_dedup else None
        if worker is not None:
            _cleanup.callback(worker.close)

        def seal(p):
            batch = {k: v[:] for k, v in p.items()}
            for v in p.values():
                v.clear()
            return batch

        def waited(fn, *a):
            """``fn(*a)``, its wall added to ``stats["flush_wait_s"]``: the
            main loop's time spent waiting for, or doing, host dedup."""
            t = time.perf_counter()
            out = fn(*a)
            self.stats["flush_wait_s"] += time.perf_counter() - t
            return out

        def flush_sync():
            """Drain the background queue, then flush the rest inline."""
            nonlocal n_states
            if worker is not None:
                n_states += waited(worker.drain)
            n_states += waited(self._flush, pend, master, host, constore,
                               keystore, cov)

        Fcap = self.caps.block
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        pinned = dev.type == "cuda"
        slots = [(torch.empty((Fcap, P), dtype=I32, pin_memory=pinned),
                  torch.empty((Fcap,), dtype=torch.bool, pin_memory=pinned),
                  torch.empty((Fcap, P), dtype=I32, device=dev),
                  torch.empty((Fcap,), dtype=torch.bool, device=dev))
                 for _ in range(2)]

        def load_block(start, rows, slot):
            """Read rows [start, start + rows) and their constraint flags
            into the slot's host buffers and start their copy to the
            device; returns ``(rows, con, event or None)``."""
            hr, hc, dr, dc = slots[slot]
            hr.numpy()[:rows] = host.read(start, rows)
            hc.numpy()[:rows] = constore.read(start, rows)[:, 0] != 0
            if side is None:
                return hr, hc, None
            with torch.cuda.stream(side):
                dr[:rows].copy_(hr[:rows], non_blocking=True)
                dc[:rows].copy_(hc[:rows], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            return dr, dc, ev

        # Upload prefetcher (RAFT_TLA_PREFETCH): block k+1 is read and
        # copied while block k expands; block reads target rows below
        # lvl_hi only, while in-flight flushes append rows >= lvl_hi (the
        # store concurrency contract, utils/native).
        prefetcher = None
        if self._prefetch:
            def pf_load(start, rows, slot):
                assert start + rows <= level_ends[-1], \
                    (start, rows, level_ends[-1])
                return load_block(start, rows, slot)

            prefetcher = prefetch.BlockPrefetcher(pf_load)
            _cleanup.callback(prefetcher.close)
        viol = None          # (kind, inv_idx, dead_g) once detected
        viol_key = None
        fail = 0
        complete = True
        stopped = False
        t_warm = None
        pacer = pacing.SegmentPacer(self.seg_chunks, self.SEG_MIN,
                                    self.SEG_MAX, self.SEG_TARGET_S,
                                    self.SEG_CLAMP_S)
        budget = pacer.budget
        last_ckpt = time.monotonic()
        tel = RunTelemetry(config=self.config, on_progress=on_progress,
                           resumed=resume is not None, n0=n_states, t0=t0)

        def progress():
            if not tel.active:
                return
            # the inclusive count (states + pending keys awaiting dedup),
            # as the reference's stats stream reports it
            n_incl = n_states + sum(len(k) for k in pend["keys"])
            if worker is not None:
                n_incl += worker.inclusive_extra()
            tel.segment(
                n_states=n_states, n_incl=n_incl, level=len(level_ends),
                n_transitions=n_trans,
                coverage=dict(aggregate_coverage(self.table, cov)),
                flush_backlog=worker.backlog() if worker else None,
                upload_wait_ms=round(prefetcher.wait_s * 1e3, 3)
                if prefetcher else None,
                prefetch_hits=prefetcher.hits if prefetcher else None,
                export_rows=export_rows)

        n_trans_mark = n_trans   # n_trans as of the current block's start
        while not stopped:
            lvl_lo = level_ends[-2] if len(level_ends) > 1 else 0
            lvl_hi = level_ends[-1]
            b0 = lvl_lo + blocks_done * Fcap
            if prefetcher is not None and b0 < lvl_hi:
                prefetcher.schedule(b0, min(Fcap, lvl_hi - b0))
            for b_start in range(b0, lvl_hi, Fcap):
                b_rows = min(Fcap, lvl_hi - b_start)
                n_trans_mark = n_trans
                if prefetcher is not None:
                    fbuf, fcon, ev = prefetcher.take(b_start, b_rows)
                    nxt = b_start + Fcap
                    if nxt < lvl_hi:
                        prefetcher.schedule(nxt, min(Fcap, lvl_hi - nxt))
                else:
                    if worker is not None:
                        n_states += waited(worker.drain)
                    fbuf, fcon, ev = load_block(b_start, b_rows,
                                                blocks_done % 2)
                if ev is not None:      # the card waits, not the host
                    torch.cuda.current_stream(dev).wait_event(ev)
                c = 0
                # Two-deep segment pipeline: segment k+1 runs before k is
                # harvested, so k's copy to the host and the host flush
                # overlap it.  Run order == harvest order == stream order.
                q = []               # in flight: (bufset, stats, host, ev)
                free = [0, 1]
                dispatched_all = False
                while q or not (dispatched_all or stopped):
                    if (not stopped and deadline_s is not None
                            and t_warm is not None
                            and time.monotonic() - t_warm > deadline_s):
                        complete = False
                        stopped = True
                    if not stopped and self._sigint:
                        complete = False
                        stopped = True
                    if not (dispatched_all or stopped) and free:
                        idx = free.pop(0)
                        t_seg = time.monotonic()
                        c, sst = self.run_segment(tbl, bufsets[idx], fbuf,
                                                  fcon, b_rows, c, budget)
                        if sst["steps"]:
                            budget = pacer.update(
                                time.monotonic() - t_seg, sst["steps"])
                            self.seg_chunks = budget
                        hbuf, cev = self._export(bufsets[idx],
                                                 sst["cursor"])
                        q.append((idx, sst, hbuf, cev))
                        dispatched_all = sst["done"] or bool(
                            sst["viol_kind"] or sst["fail"])
                        if len(q) < 2 and not dispatched_all:
                            continue         # keep the pipeline full
                    if not q:
                        break
                    idx, sst, hbuf, cev = q.pop(0)
                    if cev is not None:
                        self._syncs.wait(cev)
                    self._fold_events()
                    free.append(idx)
                    if stopped:
                        continue             # drop post-stop segments
                    ns = sst["cursor"]
                    n_trans += sst["n_valid"]
                    fail |= sst["fail"]
                    if ns:
                        export_rows += ns
                        h = {k: v[:ns].numpy() for k, v in hbuf.items()}
                        pend["keys"].append(keyset.pack_keys(
                            h["okey_hi"].view(np.uint32),
                            h["okey_lo"].view(np.uint32)))
                        pend["rows"].append(h["orows"].copy())
                        if not frontier:
                            pend["par"].append(
                                h["opar"].astype(np.int64) + b_start)
                        pend["lane"].append(h["olane"].copy())
                        pend["con"].append(h["ocon"].copy())
                    vk = sst["viol_kind"]
                    if vk or fail:
                        if vk:
                            dg = sst["dead_g"]
                            viol = (vk, sst["viol_inv"],
                                    dg + b_start if dg >= 0 else dg)
                            if vk == 1:
                                # truncation makes the violator the last
                                # streamed candidate
                                viol_key = pend["keys"][-1][-1]
                        stopped = True
                        continue
                    if t_warm is None:
                        t_warm = time.monotonic()
                    if sum(len(x) for x in pend["keys"]) >= \
                            self.caps.flush:
                        if worker is not None:
                            n_pend = sum(len(x) for x in pend["keys"])
                            waited(worker.submit, seal(pend), n_pend)
                            n_states += worker.collect()
                        else:
                            n_states += waited(self._flush, pend, master,
                                               host, constore, keystore,
                                               cov)
                        if n_states > _IDX_CEIL:
                            fail = FAIL_INDEX
                            stopped = True
                        progress()
                if stopped:
                    break
                blocks_done += 1
                if checkpoint and (time.monotonic() - last_ckpt
                                   >= checkpoint_every_s):
                    flush_sync()
                    self.save_checkpoint(checkpoint, host, constore,
                                         keystore, n_states, n_trans, cov,
                                         level_ends, blocks_done,
                                         (hi0, lo0))
                    last_ckpt = time.monotonic()
            if stopped:
                break
            blocks_done = 0
            flush_sync()
            progress()
            if n_states > _IDX_CEIL:
                fail = FAIL_INDEX
                break
            if n_states == level_ends[-1]:       # no new states: done
                break
            level_ends.append(n_states)
            if prefetcher is not None:
                prefetcher.invalidate()
            if frontier:
                # the finished level's rows are dead weight now; without
                # snapshots (tmpdir) nothing can resume, so delete at once
                keep = self.caps.keep_levels
                host.rotate(delete_old=tmpdir is not None and not keep)
                constore.rotate(delete_old=tmpdir is not None and not keep)
            if len(level_ends) > self.caps.levels:
                _cleanup.close()
                raise RuntimeError(
                    f"DDD search aborted: {decode_fail(FAIL_LEVEL)} "
                    f"(caps={self.caps}) — grow DDDCapacities and rerun")

        if prefetcher is not None:
            prefetcher.invalidate()
        flush_sync()
        if not complete and checkpoint and not viol and not fail:
            # graceful stop (SIGINT or deadline): a mid-level snapshot
            # with n_trans as of the partial block's start — its states
            # dedup on the re-run, its transitions would count twice
            self.save_checkpoint(checkpoint, host, constore, keystore,
                                 n_states, n_trans_mark, cov, level_ends,
                                 blocks_done, (hi0, lo0))
        self._fold_events(wait=True)
        if fail:
            _cleanup.close()
            raise RuntimeError(
                f"DDD search aborted: {decode_fail(fail)} "
                f"(caps={self.caps}) — grow DDDCapacities and rerun")

        violation = None
        if viol is not None:
            violation = self._violation(viol, viol_key, host, constore,
                                        keystore, checkpoint, level_ends,
                                        n_states, frontier, _cleanup)

        levels_arr = [level_ends[0]] + [
            level_ends[k] - level_ends[k - 1]
            for k in range(1, len(level_ends))]
        tail = n_states - level_ends[-1]
        if tail > 0:                 # partial final level (stopped run)
            levels_arr.append(tail)
        host.close()
        constore.close()
        keystore.close()
        result = EngineResult(
            n_states=n_states, diameter=len(levels_arr) - 1,
            n_transitions=n_trans,
            coverage=aggregate_coverage(self.table, cov),
            violation=violation, levels=levels_arr,
            wall_s=time.monotonic() - t0, complete=complete)
        _cleanup.close()
        return result

    def _fold_events(self, wait: bool = False) -> None:
        """Add the finished chunks' K1 and filter times (CUDA events) to
        ``stats["step_s"]`` and ``stats["filter_s"]`` and drop their
        events, so a run holds only the in-flight segments' events.
        ``wait`` first waits for the card (the end of a run)."""
        self.stats["syncs"] = self._syncs.n
        ev = self._events
        if ev is None:
            return
        if wait:
            torch.cuda.synchronize(self.device)
        # recorded in order on one stream: the first unfinished chunk ends
        # the finished run
        while ev and ev[0][3].query():
            e = ev.popleft()
            self.stats["step_s"] += e[0].elapsed_time(e[1]) / 1e3
            self.stats["filter_s"] += e[2].elapsed_time(e[3]) / 1e3

    def _violation(self, viol, viol_key, host, constore, keystore,
                   checkpoint, level_ends, n_states, frontier, cleanup):
        kind, vi, dead_g = viol
        if kind == 1:
            viol_g = n_states - 1    # the violator is always new and last
            n_inv = len(self.config.invariants)
            inv_name = self.config.invariants[min(vi, n_inv - 1)]
            kw = keystore.read(viol_g, 1).view(np.uint32)
            got_key = int(keyset.pack_keys(kw[:, 1], kw[:, 0])[0])
            if got_key != int(viol_key):
                cleanup.close()
                raise RuntimeError(
                    "DDD violator identity mismatch after flush — "
                    "fingerprint collision or dedup-order bug")
        else:
            viol_g = dead_g
            inv_name = DEADLOCK
        if frontier:
            row = self.schema.unpack(host.read(int(viol_g), 1)[0], np)
            py = interp.from_struct(st.unpack(row, self.lay), self.bounds)
            host.sync()              # commit cur/nxt for mmap reads
            constore.sync()
            trace = frontier_backtrace(
                self.step, self.schema, self.lay, self.bounds, self.table,
                self.config.chunk, self.device, checkpoint, level_ends,
                n_states, int(viol_g), keystore)
            return Violation(invariant=inv_name, state=py,
                             trace=trace or [(None, py)])
        chain = []
        for k, g in enumerate(host.trace_chain(viol_g)):
            row = self.schema.unpack(host.read(int(g), 1)[0], np)
            _, lane_g = host.read_links(int(g), 1)
            py = interp.from_struct(st.unpack(row, self.lay), self.bounds)
            label = self.table[int(lane_g[0])].label() if k > 0 else None
            chain.append((label, py))
        return Violation(invariant=inv_name, state=chain[-1][1], trace=chain)

