"""ctypes bindings for the port's C++ host store (``csrc/host_store.cc``) —
the port of ``raft_tla_tpu/utils/native.py``, cut to what the DDD engine
uses: :class:`HostStore` (C++), :class:`PyHostStore` (its NumPy twin),
:class:`FileStore`, :class:`LevelStore` and :func:`make_store`; and, for
the liveness checker, :func:`scc_csr` (C++ Tarjan) with its Python twin
:func:`scc_csr_py`.

The library is built with ``g++`` at first use into ``build/host_store/``
at the root of the checkout, named by a hash of the source.  There is no
fallback: a missing compiler or a failed build raises.  :class:`PyHostStore`
and :func:`scc_csr_py` have the identical interfaces and are what the tests
hold the native code against; a caller gets them only by naming them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "host_store.cc"
LIB_DIR = Path(__file__).resolve().parents[2] / "build" / "host_store"

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)

_lock = threading.Lock()
_lib_handle = None


def _build() -> Path:
    """The library of the current source, built if absent.  Named by the
    source's hash, so concurrent builders race benignly (identical bytes,
    atomic ``os.replace``)."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    lib = LIB_DIR / f"libraft_host-{digest}.so"
    if lib.exists():
        return lib
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
           str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SRC.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _lib():
    """The loaded library (built at first use)."""
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(str(_build()))
            lib.store_create.restype = ctypes.c_void_p
            lib.store_create.argtypes = [ctypes.c_int32]
            lib.store_destroy.argtypes = [ctypes.c_void_p]
            lib.store_size.restype = ctypes.c_int64
            lib.store_size.argtypes = [ctypes.c_void_p]
            lib.store_append.restype = ctypes.c_int64
            lib.store_append.argtypes = [ctypes.c_void_p, _i32p,
                                         ctypes.c_int64]
            lib.store_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, _i32p]
            lib.store_append_links.restype = ctypes.c_int64
            lib.store_append_links.argtypes = [ctypes.c_void_p, _i64p,
                                               _i32p, ctypes.c_int64]
            lib.store_read_links.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                             ctypes.c_int64, _i64p, _i32p]
            lib.store_trace_chain.restype = ctypes.c_int64
            lib.store_trace_chain.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int64, _i64p,
                                              ctypes.c_int64]
            lib.scc_tarjan.restype = ctypes.c_int64
            lib.scc_tarjan.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
            _lib_handle = lib
        return _lib_handle


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _as_i64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


class HostStore:
    """Append-only host store of packed state rows + trace links.

    The TLC ``states/`` analog: discovery-indexed, append-only, host-RAM
    resident, C++-backed.

    Safe for ONE appender thread plus concurrent readers of disjoint,
    already-published ranges: the C++ side publishes new rows through an
    atomic block directory and a release-stored size, so any read that
    bounds-checks against a previously observed ``len()`` sees fully
    written rows (the upload-prefetch contract, ``utils/prefetch``).
    Reads racing the rows being appended remain undefined.
    """

    def __init__(self, width: int):
        self.width = int(width)
        self._lib = _lib()
        self._h = self._lib.store_create(self.width)
        self._n_links = 0

    def __len__(self) -> int:
        return self._lib.store_size(self._h)

    def append(self, rows: np.ndarray) -> int:
        rows = _as_i32(rows).reshape(-1, self.width)
        return self._lib.store_append(
            self._h, rows.ctypes.data_as(_i32p), rows.shape[0])

    def read(self, start: int, n: int) -> np.ndarray:
        if not (0 <= start and start + n <= len(self)):
            raise IndexError(f"read [{start}, {start + n}) of {len(self)}")
        out = np.empty((n, self.width), np.int32)
        self._lib.store_read(self._h, start, n, out.ctypes.data_as(_i32p))
        return out

    def append_links(self, parent: np.ndarray, lane: np.ndarray) -> int:
        # int64 parents: discovery indices outgrow int32 (VERDICT r3 #2)
        parent, lane = _as_i64(parent).ravel(), _as_i32(lane).ravel()
        assert parent.shape == lane.shape
        self._n_links = self._lib.store_append_links(
            self._h, parent.ctypes.data_as(_i64p),
            lane.ctypes.data_as(_i32p), parent.shape[0])
        return self._n_links

    def read_links(self, start: int, n: int):
        if not (0 <= start and start + n <= self._n_links):
            raise IndexError(
                f"read_links [{start}, {start + n}) of {self._n_links}")
        parent = np.empty((n,), np.int64)
        lane = np.empty((n,), np.int32)
        self._lib.store_read_links(self._h, start, n,
                              parent.ctypes.data_as(_i64p),
                              lane.ctypes.data_as(_i32p))
        return parent, lane

    def trace_chain(self, from_row: int) -> np.ndarray:
        """Discovery indices from the root to ``from_row`` (inclusive)."""
        if not (0 <= from_row < self._n_links):
            raise IndexError(
                f"trace_chain from {from_row} of {self._n_links}")
        cap = 1 << 10
        while True:
            out = np.empty((cap,), np.int64)
            n = self._lib.store_trace_chain(self._h, from_row,
                                       out.ctypes.data_as(_i64p), cap)
            if n >= 0:
                return out[:n]
            cap *= 4

    def close(self) -> None:
        if self._h is not None:
            self._lib.store_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _BlockList:
    """Appended ndarray blocks with O(log blocks) range reads (no global
    concatenation — the C++ twin's block structure, in NumPy).

    Concurrency contract (mirrors the C++ store): one appender thread
    plus readers of already-published rows.  ``append`` publishes the
    block before the new cumulative count, and readers snapshot both
    references once (GIL-atomic) before indexing, so a read below a
    previously observed ``len()`` always sees fully-appended blocks.
    """

    def __init__(self):
        self._blocks: list = []
        self._ends = np.zeros((0,), np.int64)   # cumulative row counts

    def __len__(self) -> int:
        ends = self._ends
        return int(ends[-1]) if ends.shape[0] else 0

    def append(self, block: np.ndarray) -> None:
        total = len(self) + block.shape[0]
        # block first, THEN the count that publishes it (the reader's
        # snapshot of _ends never indexes past its snapshot of _blocks)
        self._blocks.append(block)
        self._ends = np.append(self._ends, total)

    def read(self, start: int, n: int) -> np.ndarray:
        blocks, ends = self._blocks, self._ends   # one coherent snapshot
        total = int(ends[-1]) if ends.shape[0] else 0
        if not (0 <= start and start + n <= total):
            raise IndexError(f"read [{start}, {start + n}) of {total}")
        if n <= 0:
            return blocks[0][:0] if blocks else np.empty((0,), np.int32)
        out = []
        b = int(np.searchsorted(ends, start, side="right"))
        pos = start
        while n > 0:
            b_start = int(ends[b - 1]) if b else 0
            take = min(n, int(ends[b]) - pos)
            off = pos - b_start
            out.append(blocks[b][off:off + take])
            pos += take
            n -= take
            b += 1
        return np.concatenate(out) if len(out) != 1 else out[0]


class PyHostStore:
    """The NumPy twin with the identical interface — including the
    one-appender + disjoint-range-readers concurrency contract and the
    ``IndexError`` bounds messages of the C++ store."""

    def __init__(self, width: int):
        self.width = int(width)
        self._rows = _BlockList()
        self._parents = _BlockList()
        self._lanes = _BlockList()

    def __len__(self) -> int:
        return len(self._rows)

    def append(self, rows: np.ndarray) -> int:
        self._rows.append(_as_i32(rows).reshape(-1, self.width).copy())
        return len(self)

    def read(self, start: int, n: int) -> np.ndarray:
        if not (0 <= start and start + n <= len(self)):
            raise IndexError(f"read [{start}, {start + n}) of {len(self)}")
        return self._rows.read(start, n)

    def append_links(self, parent, lane) -> int:
        self._parents.append(_as_i64(parent).ravel().copy())
        self._lanes.append(_as_i32(lane).ravel().copy())
        return len(self._parents)

    def read_links(self, start: int, n: int):
        n_links = len(self._parents)
        if not (0 <= start and start + n <= n_links):
            raise IndexError(
                f"read_links [{start}, {start + n}) of {n_links}")
        return self._parents.read(start, n), self._lanes.read(start, n)

    def trace_chain(self, from_row: int) -> np.ndarray:
        n_links = len(self._parents)
        if not (0 <= from_row < n_links):
            raise IndexError(
                f"trace_chain from {from_row} of {n_links}")
        chain = []
        cur = int(from_row)
        while cur >= 0:
            chain.append(cur)
            cur = int(self._parents.read(cur, 1)[0])
        return np.asarray(chain[::-1], np.int64)

    def close(self) -> None:
        pass


def make_store(width: int):
    """The C++ store (built at first use; no fallback)."""
    return HostStore(width)


class FileStore:
    """Append-only row store backed by a ckpt-format stream file — the
    external-memory regime TLC's own ``states/`` directory uses: rows
    live on DISK, not host RAM, so a
    campaign's state capacity is the filesystem, and the file IS the
    checkpoint stream (``utils/ckpt`` header ``[n_rows, width]`` int64,
    then raw int32 rows) — snapshotting costs an fsync, not a copy.

    ``base``: global discovery index of the file's first row.  Reads
    and appends address GLOBAL indices; rows below ``base`` don't exist
    here (the frontier-retention engine mode drops pre-frontier levels
    entirely).  The header's row count is committed by :meth:`sync` —
    torn appends past the last sync are discarded on reopen, the same
    crash contract as ckpt.stream_rows_append.

    Reads are positionless (``os.preadv``), so one appender thread plus
    concurrent readers of rows below a previously observed ``len()`` is
    safe — the host-store concurrency contract, see :class:`HostStore`.
    """

    def __init__(self, path: str, width: int, base: int = 0,
                 reset: bool = False):
        self.path = path
        self.width = int(width)
        self.base = int(base)
        mode = "w+b" if (reset or not os.path.exists(path)) else "r+b"
        self._f = open(path, mode)
        if mode == "w+b":
            self._n = 0
            self._write_header()
        else:
            hdr = np.fromfile(self._f, np.int64, 2)
            if hdr.shape[0] != 2 or int(hdr[1]) != self.width:
                raise ValueError(
                    f"{path}: not a width-{self.width} row stream")
            self._n = int(hdr[0])
            # drop any torn tail beyond the committed header count —
            # but never extend: truncate() also GROWS a file with a
            # zero hole, and a stream shorter than its header is
            # corruption read() must surface, not silently zero-fill
            end = 16 + self._n * self.width * 4
            self._f.seek(0, os.SEEK_END)
            if self._f.tell() > end:
                self._f.truncate(end)

    def _write_header(self) -> None:
        self._f.seek(0)
        np.array([self._n, self.width], np.int64).tofile(self._f)

    def __len__(self) -> int:
        return self.base + self._n

    def append(self, rows: np.ndarray) -> int:
        rows = np.ascontiguousarray(rows, np.int32) \
            .reshape(-1, self.width)
        self._f.seek(16 + self._n * self.width * 4)
        rows.tofile(self._f)
        self._n += rows.shape[0]
        return len(self)

    def read(self, start: int, n: int) -> np.ndarray:
        if not (self.base <= start and start + n <= len(self)):
            raise IndexError(
                f"read [{start}, {start + n}) of [{self.base}, "
                f"{len(self)})")
        out = np.empty((n, self.width), np.int32)
        if n == 0:
            return out
        # Positionless pread into the preallocated buffer: no shared
        # fd-offset, so a prefetch-thread read never races the appender's
        # seek+tofile or a header rewrite in sync() (appends land via
        # numpy's fd dup, already page-cache-visible here).  One appender
        # plus readers of rows below an observed len() is safe; reads of
        # the appending tail are not.
        nbytes = n * self.width * 4
        mv = memoryview(out).cast("B")
        fd, off, got = self._f.fileno(), 16 + (start - self.base) \
            * self.width * 4, 0
        while got < nbytes:
            k = os.preadv(fd, [mv[got:]], off + got)
            if k <= 0:
                break
            got += k
        if got != nbytes:
            raise ValueError(
                f"{self.path}: truncated row stream — expected {n} rows "
                f"at index {start}, got {got // (self.width * 4)}")
        return out

    def sync(self) -> None:
        """Commit appended rows: data flush, then header, then fsync."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self._write_header()
        self._f.flush()
        os.fsync(self._f.fileno())

    def trim(self, n_global: int) -> None:
        """Drop committed rows past ``n_global`` (resume hygiene: rows
        synced after the surviving metadata npz must be re-discovered,
        not trusted)."""
        n_local = n_global - self.base
        if n_local < 0:
            raise ValueError(
                f"trim to {n_global} below stream base {self.base}")
        if n_local < self._n:
            self._n = n_local
            self._f.truncate(16 + n_local * self.width * 4)
            self._write_header()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LevelStore:
    """Current + next BFS level of rows, disk-backed (frontier
    retention).  The level-synchronous engines only ever read the level
    being expanded and append the one being discovered, so older
    levels are dead weight in a no-trace campaign — exactly TLC's
    memory regime (fingerprint set in RAM, states on disk).

    Files are named ``{prefix}L{k}`` by BFS level index; ``rotate()``
    at a level boundary makes the append target the new current level
    and opens the next.  Files for levels older than current are
    deleted only by :meth:`delete_old` (the checkpoint writer calls it
    AFTER the metadata npz commits, so a crash mid-rotation still
    resumes from the previous snapshot's files).
    """

    def __init__(self, prefix: str, width: int, cur_idx: int,
                 cur_base: int, nxt_base: int, reset: bool = False):
        self.prefix = prefix
        self.width = int(width)
        self.cur_idx = int(cur_idx)
        self.cur = FileStore(f"{prefix}L{cur_idx}", width, cur_base,
                             reset=reset)
        self.nxt = FileStore(f"{prefix}L{cur_idx + 1}", width, nxt_base,
                             reset=reset)

    def __len__(self) -> int:
        return len(self.nxt)

    def append(self, rows: np.ndarray) -> int:
        return self.nxt.append(rows)

    def read(self, start: int, n: int) -> np.ndarray:
        """Read ``n`` rows from ONE level (the engines clamp blocks to
        the level end, so a range never spans the cur/nxt boundary)."""
        store = self.nxt if start >= self.nxt.base else self.cur
        if store is self.cur and start + n > len(self.cur):
            raise IndexError(
                f"read [{start}, {start + n}) spans the level boundary "
                f"at {len(self.cur)} — single-level reads only")
        return store.read(start, n)

    def rotate(self, delete_old: bool = False) -> None:
        """Level boundary: next becomes current; open a fresh next.
        ``delete_old`` removes the finished level's file immediately —
        only sound when no snapshot will ever resume from it."""
        old_path = self.cur.path
        if not delete_old:
            # commit the header: close() alone leaves the count stale,
            # and anything reopening the file (backtrace over retained
            # levels) would truncate the data to the stale count
            self.cur.sync()
        self.cur.close()
        if delete_old:
            try:
                os.remove(old_path)
            except OSError:
                pass
        self.cur = self.nxt
        self.cur_idx += 1
        self.nxt = FileStore(f"{self.prefix}L{self.cur_idx + 1}",
                             self.width, len(self.cur), reset=True)

    def trim_next(self, n_global: int) -> None:
        """Drop uncommitted next-level rows past the metadata count."""
        self.nxt.trim(n_global)

    def sync(self) -> None:
        self.cur.sync()
        self.nxt.sync()

    def delete_old(self) -> None:
        """Remove level files below the current index (post-npz-commit
        cleanup; also reclaims files from superseded runs)."""
        import glob
        import re

        for p in glob.glob(f"{self.prefix}L*"):
            m = re.fullmatch(re.escape(self.prefix) + r"L(\d+)", p)
            if m and int(m.group(1)) < self.cur_idx:
                try:
                    os.remove(p)
                except OSError:
                    pass

    def close(self) -> None:
        self.cur.close()
        self.nxt.close()


def scc_csr(indptr: np.ndarray, dst: np.ndarray) -> tuple:
    """Strongly connected components of a CSR digraph (C++ iterative
    Tarjan): ``(comp_id int64[n], n_comps)``, ids in Tarjan completion
    order (reverse topological), the reference's contract."""
    indptr = _as_i64(indptr)
    dst = _as_i64(dst)
    n = indptr.shape[0] - 1
    comp = np.empty(n, np.int64)
    ncomp = _lib().scc_tarjan(n, indptr.ctypes.data_as(_i64p),
                              dst.ctypes.data_as(_i64p),
                              comp.ctypes.data_as(_i64p))
    return comp, int(ncomp)


def scc_csr_py(indptr: np.ndarray, dst: np.ndarray) -> tuple:
    """:func:`scc_csr` in Python (the reference's iterative Tarjan over the
    CSR arrays): the twin the tests hold the native one to."""
    indptr = _as_i64(indptr)
    dst = _as_i64(dst)
    n = indptr.shape[0] - 1
    comp = np.empty(n, np.int64)
    num = np.full(n, -1, np.int64)
    low = np.empty(n, np.int64)
    on_stk = np.zeros(n, bool)
    stk: list = []
    counter = 0
    ncomp = 0
    for root in range(n):
        if num[root] != -1:
            continue
        frames = [(root, int(indptr[root]))]
        num[root] = low[root] = counter
        counter += 1
        stk.append(root)
        on_stk[root] = True
        while frames:
            u, e = frames[-1]
            if e < indptr[u + 1]:
                frames[-1] = (u, e + 1)
                v = int(dst[e])
                if num[v] == -1:
                    num[v] = low[v] = counter
                    counter += 1
                    stk.append(v)
                    on_stk[v] = True
                    frames.append((v, int(indptr[v])))
                elif on_stk[v] and num[v] < low[u]:
                    low[u] = num[v]
            else:
                frames.pop()
                if low[u] == num[u]:
                    while True:
                        w = stk.pop()
                        on_stk[w] = False
                        comp[w] = ncomp
                        if w == u:
                            break
                    ncomp += 1
                if frames:
                    p_ = frames[-1][0]
                    if low[u] < low[p_]:
                        low[p_] = low[u]
    return comp, ncomp
