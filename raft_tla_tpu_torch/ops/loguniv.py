"""Bounded-log universe enumeration — the port's copy of
``raft_tla_tpu/ops/loguniv.py``, the keystone of faithful mode.

Faithful mode carries the spec's proof-only history variables —
``elections`` (raft.tla:39), ``allLogs`` (raft.tla:44), ``voterLog``
(raft.tla:77) and the ``mlog`` message fields (raft.tla:220-222, 297-299) —
as real, fingerprinted state.  All of them are *log-valued*.  Under the
StateConstraint every log is drawn from the finite universe

    U = { <<e_1..e_k>> : 0 <= k <= L, e_i in [1..T] x [1..V] }

(L = ``Bounds.log_cap``, T = ``Bounds.term_cap``, V = ``n_values``), so a
log is stored as its *rank* in a fixed enumeration: ``allLogs`` becomes a
U-bit bitmask, ``voterLog`` an n x n table of rank+1 (0 = absent), the
``elections`` slots hold ranks, and ``mlog`` rides the ``g`` field of a
message's lo word (ops/msgbits.py).

Enumeration: logs ordered by length, then lexicographically by entry codes.
An entry (t, v) has code ``c = (t-1)*V + (v-1)`` in radix ``R = T*V``; a log
of length k has ``id = offset[k] + sum_i c_i * R^(k-1-i)`` where
``offset[k] = (R^k - 1) / (R - 1)`` counts all shorter logs.  So ``id = 0``
iff the log is empty, and dropping the last entry is the closed form
``prefix_id(id) = offset[k-1] + (id - offset[k]) // R``.

The element-wise methods take numpy arrays or torch tensors (any leading
shape) and return the same kind: the numpy form serves the host
interpreter and the symmetry tables, the torch form the plain step
(ops/kernels.py).  ``csrc/step.cu`` repeats the arithmetic (``log_rank``,
``decode_log``, ``prefix_rank``).  Ranks are formed by Horner's rule over
the first ``len`` columns, which equals the reference's weighted sum for
every length in ``[0, L]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tla_tpu_torch.config import Bounds


def _where(c, a, b):
    if isinstance(c, torch.Tensor):
        return torch.where(c, a, b)
    return np.where(c, a, b)


def _i32(x, like):
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(x, device=like.device).to(torch.int32)
    return np.asarray(x).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class LogUniverse:
    """Static enumeration tables for one Bounds instance."""

    T: int          # entry terms 1..T (term_cap: one past MaxTerm)
    V: int          # entry values 1..V
    L: int          # lengths 0..L (log_cap)
    R: int          # entry radix T*V
    offsets: tuple  # offsets[k] = first id of length-k logs; len L+2
    size: int       # |U| = offsets[L+1]

    @classmethod
    def of(cls, bounds: Bounds) -> "LogUniverse":
        T, V, L = bounds.term_cap, bounds.n_values, bounds.log_cap
        R = T * V
        offs = [0]
        for _k in range(L + 1):
            offs.append(offs[-1] * R + 1)
        return cls(T=T, V=V, L=L, R=R, offsets=tuple(offs), size=offs[-1])

    @property
    def mask_words(self) -> int:
        """int32 words of a U-bit set-of-logs bitmask (allLogs)."""
        return (self.size + 31) // 32

    # -- rank arithmetic (element-wise, numpy or torch) -----------------------

    def _offset(self, k):
        """``offsets[k]`` for an integer array ``k`` in [0, L+1]."""
        out = 0 * k
        for j in range(1, self.L + 2):
            out = _where(k == j, self.offsets[j], out)
        return out

    def log_id(self, log_term, log_val, log_len):
        """Rank of the log held in padded rows (ops/state.py encoding):
        ``log_term``/``log_val`` are ``[..., L]``, ``log_len`` the matching
        lengths (clamped to [0, L]); columns >= len are ignored."""
        ln = log_len.clip(0, self.L) if isinstance(log_len, torch.Tensor) \
            else np.clip(log_len, 0, self.L)
        acc = 0 * ln
        for k in range(self.L):
            code = (log_term[..., k] - 1) * self.V + (log_val[..., k] - 1)
            acc = _where(ln > k, acc * self.R + code, acc)
        return _i32(self._offset(ln) + acc, ln)

    def log_len_of(self, ids):
        """Length of the log with the given rank."""
        ln = 0 * ids
        for k in range(1, self.L + 1):
            ln = _where(ids >= self.offsets[k], k, ln)
        return ln

    def prefix_id(self, ids):
        """Rank of the log minus its last entry (the empty log maps to 0)."""
        ln = self.log_len_of(ids)
        kk = ln.clip(1, self.L) if isinstance(ln, torch.Tensor) \
            else np.clip(ln, 1, self.L)
        rest = (ids - self._offset(kk))
        rest = rest.clamp(min=0) if isinstance(rest, torch.Tensor) \
            else np.maximum(rest, 0)
        return _where(ln > 0, self._offset(kk - 1) + rest // self.R, 0)

    def decode(self, ids):
        """Rank -> padded ``(log_term [..., L], log_val [..., L], log_len)``,
        digits extracted from the most significant side."""
        L, R, V = self.L, self.R, self.V
        ln = self.log_len_of(ids)
        rem = ids - self._offset(ln)
        terms, vals = [], []
        for k in range(L):
            w = 0 * ln + 1
            for e in range(1, L):               # w = R^(ln-1-k) where k < ln
                w = _where(ln - 1 - k >= e, w * R, w)
            live = k < ln
            digit = _where(live, rem // w, 0)
            rem = _where(live, rem - digit * w, rem)
            terms.append(_where(live, digit // V + 1, 0))
            vals.append(_where(live, digit % V + 1, 0))
        if isinstance(ids, torch.Tensor):
            z = ids.new_zeros(ids.shape + (0,))
            stack = (lambda xs: torch.stack(xs, -1).to(torch.int32)) \
                if L else (lambda xs: z)
        else:
            z = np.zeros(np.shape(ids) + (0,), np.int32)
            stack = (lambda xs: np.stack(xs, -1).astype(np.int32)) \
                if L else (lambda xs: z)
        return stack(terms), stack(vals), _i32(ln, ln)

    # -- host-side conveniences ----------------------------------------------

    def id_of_tuple(self, log: tuple) -> int:
        """Rank of a ((term, value), ...) tuple (interpreter form)."""
        k = len(log)
        if k > self.L:
            raise OverflowError(f"log of length {k} exceeds universe L={self.L}")
        rid = self.offsets[k]
        for pos, (t, v) in enumerate(log):
            if not (1 <= t <= self.T and 1 <= v <= self.V):
                raise OverflowError(f"entry ({t},{v}) outside universe "
                                    f"T={self.T} V={self.V}")
            rid += ((t - 1) * self.V + (v - 1)) * self.R ** (k - 1 - pos)
        return rid

    def tuple_of_id(self, rid: int) -> tuple:
        """Inverse of :meth:`id_of_tuple`."""
        lt, lv, ln = self.decode(np.asarray(rid, np.int64))
        return tuple((int(lt[..., k]), int(lv[..., k]))
                     for k in range(int(ln)))
