"""Bit-packed message encoding — a copy of ``raft_tla_tpu/ops/msgbits.py``.

The tensor form of the spec's message records.

The reference's ``messages`` variable is a bag of heterogeneous records
(``raft.tla:32``, schemas built at ``raft.tla:193-198`` (RequestVoteRequest),
``raft.tla:294-301`` (RequestVoteResponse), ``raft.tla:215-225``
(AppendEntriesRequest), ``raft.tla:338-343,366-372`` (AppendEntriesResponse)).
Each distinct message maps to one slot of three int32s: two *content words*
``(hi, lo)`` and a multiplicity ``count`` (the bag value, ``raft.tla:106-119``).

Content is unioned into generic fields ``a..f`` so every record type fits one
layout (field meanings per type are in the table below).  Two messages are the
same bag element iff their ``(hi, lo)`` words are equal, and canonical state
ordering sorts slots by ``(hi, lo)`` — so packing *is* the equality and order
structure of the bag.

The ``mlog`` fields (``raft.tla:220-222`` and ``raft.tla:297-299``) are
proof-only history data: in parity mode they are stripped (field ``g`` = 0),
exactly as they are stripped from the derived history-free spec that the TLC
oracle runs (models/tla_export.py, SURVEY §7.0.3); in faithful mode they are
carried as log-universe ranks (ops/loguniv.py) and join message identity, as
in stock TLC on the unmodified spec.

=========  =============================  =====================================
field      bits (word@shift)              meaning by mtype
=========  =============================  =====================================
mtype      3  (hi@0)                      1=RVReq 2=RVResp 3=AEReq 4=AEResp
mterm      6  (hi@3)                      all types (raft.tla:194,295,216,339)
a          6  (hi@9)                      RVReq: mlastLogTerm (:195)
                                          RVResp: mvoteGranted (:296)
                                          AEReq: mprevLogIndex (:217)
                                          AEResp: msuccess (:340)
b          6  (hi@15)                     RVReq: mlastLogIndex (:196)
                                          AEReq: mprevLogTerm (:218)
                                          AEResp: mmatchIndex (:341)
src        4  (hi@21)                     msource (all)
dst        4  (hi@25)                     mdest (all)
c          1  (lo@0)                      AEReq: Len(mentries), 0|1 (:212-214)
d          6  (lo@1)                      AEReq: mentries[1].term
e          4  (lo@7)                      AEReq: mentries[1].value
f          6  (lo@11)                     AEReq: mcommitIndex (:223)
g          14 (lo@17)                     faithful mode only: ``mlog`` as a
                                          log-universe rank (ops/loguniv.py)
                                          AEReq :220-222, RVResp :297-299;
                                          0 in parity mode (stripped)
=========  =============================  =====================================

All helpers are plain shift/mask arithmetic, so they work identically on
Python ints, NumPy arrays and int32 torch tensors (the interpreter and the
plain torch step share this module; ``csrc/step.cu`` repeats the table).
Every field ends at or below bit 30, so arithmetic right shifts on int32
tensors are safe.
"""

from __future__ import annotations

# (shift, width) per field — THE packed-record encoding.  No field spills
# past bit 30, so the int32 sign bit stays clear.
HI_FIELDS = {"mtype": (0, 3), "mterm": (3, 6), "a": (9, 6), "b": (15, 6),
             "src": (21, 4), "dst": (25, 4)}
LO_FIELDS = {"c": (0, 1), "d": (1, 6), "e": (7, 4), "f": (11, 6),
             "g": (17, 14)}
_HI_FIELDS = HI_FIELDS
_LO_FIELDS = LO_FIELDS


def pack_hi(mtype, mterm, a, b, src, dst):
    return (mtype | (mterm << 3) | (a << 9) | (b << 15)
            | (src << 21) | (dst << 25))


def pack_lo(c, d, e, f, g=0):
    return c | (d << 1) | (e << 7) | (f << 11) | (g << 17)


def _get(word, shift, width):
    return (word >> shift) & ((1 << width) - 1)


def mtype(hi):
    return _get(hi, *_HI_FIELDS["mtype"])


def mterm(hi):
    return _get(hi, *_HI_FIELDS["mterm"])


def fa(hi):
    return _get(hi, *_HI_FIELDS["a"])


def fb(hi):
    return _get(hi, *_HI_FIELDS["b"])


def src(hi):
    return _get(hi, *_HI_FIELDS["src"])


def dst(hi):
    return _get(hi, *_HI_FIELDS["dst"])


def fc(lo):
    return _get(lo, *_LO_FIELDS["c"])


def fd(lo):
    return _get(lo, *_LO_FIELDS["d"])


def fe(lo):
    return _get(lo, *_LO_FIELDS["e"])


def ff(lo):
    return _get(lo, *_LO_FIELDS["f"])


def fg(lo):
    """``mlog`` as a log-universe rank (faithful mode only; 0 in parity)."""
    return _get(lo, *_LO_FIELDS["g"])


# -- typed constructors (field meanings per record schema, see module doc) ---

def rv_request(term, last_log_term, last_log_index, i, j):
    """RequestVoteRequest record (raft.tla:193-198)."""
    return pack_hi(1, term, last_log_term, last_log_index, i, j), pack_lo(0, 0, 0, 0)


def rv_response(term, granted, i, j, mlog=0):
    """RequestVoteResponse record (raft.tla:294-301).

    ``mlog`` — the voter's log as a universe rank (raft.tla:297-299) — is
    carried only in faithful mode; parity mode passes 0 (stripped).
    """
    return pack_hi(2, term, granted, 0, i, j), pack_lo(0, 0, 0, 0, mlog)


def ae_request(term, prev_idx, prev_term, n_entries, ent_term, ent_val,
               commit, i, j, mlog=0):
    """AppendEntriesRequest record (raft.tla:215-225).

    ``mlog`` — the leader's log as a universe rank (raft.tla:220-222) — is
    carried only in faithful mode; parity mode passes 0 (stripped).
    """
    return (pack_hi(3, term, prev_idx, prev_term, i, j),
            pack_lo(n_entries, ent_term, ent_val, commit, mlog))


def ae_response(term, success, match_idx, i, j):
    """AppendEntriesResponse record (raft.tla:338-343, 366-372)."""
    return pack_hi(4, term, success, match_idx, i, j), pack_lo(0, 0, 0, 0)
