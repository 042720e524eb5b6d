"""Reference interpreter — the port's copy of ``raft_tla_tpu/models/interp.py``.

A deliberately straight-line, un-optimized Python reading of the spec's
guards and effects (``raft.tla:99-465``) over hashable states.  The plain
torch step and the CUDA step are held against it through the JAX reference
in the tests, and the engine uses it for the initial state, trace rendering
and trace replay.

Parity mode (default): the proof-only history variables — ``elections``
(raft.tla:39), ``allLogs`` (raft.tla:44), ``voterLog`` (raft.tla:77) and the
``mlog`` message fields (raft.tla:220-222, 297-299) — are stripped.  No guard
reads them, so the transition behaviour is unchanged; only state identity
coarsens.

Faithful mode (``Bounds.history``): the history variables are carried as
real state, as stock TLC fingerprints them on the unmodified spec —
``allLogs' = allLogs \\cup {log[i] : i \\in Server}`` conjoined (with the
*unprimed* logs) onto every step (raft.tla:464-465), ``voterLog`` rows
cleared by Restart/Timeout (raft.tla:171,186) and extended by granted vote
responses via ``@@`` (keep-existing, raft.tla:316-317), ``elections``
accumulated by BecomeLeader (raft.tla:237-242), and ``mlog`` carried in
RequestVoteResponse/AppendEntriesRequest records as log-universe ranks
(ops/loguniv.py).

Messages use the same packed (hi, lo) content words as the tensor encoding
(ops/msgbits.py), so slot ordering, bag equality and packing agree with the
kernels by construction.
"""

from __future__ import annotations

import dataclasses
import functools as _functools
from typing import Iterator, Optional

import numpy as np

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import spec as S
from raft_tla_tpu_torch.ops import msgbits as mb
from raft_tla_tpu_torch.ops import state as st


@dataclasses.dataclass(frozen=True)
class PyState:
    """One state of the (parity-mode) spec; all fields hashable tuples.

    ``log`` is a tuple per server of (term, value) pairs (``raft.tla:61``);
    ``vResp``/``vGrant`` are bitmask ints over servers (``raft.tla:69,72``);
    ``msgs`` is the bag (``raft.tla:32``) as a tuple of ((hi, lo), count)
    sorted by (hi, lo) — the canonical slot order of the tensor encoding.
    """

    role: tuple
    term: tuple
    votedFor: tuple      # 0 = Nil, else server id + 1
    commitIndex: tuple
    log: tuple           # per server: tuple[(term, value), ...]
    vResp: tuple         # bitmask
    vGrant: tuple        # bitmask
    nextIndex: tuple     # per server: tuple[int, ...]
    matchIndex: tuple
    msgs: tuple          # sorted tuple[((hi, lo), count), ...]
    # Faithful mode only (None in parity mode):
    allLogs: tuple = None    # sorted tuple of logs ever seen (raft.tla:44)
    vLog: tuple = None       # voterLog[i][j]: log tuple or None (raft.tla:77)
    elections: tuple = None  # sorted (eterm, eleader, elog, evotes, evoterLog)

    def _replace(self, **kw) -> "PyState":
        return dataclasses.replace(self, **kw)


def init_state(bounds: Bounds) -> PyState:
    """``Init`` (raft.tla:155-160): the unique initial state."""
    n = bounds.n_servers
    hist = {}
    if bounds.history:
        # InitHistoryVars (raft.tla:140-142): empty set, empty set, empty maps.
        hist = dict(allLogs=(), vLog=((None,) * n,) * n, elections=())
    return PyState(
        role=(S.FOLLOWER,) * n,
        term=(1,) * n,                      # InitServerVars, raft.tla:143
        votedFor=(S.NIL,) * n,
        commitIndex=(0,) * n,
        log=((),) * n,                      # InitLogVars, raft.tla:153-154
        vResp=(0,) * n,
        vGrant=(0,) * n,                    # InitCandidateVars, raft.tla:146-147
        nextIndex=((1,) * n,) * n,          # InitLeaderVars, raft.tla:151-152
        matchIndex=((0,) * n,) * n,
        msgs=(),                            # raft.tla:155
        **hist,
    )


# -- helpers (raft.tla:99-135) ----------------------------------------------

def last_term(log: tuple) -> int:
    """``LastTerm(xlog)`` (raft.tla:102)."""
    return log[-1][0] if log else 0


def quorum(mask: int, n: int) -> bool:
    """``votesGranted[i] \\in Quorum`` (raft.tla:99) as a popcount test."""
    return 2 * mask.bit_count() > n


def with_message(m: tuple, msgs: tuple) -> tuple:
    """``WithMessage`` (raft.tla:106-110): bag insert, canonical order kept."""
    d = dict(msgs)
    d[m] = d.get(m, 0) + 1
    return tuple(sorted(d.items()))


def without_message(m: tuple, msgs: tuple) -> tuple:
    """``WithoutMessage`` (raft.tla:114-119): bag remove (no-op if absent)."""
    d = dict(msgs)
    if m in d:
        if d[m] <= 1:
            del d[m]
        else:
            d[m] -= 1
    return tuple(sorted(d.items()))


def _upd(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


# -- faithful-mode helpers (history variables) -------------------------------

def _log_key(log: tuple) -> tuple:
    """Sort key matching log-universe rank order (ops/loguniv.py): by
    length, then lexicographically by entries — entry codes are
    lex-increasing in (term, value), so plain tuple comparison agrees."""
    return (len(log), log)


def _opt_log_key(log) -> tuple:
    """Key matching rank+1 order (0 = absent sorts first)."""
    return (0,) if log is None else (1,) + _log_key(log)


def _election_key(rec: tuple) -> tuple:
    """Canonical election-slot order: must match ops/state.canonicalize."""
    eterm, eleader, elog, evotes, evlog = rec
    return (eterm, eleader, _log_key(elog), evotes,
            tuple(_opt_log_key(l) for l in evlog))


def _clear_vlog_row(s: "PyState", i: int, n: int) -> dict:
    """``voterLog' = [voterLog EXCEPT ![i] = empty map]`` (raft.tla:171,186)."""
    if s.vLog is None:
        return {}
    return {"vLog": _upd(s.vLog, i, (None,) * n)}


# -- actions (raft.tla:167-276); return None when the guard is disabled ------

def restart(s: PyState, i: int, n: int) -> PyState:
    """``Restart(i)`` (raft.tla:167-175): crash-recover from stable storage.

    Keeps currentTerm/votedFor/log (and messages); resets role to Follower,
    vote sets, nextIndex -> 1, matchIndex -> 0, commitIndex -> 0.
    """
    return s._replace(
        role=_upd(s.role, i, S.FOLLOWER),
        vResp=_upd(s.vResp, i, 0),
        vGrant=_upd(s.vGrant, i, 0),
        nextIndex=_upd(s.nextIndex, i, (1,) * n),
        matchIndex=_upd(s.matchIndex, i, (0,) * n),
        commitIndex=_upd(s.commitIndex, i, 0),
        **_clear_vlog_row(s, i, n),
    )


def timeout(s: PyState, i: int) -> Optional[PyState]:
    """``Timeout(i)`` (raft.tla:178-187): start an election.

    Becomes Candidate with term+1 but does *not* vote for itself —
    self-voting goes through the network (raft.tla:181-183).
    """
    if s.role[i] not in (S.FOLLOWER, S.CANDIDATE):
        return None
    return s._replace(
        role=_upd(s.role, i, S.CANDIDATE),
        term=_upd(s.term, i, s.term[i] + 1),
        votedFor=_upd(s.votedFor, i, S.NIL),
        vResp=_upd(s.vResp, i, 0),
        vGrant=_upd(s.vGrant, i, 0),
        **_clear_vlog_row(s, i, len(s.role)),
    )


def request_vote(s: PyState, i: int, j: int) -> Optional[PyState]:
    """``RequestVote(i, j)`` (raft.tla:190-199); j may equal i (raft.tla:456)."""
    if s.role[i] != S.CANDIDATE or (s.vResp[i] >> j) & 1:
        return None
    m = mb.rv_request(s.term[i], last_term(s.log[i]), len(s.log[i]), i, j)
    return s._replace(msgs=with_message(m, s.msgs))


def append_entries(s: PyState, i: int, j: int, uni=None) -> Optional[PyState]:
    """``AppendEntries(i, j)`` (raft.tla:204-226): <=1 entry from nextIndex.

    Also the heartbeat (empty ``mentries`` when nextIndex is past the log);
    piggybacks ``mcommitIndex = Min(commitIndex[i], lastEntry)`` (raft.tla:223).
    In faithful mode the record carries ``mlog = log[i]`` as a universe rank
    (raft.tla:220-222).
    """
    if i == j or s.role[i] != S.LEADER:
        return None
    log_i = s.log[i]
    ni = s.nextIndex[i][j]
    prev_idx = ni - 1
    prev_term = log_i[prev_idx - 1][0] if prev_idx > 0 else 0
    last_entry = min(len(log_i), ni)
    if ni <= last_entry:
        n_ent, ent_term, ent_val = 1, log_i[ni - 1][0], log_i[ni - 1][1]
    else:
        n_ent, ent_term, ent_val = 0, 0, 0
    mlog = uni.id_of_tuple(log_i) if uni is not None else 0
    m = mb.ae_request(s.term[i], prev_idx, prev_term, n_ent, ent_term, ent_val,
                      min(s.commitIndex[i], last_entry), i, j, mlog)
    return s._replace(msgs=with_message(m, s.msgs))


def become_leader(s: PyState, i: int, n: int) -> Optional[PyState]:
    """``BecomeLeader(i)`` (raft.tla:229-243).

    In faithful mode also records the election into the ``elections``
    history set (raft.tla:237-242): [eterm, eleader, elog, evotes,
    evoterLog], all from the unprimed state.
    """
    if s.role[i] != S.CANDIDATE or not quorum(s.vGrant[i], n):
        return None
    hist = {}
    if s.elections is not None:
        rec = (s.term[i], i, s.log[i], s.vGrant[i], s.vLog[i])
        recs = set(s.elections) | {rec}
        hist = {"elections": tuple(sorted(recs, key=_election_key))}
    return s._replace(
        role=_upd(s.role, i, S.LEADER),
        nextIndex=_upd(s.nextIndex, i, (len(s.log[i]) + 1,) * n),
        matchIndex=_upd(s.matchIndex, i, (0,) * n),
        **hist,
    )


def client_request(s: PyState, i: int, v: int) -> Optional[PyState]:
    """``ClientRequest(i, v)`` (raft.tla:246-253): leader appends locally."""
    if s.role[i] != S.LEADER:
        return None
    return s._replace(log=_upd(s.log, i, s.log[i] + ((s.term[i], v),)))


def advance_commit_index(s: PyState, i: int, n: int) -> Optional[PyState]:
    """``AdvanceCommitIndex(i)`` (raft.tla:259-276).

    Commits ``Max(agreeIndexes)`` only when that entry is from the current
    term — the current-term-commit restriction (raft.tla:268-270).  Note the
    term test applies to the *max* agree index only.
    """
    if s.role[i] != S.LEADER:
        return None
    log_i = s.log[i]
    agree_indexes = [
        idx for idx in range(1, len(log_i) + 1)
        if 2 * len({i} | {k for k in range(n) if s.matchIndex[i][k] >= idx}) > n
    ]
    if agree_indexes and log_i[max(agree_indexes) - 1][0] == s.term[i]:
        new_commit = max(agree_indexes)
    else:
        new_commit = s.commitIndex[i]
    return s._replace(commitIndex=_upd(s.commitIndex, i, new_commit))


# -- message handlers (raft.tla:284-418), dispatched by receive --------------

def _handle_request_vote_request(s, i, j, m_hi, m_lo, uni=None):
    """``HandleRequestVoteRequest`` (raft.tla:284-303), mterm <= currentTerm."""
    mt = mb.mterm(m_hi)
    log_ok = (mb.fa(m_hi) > last_term(s.log[i])
              or (mb.fa(m_hi) == last_term(s.log[i])
                  and mb.fb(m_hi) >= len(s.log[i])))       # raft.tla:285-287
    grant = (mt == s.term[i] and log_ok
             and s.votedFor[i] in (S.NIL, j + 1))           # raft.tla:288-290
    mlog = uni.id_of_tuple(s.log[i]) if uni is not None else 0
    resp = mb.rv_response(s.term[i], int(grant), i, j, mlog)  # mlog :297-299
    msgs = without_message((m_hi, m_lo), with_message(resp, s.msgs))  # Reply :129-130
    out = s._replace(msgs=msgs)
    if grant:
        out = out._replace(votedFor=_upd(s.votedFor, i, j + 1))  # raft.tla:292
    return out


def _handle_request_vote_response(s, i, j, m_hi, m_lo, uni=None):
    """``HandleRequestVoteResponse`` (raft.tla:307-321), mterm = currentTerm.

    Tallies even when i is not a Candidate (harmless, raft.tla:308-309).
    In faithful mode a granted vote extends ``voterLog[i]`` with
    ``j :> m.mlog`` via ``@@`` — the *existing* entry wins on a duplicated
    response (raft.tla:316-317).
    """
    out = s._replace(vResp=_upd(s.vResp, i, s.vResp[i] | (1 << j)))
    if mb.fa(m_hi):                                          # mvoteGranted
        out = out._replace(vGrant=_upd(out.vGrant, i, out.vGrant[i] | (1 << j)))
        if uni is not None and s.vLog[i][j] is None:
            row = _upd(s.vLog[i], j, uni.tuple_of_id(mb.fg(m_lo)))
            out = out._replace(vLog=_upd(s.vLog, i, row))
    return out._replace(msgs=without_message((m_hi, m_lo), s.msgs))


def _handle_append_entries_request(s, i, j, m_hi, m_lo):
    """``HandleAppendEntriesRequest`` (raft.tla:327-389), mterm <= currentTerm.

    Three-way outer branch (reject / candidate-step-down / accept), with the
    accept case split into already-done / conflict-truncate-one / append
    (raft.tla:356-388).  The conflict and append branches *keep* the request
    in the bag, producing the spec's multi-step convergence loop (SURVEY §2.6).
    A Leader receiving a same-term request enables no branch (unreachable
    under Election Safety, but arbitrary differential-test states hit it).
    """
    mt = mb.mterm(m_hi)
    prev_idx, prev_term = mb.fa(m_hi), mb.fb(m_hi)
    n_ent, ent_term, ent_val = mb.fc(m_lo), mb.fd(m_lo), mb.fe(m_lo)
    log_i = s.log[i]
    log_ok = (prev_idx == 0
              or (0 < prev_idx <= len(log_i)
                  and prev_term == log_i[prev_idx - 1][0]))  # raft.tla:328-331
    # reject (raft.tla:333-345)
    if mt < s.term[i] or (mt == s.term[i] and s.role[i] == S.FOLLOWER
                          and not log_ok):
        resp = mb.ae_response(s.term[i], 0, 0, i, j)
        return s._replace(
            msgs=without_message((m_hi, m_lo), with_message(resp, s.msgs)))
    # return to follower state (raft.tla:346-350); message kept
    if mt == s.term[i] and s.role[i] == S.CANDIDATE:
        return s._replace(role=_upd(s.role, i, S.FOLLOWER))
    # accept (raft.tla:351-388)
    if mt == s.term[i] and s.role[i] == S.FOLLOWER and log_ok:
        index = prev_idx + 1
        if n_ent == 0 or (len(log_i) >= index
                          and log_i[index - 1][0] == ent_term):
            # already done with request (raft.tla:356-374); commitIndex may
            # DECREASE on an old duplicated request (raft.tla:361-363).
            resp = mb.ae_response(s.term[i], 1, prev_idx + n_ent, i, j)
            return s._replace(
                commitIndex=_upd(s.commitIndex, i, mb.ff(m_lo)),
                msgs=without_message((m_hi, m_lo),
                                     with_message(resp, s.msgs)))
        if len(log_i) >= index and log_i[index - 1][0] != ent_term:
            # conflict: remove exactly one entry off the TAIL (raft.tla:375-382)
            return s._replace(log=_upd(s.log, i, log_i[:-1]))
        if len(log_i) == prev_idx:
            # no conflict: append entry (raft.tla:383-388)
            return s._replace(
                log=_upd(s.log, i, log_i + ((ent_term, ent_val),)))
    return None


def _handle_append_entries_response(s, i, j, m_hi, m_lo):
    """``HandleAppendEntriesResponse`` (raft.tla:393-403), mterm = currentTerm."""
    if mb.fa(m_hi):  # msuccess
        match = mb.fb(m_hi)
        nexti = _upd(s.nextIndex[i], j, match + 1)
        matchi = _upd(s.matchIndex[i], j, match)
        out = s._replace(nextIndex=_upd(s.nextIndex, i, nexti),
                         matchIndex=_upd(s.matchIndex, i, matchi))
    else:
        nexti = _upd(s.nextIndex[i], j, max(s.nextIndex[i][j] - 1, 1))
        out = s._replace(nextIndex=_upd(s.nextIndex, i, nexti))
    return out._replace(msgs=without_message((m_hi, m_lo), s.msgs))


def receive(s: PyState, slot: int, uni=None) -> Optional[PyState]:
    """``Receive(m)`` (raft.tla:421-436) on the slot-th canonical bag element.

    The guards partition on mterm vs currentTerm[i] (>, =, <), so dispatch is
    deterministic per message; all nondeterminism is in *which* slot is picked
    (SURVEY §2.6).
    """
    if slot >= len(s.msgs):
        return None
    (m_hi, m_lo), _count = s.msgs[slot]
    i, j = mb.dst(m_hi), mb.src(m_hi)
    mt, mty = mb.mterm(m_hi), mb.mtype(m_hi)
    if mt > s.term[i]:
        # UpdateTerm (raft.tla:406-412): adopt term, -> Follower; message is
        # NOT consumed, so it is reprocessed in a later step (raft.tla:411-412).
        return s._replace(term=_upd(s.term, i, mt),
                          role=_upd(s.role, i, S.FOLLOWER),
                          votedFor=_upd(s.votedFor, i, S.NIL))
    if mty == S.M_RVREQ:
        return _handle_request_vote_request(s, i, j, m_hi, m_lo, uni)
    if mty == S.M_RVRESP:
        if mt < s.term[i]:  # DropStaleResponse (raft.tla:415-418)
            return s._replace(msgs=without_message((m_hi, m_lo), s.msgs))
        return _handle_request_vote_response(s, i, j, m_hi, m_lo, uni)
    if mty == S.M_AEREQ:
        return _handle_append_entries_request(s, i, j, m_hi, m_lo)
    if mty == S.M_AERESP:
        if mt < s.term[i]:  # DropStaleResponse (raft.tla:415-418)
            return s._replace(msgs=without_message((m_hi, m_lo), s.msgs))
        return _handle_append_entries_response(s, i, j, m_hi, m_lo)
    return None


def duplicate_message(s: PyState, slot: int) -> Optional[PyState]:
    """``DuplicateMessage(m)`` (raft.tla:443-445): network duplication fault."""
    if slot >= len(s.msgs):
        return None
    return s._replace(msgs=with_message(s.msgs[slot][0], s.msgs))


def drop_message(s: PyState, slot: int) -> Optional[PyState]:
    """``DropMessage(m)`` (raft.tla:448-450): network loss fault."""
    if slot >= len(s.msgs):
        return None
    return s._replace(msgs=without_message(s.msgs[slot][0], s.msgs))


# -- successor enumeration (Next, raft.tla:454-465) --------------------------

@_functools.lru_cache(maxsize=None)
def _uni(bounds: Bounds):
    from raft_tla_tpu_torch.ops.loguniv import LogUniverse
    return LogUniverse.of(bounds)


def apply_action(s: PyState, a: S.ActionInstance, bounds: Bounds
                 ) -> Optional[PyState]:
    n = bounds.n_servers
    uni = _uni(bounds) if bounds.history else None
    if a.family == S.RESTART:
        out = restart(s, a.i, n)
    elif a.family == S.TIMEOUT:
        out = timeout(s, a.i)
    elif a.family == S.REQUESTVOTE:
        out = request_vote(s, a.i, a.j)
    elif a.family == S.BECOMELEADER:
        out = become_leader(s, a.i, n)
    elif a.family == S.CLIENTREQUEST:
        out = client_request(s, a.i, a.v)
    elif a.family == S.ADVANCECOMMIT:
        out = advance_commit_index(s, a.i, n)
    elif a.family == S.APPENDENTRIES:
        out = append_entries(s, a.i, a.j, uni)
    elif a.family == S.RECEIVE:
        out = receive(s, a.slot, uni)
    elif a.family == S.DUPLICATE:
        out = duplicate_message(s, a.slot)
    elif a.family == S.DROP:
        out = drop_message(s, a.slot)
    else:
        raise AssertionError(a.family)
    if out is not None and bounds.history:
        # allLogs' = allLogs \cup {log[i] : i \in Server} — conjoined onto
        # EVERY Next disjunct with the *unprimed* logs (raft.tla:464-465).
        new = set(s.allLogs) | set(s.log)
        out = out._replace(allLogs=tuple(sorted(new, key=_log_key)))
    return out


def successors(s: PyState, bounds: Bounds, table=None, spec: str = "full"
               ) -> Iterator[tuple]:
    """Yield (action_index, successor) for every enabled ``Next`` disjunct."""
    if table is None:
        table = S.action_table(bounds, spec)
    for idx, a in enumerate(table):
        nxt = apply_action(s, a, bounds)
        if nxt is not None:
            yield idx, nxt


# -- struct/vector bridge (trace rendering and replay) -----------------------

def to_struct(s: PyState, bounds: Bounds) -> dict:
    """PyState -> numpy struct (ops/state.py layout), canonical by construction."""
    lay = st.Layout.of(bounds)
    n, L, Sc = lay.n, lay.L, lay.S
    out = st.init_struct(bounds)
    out["role"] = np.array(s.role, np.int32)
    out["term"] = np.array(s.term, np.int32)
    out["votedFor"] = np.array(s.votedFor, np.int32)
    out["commitIndex"] = np.array(s.commitIndex, np.int32)
    out["logLen"] = np.array([len(l) for l in s.log], np.int32)
    lt = np.zeros((n, L), np.int32)
    lv = np.zeros((n, L), np.int32)
    for i, l in enumerate(s.log):
        if len(l) > L:
            raise OverflowError(f"log of server {i} exceeds capacity {L}")
        for k, (t, v) in enumerate(l):
            lt[i, k], lv[i, k] = t, v
    out["logTerm"], out["logVal"] = lt, lv
    out["vResp"] = np.array(s.vResp, np.int32)
    out["vGrant"] = np.array(s.vGrant, np.int32)
    out["nextIndex"] = np.array(s.nextIndex, np.int32)
    out["matchIndex"] = np.array(s.matchIndex, np.int32)
    if len(s.msgs) > Sc:
        raise OverflowError(f"message bag exceeds {Sc} slots")
    hi = np.zeros((Sc,), np.int32)
    lo = np.zeros((Sc,), np.int32)
    ct = np.zeros((Sc,), np.int32)
    for k, ((h, l), c) in enumerate(s.msgs):
        hi[k], lo[k], ct[k] = h, l, c
    out["msgHi"], out["msgLo"], out["msgCount"] = hi, lo, ct
    if bounds.history:
        uni = _uni(bounds)
        E = bounds.max_elections
        mask = np.zeros((lay.Wa,), np.int64)
        for l in s.allLogs:
            r = uni.id_of_tuple(l)
            mask[r // 32] |= 1 << (r % 32)
        out["allLogs"] = mask.astype(np.uint32).view(np.int32)
        out["vLog"] = np.asarray(
            [[0 if l is None else uni.id_of_tuple(l) + 1
              for l in row] for row in s.vLog], np.int32)
        if len(s.elections) > E:
            raise OverflowError(f"elections set exceeds {E} slots")
        for k, (eterm, eleader, elog, evotes, evlog) in enumerate(s.elections):
            out["eTerm"][k] = eterm
            out["eLeader"][k] = eleader
            out["eLog"][k] = uni.id_of_tuple(elog)
            out["eVotes"][k] = evotes
            out["eVLog"][k] = [0 if l is None else uni.id_of_tuple(l) + 1
                               for l in evlog]
    return out


def from_struct(struct: dict, bounds: Bounds) -> PyState:
    """numpy struct -> PyState (inverse of :func:`to_struct`)."""
    n = bounds.n_servers
    log = tuple(
        tuple((int(struct["logTerm"][i, k]), int(struct["logVal"][i, k]))
              for k in range(int(struct["logLen"][i])))
        for i in range(n))
    msgs = tuple(
        ((int(struct["msgHi"][k]), int(struct["msgLo"][k])),
         int(struct["msgCount"][k]))
        for k in range(len(struct["msgCount"]))
        if int(struct["msgCount"][k]) > 0)
    hist = {}
    if bounds.history and "allLogs" in struct:
        uni = _uni(bounds)
        logs = []
        for w, word in enumerate(np.asarray(struct["allLogs"],
                                            np.int32).view(np.uint32)):
            word = int(word)
            for b in range(32):
                if word & (1 << b):
                    logs.append(uni.tuple_of_id(32 * w + b))
        vlog = tuple(
            tuple(None if int(x) == 0 else uni.tuple_of_id(int(x) - 1)
                  for x in row) for row in struct["vLog"])
        recs = []
        for k in range(len(struct["eTerm"])):
            if int(struct["eTerm"][k]) == 0:
                continue
            recs.append((
                int(struct["eTerm"][k]), int(struct["eLeader"][k]),
                uni.tuple_of_id(int(struct["eLog"][k])),
                int(struct["eVotes"][k]),
                tuple(None if int(x) == 0 else uni.tuple_of_id(int(x) - 1)
                      for x in struct["eVLog"][k])))
        hist = dict(allLogs=tuple(sorted(logs, key=_log_key)),
                    vLog=vlog,
                    elections=tuple(sorted(recs, key=_election_key)))
    return PyState(
        **hist,
        role=tuple(int(x) for x in struct["role"]),
        term=tuple(int(x) for x in struct["term"]),
        votedFor=tuple(int(x) for x in struct["votedFor"]),
        commitIndex=tuple(int(x) for x in struct["commitIndex"]),
        log=log,
        vResp=tuple(int(x) for x in struct["vResp"]),
        vGrant=tuple(int(x) for x in struct["vGrant"]),
        nextIndex=tuple(tuple(int(x) for x in row)
                        for row in struct["nextIndex"]),
        matchIndex=tuple(tuple(int(x) for x in row)
                         for row in struct["matchIndex"]),
        msgs=tuple(sorted(msgs)),
    )


def to_vec(s: PyState, bounds: Bounds) -> np.ndarray:
    return st.pack(to_struct(s, bounds))


def constraint_ok(s: PyState, bounds: Bounds) -> bool:
    """Host-side StateConstraint (must agree with ops/state.constraint_ok)."""
    return (all(t <= bounds.max_term for t in s.term)
            and all(len(l) <= bounds.max_log for l in s.log)
            and len(s.msgs) <= bounds.max_msgs
            and all(c <= bounds.max_dup for _m, c in s.msgs))
