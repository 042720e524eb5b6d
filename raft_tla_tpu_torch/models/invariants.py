"""Invariant registry — the port of ``raft_tla_tpu/models/invariants.py``.

``NoTwoLeaders`` (the reference cfg's otherwise undefined operator) is Raft's
Election Safety: at most one leader per term.  ``NaiveNoTwoLeaders`` ("never
two leaders in any terms") is NOT an invariant of Raft — a deposed leader
keeps ``state = Leader`` until it sees a higher term — and stays as the smoke
test that violations and traces are found.

Every invariant has two faces: a Python predicate over
:class:`~raft_tla_tpu_torch.models.interp.PyState` and a torch predicate over
a batch of tensor structs (one bool per state, leading dims kept).
``csrc/step.cu`` evaluates the same predicates per lane, by the code of
:data:`CODES`.  The three history invariants (:data:`HISTORY_REGISTRY`)
read the faithful-mode fields and are accepted only with ``Bounds.history``
(config.py).  Any other name is a whole-line predicate expression over the
14 parity fields (frontend/predicate.py): its Python face unpacks the state
and evaluates it with numpy, as the reference's does; its torch face is the
batched evaluator; K1 runs it as the flat program of ops/predprog.py.
"""

from __future__ import annotations

import functools

import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import spec as S


# -- Python (oracle) predicates: state -> bool (True = invariant holds) ------

def _py_election_safety(s, bounds: Bounds) -> bool:
    n = bounds.n_servers
    return not any(
        s.role[i] == S.LEADER and s.role[j] == S.LEADER
        and s.term[i] == s.term[j]
        for i in range(n) for j in range(i + 1, n))


def _py_naive_no_two_leaders(s, bounds: Bounds) -> bool:
    return sum(1 for r in s.role if r == S.LEADER) <= 1


def _py_log_matching(s, bounds: Bounds) -> bool:
    """If two logs share (index, term), they agree on the whole prefix."""
    n = bounds.n_servers
    for i in range(n):
        for j in range(i + 1, n):
            li, lj = s.log[i], s.log[j]
            for k in range(min(len(li), len(lj))):
                if li[k][0] == lj[k][0] and li[:k + 1] != lj[:k + 1]:
                    return False
    return True


def _py_committed_within_log(s, bounds: Bounds) -> bool:
    """commitIndex never points past the log."""
    return all(s.commitIndex[i] <= len(s.log[i])
               for i in range(bounds.n_servers))


def _py_leader_completeness(s, bounds: Bounds) -> bool:
    """Leader Completeness, state-level reading: for every j, every
    k <= commitIndex[j] and every leader i with currentTerm[i] >
    currentTerm[j], the identical entry sits at k in log[i] (the commit
    term of j's entries is at most currentTerm[j])."""
    n = bounds.n_servers
    for j in range(n):
        for k in range(s.commitIndex[j]):
            ent = s.log[j][k]
            for i in range(n):
                if (s.role[i] == S.LEADER and s.term[i] > s.term[j]
                        and (len(s.log[i]) <= k or s.log[i][k] != ent)):
                    return False
    return True


def _py_election_safety_hist(s, bounds: Bounds) -> bool:
    """Election Safety over the ``elections`` history set: at most one
    leader was *ever* elected per term (raft.tla:237-242)."""
    if s.elections is None:
        return True
    terms = {}
    for (eterm, eleader, _elog, _evotes, _evlog) in s.elections:
        if terms.setdefault(eterm, eleader) != eleader:
            return False
    return True


def _py_leader_completeness_hist(s, bounds: Bounds) -> bool:
    """Leader Completeness over history (the proof's reading): every entry
    committed now is in the ``elog`` of every recorded election of a later
    term, including elections whose leader has since crashed or been
    deposed."""
    if s.elections is None:
        return True
    for j in range(bounds.n_servers):
        for k in range(s.commitIndex[j]):
            ent = s.log[j][k]
            for (eterm, _el, elog, _ev, _evl) in s.elections:
                if eterm > s.term[j] and (len(elog) <= k or elog[k] != ent):
                    return False
    return True


def _py_all_logs_prefix_closed(s, bounds: Bounds) -> bool:
    """``allLogs`` is prefix-closed: logs grow by single appends and every
    pre-state log is recorded (raft.tla:465)."""
    if s.allLogs is None:
        return True
    seen = set(s.allLogs)
    return all(l[:-1] in seen for l in s.allLogs if l)


# -- torch predicates: struct [..., fields] -> bool [...] -------------------

def _t_election_safety(st):
    is_l = st["role"] == S.LEADER
    same_term = st["term"].unsqueeze(-1) == st["term"].unsqueeze(-2)
    both = is_l.unsqueeze(-1) & is_l.unsqueeze(-2) & same_term
    n = st["role"].shape[-1]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=st["role"].device)
    return ~(both & off_diag).flatten(-2).any(-1)


def _t_naive_no_two_leaders(st):
    return (st["role"] == S.LEADER).sum(-1) <= 1


def _t_log_matching(st):
    lt, lv, ln = st["logTerm"], st["logVal"], st["logLen"]
    ks = torch.arange(lt.shape[-1], device=lt.device)
    # [..., i, j, k] masks
    short = torch.minimum(ln.unsqueeze(-1), ln.unsqueeze(-2))
    valid = ks < short.unsqueeze(-1)
    term_eq = lt.unsqueeze(-2) == lt.unsqueeze(-3)
    ent_eq = term_eq & (lv.unsqueeze(-2) == lv.unsqueeze(-3))
    prefix_eq = torch.cumprod(ent_eq.to(torch.int32), dim=-1) > 0
    bad = valid & term_eq & ~prefix_eq
    return ~bad.flatten(-3).any(-1)


def _t_committed_within_log(st):
    return (st["commitIndex"] <= st["logLen"]).all(-1)


def _t_leader_completeness(st):
    lt, lv = st["logTerm"], st["logVal"]
    ks = torch.arange(lt.shape[-1], device=lt.device)
    committed = ks < st["commitIndex"].unsqueeze(-1)               # [j, k]
    is_leader = st["role"] == S.LEADER                             # [i]
    later = st["term"].unsqueeze(-1) > st["term"].unsqueeze(-2)    # [i, j]
    must_hold = (is_leader.unsqueeze(-1) & later).unsqueeze(-1) \
        & committed.unsqueeze(-3)                                  # [i, j, k]
    present = ks < st["logLen"].unsqueeze(-1)                      # [i, k]
    same = (lt.unsqueeze(-2) == lt.unsqueeze(-3)) \
        & (lv.unsqueeze(-2) == lv.unsqueeze(-3))                   # [i, j, k]
    ok = present.unsqueeze(-2) & same
    return ~(must_hold & ~ok).flatten(-3).any(-1)


def _t_election_safety_hist(st, bounds):
    occ = st["eTerm"] > 0
    both = occ.unsqueeze(-1) & occ.unsqueeze(-2)
    same_term = st["eTerm"].unsqueeze(-1) == st["eTerm"].unsqueeze(-2)
    diff_leader = st["eLeader"].unsqueeze(-1) != st["eLeader"].unsqueeze(-2)
    return ~(both & same_term & diff_leader).flatten(-2).any(-1)


def _t_leader_completeness_hist(st, bounds):
    from raft_tla_tpu_torch.ops.loguniv import LogUniverse
    lt, lv = st["logTerm"], st["logVal"]
    ks = torch.arange(lt.shape[-1], device=lt.device)
    committed = ks < st["commitIndex"].unsqueeze(-1)               # [j, k]
    et, ev, eln = LogUniverse.of(bounds).decode(st["eLog"])        # [e, k]
    occ = st["eTerm"] > 0
    later = occ.unsqueeze(-1) & (st["eTerm"].unsqueeze(-1)
                                 > st["term"].unsqueeze(-2))       # [e, j]
    long_enough = ks < eln.unsqueeze(-1)                           # [e, k]
    same = (et.unsqueeze(-2) == lt.unsqueeze(-3)) \
        & (ev.unsqueeze(-2) == lv.unsqueeze(-3))                   # [e, j, k]
    ok = long_enough.unsqueeze(-2) & same
    must = later.unsqueeze(-1) & committed.unsqueeze(-3)
    return ~(must & ~ok).flatten(-3).any(-1)


def _t_all_logs_prefix_closed(st, bounds):
    from raft_tla_tpu_torch.ops.loguniv import LogUniverse
    uni = LogUniverse.of(bounds)
    mask = st["allLogs"]
    rs = torch.arange(uni.size, device=mask.device)
    parent = uni.prefix_id(rs)

    def has(r):
        return (mask[..., r // 32] >> (r % 32)) & 1

    bad = (has(rs) > 0) & (rs >= 1) & (has(parent) == 0)
    return ~bad.any(-1)


# name -> (python predicate, torch predicate)
REGISTRY = {
    "NoTwoLeaders": (_py_election_safety, _t_election_safety),
    "ElectionSafety": (_py_election_safety, _t_election_safety),
    "NaiveNoTwoLeaders": (_py_naive_no_two_leaders, _t_naive_no_two_leaders),
    "LogMatching": (_py_log_matching, _t_log_matching),
    "CommittedWithinLog": (_py_committed_within_log, _t_committed_within_log),
    "LeaderCompleteness": (_py_leader_completeness, _t_leader_completeness),
}

# History-based invariants: they read the faithful-mode fields, so
# CheckConfig accepts them only with Bounds.history.  Their torch predicates
# take the bounds (the log universe) as a second argument.
HISTORY_REGISTRY = {
    "ElectionSafetyHist": (_py_election_safety_hist,
                           _t_election_safety_hist),
    "LeaderCompletenessHist": (_py_leader_completeness_hist,
                               _t_leader_completeness_hist),
    "AllLogsPrefixClosed": (_py_all_logs_prefix_closed,
                            _t_all_logs_prefix_closed),
}
REGISTRY.update(HISTORY_REGISTRY)

# Which struct fields each invariant's predicate reads (the reference's
# table, for analysis/cfglint): an invariant whose READS no transition of
# the active spec subset writes is vacuous, and one reading fields a VIEW
# rewrites is checked only up to the view.  Keep in sync with the
# _py_*/_t_* bodies above.
READS = {
    "NoTwoLeaders": ("role", "term"),
    "ElectionSafety": ("role", "term"),
    "NaiveNoTwoLeaders": ("role",),
    "LogMatching": ("logTerm", "logVal", "logLen"),
    "CommittedWithinLog": ("commitIndex", "logLen"),
    "LeaderCompleteness": ("role", "term", "logTerm", "logVal", "logLen",
                           "commitIndex"),
    "ElectionSafetyHist": ("eTerm", "eLeader"),
    "LeaderCompletenessHist": ("eTerm", "eLog", "term", "commitIndex",
                               "logTerm", "logVal", "logLen"),
    "AllLogsPrefixClosed": ("allLogs",),
}

# name -> predicate code in csrc/step.cu (``enum Invariant``)
CODES = {
    "NoTwoLeaders": 0, "ElectionSafety": 0, "NaiveNoTwoLeaders": 1,
    "LogMatching": 2, "CommittedWithinLog": 3, "LeaderCompleteness": 4,
    "ElectionSafetyHist": 5, "LeaderCompletenessHist": 6,
    "AllLogsPrefixClosed": 7,
}


@functools.lru_cache(maxsize=None)
def _expression(text: str):
    """Compile a non-registry invariant as a frontend predicate over the
    Raft state schema (cached: cfg text recurs per step build)."""
    from raft_tla_tpu_torch.frontend.predicate import compile_predicate
    from raft_tla_tpu_torch.ops.state import STATE_FIELDS
    return compile_predicate(text, fields=STATE_FIELDS)


def py_invariant(name: str):
    if name in REGISTRY:
        return REGISTRY[name][0]
    pred = _expression(name)

    def check(s, bounds) -> bool:
        import numpy as np
        from raft_tla_tpu_torch.models import interp
        from raft_tla_tpu_torch.ops import state as st
        struct = st.unpack(interp.to_vec(s, bounds), st.Layout.of(bounds))
        return bool(pred.ev(struct, np))

    return check


def torch_invariant(name: str, bounds: Bounds):
    """The batched torch predicate of ``name`` for ``bounds``: one bool per
    state, leading dims kept."""
    if name not in REGISTRY:
        pred = _expression(name)

        def check(st):
            lead = st["role"].shape[:-1]
            n = 1
            for d in lead:
                n *= d
            flat = {f: st[f].reshape((n,) + st[f].shape[len(lead):])
                    for f in pred.reads}
            return pred.ev_torch(flat, n, st["role"].device).reshape(lead)

        return check
    fn = REGISTRY[name][1]
    if name in HISTORY_REGISTRY:
        return lambda st: fn(st, bounds)
    return fn
