"""The plain PyTorch frontier step — the port of ``raft_tla_tpu/ops/kernels.py``.

Each of the spec's 10 action families (``Next`` disjuncts,
``raft.tla:454-463``) is a guarded functional update on a batch of tensor
structs (ops/state.py): the guard is a bool, the effect is computed
unconditionally, ``torch.where`` selects.  The reference writes one state and
``jax.vmap``s it over action parameters and frontier rows; here both vmaps
are written out as batch dimensions.  Every family kernel takes the frontier
struct broadcast to ``[B, K, ...]`` and its K instances' parameters as
``[1, K]`` index tensors, and returns the successors ``[B, K, ...]`` with
``valid``/``overflow`` ``[B, K]``.

This is the plain version of the fused step kernel ``csrc/step.cu`` (see
ops/pallas_step.py): the CPU tests run it against the JAX reference, and
``chip_smoke.py`` holds the kernel against it on the card.  It is not a
yardstick of speed.

In faithful mode (``Bounds.history``) the steps also update the history
variables: Restart and Timeout clear ``voterLog[i]``, AppendEntries and the
RequestVote reply carry ``mlog`` as a log rank, a granted vote response
extends ``voterLog``, BecomeLeader inserts its record into the
``elections`` slots, and every lane's ``allLogs`` gains the parent's logs
(:func:`finish_expand`).

Capacity overflow is loud: ``bag_add`` (and the elections insert) report
when no slot is free, and the engine fails if the flag fires on a lane it
expands.
"""

from __future__ import annotations

import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import invariants as inv_mod
from raft_tla_tpu_torch.models import spec as SP
from raft_tla_tpu_torch.models import views
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import loguniv
from raft_tla_tpu_torch.ops import msgbits as mb
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym

I32 = torch.int32

# Calls of the plain fused step (chip_smoke.py checks that the card path
# never makes one).
calls = 0


# -- batched indexing helpers (one-hot updates, clamped gathers) -------------

def _get(a, i):
    """``a[..., i]`` per batch element; ``i`` broadcasts to ``a.shape[:-1]``
    and is clamped into range, as a JAX gather with a traced index is."""
    i = i.clamp(0, a.shape[-1] - 1).long().expand(a.shape[:-1])
    return torch.gather(a, -1, i.unsqueeze(-1)).squeeze(-1)


def _get_row(m, i):
    """``m[..., i, :]`` per batch element (clamped)."""
    i = i.clamp(0, m.shape[-2] - 1).long().expand(m.shape[:-2])
    idx = i[..., None, None].expand(*m.shape[:-2], 1, m.shape[-1])
    return torch.gather(m, -2, idx).squeeze(-2)


def _onehot(i, n):
    return torch.arange(n, device=i.device) == i.unsqueeze(-1)


def _lift(v, k):
    """A per-batch value, broadcastable against ``k`` more trailing dims."""
    if isinstance(v, torch.Tensor):
        return v.reshape(v.shape + (1,) * k)
    return v


def _set1(a, i, v):
    """``a`` with ``a[..., i] = v``."""
    return torch.where(_onehot(i, a.shape[-1]), _lift(v, 1), a)


def _set_row(m, i, v):
    """``m`` with row ``i`` set to the scalar ``v``."""
    return torch.where(_onehot(i, m.shape[-2]).unsqueeze(-1), _lift(v, 2), m)


def _set2(m, i, j, v):
    mask = _onehot(i, m.shape[-2]).unsqueeze(-1) \
        & _onehot(j, m.shape[-1]).unsqueeze(-2)
    return torch.where(mask, _lift(v, 2), m)


def _popcount(x):
    """Branchless popcount of a server bitmask (Quorum, ``raft.tla:99``);
    the reference's formula, exact for the non-negative masks it sees."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def _last_term(s, i):
    """``LastTerm(log[i])`` (raft.tla:102)."""
    ln = _get(s["logLen"], i)
    return torch.where(ln > 0, _get(_get_row(s["logTerm"], i), ln - 1), 0)


def _log_rank(bounds, s, i):
    """Rank of ``log[i]`` in the bounded log universe (faithful mode)."""
    return loguniv.LogUniverse.of(bounds).log_id(
        _get_row(s["logTerm"], i), _get_row(s["logVal"], i),
        _get(s["logLen"], i))


def _log_at(s, i, k):
    """``logTerm[i, clip(k)]`` / ``logVal[i, clip(k)]`` (0-based column)."""
    return _get(_get_row(s["logTerm"], i), k), _get(_get_row(s["logVal"], i), k)


# -- bag operations (raft.tla:106-130) ---------------------------------------

def _slot_insert(match, empty):
    """Set/bag insert plan over slot masks ``[..., M]``: ``(ins, overflow)``
    with ``ins`` the one-hot first free slot (all-False when the element
    exists or nothing is free).  Shared by the message bag and the
    faithful-mode elections set."""
    exists, has_empty = match.any(-1), empty.any(-1)
    first_empty = empty & (torch.cumsum(empty.to(I32), -1) == 1)
    ins = (~exists & has_empty).unsqueeze(-1) & first_empty
    return ins, ~exists & ~has_empty


def bag_add(s, hi, lo):
    """``WithMessage`` (raft.tla:106-110). Returns (struct', overflow)."""
    H, L, C = s["msgHi"], s["msgLo"], s["msgCount"]
    match = (H == hi.unsqueeze(-1)) & (L == lo.unsqueeze(-1)) & (C > 0)
    ins, ovf = _slot_insert(match, C == 0)
    out = dict(s)
    out["msgHi"] = torch.where(ins, hi.unsqueeze(-1), H)
    out["msgLo"] = torch.where(ins, lo.unsqueeze(-1), L)
    out["msgCount"] = C + match.to(I32) + ins.to(I32)
    return out, ovf


def bag_remove(s, hi, lo):
    """``WithoutMessage`` (raft.tla:114-119); no-op when absent."""
    H, L, C = s["msgHi"], s["msgLo"], s["msgCount"]
    match = (H == hi.unsqueeze(-1)) & (L == lo.unsqueeze(-1)) & (C > 0)
    c2 = C - match.to(I32)
    emptied = match & (c2 == 0)
    out = dict(s)
    out["msgHi"] = torch.where(emptied, 0, H)
    out["msgLo"] = torch.where(emptied, 0, L)
    out["msgCount"] = c2
    return out


def reply(s, resp_hi, resp_lo, req_hi, req_lo):
    """``Reply`` (raft.tla:129-130), evaluated remove-first: request and
    response always differ (mtype), so the two bag edits commute, and
    overflow then fires iff the *final* bag exceeds capacity."""
    return bag_add(bag_remove(s, req_hi, req_lo), resp_hi, resp_lo)


def _tree_select(branches, default):
    """Select among (guard, struct) branches; guards must be exclusive."""
    out = dict(default)
    for g, sb in branches:
        for f, a in sb.items():
            if a is not default[f]:
                out[f] = torch.where(_lift(g, a.ndim - g.ndim), a, out[f])
    return out


def _const(shape_of, value: bool):
    return torch.full(shape_of.shape[:2], value, dtype=torch.bool,
                      device=shape_of.device)


# -- action families ---------------------------------------------------------

def k_restart(bounds, s, i):
    """``Restart(i)`` (raft.tla:167-175): always enabled."""
    out = dict(s)
    out["role"] = _set1(s["role"], i, SP.FOLLOWER)
    out["vResp"] = _set1(s["vResp"], i, 0)
    out["vGrant"] = _set1(s["vGrant"], i, 0)
    out["nextIndex"] = _set_row(s["nextIndex"], i, 1)
    out["matchIndex"] = _set_row(s["matchIndex"], i, 0)
    out["commitIndex"] = _set1(s["commitIndex"], i, 0)
    if "vLog" in s:   # voterLog[i] := empty map (raft.tla:171)
        out["vLog"] = _set_row(s["vLog"], i, 0)
    return out, _const(s["role"], True), _const(s["role"], False)


def k_timeout(bounds, s, i):
    """``Timeout(i)`` (raft.tla:178-187)."""
    role_i = _get(s["role"], i)
    valid = (role_i == SP.FOLLOWER) | (role_i == SP.CANDIDATE)
    out = dict(s)
    out["role"] = _set1(s["role"], i, SP.CANDIDATE)
    out["term"] = _set1(s["term"], i, _get(s["term"], i) + 1)
    out["votedFor"] = _set1(s["votedFor"], i, SP.NIL)
    out["vResp"] = _set1(s["vResp"], i, 0)
    out["vGrant"] = _set1(s["vGrant"], i, 0)
    if "vLog" in s:   # voterLog[i] := empty map (raft.tla:186)
        out["vLog"] = _set_row(s["vLog"], i, 0)
    return out, valid, _const(s["role"], False)


def k_request_vote(bounds, s, i, j):
    """``RequestVote(i, j)`` (raft.tla:190-199); j may equal i."""
    valid = (_get(s["role"], i) == SP.CANDIDATE) \
        & (((_get(s["vResp"], i) >> j) & 1) == 0)
    hi, lo = mb.rv_request(_get(s["term"], i), _last_term(s, i),
                           _get(s["logLen"], i), i, j)
    out, ovf = bag_add(s, hi, torch.zeros_like(hi))     # lo word is 0
    return out, valid, valid & ovf


def k_append_entries(bounds, s, i, j):
    """``AppendEntries(i, j)`` (raft.tla:204-226): <=1 entry, heartbeats incl."""
    valid = (i != j) & (_get(s["role"], i) == SP.LEADER)
    ni = _get(_get_row(s["nextIndex"], i), j)
    prev_idx = ni - 1
    prev_term = torch.where(prev_idx > 0, _log_at(s, i, prev_idx - 1)[0], 0)
    last_entry = torch.minimum(_get(s["logLen"], i), ni)        # raft.tla:213
    has_ent = ni <= last_entry
    et, ev = _log_at(s, i, ni - 1)
    ent_term = torch.where(has_ent, et, 0)
    ent_val = torch.where(has_ent, ev, 0)
    mlog = _log_rank(bounds, s, i) if "allLogs" in s else 0  # :220-222
    hi, lo = mb.ae_request(
        _get(s["term"], i), prev_idx, prev_term, has_ent.to(I32), ent_term,
        ent_val, torch.minimum(_get(s["commitIndex"], i), last_entry), i, j,
        mlog)
    out, ovf = bag_add(s, hi.to(I32), lo.to(I32))
    return out, valid, valid & ovf


def k_become_leader(bounds, s, i):
    """``BecomeLeader(i)`` (raft.tla:229-243); Quorum as popcount.

    In faithful mode also inserts [eterm, eleader, elog, evotes, evoterLog]
    into the ``elections`` slot set (raft.tla:237-242), all from the
    unprimed state — a set insert like ``bag_add``, minus multiplicities;
    a full table is a loud overflow.
    """
    n = bounds.n_servers
    valid = (_get(s["role"], i) == SP.CANDIDATE) \
        & (2 * _popcount(_get(s["vGrant"], i)) > n)
    out = dict(s)
    out["role"] = _set1(s["role"], i, SP.LEADER)
    out["nextIndex"] = _set_row(s["nextIndex"], i, _get(s["logLen"], i) + 1)
    out["matchIndex"] = _set_row(s["matchIndex"], i, 0)
    ovf = _const(s["role"], False)
    if "eTerm" in s:
        lid, term_i = _log_rank(bounds, s, i), _get(s["term"], i)
        votes_i, vrow = _get(s["vGrant"], i), _get_row(s["vLog"], i)
        occ = s["eTerm"] > 0
        match = occ & (s["eTerm"] == term_i.unsqueeze(-1)) \
            & (s["eLeader"] == i.unsqueeze(-1)) \
            & (s["eLog"] == lid.unsqueeze(-1)) \
            & (s["eVotes"] == votes_i.unsqueeze(-1)) \
            & (s["eVLog"] == vrow.unsqueeze(-2)).all(-1)
        ins, ovf = _slot_insert(match, ~occ)
        for f, v in (("eTerm", term_i), ("eLeader", i.expand_as(term_i)),
                     ("eLog", lid), ("eVotes", votes_i)):
            out[f] = torch.where(ins, v.unsqueeze(-1), s[f])
        out["eVLog"] = torch.where(ins.unsqueeze(-1), vrow.unsqueeze(-2),
                                   s["eVLog"])
    return out, valid, valid & ovf


def k_client_request(bounds, s, i, v):
    """``ClientRequest(i, v)`` (raft.tla:246-253)."""
    Lcap = s["logTerm"].shape[-1]
    ln = _get(s["logLen"], i)
    valid = _get(s["role"], i) == SP.LEADER
    cell = _onehot(i, bounds.n_servers).unsqueeze(-1) \
        & _onehot(ln, Lcap).unsqueeze(-2)
    out = dict(s)
    out["logTerm"] = torch.where(cell, _lift(_get(s["term"], i), 2),
                                 s["logTerm"])
    out["logVal"] = torch.where(cell, _lift(v.expand_as(ln).to(I32), 2),
                                s["logVal"])
    out["logLen"] = _set1(s["logLen"], i, ln + 1)
    # ln == Lcap would silently drop the entry; the capacity scheme makes it
    # unreachable from constraint-satisfying states — flag, don't clamp.
    return out, valid, valid & (ln >= Lcap)


def k_advance_commit(bounds, s, i):
    """``AdvanceCommitIndex(i)`` (raft.tla:259-276): commits
    ``Max(agreeIndexes)`` only if that entry's term is current."""
    n, Lcap = bounds.n_servers, s["logTerm"].shape[-1]
    dev = i.device
    valid = _get(s["role"], i) == SP.LEADER
    idxs = torch.arange(1, Lcap + 1, device=dev)                      # [L]
    match_i = _get_row(s["matchIndex"], i)                            # [.., n]
    others = match_i.unsqueeze(-2) >= idxs.unsqueeze(-1)              # [.., L, n]
    in_set = others | (torch.arange(n, device=dev) == i.unsqueeze(-1)
                       ).unsqueeze(-2)
    agree_cnt = in_set.to(I32).sum(-1)
    agree_ok = (2 * agree_cnt > n) & (idxs <= _get(s["logLen"], i)
                                      .unsqueeze(-1))
    max_agree = torch.where(agree_ok, idxs, 0).amax(-1).to(I32)
    t_at = _log_at(s, i, max_agree - 1)[0]
    commit = torch.where((max_agree > 0) & (t_at == _get(s["term"], i)),
                         max_agree, _get(s["commitIndex"], i))
    out = dict(s)
    out["commitIndex"] = _set1(s["commitIndex"], i, commit)
    return out, valid, _const(s["role"], False)


def k_receive(bounds, s, slot):
    """``Receive(m)`` (raft.tla:421-436): deterministic dispatch over one
    slot; the handler guards partition on mterm vs currentTerm."""
    n = bounds.n_servers
    Lcap = s["logTerm"].shape[-1]
    occupied = _get(s["msgCount"], slot) > 0
    hi, lo = _get(s["msgHi"], slot), _get(s["msgLo"], slot)
    i, j = mb.dst(hi), mb.src(hi)
    mt, mty = mb.mterm(hi), mb.mtype(hi)
    ct = _get(s["term"], i)
    role_i = _get(s["role"], i)
    len_i = _get(s["logLen"], i)
    bit_j = torch.ones_like(j) << j
    ovf = torch.zeros_like(occupied)

    # UpdateTerm (raft.tla:406-412): any type, message kept.
    g_upd = mt > ct
    s_upd = dict(s)
    s_upd["term"] = _set1(s["term"], i, mt)
    s_upd["role"] = _set1(s["role"], i, SP.FOLLOWER)
    s_upd["votedFor"] = _set1(s["votedFor"], i, SP.NIL)
    not_upd = ~g_upd

    # HandleRequestVoteRequest (raft.tla:284-303)
    g_rvreq = not_upd & (mty == SP.M_RVREQ)
    lt_i = _last_term(s, i)
    log_ok_rv = (mb.fa(hi) > lt_i) | ((mb.fa(hi) == lt_i)
                                      & (mb.fb(hi) >= len_i))
    voted_i = _get(s["votedFor"], i)
    grant = (mt == ct) & log_ok_rv & ((voted_i == SP.NIL)
                                      | (voted_i == j + 1))
    my_mlog = _log_rank(bounds, s, i) if "allLogs" in s \
        else torch.zeros_like(ct)                             # :297-299
    resp_hi, resp_lo = mb.rv_response(ct, grant.to(I32), i, j, my_mlog)
    s_rvreq = dict(s)
    s_rvreq["votedFor"] = torch.where(
        grant.unsqueeze(-1), _set1(s["votedFor"], i, j + 1), s["votedFor"])
    s_rvreq, ovf_rv = reply(s_rvreq, resp_hi, resp_lo, hi, lo)
    ovf = ovf | (g_rvreq & ovf_rv)

    # RequestVoteResponse: DropStaleResponse | HandleRequestVoteResponse
    g_rvresp_drop = not_upd & (mty == SP.M_RVRESP) & (mt < ct)
    g_rvresp = not_upd & (mty == SP.M_RVRESP) & (mt == ct)
    s_drop = bag_remove(s, hi, lo)
    s_rvresp = dict(s)
    s_rvresp["vResp"] = _set1(s["vResp"], i, _get(s["vResp"], i) | bit_j)
    s_rvresp["vGrant"] = torch.where(
        (mb.fa(hi) > 0).unsqueeze(-1),
        _set1(s["vGrant"], i, _get(s["vGrant"], i) | bit_j), s["vGrant"])
    if "vLog" in s:
        # voterLog[i] @@ (j :> m.mlog): the existing entry wins
        # (raft.tla:316-317)
        cur = _get(_get_row(s["vLog"], i), j)
        newv = torch.where((mb.fa(hi) > 0) & (cur == 0), mb.fg(lo) + 1, cur)
        s_rvresp["vLog"] = _set2(s["vLog"], i, j, newv)
    s_rvresp = bag_remove(s_rvresp, hi, lo)

    # HandleAppendEntriesRequest (raft.tla:327-389)
    prev_idx, prev_term = mb.fa(hi), mb.fb(hi)
    n_ent, ent_term, ent_val = mb.fc(lo), mb.fd(lo), mb.fe(lo)
    log_ok_ae = (prev_idx == 0) | ((prev_idx > 0) & (prev_idx <= len_i)
                                   & (prev_term
                                      == _log_at(s, i, prev_idx - 1)[0]))
    is_ae = not_upd & (mty == SP.M_AEREQ)
    g_ae_reject = is_ae & ((mt < ct) | ((mt == ct) & (role_i == SP.FOLLOWER)
                                        & ~log_ok_ae))
    rej_hi, rej_lo = mb.ae_response(ct, 0, 0, i, j)
    s_ae_reject, ovf_rej = reply(s, rej_hi, torch.zeros_like(rej_hi), hi, lo)
    ovf = ovf | (g_ae_reject & ovf_rej)

    g_ae_step = is_ae & (mt == ct) & (role_i == SP.CANDIDATE)
    s_ae_step = dict(s)
    s_ae_step["role"] = _set1(s["role"], i, SP.FOLLOWER)           # msg kept

    accept = is_ae & (mt == ct) & (role_i == SP.FOLLOWER) & log_ok_ae
    index = prev_idx + 1
    t_at_index = _log_at(s, i, index - 1)[0]
    g_ae_done = accept & ((n_ent == 0)
                          | ((len_i >= index) & (t_at_index == ent_term)))
    # already done (raft.tla:356-374): commitIndex := mcommitIndex (may
    # decrease, :361-363), Reply success.
    done_hi, done_lo = mb.ae_response(ct, 1, prev_idx + n_ent, i, j)
    s_ae_done = dict(s)
    s_ae_done["commitIndex"] = _set1(s["commitIndex"], i, mb.ff(lo))
    s_ae_done, ovf_done = reply(s_ae_done, done_hi,
                                torch.zeros_like(done_hi), hi, lo)
    ovf = ovf | (g_ae_done & ovf_done)

    g_ae_conflict = accept & (n_ent > 0) & (len_i >= index) \
        & (t_at_index != ent_term)
    # conflict: drop exactly one entry off the TAIL; message kept.
    row = _onehot(i, n).unsqueeze(-1)
    tail = row & _onehot(len_i - 1, Lcap).unsqueeze(-2)
    s_ae_conflict = dict(s)
    s_ae_conflict["logTerm"] = torch.where(tail, 0, s["logTerm"])
    s_ae_conflict["logVal"] = torch.where(tail, 0, s["logVal"])
    s_ae_conflict["logLen"] = _set1(s["logLen"], i, len_i - 1)

    g_ae_append = accept & (n_ent > 0) & (len_i == prev_idx)
    newcol = row & _onehot(len_i, Lcap).unsqueeze(-2)
    s_ae_append = dict(s)
    s_ae_append["logTerm"] = torch.where(newcol, _lift(ent_term, 2),
                                         s["logTerm"])
    s_ae_append["logVal"] = torch.where(newcol, _lift(ent_val, 2),
                                        s["logVal"])
    s_ae_append["logLen"] = _set1(s["logLen"], i, len_i + 1)
    ovf = ovf | (g_ae_append & (len_i >= Lcap))

    # AppendEntriesResponse: DropStaleResponse | Handle (raft.tla:393-403)
    g_aeresp_drop = not_upd & (mty == SP.M_AERESP) & (mt < ct)
    g_aeresp = not_upd & (mty == SP.M_AERESP) & (mt == ct)
    succ_flag = mb.fa(hi) > 0
    match = mb.fb(hi)
    ni_new = torch.where(
        succ_flag, match + 1,
        torch.clamp(_get(_get_row(s["nextIndex"], i), j) - 1, min=1))
    s_aeresp = dict(s)
    s_aeresp["nextIndex"] = _set2(s["nextIndex"], i, j, ni_new)
    s_aeresp["matchIndex"] = torch.where(
        succ_flag[..., None, None], _set2(s["matchIndex"], i, j, match),
        s["matchIndex"])
    s_aeresp = bag_remove(s_aeresp, hi, lo)

    branches = [
        (g_upd, s_upd),
        (g_rvreq, s_rvreq),
        (g_rvresp_drop, s_drop),
        (g_rvresp, s_rvresp),
        (g_ae_reject, s_ae_reject),
        (g_ae_step, s_ae_step),
        (g_ae_done, s_ae_done),
        (g_ae_conflict, s_ae_conflict),
        (g_ae_append, s_ae_append),
        (g_aeresp_drop, s_drop),
        (g_aeresp, s_aeresp),
    ]
    any_branch = torch.stack([g for g, _ in branches]).any(0)
    out = _tree_select(branches, s)
    valid = occupied & any_branch
    return out, valid, valid & ovf


def k_duplicate(bounds, s, slot):
    """``DuplicateMessage(m)`` (raft.tla:443-445)."""
    occupied = _get(s["msgCount"], slot) > 0
    out = dict(s)
    out["msgCount"] = s["msgCount"] + _onehot(slot, s["msgCount"].shape[-1]
                                              ).to(I32)
    return out, occupied, _const(s["role"], False)


def k_drop(bounds, s, slot):
    """``DropMessage(m)`` (raft.tla:448-450)."""
    occupied = _get(s["msgCount"], slot) > 0
    out = bag_remove(s, _get(s["msgHi"], slot), _get(s["msgLo"], slot))
    return out, occupied, _const(s["role"], False)


# -- assembly ----------------------------------------------------------------

_FAMILY_KERNELS = {
    SP.RESTART: (k_restart, ("i",)),
    SP.TIMEOUT: (k_timeout, ("i",)),
    SP.REQUESTVOTE: (k_request_vote, ("i", "j")),
    SP.BECOMELEADER: (k_become_leader, ("i",)),
    SP.CLIENTREQUEST: (k_client_request, ("i", "v")),
    SP.ADVANCECOMMIT: (k_advance_commit, ("i",)),
    SP.APPENDENTRIES: (k_append_entries, ("i", "j")),
    SP.RECEIVE: (k_receive, ("slot",)),
    SP.DUPLICATE: (k_duplicate, ("slot",)),
    SP.DROP: (k_drop, ("slot",)),
}


# The struct fields each family's kernel can write (beyond copying the
# input): the kernel side of the width-safety contract.  The analyzer
# (analysis/widthcheck) keeps an abstract transfer twin per family and
# cross-checks the two write sets, so a k_* body growing a new write
# without its twin being re-proved is a loud lint finding.  History-only
# fields are listed unconditionally; the analyzer filters by mode.  Keep in
# sync with the k_* bodies above (the reference's TRANSFER_WRITES).
TRANSFER_WRITES = {
    SP.RESTART: ("role", "vResp", "vGrant", "nextIndex", "matchIndex",
                 "commitIndex", "vLog"),
    SP.TIMEOUT: ("role", "term", "votedFor", "vResp", "vGrant", "vLog"),
    SP.REQUESTVOTE: ("msgHi", "msgLo", "msgCount"),
    SP.BECOMELEADER: ("role", "nextIndex", "matchIndex",
                      "eTerm", "eLeader", "eLog", "eVotes", "eVLog"),
    SP.CLIENTREQUEST: ("logTerm", "logVal", "logLen"),
    SP.ADVANCECOMMIT: ("commitIndex",),
    SP.APPENDENTRIES: ("msgHi", "msgLo", "msgCount"),
    SP.RECEIVE: ("term", "role", "votedFor", "vResp", "vGrant", "vLog",
                 "commitIndex", "logTerm", "logVal", "logLen",
                 "nextIndex", "matchIndex", "msgHi", "msgLo", "msgCount"),
    SP.DUPLICATE: ("msgCount",),
    SP.DROP: ("msgHi", "msgLo", "msgCount"),
}

# finish_expand's shared postlude writes (outside any single family): the
# faithful-mode allLogs union, raw 32-bit mask words, or-only.
POSTLUDE_WRITES = ("allLogs",)


def transfer_metadata() -> dict:
    """Per-family metadata for the width pass: parameter names and declared
    write sets.  Raises KeyError if the two tables ever drift apart."""
    out = {}
    for fam, (_kern, params) in _FAMILY_KERNELS.items():
        out[fam] = {"params": params, "writes": TRANSFER_WRITES[fam]}
    for fam in TRANSFER_WRITES:
        if fam not in _FAMILY_KERNELS:
            raise KeyError(f"TRANSFER_WRITES names unknown family {fam}")
    return out

def group_instances(table):
    """Group contiguous instances of the same family (one dispatch each)."""
    groups: list = []
    for a in table:
        if groups and groups[-1][0] == a.family:
            groups[-1][1].append(a)
        else:
            groups.append((a.family, [a]))
    return groups


def grouped_dispatch(bounds, s, groups, family_kernels=None):
    """Evaluate the family kernels over grouped static instances:
    ``-> (succs, valids, ovfs)`` lists of ``[B, K, ...]`` / ``[B, K]``.
    The reference's ``jax.vmap`` over instance parameters is the K axis.
    ``family_kernels`` (``{family: (kernel, params)}``, e.g. compiled from
    the IR by ``frontend/actions.compile_kernels``) replaces the
    hand-written table; same contract, same lane order."""
    table = _FAMILY_KERNELS if family_kernels is None else family_kernels
    x0 = next(iter(s.values()))
    B, dev = x0.shape[0], x0.device
    succs, valids, ovfs = [], [], []
    for fam, instances in groups:
        kern, params = table[fam]
        K = len(instances)
        args = [torch.tensor([[getattr(a, p) for a in instances]],
                             dtype=I32, device=dev) for p in params]
        sb = {f: x.unsqueeze(1).expand(B, K, *x.shape[1:])
              for f, x in s.items()}
        out, valid, ovf = kern(bounds, sb, *args)
        succs.append(out)
        valids.append(valid.expand(B, K))
        ovfs.append(ovf.expand(B, K))
    return succs, valids, ovfs


def _alllogs_update(bounds, s):
    """``allLogs' = allLogs \\cup {log[i] : i \\in Server}`` with the
    UNPRIMED logs (raft.tla:464-465): one update per parent row ``[B, Wa]``,
    the same on every lane.  Words are built in int64 holding [0, 2^32)."""
    uni = loguniv.LogUniverse.of(bounds)
    ids = uni.log_id(s["logTerm"], s["logVal"], s["logLen"]).long()  # [B, n]
    Wa = s["allLogs"].shape[-1]
    words = torch.arange(Wa, device=ids.device)
    bits = torch.where((ids // 32).unsqueeze(-1) == words,
                       (1 << (ids % 32)).unsqueeze(-1), 0)          # [B, n, Wa]
    delta = bits[..., 0, :]
    for t in range(1, bits.shape[-2]):
        delta = delta | bits[..., t, :]
    return fpr.u32_bits((s["allLogs"].long() & 0xFFFFFFFF) | delta)


def finish_expand(bounds, s, succs, valids, ovfs):
    """Concatenate the groups' lanes, apply the shared allLogs union
    (faithful mode) and canonicalize every successor."""
    all_succs = {f: torch.cat([g[f] for g in succs], dim=1).to(I32)
                 for f in succs[0]}
    if "allLogs" in s:
        new = _alllogs_update(bounds, s)
        all_succs["allLogs"] = new.unsqueeze(1).expand_as(
            all_succs["allLogs"]).contiguous()
    return (st.canonicalize(all_succs), torch.cat(valids, 1),
            torch.cat(ovfs, 1))


def build_expand(bounds: Bounds, spec: str = "full", family_kernels=None):
    """``expand(struct[B, ...]) -> (succs[B, A, ...], valid, overflow)``;
    the A lanes follow ``models/spec.action_table`` order exactly.
    ``family_kernels`` as in :func:`grouped_dispatch`."""
    groups = group_instances(SP.action_table(bounds, spec))

    def expand(s):
        return finish_expand(bounds, s, *grouped_dispatch(
            bounds, s, groups, family_kernels=family_kernels))

    return expand


def build_step(bounds: Bounds, spec: str = "full", invariants: tuple = (),
               symmetry: tuple = (), view: str | None = None,
               family_kernels=None, keyer=None):
    """The plain fused frontier step: packed rows -> everything the engine
    needs, the same dict as the reference's ``kernels.build_step``.

    ``step(vecs int32[B, W]) -> dict`` with packed successors ``svecs
    [B, A, W]``, ``valid``/``overflow`` ``[B, A]`` bool, dedup keys
    ``fp_hi``/``fp_lo`` ``[B, A]`` (int32 holding the uint32 bits),
    per-invariant truth ``inv_ok [B, A, n_inv]`` and StateConstraint
    satisfaction ``con_ok [B, A]``.  Runs on the device of ``vecs``.

    The dedup key is the fingerprint of the successor, taken after the
    ``view`` (models/views.py) when one is set and minimized over the
    ``symmetry`` group (ops/symmetry.build_orbit_fp) when one is set; under
    symmetry invalid lanes get key 0.  ``svecs``, ``inv_ok`` and ``con_ok``
    are always those of the full, unviewed successor (the reference's
    ``apply_stages``).  ``family_kernels`` swaps the hand-written family
    kernels for others of the same contract (:func:`grouped_dispatch`);
    ``keyer(rows int32[N, W]) -> (hi, lo)``, e.g. K2
    (ops/pallas_fp.fingerprint_rows), replaces the plain fingerprint of the
    keys without symmetry.
    """
    lay = st.Layout.of(bounds)
    expand = build_expand(bounds, spec, family_kernels)
    inv_fns = [inv_mod.torch_invariant(nm, bounds) for nm in invariants]
    viewer = views.torch_view(view) if view else None
    consts, orbit = {}, {}

    def step(vecs):
        global calls
        calls += 1
        B, dev = vecs.shape[0], vecs.device
        if dev not in consts:
            consts[dev] = fpr.torch_constants(lay.width, dev)
            if symmetry:
                orbit[dev] = sym.build_orbit_fp(bounds, symmetry, consts[dev])
        succs, valid, ovf = expand(st.unpack(vecs.to(I32), lay))
        svecs = st.pack(succs)
        ksuccs = viewer(succs) if viewer else succs
        if symmetry:
            fp_hi, fp_lo = orbit[dev](ksuccs)
            fp_hi = torch.where(valid, fp_hi, 0)
            fp_lo = torch.where(valid, fp_lo, 0)
        else:
            ksvecs = st.pack(ksuccs) if viewer else svecs
            if keyer is None:
                fp_hi, fp_lo = fpr.fingerprint(ksvecs, consts[dev])
            else:
                fp_hi, fp_lo = (k.reshape(valid.shape) for k in keyer(
                    ksvecs.reshape(-1, lay.width)))
        if inv_fns:
            inv_ok = torch.stack([f(succs) for f in inv_fns], dim=-1)
        else:
            inv_ok = torch.ones(valid.shape + (0,), dtype=torch.bool,
                                device=dev)
        return {"svecs": svecs, "valid": valid, "overflow": ovf,
                "fp_hi": fp_hi, "fp_lo": fp_lo, "inv_ok": inv_ok,
                "con_ok": st.constraint_ok(succs, bounds)}

    return step
