"""Raft transcribed into the action IR — the port of
``raft_tla_tpu/frontend/raft_ir.py``.

Every family of ``ops/kernels.py`` re-expressed as an
:class:`~raft_tla_tpu_torch.frontend.expr.ActionDef`; compiled through
``frontend/actions.compile_kernels`` and plugged into ``build_step``'s
``family_kernels`` seam, the generated step must be bit-identical to the
hand-written plain step, to K1 on the card, and to the reference's IR step
(tests/test_torch_frontend.py, ``chip_smoke.py`` phase 16c), and
``widthgen.transfer_of`` over the same defs must reproduce the hand-written
width twins exactly.  Guard and update structure mirrors the kernel bodies
line for line; the ``raft.tla`` line references live on the kernels.

Parity mode only: the faithful-mode history fields stay on the
hand-written kernels — :func:`family_kernels` refuses history bounds
rather than silently dropping proof-state writes.
"""

from __future__ import annotations

import torch

from raft_tla_tpu_torch.analysis import intervals as iv
from raft_tla_tpu_torch.frontend import expr as E
from raft_tla_tpu_torch.frontend import raft_schema as SP

# -- shorthand ---------------------------------------------------------------

I, J, V, SLOT = E.Param("i"), E.Param("j"), E.Param("v"), E.Param("slot")
N, LCAP = E.Dim("n_servers"), E.Dim("log_cap")


def lit(v):
    return E.Lit(v)


def g(field, *idx):
    return E.Get(field, tuple(idx))


def add(a, b):
    return E.Bin("+", a, b)


def sub(a, b):
    return E.Bin("-", a, b)


def eq(a, b):
    return E.Bin("==", a, b)


def ne(a, b):
    return E.Bin("!=", a, b)


def lt(a, b):
    return E.Bin("<", a, b)


def le(a, b):
    return E.Bin("<=", a, b)


def gt(a, b):
    return E.Bin(">", a, b)


def ge(a, b):
    return E.Bin(">=", a, b)


def and_(a, b):
    return E.Bin("and", a, b)


def or_(a, b):
    return E.Bin("or", a, b)


def clip_log(a):
    """clip(a, 0, log_cap-1) — the guarded log-index idiom."""
    return E.Clip(a, lit(0), sub(LCAP, lit(1)))


def _srv(b):
    return iv.Interval(0, max(b.n_servers - 1, 0))


def _val_iv(b):
    return iv.Interval(1, b.n_values)


def _slot_iv(b):
    return iv.Interval(0, max(b.msg_cap - 1, 0))


_IJ = (("i", _srv), ("j", _srv))
_I = (("i", _srv),)
_SLOT = (("slot", _slot_iv),)

# -- local actions -----------------------------------------------------------

# kernels.k_restart
RESTART = E.ActionDef(SP.RESTART, ("i",), lit(True), (E.Branch(updates=(
    E.Set1("role", I, lit(SP.FOLLOWER)),
    E.Set1("vResp", I, lit(0)),
    E.Set1("vGrant", I, lit(0)),
    E.SetRow("nextIndex", I, lit(1)),
    E.SetRow("matchIndex", I, lit(0)),
    E.Set1("commitIndex", I, lit(0)),
)),), param_iv=_I)

# kernels.k_timeout
TIMEOUT = E.ActionDef(
    SP.TIMEOUT, ("i",),
    or_(eq(g("role", I), lit(SP.FOLLOWER)),
        eq(g("role", I), lit(SP.CANDIDATE))),
    (E.Branch(updates=(
        E.Set1("role", I, lit(SP.CANDIDATE)),
        E.Set1("term", I, add(g("term", I), lit(1))),
        E.Set1("votedFor", I, lit(SP.NIL)),
        E.Set1("vResp", I, lit(0)),
        E.Set1("vGrant", I, lit(0)),
    )),), param_iv=_I)

# kernels.k_request_vote
REQUESTVOTE = E.ActionDef(
    SP.REQUESTVOTE, ("i", "j"),
    and_(eq(g("role", I), lit(SP.CANDIDATE)),
         eq(E.Bin("band", E.Bin(">>", g("vResp", I), J), lit(1)), lit(0))),
    (E.Branch(ops=(E.BagAdd(E.PackMsg(SP.M_RVREQ, (
        ("mterm", g("term", I)),
        ("a", E.LastTerm(I)),
        ("b", g("logLen", I)),
        ("src", I),
        ("dst", J),
    ))),)),), param_iv=_IJ)

# kernels.k_become_leader
BECOMELEADER = E.ActionDef(
    SP.BECOMELEADER, ("i",),
    and_(eq(g("role", I), lit(SP.CANDIDATE)),
         gt(E.Bin("*", lit(2), E.Popcount(g("vGrant", I))), N)),
    (E.Branch(updates=(
        E.Set1("role", I, lit(SP.LEADER)),
        E.SetRow("nextIndex", I, add(g("logLen", I), lit(1))),
        E.SetRow("matchIndex", I, lit(0)),
    )),), param_iv=_I)

# kernels.k_client_request
CLIENTREQUEST = E.ActionDef(
    SP.CLIENTREQUEST, ("i", "v"),
    eq(g("role", I), lit(SP.LEADER)),
    (E.Branch(updates=(
        E.Set2("logTerm", I, g("logLen", I), g("term", I)),
        E.Set2("logVal", I, g("logLen", I), V),
        E.Set1("logLen", I, add(g("logLen", I), lit(1))),
    ), overflow=ge(g("logLen", I), LCAP)),),
    param_iv=(("i", _srv), ("v", _val_iv)))


def _quorum_commit(bounds, s, params):
    """kernels.k_advance_commit's quorum aggregation over the batched
    struct: the largest index a majority matches at the leader's current
    term, else the current commitIndex."""
    from raft_tla_tpu_torch.ops.kernels import _get, _get_row, _log_at
    i = params["i"]
    n, Lcap = bounds.n_servers, s["logTerm"].shape[-1]
    dev = i.device
    idxs = torch.arange(1, Lcap + 1, device=dev)                  # [L]
    others = _get_row(s["matchIndex"], i).unsqueeze(-2) \
        >= idxs.unsqueeze(-1)                                     # [.., L, n]
    in_set = others | (torch.arange(n, device=dev) == i.unsqueeze(-1)
                       ).unsqueeze(-2)
    agree_cnt = in_set.to(torch.int32).sum(-1)
    agree_ok = (2 * agree_cnt > n) & (idxs <= _get(s["logLen"], i)
                                      .unsqueeze(-1))
    max_agree = torch.where(agree_ok, idxs, 0).amax(-1).to(torch.int32)
    t_at = _log_at(s, i, max_agree - 1)[0]
    return torch.where((max_agree > 0) & (t_at == _get(s["term"], i)),
                       max_agree, _get(s["commitIndex"], i))


# kernels.k_advance_commit — the quorum-max is an Intrinsic (a scalar
# aggregation over the match matrix, outside the IR's expression
# language) with the hand twin's declared transfer.
ADVANCECOMMIT = E.ActionDef(
    SP.ADVANCECOMMIT, ("i",),
    eq(g("role", I), lit(SP.LEADER)),
    (E.Branch(updates=(E.Set1("commitIndex", I, E.Intrinsic(
        "quorum_commit", _quorum_commit,
        lambda bounds, env: iv.Interval(0, env["logLen"].hi)
        .join(env["commitIndex"]))),)),),
    param_iv=_I)

# kernels.k_append_entries
_NI = g("nextIndex", I, J)
_PREV_IDX = sub(_NI, lit(1))
_LAST_ENTRY = E.MinE(g("logLen", I), _NI)
_HAS_ENT = le(_NI, _LAST_ENTRY)
_EIDX = clip_log(sub(_NI, lit(1)))
APPENDENTRIES = E.ActionDef(
    SP.APPENDENTRIES, ("i", "j"),
    and_(ne(I, J), eq(g("role", I), lit(SP.LEADER))),
    (E.Branch(ops=(E.BagAdd(E.PackMsg(SP.M_AEREQ, (
        ("mterm", g("term", I)),
        ("a", _PREV_IDX),
        ("b", E.Where(gt(_PREV_IDX, lit(0)),
                      g("logTerm", I, clip_log(sub(_PREV_IDX, lit(1)))),
                      lit(0))),
        ("c", _HAS_ENT),
        ("d", E.Where(_HAS_ENT, g("logTerm", I, _EIDX), lit(0))),
        ("e", E.Where(_HAS_ENT, g("logVal", I, _EIDX), lit(0))),
        ("f", E.MinE(g("commitIndex", I), _LAST_ENTRY)),
        ("src", I),
        ("dst", J),
    ), facts=(("a+c", lambda bounds, env, menv:
               (env["nextIndex"] - 1).join(iv.Interval(1, env["logLen"].hi))
               if env["logLen"].hi >= 1 else env["nextIndex"] - 1),))),)),),
    param_iv=_IJ)

# kernels.k_receive — eleven exclusive branches over the slot's message.
_MT, _MTY = E.MsgField("mterm"), E.MsgField("mtype")
_DST, _SRC = E.MsgField("dst"), E.MsgField("src")
_CT = g("term", _DST)
_ROLE_I = g("role", _DST)
_LEN_I = g("logLen", _DST)
_NOT_UPD = le(_MT, _CT)

_LAST_I = E.LastTerm(_DST)
_LOG_OK_RV = or_(gt(E.MsgField("a"), _LAST_I),
                 and_(eq(E.MsgField("a"), _LAST_I),
                      ge(E.MsgField("b"), _LEN_I)))
_GRANT = and_(and_(eq(_MT, _CT), _LOG_OK_RV),
              or_(eq(g("votedFor", _DST), lit(SP.NIL)),
                  eq(g("votedFor", _DST), add(_SRC, lit(1)))))

_AE_PREV = E.MsgField("a")
_AE_NENT = E.MsgField("c")
_LOG_OK_AE = or_(eq(_AE_PREV, lit(0)),
                 and_(and_(gt(_AE_PREV, lit(0)), le(_AE_PREV, _LEN_I)),
                      eq(E.MsgField("b"),
                         g("logTerm", _DST,
                           clip_log(sub(_AE_PREV, lit(1)))))))
_IS_AE = and_(_NOT_UPD, eq(_MTY, lit(SP.M_AEREQ)))
_ACCEPT = and_(and_(_IS_AE, eq(_MT, _CT)),
               and_(eq(_ROLE_I, lit(SP.FOLLOWER)), _LOG_OK_AE))
_INDEX = add(_AE_PREV, lit(1))
_T_AT_INDEX = g("logTerm", _DST, clip_log(sub(_INDEX, lit(1))))
_AE_SUCC = gt(E.MsgField("a"), lit(0))

RECEIVE = E.ActionDef(
    SP.RECEIVE, ("slot",),
    gt(g("msgCount", SLOT), lit(0)),
    (
        # UpdateTerm (any message with a newer term)
        E.Branch(gt(_MT, _CT), updates=(
            E.Set1("term", _DST, _MT),
            E.Set1("role", _DST, lit(SP.FOLLOWER)),
            E.Set1("votedFor", _DST, lit(SP.NIL)),
        )),
        # HandleRequestVoteRequest
        E.Branch(and_(_NOT_UPD, eq(_MTY, lit(SP.M_RVREQ))), updates=(
            E.Set1("votedFor", _DST, add(_SRC, lit(1)), cond=_GRANT),
        ), ops=(E.Reply(E.PackMsg(SP.M_RVRESP, (
            ("mterm", _CT),
            ("a", _GRANT),
            ("src", _DST),
            ("dst", _SRC),
        ))),), mtype=SP.M_RVREQ),
        # DropStaleResponse (RequestVote)
        E.Branch(and_(and_(_NOT_UPD, eq(_MTY, lit(SP.M_RVRESP))),
                      lt(_MT, _CT)),
                 ops=(E.BagRemove(),), mtype=SP.M_RVRESP),
        # HandleRequestVoteResponse
        E.Branch(and_(and_(_NOT_UPD, eq(_MTY, lit(SP.M_RVRESP))),
                      eq(_MT, _CT)), updates=(
            E.Set1("vResp", _DST,
                   E.Bin("bor", g("vResp", _DST),
                         E.Bin("<<", lit(1), _SRC))),
            E.Set1("vGrant", _DST,
                   E.Bin("bor", g("vGrant", _DST),
                         E.Bin("<<", lit(1), _SRC)),
                   cond=gt(E.MsgField("a"), lit(0))),
        ), ops=(E.BagRemove(),), mtype=SP.M_RVRESP),
        # AppendEntries: reject (stale term, or follower with a log
        # mismatch)
        E.Branch(and_(_IS_AE,
                      or_(lt(_MT, _CT),
                          and_(and_(eq(_MT, _CT),
                                    eq(_ROLE_I, lit(SP.FOLLOWER))),
                               E.Not(_LOG_OK_AE)))),
                 ops=(E.Reply(E.PackMsg(SP.M_AERESP, (
                     ("mterm", _CT),
                     ("src", _DST),
                     ("dst", _SRC),
                 ))),), mtype=SP.M_AEREQ),
        # AppendEntries: candidate steps down (message kept)
        E.Branch(and_(and_(_IS_AE, eq(_MT, _CT)),
                      eq(_ROLE_I, lit(SP.CANDIDATE))),
                 updates=(E.Set1("role", _DST, lit(SP.FOLLOWER)),),
                 mtype=SP.M_AEREQ),
        # AppendEntries: done (heartbeat or already-matching entry)
        E.Branch(and_(_ACCEPT,
                      or_(eq(_AE_NENT, lit(0)),
                          and_(ge(_LEN_I, _INDEX),
                               eq(_T_AT_INDEX, E.MsgField("d"))))),
                 updates=(E.Set1("commitIndex", _DST, E.MsgField("f")),),
                 ops=(E.Reply(E.PackMsg(SP.M_AERESP, (
                     ("mterm", _CT),
                     ("a", lit(1)),
                     ("b", add(_AE_PREV, _AE_NENT)),
                     ("src", _DST),
                     ("dst", _SRC),
                 ), overrides=(("b", "a+c"),))),), mtype=SP.M_AEREQ),
        # AppendEntries: conflict — truncate the last entry (msg kept)
        E.Branch(and_(and_(_ACCEPT, gt(_AE_NENT, lit(0))),
                      and_(ge(_LEN_I, _INDEX),
                           ne(_T_AT_INDEX, E.MsgField("d")))),
                 updates=(
                     E.Set2("logTerm", _DST, sub(_LEN_I, lit(1)), lit(0)),
                     E.Set2("logVal", _DST, sub(_LEN_I, lit(1)), lit(0)),
                     E.Set1("logLen", _DST, sub(_LEN_I, lit(1))),
                 ), mtype=SP.M_AEREQ,
                 refines=(("logLen", 1, 1 << 40),)),
        # AppendEntries: append the entry (msg kept)
        E.Branch(and_(and_(_ACCEPT, gt(_AE_NENT, lit(0))),
                      eq(_LEN_I, _AE_PREV)),
                 updates=(
                     E.Set2("logTerm", _DST, _LEN_I, E.MsgField("d")),
                     E.Set2("logVal", _DST, _LEN_I, E.MsgField("e")),
                     E.Set1("logLen", _DST, add(_LEN_I, lit(1))),
                 ), overflow=ge(_LEN_I, LCAP), mtype=SP.M_AEREQ),
        # DropStaleResponse (AppendEntries)
        E.Branch(and_(and_(_NOT_UPD, eq(_MTY, lit(SP.M_AERESP))),
                      lt(_MT, _CT)),
                 ops=(E.BagRemove(),), mtype=SP.M_AERESP),
        # HandleAppendEntriesResponse
        E.Branch(and_(and_(_NOT_UPD, eq(_MTY, lit(SP.M_AERESP))),
                      eq(_MT, _CT)), updates=(
            E.Set2("nextIndex", _DST, _SRC,
                   E.Where(_AE_SUCC, add(E.MsgField("b"), lit(1)),
                           E.MaxE(sub(g("nextIndex", _DST, _SRC), lit(1)),
                                  lit(1)))),
            E.Set2("matchIndex", _DST, _SRC, E.MsgField("b"),
                   cond=_AE_SUCC),
        ), ops=(E.BagRemove(),), mtype=SP.M_AERESP),
    ),
    param_iv=_SLOT, any_guard_valid=True)

# kernels.k_duplicate
DUPLICATE = E.ActionDef(
    SP.DUPLICATE, ("slot",),
    gt(g("msgCount", SLOT), lit(0)),
    (E.Branch(updates=(
        E.Set1("msgCount", SLOT, add(g("msgCount", SLOT), lit(1))),
    )),), param_iv=_SLOT)

# kernels.k_drop
DROP = E.ActionDef(
    SP.DROP, ("slot",),
    gt(g("msgCount", SLOT), lit(0)),
    (E.Branch(ops=(E.BagRemove(),)),), param_iv=_SLOT)

ACTIONS = (RESTART, TIMEOUT, REQUESTVOTE, BECOMELEADER, CLIENTREQUEST,
           ADVANCECOMMIT, APPENDENTRIES, RECEIVE, DUPLICATE, DROP)


def family_kernels(bounds):
    """The IR-compiled kernel table for ``build_step(...,
    family_kernels=)``.  Parity mode only — the faithful history fields
    are hand-written (module docstring)."""
    if bounds.history:
        raise ValueError(
            "the Raft IR transcription covers parity mode only; faithful "
            "(history) bounds keep the hand-written kernels")
    from raft_tla_tpu_torch.frontend.actions import compile_kernels
    return compile_kernels(ACTIONS)


def transfers():
    """Generated speclint Pass-1 twins, ``{family: transfer}`` — the
    drop-in for ``widthcheck.check_widths(transfers=...)``, cross-checked
    against the hand twins by tests/test_torch_frontend.py."""
    from raft_tla_tpu_torch.frontend.widthgen import transfer_of
    return {adef.family: transfer_of(adef) for adef in ACTIONS}
