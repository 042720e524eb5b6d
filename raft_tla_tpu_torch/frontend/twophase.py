"""Bounded two-phase commit — the port of ``raft_tla_tpu/frontend/twophase.py``.

Lamport's ``TwoPhase.tla`` (the TM/RM transaction-commit protocol from the
TLA+ hyperbook, a refinement of ``TCommit``) declared purely as frontend
data — a :class:`~raft_tla_tpu_torch.frontend.schema.Schema` plus an
:class:`~raft_tla_tpu_torch.frontend.expr.ActionDef` table — and compiled
by ``frontend/actions.build_schema_step`` into the step dict every engine
consumes.  No kernel code is specific to this protocol.

Encoding
--------
Messages in ``TwoPhase.tla`` live in a *set* (never removed), so each
possible message is one monotone flag: ``msgPrepared[rm]`` for
``[type |-> "Prepared", rm |-> rm]``, and scalar ``msgCommit`` /
``msgAbort`` flags for the TM's broadcast decisions.  State is ``3n + 3``
words for ``n`` RMs; the state space is finite with no ``--max-*`` bound
needed.  ``rmState`` values: 0 working, 1 prepared, 2 committed, 3
aborted; ``tmState``: 0 init, 1 committed, 2 aborted.

The module also carries what a model adapter needs end to end: a hashable
Python state and row codec (trace rendering), an *independent*
pure-Python BFS oracle (:func:`reference_check` — hand-transcribed guards,
no IR), the host interpreter one lane at a time (:func:`apply_instance`,
simulation replay), a TLC-style state renderer, and :func:`emit_tla` for a
stock-TLC parity run of the identical bounded model (byte-equal to the
reference's).

The canonical invariant is ``TCConsistent`` (``TCommit.tla``): no RM has
committed while another has aborted — written in the frontend predicate
language, so it rides the same compiled-predicate path as any cfg
INVARIANT expression.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from raft_tla_tpu_torch.analysis import intervals as iv
from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.frontend import expr as E
from raft_tla_tpu_torch.frontend.schema import Field, Schema

# rmState values (TCommit.tla: RM states)
WORKING, PREPARED, COMMITTED, ABORTED = 0, 1, 2, 3
RM_STATE_NAMES = ("working", "prepared", "committed", "aborted")
# tmState values (TwoPhase.tla: TM states)
TM_INIT, TM_COMMITTED, TM_ABORTED = 0, 1, 2
TM_STATE_NAMES = ("init", "committed", "aborted")

SCHEMA = Schema("twophase", (
    Field("rmState", ("n",), 0, 3),
    Field("tmState", (1,), 0, 2),
    Field("tmPrepared", ("n",), 0, 1),
    Field("msgPrepared", ("n",), 0, 1),
    Field("msgCommit", (1,), 0, 1),
    Field("msgAbort", (1,), 0, 1),
))

# Action families, in Next-disjunct order (TwoPhase.tla: TPNext).
TM_RCV_PREPARED = "TMRcvPrepared"
TM_COMMIT = "TMCommit"
TM_ABORT = "TMAbort"
RM_PREPARE = "RMPrepare"
RM_CHOOSE_ABORT = "RMChooseToAbort"
RM_RCV_COMMIT = "RMRcvCommitMsg"
RM_RCV_ABORT = "RMRcvAbortMsg"

ALL_FAMILIES = (TM_RCV_PREPARED, TM_COMMIT, TM_ABORT, RM_PREPARE,
                RM_CHOOSE_ABORT, RM_RCV_COMMIT, RM_RCV_ABORT)

# TCommit.tla's TCConsistent, in the frontend predicate grammar: no two
# RMs ever disagree committed-vs-aborted.  Registered names resolve to
# these texts; whole-line INVARIANT expressions compile directly.
INVARIANTS = {
    "TCConsistent": "~(any(rmState = 3) /\\ any(rmState = 2))",
}
DEFAULT_INVARIANT = "TCConsistent"


# -- the IR action table ------------------------------------------------------

def _lit(v):
    return E.Lit(v)


def _g(field, *idx):
    return E.Get(field, tuple(idx))


def _eq(a, b):
    return E.Bin("==", a, b)


def _and(a, b):
    return E.Bin("and", a, b)


_I = E.Param("i")
_Z = _lit(0)
_TM = _g("tmState", _Z)

# TMCommit's \A rm: tmPrepared[rm] guard is a reduction over the RM
# axis — an Intrinsic, like Raft's quorum scan (entries are 0/1, so
# "all prepared" is min > 0), over the trailing axis of the batched field.
_ALL_PREPARED = E.Intrinsic(
    "all_prepared",
    lambda bounds, s, params: s["tmPrepared"].amin(-1) > 0,
    lambda bounds, env: iv.BOOL)


def _set1(field, i, val):
    return E.Set1(field, i, _lit(val))


ACTIONS = (
    # TMRcvPrepared(rm): the TM records rm's Prepared message.
    E.ActionDef(
        TM_RCV_PREPARED, ("i",),
        _and(_eq(_TM, _lit(TM_INIT)), _eq(_g("msgPrepared", _I), _lit(1))),
        (E.Branch(updates=(_set1("tmPrepared", _I, 1),)),)),
    # TMCommit: every RM prepared -> commit and broadcast.
    E.ActionDef(
        TM_COMMIT, ("i",),
        _and(_eq(_TM, _lit(TM_INIT)), _ALL_PREPARED),
        (E.Branch(updates=(_set1("tmState", _Z, TM_COMMITTED),
                           _set1("msgCommit", _Z, 1))),)),
    # TMAbort: the TM may spontaneously abort while undecided.
    E.ActionDef(
        TM_ABORT, ("i",),
        _eq(_TM, _lit(TM_INIT)),
        (E.Branch(updates=(_set1("tmState", _Z, TM_ABORTED),
                           _set1("msgAbort", _Z, 1))),)),
    # RMPrepare(rm): a working RM prepares and tells the TM.
    E.ActionDef(
        RM_PREPARE, ("i",),
        _eq(_g("rmState", _I), _lit(WORKING)),
        (E.Branch(updates=(_set1("rmState", _I, PREPARED),
                           _set1("msgPrepared", _I, 1))),)),
    # RMChooseToAbort(rm): a working RM unilaterally aborts.
    E.ActionDef(
        RM_CHOOSE_ABORT, ("i",),
        _eq(_g("rmState", _I), _lit(WORKING)),
        (E.Branch(updates=(_set1("rmState", _I, ABORTED),)),)),
    # RMRcvCommitMsg(rm): any RM that sees the Commit message commits.
    E.ActionDef(
        RM_RCV_COMMIT, ("i",),
        _eq(_g("msgCommit", _Z), _lit(1)),
        (E.Branch(updates=(_set1("rmState", _I, COMMITTED),)),)),
    # RMRcvAbortMsg(rm): any RM that sees the Abort message aborts.
    E.ActionDef(
        RM_RCV_ABORT, ("i",),
        _eq(_g("msgAbort", _Z), _lit(1)),
        (E.Branch(updates=(_set1("rmState", _I, ABORTED),)),)),
)


@dataclasses.dataclass(frozen=True)
class TPInstance:
    """One successor lane: family + bound RM index.  The TM-only actions
    carry a single dummy instance (``i`` unread) so the grouped dispatch
    keeps its one instance axis."""

    family: str
    i: int = 0

    def label(self) -> str:
        if self.family in (TM_COMMIT, TM_ABORT):
            return self.family
        return f"{self.family}(r{self.i + 1})"


def action_table(bounds: Bounds) -> list:
    """The static successor fan-out, in Next-disjunct order: A = 5n + 2."""
    n = bounds.n_servers
    table = [TPInstance(TM_RCV_PREPARED, i) for i in range(n)]
    table += [TPInstance(TM_COMMIT), TPInstance(TM_ABORT)]
    for fam in (RM_PREPARE, RM_CHOOSE_ABORT, RM_RCV_COMMIT, RM_RCV_ABORT):
        table += [TPInstance(fam, i) for i in range(n)]
    return table


# -- Python state + codec -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPState:
    """One state, hashable — the twophase analog of ``interp.PyState``."""

    rmState: tuple
    tmState: int
    tmPrepared: tuple
    msgPrepared: tuple
    msgCommit: int
    msgAbort: int

    def _replace(self, **kw) -> "TPState":
        return dataclasses.replace(self, **kw)


def init_state(bounds: Bounds) -> TPState:
    """TPInit: every RM working, TM undecided, no messages."""
    n = bounds.n_servers
    return TPState((WORKING,) * n, TM_INIT, (0,) * n, (0,) * n, 0, 0)


def to_vec(s: TPState, bounds: Bounds) -> np.ndarray:
    """Pack in schema declaration order — agrees with
    ``SCHEMA.layout(bounds).pack`` (pinned by tests)."""
    return np.asarray([*s.rmState, s.tmState, *s.tmPrepared,
                       *s.msgPrepared, s.msgCommit, s.msgAbort],
                      dtype=np.int32)


def from_vec(vec, bounds: Bounds) -> TPState:
    n = bounds.n_servers
    v = [int(x) for x in np.asarray(vec).reshape(-1)]
    return TPState(tuple(v[0:n]), v[n], tuple(v[n + 1:2 * n + 1]),
                   tuple(v[2 * n + 1:3 * n + 1]), v[3 * n + 1], v[3 * n + 2])


# -- the independent NumPy/pure-Python reference oracle -----------------------

def _py_successors(s: TPState, n: int):
    """Enabled (label, successor) pairs in action_table order — a direct
    hand transcription of the TwoPhase.tla guards, deliberately NOT via
    the IR (it is the oracle the compiled step is validated against)."""
    out = []
    for rm in range(n):
        if s.tmState == TM_INIT and s.msgPrepared[rm]:
            tp = list(s.tmPrepared)
            tp[rm] = 1
            out.append((f"TMRcvPrepared(r{rm + 1})",
                        s._replace(tmPrepared=tuple(tp))))
    if s.tmState == TM_INIT and all(s.tmPrepared):
        out.append(("TMCommit",
                    s._replace(tmState=TM_COMMITTED, msgCommit=1)))
    if s.tmState == TM_INIT:
        out.append(("TMAbort", s._replace(tmState=TM_ABORTED, msgAbort=1)))
    for rm in range(n):
        if s.rmState[rm] == WORKING:
            rs, mp = list(s.rmState), list(s.msgPrepared)
            rs[rm], mp[rm] = PREPARED, 1
            out.append((f"RMPrepare(r{rm + 1})",
                        s._replace(rmState=tuple(rs),
                                   msgPrepared=tuple(mp))))
    for rm in range(n):
        if s.rmState[rm] == WORKING:
            rs = list(s.rmState)
            rs[rm] = ABORTED
            out.append((f"RMChooseToAbort(r{rm + 1})",
                        s._replace(rmState=tuple(rs))))
    for rm in range(n):
        if s.msgCommit:
            rs = list(s.rmState)
            rs[rm] = COMMITTED
            out.append((f"RMRcvCommitMsg(r{rm + 1})",
                        s._replace(rmState=tuple(rs))))
    for rm in range(n):
        if s.msgAbort:
            rs = list(s.rmState)
            rs[rm] = ABORTED
            out.append((f"RMRcvAbortMsg(r{rm + 1})",
                        s._replace(rmState=tuple(rs))))
    return out


def apply_instance(s: TPState, inst: TPInstance,
                   bounds: Bounds) -> TPState | None:
    """Host interpreter for one action lane (simulation replay): the
    successor for ``inst`` if its guard holds, else None — the same
    hand-transcribed guards as :func:`_py_successors`, addressed by
    lane instead of enumerated, so a recorded walk replays exactly."""
    rm, fam = inst.i, inst.family
    if fam == TM_RCV_PREPARED:
        if s.tmState == TM_INIT and s.msgPrepared[rm]:
            tp = list(s.tmPrepared)
            tp[rm] = 1
            return s._replace(tmPrepared=tuple(tp))
        return None
    if fam == TM_COMMIT:
        if s.tmState == TM_INIT and all(s.tmPrepared):
            return s._replace(tmState=TM_COMMITTED, msgCommit=1)
        return None
    if fam == TM_ABORT:
        if s.tmState == TM_INIT:
            return s._replace(tmState=TM_ABORTED, msgAbort=1)
        return None
    if fam == RM_PREPARE:
        if s.rmState[rm] == WORKING:
            rs, mp = list(s.rmState), list(s.msgPrepared)
            rs[rm], mp[rm] = PREPARED, 1
            return s._replace(rmState=tuple(rs), msgPrepared=tuple(mp))
        return None
    if fam == RM_CHOOSE_ABORT:
        if s.rmState[rm] == WORKING:
            rs = list(s.rmState)
            rs[rm] = ABORTED
            return s._replace(rmState=tuple(rs))
        return None
    if fam == RM_RCV_COMMIT:
        if s.msgCommit:
            rs = list(s.rmState)
            rs[rm] = COMMITTED
            return s._replace(rmState=tuple(rs))
        return None
    if fam == RM_RCV_ABORT:
        if s.msgAbort:
            rs = list(s.rmState)
            rs[rm] = ABORTED
            return s._replace(rmState=tuple(rs))
        return None
    raise ValueError(f"unknown twophase action family {fam!r}")


def py_tc_consistent(s: TPState) -> bool:
    """TCConsistent, hand-written (the oracle face of the predicate)."""
    return not (any(r == ABORTED for r in s.rmState)
                and any(r == COMMITTED for r in s.rmState))


@dataclasses.dataclass
class ReferenceResult:
    n_states: int
    diameter: int
    n_transitions: int
    levels: list
    consistent: bool          # TCConsistent held on every reachable state


def reference_check(n: int) -> ReferenceResult:
    """Exhaustive BFS over hashable states: the count/diameter oracle the
    engine and serve paths are pinned against at small n."""
    bounds = Bounds(n_servers=n)
    init = init_state(bounds)
    seen = {init}
    frontier = [init]
    levels = [1]
    n_transitions = 0
    consistent = py_tc_consistent(init)
    while frontier:
        nxt = []
        for s in frontier:
            succs = _py_successors(s, n)
            n_transitions += len(succs)
            for _label, t in succs:
                if t in seen:
                    continue
                seen.add(t)
                consistent = consistent and py_tc_consistent(t)
                nxt.append(t)
        if nxt:
            levels.append(len(nxt))
        frontier = nxt
    return ReferenceResult(n_states=len(seen), diameter=len(levels) - 1,
                           n_transitions=n_transitions, levels=levels,
                           consistent=consistent)


# -- rendering ----------------------------------------------------------------

def _rm(i: int) -> str:
    return f"r{i + 1}"


def render_state(s: TPState, bounds: Bounds, indent: str = "    ") -> str:
    """TLC-style conjunction, message flags rendered back as the
    TwoPhase.tla message *set*."""
    n = bounds.n_servers
    msgs = [f'[type |-> "Prepared", rm |-> {_rm(i)}]'
            for i in range(n) if s.msgPrepared[i]]
    if s.msgCommit:
        msgs.append('[type |-> "Commit"]')
    if s.msgAbort:
        msgs.append('[type |-> "Abort"]')
    lines = [
        "/\\ rmState = (" + " @@ ".join(
            f'{_rm(i)} :> "{RM_STATE_NAMES[s.rmState[i]]}"'
            for i in range(n)) + ")",
        f'/\\ tmState = "{TM_STATE_NAMES[s.tmState]}"',
        "/\\ tmPrepared = {" + ", ".join(
            _rm(i) for i in range(n) if s.tmPrepared[i]) + "}",
        "/\\ msgs = {" + ", ".join(msgs) + "}",
    ]
    return "\n".join(indent + ln for ln in lines)


def render_trace(violation, bounds: Bounds) -> str:
    from raft_tla_tpu_torch.utils import render
    return render.render_trace(violation, bounds,
                               state_renderer=render_state)


# -- TLC parity emission ------------------------------------------------------

_TLA_TEMPLATE = """---------------------------- MODULE MC2pc ----------------------------
\\* Bounded two-phase commit — emitted by raft_tla_tpu for a stock-TLC
\\* parity run of the exact model the TPU checker explored (the message
\\* set is total: TwoPhase.tla messages are never removed).
EXTENDS Naturals

CONSTANT RM                  \\* the set of resource managers

VARIABLES rmState, tmState, tmPrepared, msgs
vars == <<rmState, tmState, tmPrepared, msgs>>

Messages == [type : {{"Prepared"}}, rm : RM] \\cup [type : {{"Commit", "Abort"}}]

TPTypeOK ==
  /\\ rmState \\in [RM -> {{"working", "prepared", "committed", "aborted"}}]
  /\\ tmState \\in {{"init", "committed", "aborted"}}
  /\\ tmPrepared \\subseteq RM
  /\\ msgs \\subseteq Messages

Init ==
  /\\ rmState = [rm \\in RM |-> "working"]
  /\\ tmState = "init"
  /\\ tmPrepared = {{}}
  /\\ msgs = {{}}

TMRcvPrepared(rm) ==
  /\\ tmState = "init"
  /\\ [type |-> "Prepared", rm |-> rm] \\in msgs
  /\\ tmPrepared' = tmPrepared \\cup {{rm}}
  /\\ UNCHANGED <<rmState, tmState, msgs>>

TMCommit ==
  /\\ tmState = "init"
  /\\ tmPrepared = RM
  /\\ tmState' = "committed"
  /\\ msgs' = msgs \\cup {{[type |-> "Commit"]}}
  /\\ UNCHANGED <<rmState, tmPrepared>>

TMAbort ==
  /\\ tmState = "init"
  /\\ tmState' = "aborted"
  /\\ msgs' = msgs \\cup {{[type |-> "Abort"]}}
  /\\ UNCHANGED <<rmState, tmPrepared>>

RMPrepare(rm) ==
  /\\ rmState[rm] = "working"
  /\\ rmState' = [rmState EXCEPT ![rm] = "prepared"]
  /\\ msgs' = msgs \\cup {{[type |-> "Prepared", rm |-> rm]}}
  /\\ UNCHANGED <<tmState, tmPrepared>>

RMChooseToAbort(rm) ==
  /\\ rmState[rm] = "working"
  /\\ rmState' = [rmState EXCEPT ![rm] = "aborted"]
  /\\ UNCHANGED <<tmState, tmPrepared, msgs>>

RMRcvCommitMsg(rm) ==
  /\\ [type |-> "Commit"] \\in msgs
  /\\ rmState' = [rmState EXCEPT ![rm] = "committed"]
  /\\ UNCHANGED <<tmState, tmPrepared, msgs>>

RMRcvAbortMsg(rm) ==
  /\\ [type |-> "Abort"] \\in msgs
  /\\ rmState' = [rmState EXCEPT ![rm] = "aborted"]
  /\\ UNCHANGED <<tmState, tmPrepared, msgs>>

Next ==
  \\/ TMCommit \\/ TMAbort
  \\/ \\E rm \\in RM :
       TMRcvPrepared(rm) \\/ RMPrepare(rm) \\/ RMChooseToAbort(rm)
         \\/ RMRcvCommitMsg(rm) \\/ RMRcvAbortMsg(rm)

Spec == Init /\\ [][Next]_vars

TCConsistent ==
  \\A rm1, rm2 \\in RM :
    ~(rmState[rm1] = "aborted" /\\ rmState[rm2] = "committed")
=======================================================================
"""


def emit_tla(out_dir: str, bounds: Bounds, invariants=()) -> tuple:
    """Write ``MC2pc.tla``/``MC2pc.cfg`` — the stock-TLC twin of this
    bounded model.  Only registered (named) invariants can be emitted;
    a whole-line expression has no TLA+ operator name to reference."""
    names = []
    for nm in invariants:
        if nm not in INVARIANTS:
            raise ValueError(
                f"cannot emit invariant expression {nm!r} to TLC: only "
                f"the registered names ({', '.join(sorted(INVARIANTS))}) "
                "have TLA+ operator definitions")
        names.append(nm)
    os.makedirs(out_dir, exist_ok=True)
    tla = os.path.join(out_dir, "MC2pc.tla")
    cfgp = os.path.join(out_dir, "MC2pc.cfg")
    with open(tla, "w", encoding="utf-8") as f:
        f.write(_TLA_TEMPLATE.format())
    rms = ", ".join(_rm(i) for i in range(bounds.n_servers))
    lines = ["SPECIFICATION Spec",
             f"CONSTANT RM = {{{rms}}}"]
    for nm in names:
        lines.append(f"INVARIANT {nm}")
    with open(cfgp, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return tla, cfgp
