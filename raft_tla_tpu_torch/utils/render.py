"""TLA+-style rendering of states and traces — the port's copy of
``raft_tla_tpu/utils/render.py``.

The output mimics TLC's violation-trace format (``State 1: <Initial ...>``
followed by a conjunction of variable assignments) so anyone used to reading
TLC ``*.out`` logs (the reference's only run artifact, ``.gitignore:1``) can
read this checker's counterexamples.  Variables render in the declaration
order of ``raft.tla:32-92``; message records render with their
``raft.tla``-schema field names.
"""

from __future__ import annotations

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.engine import DEADLOCK
from raft_tla_tpu_torch.models import spec as S
from raft_tla_tpu_torch.ops import msgbits as mb

_ROLE = {S.FOLLOWER: "Follower", S.CANDIDATE: "Candidate", S.LEADER: "Leader"}

_MTYPE = {1: "RequestVoteRequest", 2: "RequestVoteResponse",
          3: "AppendEntriesRequest", 4: "AppendEntriesResponse"}


def _srv(i: int) -> str:
    return f"s{i + 1}"


def render_msg(hi: int, lo: int) -> str:
    """One message record, with per-type field names (ops/msgbits.py table)."""
    t = mb.mtype(hi)
    base = (f"mtype |-> {_MTYPE.get(t, t)}, mterm |-> {mb.mterm(hi)}, "
            f"msource |-> {_srv(mb.src(hi))}, mdest |-> {_srv(mb.dst(hi))}")
    if t == 1:
        mid = (f"mlastLogTerm |-> {mb.fa(hi)}, "
               f"mlastLogIndex |-> {mb.fb(hi)}")
    elif t == 2:
        mid = f"mvoteGranted |-> {'TRUE' if mb.fa(hi) else 'FALSE'}"
    elif t == 3:
        n = mb.fc(lo)
        ents = (f"<<[term |-> {mb.fd(lo)}, value |-> v{mb.fe(lo)}]>>"
                if n else "<<>>")
        mid = (f"mprevLogIndex |-> {mb.fa(hi)}, "
               f"mprevLogTerm |-> {mb.fb(hi)}, mentries |-> {ents}, "
               f"mcommitIndex |-> {mb.ff(lo)}")
    elif t == 4:
        mid = (f"msuccess |-> {'TRUE' if mb.fa(hi) else 'FALSE'}, "
               f"mmatchIndex |-> {mb.fb(hi)}")
    else:
        mid = f"raw |-> <<{hi}, {lo}>>"
    return f"[{base}, {mid}]"


def _fn(bounds: Bounds, fmt) -> str:
    """A [Server -> ...] function literal in TLC's display style."""
    parts = [f"{_srv(i)} :> {fmt(i)}" for i in range(bounds.n_servers)]
    return "(" + " @@ ".join(parts) + ")"


def _bitmask(mask: int, bounds: Bounds) -> str:
    return "{" + ", ".join(_srv(i) for i in range(bounds.n_servers)
                           if mask >> i & 1) + "}"


def _log(entries) -> str:
    return "<<" + ", ".join(
        f"[term |-> {t}, value |-> v{v}]" for t, v in entries) + ">>"


def render_state(s, bounds: Bounds, indent: str = "    ") -> str:
    """A PyState as a TLC-style conjunction of variable assignments."""
    n = bounds.n_servers
    lines = [
        "/\\ messages = (" + (" @@ ".join(
            f"{render_msg(hi, lo)} :> {cnt}" for (hi, lo), cnt in s.msgs)
            if s.msgs else "<<>> :> 0") + ")",
        "/\\ currentTerm = " + _fn(bounds, lambda i: s.term[i]),
        "/\\ state = " + _fn(bounds, lambda i: _ROLE[s.role[i]]),
        "/\\ votedFor = " + _fn(
            bounds, lambda i: _srv(s.votedFor[i] - 1)
            if s.votedFor[i] else "Nil"),
        "/\\ log = " + _fn(bounds, lambda i: _log(s.log[i])),
        "/\\ commitIndex = " + _fn(bounds, lambda i: s.commitIndex[i]),
        "/\\ votesResponded = " + _fn(
            bounds, lambda i: _bitmask(s.vResp[i], bounds)),
        "/\\ votesGranted = " + _fn(
            bounds, lambda i: _bitmask(s.vGrant[i], bounds)),
        "/\\ nextIndex = " + _fn(bounds, lambda i: "(" + " @@ ".join(
            f"{_srv(j)} :> {s.nextIndex[i][j]}" for j in range(n)) + ")"),
        "/\\ matchIndex = " + _fn(bounds, lambda i: "(" + " @@ ".join(
            f"{_srv(j)} :> {s.matchIndex[i][j]}" for j in range(n)) + ")"),
    ]
    if s.elections is not None:
        # Faithful mode: the history variables (elections raft.tla:39,
        # allLogs raft.tla:44, voterLog raft.tla:77).
        lines.append("/\\ elections = {" + ", ".join(
            f"[eterm |-> {et}, eleader |-> {_srv(el)}, elog |-> {_log(lg)}, "
            f"evotes |-> {_bitmask(ev, bounds)}, "
            "evoterLog |-> (" + " @@ ".join(
                f"{_srv(j)} :> {_log(vl[j])}" for j in range(n)
                if vl[j] is not None) + ")]"
            for et, el, lg, ev, vl in s.elections) + "}")
        lines.append("/\\ allLogs = {" + ", ".join(
            _log(l) for l in s.allLogs) + "}")
        lines.append("/\\ voterLog = " + _fn(
            bounds, lambda i: "(" + " @@ ".join(
                f"{_srv(j)} :> {_log(s.vLog[i][j])}" for j in range(n)
                if s.vLog[i][j] is not None) + ")"))
    return "\n".join(indent + ln for ln in lines)


def render_trace(violation, bounds: Bounds, state_renderer=None) -> str:
    """TLC-style numbered counterexample trace.  ``state_renderer``
    overrides the per-state formatter (non-Raft models supply their
    own); the default is the Raft :func:`render_state`."""
    rs = state_renderer or render_state
    head = "Error: Deadlock reached." if violation.invariant == DEADLOCK \
        else f"Error: Invariant {violation.invariant} is violated."
    out = [head, "Error: The behavior up to this point is:"]
    for k, (label, state) in enumerate(violation.trace, start=1):
        head = "<Initial predicate>" if label is None else f"<{label}>"
        out.append(f"State {k}: {head}")
        out.append(rs(state, bounds))
        out.append("")
    return "\n".join(out)
