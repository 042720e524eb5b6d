"""Spec-level metadata — the port's copy of ``raft_tla_tpu/models/spec.py``
and the action-table part of ``raft_tla_tpu/frontend/raft_schema.py``.

Encodings
---------
Roles (``CONSTANTS Follower, Candidate, Leader``, ``raft.tla:17``): 0/1/2.
``Nil`` (``raft.tla:20``) is 0 in ``votedFor``; servers are 1..n there, and
0..n-1 everywhere else.  Message types (``raft.tla:23-24``) are 1..4, with 0
meaning "empty slot".

Action families — the ``Next`` disjuncts (``raft.tla:454-463``)
---------------------------------------------------------------
==============  ===========================  ==================
family          TLA action                   instances
==============  ===========================  ==================
RESTART         Restart(i)        :167-175   n
TIMEOUT         Timeout(i)        :178-187   n
REQUESTVOTE     RequestVote(i,j)  :190-199   n*n   (j may = i)
BECOMELEADER    BecomeLeader(i)   :229-243   n
CLIENTREQUEST   ClientRequest(i,v):246-253   n*V
ADVANCECOMMIT   AdvanceCommitIndex(i):259-276  n
APPENDENTRIES   AppendEntries(i,j):204-226   n*(n-1)  (i /= j)
RECEIVE         Receive(m)        :421-436   msg_cap slots
DUPLICATE       DuplicateMessage(m):443-445  msg_cap slots
DROP            DropMessage(m)    :448-450   msg_cap slots
==============  ===========================  ==================

``Receive``/``Duplicate``/``Drop`` quantify over ``DOMAIN messages``; in the
tensor encoding that is "occupied message slot", and because slots are kept
canonically sorted, slot index k denotes the same message on the interpreter
and the kernel sides.  The lane order of :func:`action_table` equals the
reference's ``action_table`` (asserted in tests/test_torch_step.py); the
fused step kernel reads it as a per-lane table (``FAMILY_CODES``).

Sub-specs: ``full`` is the whole ``Next``; ``election`` keeps Timeout +
RequestVote + Receive + BecomeLeader; ``replication`` keeps ClientRequest +
AppendEntries + Receive + AdvanceCommitIndex (run from a preset leader).
"""

from __future__ import annotations

import dataclasses

from raft_tla_tpu_torch.config import Bounds

# Roles (raft.tla:17)
FOLLOWER, CANDIDATE, LEADER = 0, 1, 2
ROLE_NAMES = ("Follower", "Candidate", "Leader")

# votedFor: 0 = Nil (raft.tla:20), 1..n = server id + 1
NIL = 0

# Message types (raft.tla:23-24); 0 = empty slot
M_NONE = 0
M_RVREQ = 1   # RequestVoteRequest
M_RVRESP = 2  # RequestVoteResponse
M_AEREQ = 3   # AppendEntriesRequest
M_AERESP = 4  # AppendEntriesResponse
MTYPE_NAMES = ("None", "RequestVoteRequest", "RequestVoteResponse",
               "AppendEntriesRequest", "AppendEntriesResponse")

# Action families, in enumeration order.
RESTART = "Restart"
TIMEOUT = "Timeout"
REQUESTVOTE = "RequestVote"
BECOMELEADER = "BecomeLeader"
CLIENTREQUEST = "ClientRequest"
ADVANCECOMMIT = "AdvanceCommitIndex"
APPENDENTRIES = "AppendEntries"
RECEIVE = "Receive"
DUPLICATE = "DuplicateMessage"
DROP = "DropMessage"

ALL_FAMILIES = (RESTART, TIMEOUT, REQUESTVOTE, BECOMELEADER, CLIENTREQUEST,
                ADVANCECOMMIT, APPENDENTRIES, RECEIVE, DUPLICATE, DROP)

SPECS = {
    # The full Next relation (raft.tla:454-463).
    "full": frozenset(ALL_FAMILIES),
    # Election-only sub-spec (BASELINE config #2).
    "election": frozenset({TIMEOUT, REQUESTVOTE, RECEIVE, BECOMELEADER}),
    # Log-replication sub-spec from a preset leader (BASELINE config #3).
    "replication": frozenset({CLIENTREQUEST, APPENDENTRIES, RECEIVE,
                              ADVANCECOMMIT}),
}

@dataclasses.dataclass(frozen=True)
class ActionInstance:
    """One successor lane: a family plus its bound parameters.

    ``i``/``j`` are server ids, ``v`` a value id (1..V), ``slot`` a message
    slot index — mirroring the existential quantifiers of ``raft.tla:454-463``.
    """
    family: str
    i: int = -1
    j: int = -1
    v: int = -1
    slot: int = -1

    def label(self) -> str:
        if self.family == RESTART:
            return f"Restart(s{self.i + 1})"
        if self.family == TIMEOUT:
            return f"Timeout(s{self.i + 1})"
        if self.family == REQUESTVOTE:
            return f"RequestVote(s{self.i + 1}, s{self.j + 1})"
        if self.family == BECOMELEADER:
            return f"BecomeLeader(s{self.i + 1})"
        if self.family == CLIENTREQUEST:
            return f"ClientRequest(s{self.i + 1}, v{self.v})"
        if self.family == ADVANCECOMMIT:
            return f"AdvanceCommitIndex(s{self.i + 1})"
        if self.family == APPENDENTRIES:
            return f"AppendEntries(s{self.i + 1}, s{self.j + 1})"
        return f"{self.family}(slot {self.slot})"


def action_table(bounds: Bounds, spec: str = "full") -> list[ActionInstance]:
    """The static, ordered successor fan-out for one state.

    Enumeration order mirrors the disjunct order of ``Next``
    (``raft.tla:454-463``).  Size A = 4n + n^2 + nV + n(n-1) + 3*msg_cap for
    the full spec.
    """
    fams = SPECS[spec]
    n, V, S = bounds.n_servers, bounds.n_values, bounds.msg_cap
    table: list[ActionInstance] = []
    if RESTART in fams:
        table += [ActionInstance(RESTART, i=i) for i in range(n)]
    if TIMEOUT in fams:
        table += [ActionInstance(TIMEOUT, i=i) for i in range(n)]
    if REQUESTVOTE in fams:
        table += [ActionInstance(REQUESTVOTE, i=i, j=j)
                  for i in range(n) for j in range(n)]
    if BECOMELEADER in fams:
        table += [ActionInstance(BECOMELEADER, i=i) for i in range(n)]
    if CLIENTREQUEST in fams:
        table += [ActionInstance(CLIENTREQUEST, i=i, v=v)
                  for i in range(n) for v in range(1, V + 1)]
    if ADVANCECOMMIT in fams:
        table += [ActionInstance(ADVANCECOMMIT, i=i) for i in range(n)]
    if APPENDENTRIES in fams:
        table += [ActionInstance(APPENDENTRIES, i=i, j=j)
                  for i in range(n) for j in range(n) if i != j]
    if RECEIVE in fams:
        table += [ActionInstance(RECEIVE, slot=s) for s in range(S)]
    if DUPLICATE in fams:
        table += [ActionInstance(DUPLICATE, slot=s) for s in range(S)]
    if DROP in fams:
        table += [ActionInstance(DROP, slot=s) for s in range(S)]
    return table


# Family -> small integer code, the ``family`` column of the per-lane table
# the fused step kernel reads (csrc/step.cu ``enum Family`` — same order).
FAMILY_CODES = {fam: k for k, fam in enumerate(ALL_FAMILIES)}


def lane_table(bounds: Bounds, spec: str = "full") -> list:
    """The action table as rows ``(family code, i, j, v, slot)``."""
    return [(FAMILY_CODES[a.family], a.i, a.j, a.v, a.slot)
            for a in action_table(bounds, spec)]
