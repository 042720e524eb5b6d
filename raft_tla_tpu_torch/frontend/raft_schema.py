"""Raft as frontend data — the port of ``raft_tla_tpu/frontend/raft_schema.py``.

The port keeps Raft's encodings and action-instance table in
``models/spec.py`` (the leaf every layer imports); this module re-exports
them beside the Raft *state schema*, :data:`RAFT_SCHEMA`: the declared
twin of ``ops/state.STATE_FIELDS`` (field names, order, shapes, and value
ranges equal to ``analysis/intervals.envelope``), which lets the generic
frontend paths (the IR in ``frontend/raft_ir``, schema linting) treat Raft
like any other loaded spec.  The tests hold its layout to
``ops/state.Layout``.
"""

from __future__ import annotations

from raft_tla_tpu_torch.frontend.schema import Field, Schema
from raft_tla_tpu_torch.models.spec import (  # noqa: F401
    ADVANCECOMMIT, ALL_FAMILIES, APPENDENTRIES, BECOMELEADER, CANDIDATE,
    CLIENTREQUEST, DROP, DUPLICATE, FOLLOWER, LEADER, M_AEREQ, M_AERESP,
    M_NONE, M_RVREQ, M_RVRESP, MTYPE_NAMES, NIL, RECEIVE, REQUESTVOTE,
    RESTART, ROLE_NAMES, SPECS, TIMEOUT, ActionInstance, action_table)

# The parity-mode state schema: ops/state.STATE_FIELDS as a frontend
# declaration (the packed msgHi/msgLo words are checked per subfield by the
# width pass, so the whole-word ranges here are the packed spans).
RAFT_SCHEMA = Schema("raft", (
    Field("role", ("n",), 0, 2),
    Field("term", ("n",), 1, "term_cap", init=1),
    Field("votedFor", ("n",), 0, "n_servers"),
    Field("commitIndex", ("n",), 0, "log_cap"),
    Field("logLen", ("n",), 0, "log_cap"),
    Field("logTerm", ("n", "L"), 0, "term_cap"),
    Field("logVal", ("n", "L"), 0, "n_values"),
    Field("vResp", ("n",), 0, lambda b: (1 << b.n_servers) - 1),
    Field("vGrant", ("n",), 0, lambda b: (1 << b.n_servers) - 1),
    Field("nextIndex", ("n", "n"), 1, lambda b: b.log_cap + 1, init=1),
    Field("matchIndex", ("n", "n"), 0, "log_cap"),
    Field("msgHi", ("S",), 0, lambda b: (1 << 29) - 1),
    Field("msgLo", ("S",), 0,
          lambda b: (1 << (31 if b.history else 17)) - 1),
    Field("msgCount", ("S",), 0, "dup_cap"),
))
