"""Emit the TLC-side artifacts for oracle parity runs — the port's copy of
``raft_tla_tpu/models/tla_export.py`` (``--emit-tlc DIR``).

Its output is byte-equal to the reference's for the same bounds and flags:
the generated module's header keeps naming ``raft_tla_tpu.models.
tla_export``, so one TLC twin serves both packages.  The reference's
refusals stay: expression invariants have no TLA+ text here, and PROPERTY
twins wait for liveness (ROADMAP.md queue A 5).

The reference's config is not runnable by stock TLC as-is: ``raft.cfg:3``
declares ``INVARIANT NoTwoLeaders`` but no such operator exists in
``raft.tla`` (SURVEY §0 defect 1), and the cfg has no ``CONSTRAINT`` while
the raw spec's state space is infinite (defect 2).  This module generates a
standard "MC" extension module + cfg pair that fixes both *without touching
the read-only reference*:

- ``MCraft.tla`` — ``EXTENDS raft`` and defines (a) every invariant the run
  checks, in TLA+ (one definition site with the registry in
  ``models/invariants.py``: the TLA+ text here and the predicates there are
  differentially tested via the interpreter); (b) ``StateConstraint``, the
  exact bound the tensor encoding enforces (``config.Bounds``); (c)
  ``ParityView``, a TLC ``VIEW`` that strips the history-only state the
  tensor encoding drops (``elections``/``allLogs``/``voterLog``,
  ``raft.tla:39,44,77``, and the ``mlog`` message fields,
  ``raft.tla:220-222,297-299``) so TLC deduplicates states the same way this
  checker does (SURVEY §7.0.3 parity mode).
- ``MCraft.cfg`` — the reference's CONSTANTS block (``raft.cfg:5-15``)
  verbatim-equivalent, plus the INVARIANT/CONSTRAINT/VIEW stanzas.

The artifacts are validated structurally and by round-tripping through
``utils/cfgparse``; running them under stock TLC is the documented parity
procedure for a host that has a JVM (README).

Caveat on ``ParityView`` exactness: the view maps the message bag to the set
of ``<<stripped-record, multiplicity>>`` pairs.  If two in-flight messages
differ *only* in ``mlog``, TLC sees two pairs where the tensor encoding sums
one slot; such states would be distinguished by TLC and merged here.  No
reachable pair of messages differs only in ``mlog`` under the spec's guards
(``votedFor`` blocks same-term re-grants, ``raft.tla:290-292``), so counts
agree on reachable spaces; the construction is noted for auditability.
"""

from __future__ import annotations

import os

from raft_tla_tpu_torch.config import Bounds, not_ported

MODULE_NAME = "MCraft"


def _sym_axes(symmetry) -> tuple:
    """Normalize the ``symmetry`` argument (True or an axis iterable) to a
    canonical ``("Server",)`` / ``("Value",)`` / ``("Server", "Value")``."""
    raw = ("Server",) if symmetry is True else tuple(symmetry)
    bad = [ax for ax in raw if ax not in ("Server", "Value")]
    if bad:
        raise ValueError(f"unknown symmetry axes {bad}: only Server/Value "
                         "permutation symmetry exists in this checker")
    return tuple(ax for ax in ("Server", "Value") if ax in raw)


def _sym_name(symmetry) -> str:
    """Axis-encoded SYMMETRY operator name (``SymServer`` /
    ``SymValue`` / ``SymServerValue``) — one of the names
    ``check.resolve_check_config`` accepts, so the emitted cfg
    round-trips through this checker as well as TLC.  Canonical
    axis order regardless of the caller's tuple order."""
    return "Sym" + "".join(_sym_axes(symmetry))

# TLA+ text per registry invariant (names match models/invariants.REGISTRY).
_INVARIANT_TLA = {
    "NoTwoLeaders": """\
NoTwoLeaders ==
    \\A i, j \\in Server :
        (/\\ state[i] = Leader
         /\\ state[j] = Leader
         /\\ currentTerm[i] = currentTerm[j]) => i = j""",
    "ElectionSafety": """\
ElectionSafety ==
    \\A i, j \\in Server :
        (/\\ state[i] = Leader
         /\\ state[j] = Leader
         /\\ currentTerm[i] = currentTerm[j]) => i = j""",
    "NaiveNoTwoLeaders": """\
NaiveNoTwoLeaders ==
    \\A i, j \\in Server :
        (state[i] = Leader /\\ state[j] = Leader) => i = j""",
    "LogMatching": """\
LogMatching ==
    \\A i, j \\in Server :
        \\A k \\in 1..Min({Len(log[i]), Len(log[j])}) :
            log[i][k].term = log[j][k].term =>
                SubSeq(log[i], 1, k) = SubSeq(log[j], 1, k)""",
    "CommittedWithinLog": """\
CommittedWithinLog ==
    \\A i \\in Server : commitIndex[i] <= Len(log[i])""",
    "LeaderCompleteness": """\
\\* The commit term of any entry within commitIndex[j] is <= currentTerm[j]
\\* (raft.tla:268-270, 356-365), so leaders of terms beyond currentTerm[j]
\\* must already hold the entry (Raft Fig. 3).
LeaderCompleteness ==
    \\A i, j \\in Server :
        \\A k \\in 1..commitIndex[j] :
            (state[i] = Leader /\\ currentTerm[i] > currentTerm[j]) =>
                (k <= Len(log[i]) /\\ log[i][k] = log[j][k])""",
    # -- history-based (faithful mode: read the raft.tla:39/44 variables) ----
    "ElectionSafetyHist": """\
\\* At most one leader was EVER elected per term (over the elections
\\* history, raft.tla:237-242) — stronger than the state-level reading.
ElectionSafetyHist ==
    \\A e1, e2 \\in elections : e1.eterm = e2.eterm => e1.eleader = e2.eleader""",
    "LeaderCompletenessHist": """\
\\* Every currently-committed entry appears in the elog of every recorded
\\* election of a later term (Raft Fig. 3 over history).
LeaderCompletenessHist ==
    \\A j \\in Server :
        \\A k \\in 1..commitIndex[j] :
            \\A e \\in elections :
                e.eterm > currentTerm[j] =>
                    (k <= Len(e.elog) /\\ e.elog[k] = log[j][k])""",
    "AllLogsPrefixClosed": """\
\\* allLogs (raft.tla:44,465) is prefix-closed: logs grow by single appends.
AllLogsPrefixClosed ==
    \\A l \\in allLogs :
        Len(l) > 0 => SubSeq(l, 1, Len(l) - 1) \\in allLogs""",
}

_PARITY_VIEW = """\
\\* History-free projection of one message record (SURVEY §7.0.3):
\\* mlog (raft.tla:220-222, 297-299) is proof-only and read by no guard.
StripMsg(m) == [f \\in DOMAIN m \\ {"mlog"} |-> m[f]]

\\* The VIEW under which TLC fingerprints states: drops the history
\\* variables elections/allLogs/voterLog (raft.tla:39,44,77) entirely and
\\* the mlog fields inside the message bag.
ParityView ==
    << {<<StripMsg(m), messages[m]>> : m \\in DOMAIN messages},
       currentTerm, state, votedFor, log, commitIndex,
       votesResponded, votesGranted, nextIndex, matchIndex >>"""


_DEAD_VOTES = """\
\\* The deadvotes VIEW (models/views.py): vote sets of non-Candidates are
\\* dead variables — every read in raft.tla (RequestVote raft.tla:196-203,
\\* BecomeLeader raft.tla:236-238, HandleRequestVoteResponse
\\* raft.tla:341-350) is Candidate-guarded, and Timeout (raft.tla:180-187)
\\* resets them — so masking them is an exact quotient.
DeadVotes(v) == [i \\in Server |-> IF state[i] = Candidate THEN v[i]
                                   ELSE {}]"""


# The election sub-spec's Next (models/spec.SUBSETS["election"]), with
# the reference Next's exact structure — the per-step allLogs history
# update is the top-level conjunct (raft.tla:464-465), the disjuncts are
# the subset of raft.tla:455-461 the checker's election action table
# enumerates.  Receive stays unrestricted: with AppendEntries excluded
# the bag only ever holds RequestVote traffic, so the reachable spaces
# coincide.
_ELECTION_NEXT = """\
\\* The election-only sub-spec (BASELINE config #2): Timeout +
\\* RequestVote + BecomeLeader + Receive, the same subset of the
\\* raft.tla:454-463 disjuncts the checker's --spec election explores.
ElectionNext ==
    /\\ \\/ \\E i \\in Server : Timeout(i)
       \\/ \\E i, j \\in Server : RequestVote(i, j)
       \\/ \\E i \\in Server : BecomeLeader(i)
       \\/ \\E m \\in DOMAIN messages : Receive(m)
    /\\ allLogs' = allLogs \\cup {log[i] : i \\in Server}

ElectionSpec == Init /\\ [][ElectionNext]_vars"""


def _spec_parts(spec: str):
    """(module text blocks, SPECIFICATION name) for a sub-spec twin."""
    if spec in (None, "full"):
        return [], "Spec"
    if spec == "election":
        return [_ELECTION_NEXT, ""], "ElectionSpec"
    raise ValueError(
        f"no TLA+ export for spec {spec!r} (replication starts from a "
        "preset-leader Init the exporter does not emit)")


def _no_properties(properties: tuple) -> None:
    if properties:
        raise not_ported(f"PROPERTY export {list(properties)}",
                         "item 5, liveness")


def emit_module(bounds: Bounds, invariants: tuple,
                parity_view: bool = True, symmetry: bool = False,
                view: str | None = None, spec: str = "full",
                properties: tuple = ()) -> str:
    """The ``MCraft.tla`` text: invariants + StateConstraint (+ VIEW).
    ``properties`` (temporal PROPERTY twins) are not ported."""
    _no_properties(properties)
    unknown = [nm for nm in invariants if nm not in _INVARIANT_TLA]
    if unknown:
        raise ValueError(f"no TLA+ export for invariants: {unknown}")
    spec_blocks, _ = _spec_parts(spec)
    parts = [f"---------------------------- MODULE {MODULE_NAME} "
             "----------------------------",
             "\\* Generated by raft_tla_tpu.models.tla_export — the TLC",
             "\\* oracle-side twin of one checker run. Extends the reference",
             "\\* spec unmodified.",
             "EXTENDS raft", ""]
    parts += spec_blocks
    for nm in invariants:
        parts += [_INVARIANT_TLA[nm], ""]
    parts += [f"""\
\\* The state constraint the tensor encoding enforces (config.Bounds).
StateConstraint ==
    /\\ \\A i \\in Server : currentTerm[i] <= {bounds.max_term}
    /\\ \\A i \\in Server : Len(log[i]) <= {bounds.max_log}
    /\\ Cardinality(DOMAIN messages) <= {bounds.max_msgs}
    /\\ \\A m \\in DOMAIN messages : messages[m] <= {bounds.max_dup}""", ""]
    if view not in (None, "deadvotes"):
        raise ValueError(f"no TLA+ export for view {view!r}")
    if view:
        parts += [_DEAD_VOTES, ""]
    if parity_view:
        pv = _PARITY_VIEW
        if view:
            pv = pv.replace(
                "votesResponded, votesGranted",
                "DeadVotes(votesResponded), DeadVotes(votesGranted)")
        parts += [pv, ""]
    elif view:
        # faithful mode: identity keeps the history variables, only the
        # dead vote sets are masked
        parts += ["""\
DeadVotesView ==
    << messages, currentTerm, state, votedFor, log, commitIndex,
       DeadVotes(votesResponded), DeadVotes(votesGranted),
       nextIndex, matchIndex, elections, allLogs, voterLog >>""", ""]
    if symmetry:
        union = " \\cup ".join(f"Permutations({ax})"
                               for ax in _sym_axes(symmetry))
        # Axis-encoded name (SymServer / SymValue / SymServerValue) so
        # check.py:_resolve_config accepts its own --emit-tlc artifact.
        parts += ["\\* TLC symmetry set matching the checker's "
                  "symmetry reduction.",
                  f"{_sym_name(symmetry)} == {union}", ""]
    parts.append("=" * 77)
    return "\n".join(parts)


def emit_cfg(bounds: Bounds, invariants: tuple,
             parity_view: bool = True, symmetry: bool = False,
             view: str | None = None, spec: str = "full",
             properties: tuple = ()) -> str:
    """The ``MCraft.cfg`` text: reference bindings + the new stanzas."""
    _no_properties(properties)
    servers = ", ".join(f"s{i + 1}" for i in range(bounds.n_servers))
    values = ", ".join(f"v{i + 1}" for i in range(bounds.n_values))
    _blocks, spec_name = _spec_parts(spec)
    lines = [
        f"SPECIFICATION {spec_name}",
        "",
        *[f"INVARIANT {nm}" for nm in invariants],
        "CONSTRAINT StateConstraint",
        *(["VIEW ParityView"] if parity_view
          else ["VIEW DeadVotesView"] if view else []),
        *([f"SYMMETRY {_sym_name(symmetry)}"] if symmetry else []),
        "",
        "CONSTANTS",
        f"    Server = {{{servers}}}",
        f"    Value = {{{values}}}",
        '    Follower = "Follower"',
        '    Candidate = "Candidate"',
        '    Leader = "Leader"',
        '    Nil = "Nil"',
        '    RequestVoteRequest = "RequestVoteRequest"',
        '    RequestVoteResponse = "RequestVoteResponse"',
        '    AppendEntriesRequest = "AppendEntriesRequest"',
        '    AppendEntriesResponse = "AppendEntriesResponse"',
        "",
    ]
    return "\n".join(lines)


def export(outdir: str, bounds: Bounds, invariants: tuple,
           parity_view: bool = True, symmetry: bool = False,
           view: str | None = None, spec: str = "full",
           properties: tuple = ()) -> tuple:
    """Write ``MCraft.tla``/``MCraft.cfg`` into ``outdir``; return the paths.

    Run on a host with a JVM as::

        java -jar tla2tools.jar -config MCraft.cfg MCraft.tla

    with the reference ``raft.tla`` on the module search path.
    """
    os.makedirs(outdir, exist_ok=True)
    tla = os.path.join(outdir, f"{MODULE_NAME}.tla")
    cfg = os.path.join(outdir, f"{MODULE_NAME}.cfg")
    with open(tla, "w", encoding="utf-8") as f:
        f.write(emit_module(bounds, invariants, parity_view, symmetry,
                            view, spec, properties))
    with open(cfg, "w", encoding="utf-8") as f:
        f.write(emit_cfg(bounds, invariants, parity_view, symmetry, view,
                         spec, properties))
    return tla, cfg
