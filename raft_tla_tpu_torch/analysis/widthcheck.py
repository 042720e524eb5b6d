"""Pass 1 — width-safety: prove no transition can overflow a packed field.
The port's copy of ``raft_tla_tpu/analysis/widthcheck.py``, run over the
port's own tables: ``ops/msgbits`` (the record layout ``csrc/step.cu``
repeats), ``ops/bitpack``, ``ops/kernels.TRANSFER_WRITES`` and
``ops/pallas_step.FUSED_WRITES`` (the write surface of K1).

The theorem being checked, per mode (parity / faithful):

1. **Base**: the Init state lies inside the claimed per-field envelope
   (:func:`.intervals.envelope`), and the envelope fits the bit widths
   ``ops/bitpack.field_bits`` allots.
2. **Induction**: for every action family in the spec subset, the abstract
   transfer function — mirroring the guard/update structure of the kernel
   in ``ops/kernels`` — maps the *expansion envelope* (envelope met with
   the StateConstraint: only constraint-satisfying states are ever
   expanded, TLC semantics) back inside the envelope.
3. **Messages**: every packed-record creation site writes subfields that
   fit the ``ops/msgbits`` shift/width tables, where the subfield ranges
   of *received* messages come from a monotone fixpoint over all creation
   sites (the bag starts empty at Init, so the fixpoint is the inductive
   message invariant).
4. **Tables**: the shift/width tables themselves have no overlap and no
   spill past bit 31 (int32 sign bit clear), and every flat-vector field
   width is <= 31 except the declared raw-mask fields.

Any hole is reported with the transition name, field, derived interval,
and allotted width — the acceptance contract of the analyzer.

The transfer functions are *hand-written twins* of the kernels, the same
way ``models/interp.py`` twins them for value semantics; the cross-check
against ``ops/kernels.transfer_metadata()`` (same families, same
written-field sets) makes silent drift between kernel and transfer a
loud lint error.  Every input (field widths, shift tables, envelopes,
transfers) is injectable so the seeded-mutation harness
of the reference's tests can prove the analyzer has no false
negatives on known overflow bugs.
"""

from __future__ import annotations

import dataclasses

from raft_tla_tpu_torch.analysis import intervals as iv
from raft_tla_tpu_torch.analysis.report import ERROR, WIDTH, Finding
from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import spec as SP
from raft_tla_tpu_torch.ops import state as st

BIG = 1 << 40       # "unbounded" guard limit for meet() refinements


@dataclasses.dataclass(frozen=True)
class MsgRecord:
    """Abstract packed record: one creation site's subfield intervals.

    Keys are the ``ops/msgbits`` field names; keys containing ``+`` are
    *derived* relational facts (e.g. ``a+c`` of AppendEntriesRequest:
    prevLogIndex + Len(mentries), which the done-reply echoes as
    mmatchIndex) — they join into the message envelope but are not
    width-checked against the shift tables.
    """

    mtype: int
    fields: dict


@dataclasses.dataclass(frozen=True)
class TransferResult:
    writes: dict          # struct field -> Interval of newly written values
    sends: tuple = ()     # MsgRecords added to the bag


def _rank_iv(bounds: Bounds) -> iv.Interval:
    """Log-universe ranks (faithful mode); parity passes 0 (stripped)."""
    if not bounds.history:
        return iv.const(0)
    from raft_tla_tpu_torch.ops.loguniv import LogUniverse
    return iv.Interval(0, LogUniverse.of(bounds).size - 1)


def _last_term(env) -> iv.Interval:
    """LastTerm(log[i]) (raft.tla:102): 0 when empty, else a stored term."""
    return env["logTerm"].join(0)


def _server_iv(bounds: Bounds) -> iv.Interval:
    return iv.Interval(0, max(bounds.n_servers - 1, 0))


def _bag_count(env) -> iv.Interval:
    """msgCount after a bag_add: one multiplicity bumped by 1."""
    return env["msgCount"] + iv.Interval(0, 1)


# -- per-family transfers (the kernel twins) ---------------------------------

def t_restart(bounds, env, menv):
    """Restart(i) (raft.tla:167-175)."""
    writes = {"role": iv.const(SP.FOLLOWER), "vResp": iv.const(0),
              "vGrant": iv.const(0), "nextIndex": iv.const(1),
              "matchIndex": iv.const(0), "commitIndex": iv.const(0)}
    if bounds.history:
        writes["vLog"] = iv.const(0)
    return TransferResult(writes)


def t_timeout(bounds, env, menv):
    """Timeout(i) (raft.tla:178-187): the term increment.  Sound only
    because env is the EXPANSION envelope (term <= max_term): the +1
    capacity scheme of config.py, proved rather than assumed."""
    writes = {"role": iv.const(SP.CANDIDATE), "term": env["term"] + 1,
              "votedFor": iv.const(SP.NIL), "vResp": iv.const(0),
              "vGrant": iv.const(0)}
    if bounds.history:
        writes["vLog"] = iv.const(0)
    return TransferResult(writes)


def t_request_vote(bounds, env, menv):
    """RequestVote(i, j) (raft.tla:190-199)."""
    rec = MsgRecord(SP.M_RVREQ, {
        "mtype": iv.const(SP.M_RVREQ),
        "mterm": env["term"],
        "a": _last_term(env),            # mlastLogTerm (raft.tla:195)
        "b": env["logLen"],              # mlastLogIndex (raft.tla:196)
        "src": _server_iv(bounds), "dst": _server_iv(bounds),
        "c": iv.const(0), "d": iv.const(0), "e": iv.const(0),
        "f": iv.const(0), "g": iv.const(0),
    })
    return TransferResult(_send_writes(env, (rec,)), (rec,))


def t_append_entries(bounds, env, menv):
    """AppendEntries(i, j) (raft.tla:204-226)."""
    prev_idx = env["nextIndex"] - 1
    last_entry = env["logLen"].min_(env["nextIndex"])     # raft.tla:213
    rec = MsgRecord(SP.M_AEREQ, {
        "mtype": iv.const(SP.M_AEREQ),
        "mterm": env["term"],
        "a": prev_idx,                                    # mprevLogIndex
        "b": _last_term(env),                             # mprevLogTerm
        "c": iv.BOOL,                                     # Len(mentries)
        "d": env["logTerm"].join(0),                      # mentries[1].term
        "e": env["logVal"].join(0),                       # mentries[1].value
        "f": env["commitIndex"].min_(last_entry),         # mcommitIndex
        "g": _rank_iv(bounds),                            # mlog rank
        "src": _server_iv(bounds), "dst": _server_iv(bounds),
        # Relational fact the done-reply echoes as mmatchIndex: when an
        # entry is carried (c = 1) the guard ni <= Len(log[i]) makes
        # prevIdx + 1 <= logLen; with c = 0 it is prevIdx itself.  The
        # c = 1 case is infeasible when logs cannot hold an entry.
        "a+c": (prev_idx.join(iv.Interval(1, env["logLen"].hi))
                if env["logLen"].hi >= 1 else prev_idx),
    })
    return TransferResult(_send_writes(env, (rec,)), (rec,))


def t_become_leader(bounds, env, menv):
    """BecomeLeader(i) (raft.tla:229-243)."""
    writes = {"role": iv.const(SP.LEADER),
              "nextIndex": env["logLen"] + 1,
              "matchIndex": iv.const(0)}
    if bounds.history:
        writes.update({
            "eTerm": env["term"], "eLeader": _server_iv(bounds),
            "eLog": _rank_iv(bounds), "eVotes": env["vGrant"],
            "eVLog": env["vLog"],
        })
    return TransferResult(writes)


def t_client_request(bounds, env, menv):
    """ClientRequest(i, v) (raft.tla:246-253): the log append.  logLen + 1
    fits log_cap only under the expansion envelope (logLen <= max_log)."""
    return TransferResult({
        "logTerm": env["term"],
        "logVal": iv.Interval(1, bounds.n_values),
        "logLen": env["logLen"] + 1,
    })


def t_advance_commit(bounds, env, menv):
    """AdvanceCommitIndex(i) (raft.tla:259-276): commits at most logLen."""
    max_agree = iv.Interval(0, env["logLen"].hi)
    return TransferResult({
        "commitIndex": max_agree.join(env["commitIndex"]),
    })


def t_receive(bounds, env, menv):
    """Receive(m) (raft.tla:421-436): the 11-branch dispatch.  Reads come
    from the message envelope ``menv`` (the bag's inductive invariant),
    not the raw subfield widths — the whole point of the fixpoint."""
    writes: dict = {}
    sends: list = []

    def join_write(field, interval):
        writes[field] = interval if field not in writes \
            else writes[field].join(interval)

    ct = env["term"]
    resp_srcdst = _server_iv(bounds)

    # UpdateTerm (raft.tla:406-412): term' = mterm of any carried type.
    mterms = [rec["mterm"] for rec in menv.values() if "mterm" in rec]
    if mterms:
        t = mterms[0]
        for m in mterms[1:]:
            t = t.join(m)
        join_write("term", t)
        join_write("role", iv.const(SP.FOLLOWER))
        join_write("votedFor", iv.const(SP.NIL))

    rv = menv.get(SP.M_RVREQ)
    if rv is not None:
        # HandleRequestVoteRequest (raft.tla:284-303)
        join_write("votedFor", rv["src"] + 1)          # raft.tla:292
        rec = MsgRecord(SP.M_RVRESP, {
            "mtype": iv.const(SP.M_RVRESP), "mterm": ct,
            "a": iv.BOOL,                              # mvoteGranted
            "b": iv.const(0),
            "src": resp_srcdst, "dst": resp_srcdst,
            "c": iv.const(0), "d": iv.const(0), "e": iv.const(0),
            "f": iv.const(0),
            "g": _rank_iv(bounds),                     # voter mlog (:297-299)
        })
        sends.append(rec)

    rvr = menv.get(SP.M_RVRESP)
    if rvr is not None:
        # HandleRequestVoteResponse (raft.tla:307-321)
        one_hot = iv.Interval(1, 1 << _server_iv(bounds).hi)   # 1 << j
        join_write("vResp", env["vResp"].or_(one_hot))
        join_write("vGrant", env["vGrant"].or_(one_hot))
        if bounds.history:
            # voterLog[i] @@ (j :> m.mlog): rank+1, existing entry wins
            join_write("vLog", env["vLog"].join(rvr["g"] + 1))

    ae = menv.get(SP.M_AEREQ)
    if ae is not None:
        # HandleAppendEntriesRequest (raft.tla:327-389)
        rej = MsgRecord(SP.M_AERESP, {
            "mtype": iv.const(SP.M_AERESP), "mterm": ct,
            "a": iv.const(0), "b": iv.const(0),
            "src": resp_srcdst, "dst": resp_srcdst,
            "c": iv.const(0), "d": iv.const(0), "e": iv.const(0),
            "f": iv.const(0), "g": iv.const(0),
        })
        sends.append(rej)
        # done (raft.tla:356-374): commitIndex' = mcommitIndex, success
        # reply echoes mprevLogIndex + Len(mentries) as mmatchIndex.
        join_write("commitIndex", ae["f"])
        done = MsgRecord(SP.M_AERESP, {
            "mtype": iv.const(SP.M_AERESP), "mterm": ct,
            "a": iv.const(1), "b": ae["a+c"],
            "src": resp_srcdst, "dst": resp_srcdst,
            "c": iv.const(0), "d": iv.const(0), "e": iv.const(0),
            "f": iv.const(0), "g": iv.const(0),
        })
        sends.append(done)
        # candidate step-down (raft.tla:346-350)
        join_write("role", iv.const(SP.FOLLOWER))
        # conflict (raft.tla:375-382): drop one tail entry; the guard
        # Len(log[i]) >= index >= 1 bounds logLen away from 0 (and makes
        # the branch infeasible when logs are always empty).
        join_write("logTerm", iv.const(0))
        join_write("logVal", iv.const(0))
        if env["logLen"].hi >= 1:
            join_write("logLen",
                       env["logLen"].meet(iv.Interval(1, BIG)) - 1)
        # append (raft.tla:383-388)
        join_write("logTerm", ae["d"])
        join_write("logVal", ae["e"])
        join_write("logLen", env["logLen"] + 1)

    aer = menv.get(SP.M_AERESP)
    if aer is not None:
        # HandleAppendEntriesResponse (raft.tla:393-403)
        join_write("matchIndex", aer["b"])
        join_write("nextIndex",
                   (aer["b"] + 1).join((env["nextIndex"] - 1).max_(1)))

    # Every reply is Reply = remove + add; removes zero emptied slots.
    for field, interval in _send_writes(env, sends).items():
        join_write(field, interval)
    join_write("msgHi", iv.const(0))
    join_write("msgLo", iv.const(0))
    join_write("msgCount", iv.Interval(0, env["msgCount"].hi))
    return TransferResult(writes, tuple(sends))


def t_duplicate(bounds, env, menv):
    """DuplicateMessage(m) (raft.tla:443-445): one multiplicity + 1; fits
    dup_cap only under the expansion envelope (msgCount <= max_dup)."""
    return TransferResult({"msgCount": env["msgCount"] + 1})


def t_drop(bounds, env, menv):
    """DropMessage(m) (raft.tla:448-450): decrement, zero emptied slots."""
    return TransferResult({
        "msgHi": iv.const(0), "msgLo": iv.const(0),
        "msgCount": iv.Interval(0, env["msgCount"].hi),
    })


def _send_writes(env, sends) -> dict:
    """bag_add's writes for a set of creation sites: the packed words
    (exact shift/or arithmetic over the subfield intervals — unmasked,
    so an overflowing subfield surfaces as a word-level overflow too)
    plus the bumped multiplicity."""
    if not sends:
        return {}
    from raft_tla_tpu_torch.ops.msgbits import HI_FIELDS, LO_FIELDS
    hi = lo = iv.const(0)
    for rec in sends:
        h = l = iv.const(0)
        for name, (sh, _w) in HI_FIELDS.items():
            f = rec.fields.get(name, iv.const(0))
            h = h + iv.Interval(f.lo << sh, f.hi << sh)
        for name, (sh, _w) in LO_FIELDS.items():
            f = rec.fields.get(name, iv.const(0))
            l = l + iv.Interval(f.lo << sh, f.hi << sh)
        hi, lo = hi.join(h), lo.join(l)
    return {"msgHi": hi, "msgLo": lo, "msgCount": _bag_count(env)}


TRANSFERS = {
    SP.RESTART: t_restart,
    SP.TIMEOUT: t_timeout,
    SP.REQUESTVOTE: t_request_vote,
    SP.APPENDENTRIES: t_append_entries,
    SP.BECOMELEADER: t_become_leader,
    SP.CLIENTREQUEST: t_client_request,
    SP.ADVANCECOMMIT: t_advance_commit,
    SP.RECEIVE: t_receive,
    SP.DUPLICATE: t_duplicate,
    SP.DROP: t_drop,
}


def message_envelope(bounds: Bounds, env: dict, transfers: dict) -> dict:
    """Least fixpoint of per-(mtype, subfield) intervals over all record
    creation sites.  The bag is empty at Init, so iteration from bottom
    is the inductive invariant of message content; monotone over a
    finite lattice (every interval is capped by a field range), so it
    converges — the bound is a hard error, not a widening."""
    menv: dict = {}
    for _ in range(32):
        changed = False
        for t in transfers.values():
            for rec in t(bounds, env, menv).sends:
                cur = menv.setdefault(rec.mtype, {})
                for name, interval in rec.fields.items():
                    new = interval if name not in cur \
                        else cur[name].join(interval)
                    if cur.get(name) != new:
                        cur[name] = new
                        changed = True
        if not changed:
            return menv
    raise RuntimeError("message-envelope fixpoint did not converge")


def check_tables(hi_fields=None, lo_fields=None) -> list:
    """Validate the msgHi/msgLo composite encodings: no overlapping
    subfields, no spill past bit 31 (the int32 sign bit stays clear)."""
    from raft_tla_tpu_torch.ops import msgbits as mb
    findings = []
    for word, table in (("msgHi", hi_fields or mb.HI_FIELDS),
                        ("msgLo", lo_fields or mb.LO_FIELDS)):
        spans = sorted((sh, sh + w, name) for name, (sh, w) in table.items())
        for (s0, e0, n0), (s1, e1, n1) in zip(spans, spans[1:]):
            if s1 < e0:
                findings.append(Finding(
                    WIDTH, ERROR, "msg-table-overlap",
                    f"{word} subfields {n0} [{s0},{e0}) and {n1} "
                    f"[{s1},{e1}) overlap", field=f"{word}.{n1}",
                    interval=(s1, e1 - 1), width=e0 - s1))
        top = max(e for _s, e, _n in spans)
        if top > 31:
            name = next(n for _s, e, n in spans if e == top)
            findings.append(Finding(
                WIDTH, ERROR, "msg-table-spill",
                f"{word} subfield {name} ends at bit {top} > 31: the "
                "packed word would touch the int32 sign bit",
                field=f"{word}.{name}", width=top - 31))
    return findings


def check_flat_widths(bounds: Bounds, field_bits_table=None) -> list:
    """Validate the int32 flat-vector encoding: every field width <= 31
    (values stay non-negative in int32) except the declared raw-mask
    fields, and the claimed envelope fits every width."""
    from raft_tla_tpu_torch.ops import bitpack
    fb = field_bits_table or bitpack.field_bits(bounds)
    findings = []
    for field, bits in fb.items():
        if bits > (32 if field in bitpack.RAW_FIELDS else 31):
            findings.append(Finding(
                WIDTH, ERROR, "flat-width",
                f"field {field} is allotted {bits} bits; int32 elements "
                "hold at most 31 value bits (sign clear) unless declared "
                "raw", field=field, width=bits))
    env = iv.envelope(bounds)
    for field, interval in env.items():
        if field not in fb:
            findings.append(Finding(
                WIDTH, ERROR, "schema-drift",
                f"envelope field {field} missing from field_bits",
                field=field))
            continue
        if field in bitpack.RAW_FIELDS:
            continue
        if not interval.fits_bits(fb[field]):
            findings.append(Finding(
                WIDTH, ERROR, "envelope-width",
                f"claimed envelope of {field} does not fit its packed "
                "width", field=field, interval=interval.as_tuple(),
                width=fb[field]))
    missing = [f for f in fb if f not in env]
    for field in missing:
        findings.append(Finding(
            WIDTH, ERROR, "schema-drift",
            f"packed field {field} has no envelope entry", field=field))
    return findings


def _mode_fields(bounds: Bounds) -> tuple:
    return st.STATE_FIELDS + (st.HISTORY_FIELDS if bounds.history else ())


def _top_menv(bounds: Bounds) -> dict:
    """Top of the message-envelope lattice: every mtype present, every
    subfield spanning its full table width.  Used by the coverage
    cross-check so a kernel/twin write-set comparison is structural —
    independent of which messages a spec subset can actually reach."""
    from raft_tla_tpu_torch.ops.msgbits import HI_FIELDS, LO_FIELDS
    full = {name: iv.bitmask(w) for name, (_sh, w) in HI_FIELDS.items()}
    full.update({name: iv.bitmask(w) for name, (_sh, w) in LO_FIELDS.items()})
    full["a+c"] = iv.Interval(0, bounds.log_cap)
    return {mt: dict(full)
            for mt in (SP.M_RVREQ, SP.M_RVRESP, SP.M_AEREQ, SP.M_AERESP)}


def check_transfer_coverage(bounds: Bounds, spec: str,
                            transfers: dict) -> list:
    """Cross-check the transfer twins against the kernel-side declaration
    (``ops/kernels.transfer_metadata``): same families, same written-field
    sets.  A kernel writing a field its transfer does not model — or vice
    versa — is silent-drift territory and fails the lint loudly."""
    from raft_tla_tpu_torch.ops import kernels
    findings = []
    meta = kernels.transfer_metadata()
    fams = {a.family for a in SP.action_table(bounds, spec)}
    mode = set(_mode_fields(bounds))
    env = iv.expansion_envelope(bounds)
    menv = _top_menv(bounds)
    for fam in sorted(fams):
        if fam not in transfers:
            findings.append(Finding(
                WIDTH, ERROR, "transfer-missing",
                f"kernel family {fam} has no width-transfer twin",
                transition=fam))
            continue
        if fam not in meta:
            findings.append(Finding(
                WIDTH, ERROR, "transfer-drift",
                f"family {fam} missing from kernels.transfer_metadata",
                transition=fam))
            continue
        declared = set(meta[fam]["writes"]) & mode
        modeled = set(transfers[fam](bounds, env, menv).writes) & mode
        for f in sorted(declared - modeled):
            findings.append(Finding(
                WIDTH, ERROR, "transfer-drift",
                f"kernel {fam} declares a write of {f} the transfer twin "
                "does not model", transition=fam, field=f))
        for f in sorted(modeled - declared):
            findings.append(Finding(
                WIDTH, ERROR, "transfer-drift",
                f"transfer twin of {fam} models a write of {f} the kernel "
                "does not declare", transition=fam, field=f))
    return findings


def check_fused_coverage(bounds: Bounds, spec: str) -> list:
    """Cross-check K1's whole-step write surface
    (``ops/pallas_step.FUSED_WRITES`` — hand-maintained, like the
    per-family twins) against the union of the spec subset's per-family
    kernel declarations plus the expansion postlude.  ``csrc/step.cu``
    evaluates the same staged program as the plain step, so its write
    surface must be EXACTLY that union: a family growing a new write, a
    subset gaining a family, or the fused table going stale all surface
    here as loud drift.  The messages keep the reference's wording
    ("megakernel"), so the two packages' findings compare equal."""
    from raft_tla_tpu_torch.ops import kernels, pallas_step
    findings = []
    if spec not in pallas_step.FUSED_WRITES:
        findings.append(Finding(
            WIDTH, ERROR, "fused-missing",
            f"spec subset {spec!r} has no megakernel write-surface entry "
            "(ops/pallas_step.FUSED_WRITES)", transition=spec))
        return findings
    mode = set(_mode_fields(bounds))
    fams = {a.family for a in SP.action_table(bounds, spec)}
    union = set(kernels.POSTLUDE_WRITES)
    for fam in fams:
        union |= set(kernels.TRANSFER_WRITES.get(fam, ()))
    declared = set(pallas_step.FUSED_WRITES[spec]) & mode
    modeled = union & mode
    for f in sorted(declared - modeled):
        findings.append(Finding(
            WIDTH, ERROR, "fused-drift",
            f"megakernel write surface for {spec!r} declares {f}, which "
            "no per-family transfer twin proves", transition=spec,
            field=f))
    for f in sorted(modeled - declared):
        findings.append(Finding(
            WIDTH, ERROR, "fused-drift",
            f"family kernels of {spec!r} can write {f} but the megakernel "
            "write surface (ops/pallas_step.FUSED_WRITES) omits it",
            transition=spec, field=f))
    return findings


def check_widths(bounds: Bounds, spec: str = "full", *,
                 field_bits_table=None, hi_fields=None, lo_fields=None,
                 transfers=None, expansion_env=None,
                 coverage_check: bool = True) -> list:
    """Run the full width-safety proof for one Bounds instance/mode.

    Every input is injectable (the seeded-mutation harness depends on
    it); defaults are the shipped tables and transfers.  Returns the
    list of findings — empty means *proved*: no reachable transition can
    write a value the pack would truncate.
    """
    from raft_tla_tpu_torch.ops import bitpack, msgbits as mb
    fb = field_bits_table or bitpack.field_bits(bounds)
    hi_t = hi_fields or mb.HI_FIELDS
    lo_t = lo_fields or mb.LO_FIELDS
    transfers = transfers or TRANSFERS
    findings = check_tables(hi_t, lo_t)
    findings += check_flat_widths(bounds, field_bits_table=fb)

    env = iv.envelope(bounds)
    exp_env = expansion_env or iv.expansion_envelope(bounds)

    # Base case: Init inside the envelope.
    for field, interval in iv.init_env(bounds).items():
        if field in env and not interval.subset(env[field]):
            findings.append(Finding(
                WIDTH, ERROR, "init-escape",
                f"Init writes {field} outside the claimed envelope",
                transition="Init", field=field,
                interval=interval.as_tuple()))

    fams = {a.family for a in SP.action_table(bounds, spec)}
    active = {f: transfers[f] for f in fams if f in transfers}
    menv = message_envelope(bounds, exp_env, active)
    mode = set(_mode_fields(bounds))

    for fam in sorted(fams):
        if fam not in transfers:
            continue        # reported by the coverage cross-check
        res = transfers[fam](bounds, exp_env, menv)
        for field, interval in res.writes.items():
            if field not in mode:
                continue
            if field not in fb:
                findings.append(Finding(
                    WIDTH, ERROR, "schema-drift",
                    f"{fam} writes unknown field {field}",
                    transition=fam, field=field))
                continue
            if field not in bitpack.RAW_FIELDS and \
                    not interval.fits_bits(fb[field]):
                findings.append(Finding(
                    WIDTH, ERROR, "width-overflow",
                    f"{fam} can write {field} outside its packed width — "
                    "the pack would silently truncate and collide "
                    "fingerprints", transition=fam, field=field,
                    interval=interval.as_tuple(), width=fb[field]))
            if field in env and not interval.subset(env[field]):
                findings.append(Finding(
                    WIDTH, ERROR, "envelope-escape",
                    f"{fam} writes {field} outside the inductive "
                    "envelope: the width proof is not closed under this "
                    "transition", transition=fam, field=field,
                    interval=interval.as_tuple(), width=fb.get(field)))
        for rec in res.sends:
            findings += _check_record(bounds, fam, rec, hi_t, lo_t)

    # Faithful-mode postlude: the shared allLogs union (raw 32-bit or).
    if bounds.history and "allLogs" not in bitpack.RAW_FIELDS:
        findings.append(Finding(
            WIDTH, ERROR, "schema-drift",
            "allLogs must be declared raw (32-bit mask words)",
            field="allLogs"))

    if coverage_check:
        findings += check_transfer_coverage(bounds, spec, transfers)
        findings += check_fused_coverage(bounds, spec)
    return findings


def _check_record(bounds, fam, rec, hi_fields, lo_fields) -> list:
    """One creation site vs the shift/width tables (mode-aware: parity
    must strip mlog — a nonzero g would widen parity rows)."""
    findings = []
    mtype_name = SP.MTYPE_NAMES[rec.mtype]
    tables = dict(hi_fields)
    tables.update(lo_fields)
    for name, interval in rec.fields.items():
        if "+" in name:
            continue                       # derived relational fact
        if name not in tables:
            findings.append(Finding(
                WIDTH, ERROR, "msg-subfield-unknown",
                f"{fam} packs unknown subfield {name} into a "
                f"{mtype_name}", transition=fam,
                field=f"{mtype_name}.{name}"))
            continue
        _sh, w = tables[name]
        if name == "g" and not bounds.history:
            if interval.as_tuple() != (0, 0):
                findings.append(Finding(
                    WIDTH, ERROR, "parity-mlog-nonzero",
                    f"{fam} packs a nonzero mlog into a {mtype_name} in "
                    "parity mode (history must be stripped)",
                    transition=fam, field=f"{mtype_name}.g",
                    interval=interval.as_tuple(), width=w))
            continue
        if not interval.fits_bits(w):
            findings.append(Finding(
                WIDTH, ERROR, "msg-subfield-overflow",
                f"{fam} packs {mtype_name}.{name} outside its "
                f"{w}-bit slot — neighbouring subfields would be "
                "corrupted", transition=fam,
                field=f"{mtype_name}.{name}",
                interval=interval.as_tuple(), width=w))
    return findings
