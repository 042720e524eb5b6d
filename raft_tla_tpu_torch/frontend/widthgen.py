"""Generated width-pass transfer twins — the port of
``raft_tla_tpu/frontend/widthgen.py``.

``analysis/widthcheck.TRANSFERS`` is a hand-written abstract twin per
kernel family: the interval effect of one transition on every written
field, plus the message records it creates.  :func:`transfer_of` derives
that twin from the same :class:`~raft_tla_tpu_torch.frontend.expr.ActionDef`
the plain step's IR kernels compile from, by evaluating the def over the
interval domain:

- update values evaluate via each node's ``iv`` rule (``Where`` -> join,
  comparisons -> BOOL, ``bor`` -> ``Interval.or_``, reads -> envelope);
  conditional writes contribute the *written* value only, the hand twins'
  "interval of newly written values" convention;
- a branch is skipped when it is infeasible under the current message
  envelope (its ``mtype`` has no creation site, a scoped subfield is
  absent) or its declared guard ``refines`` meet is empty;
- record creation sites become ``MsgRecord``s over the full subfield
  tables (missing subfields pack as 0), with declared relational
  ``facts`` and ``overrides`` passed through;
- bag effects reuse ``widthcheck._send_writes`` (packed-word arithmetic
  has one definition), and any remove op contributes the emptied-slot
  joins.

tests/test_torch_frontend.py holds ``transfer_of(adef)`` equal to the
port's hand ``TRANSFERS[fam]`` output for output.
"""

from __future__ import annotations

from raft_tla_tpu_torch.analysis import intervals as iv
from raft_tla_tpu_torch.frontend import expr as E


def _record(msg, ictx):
    """A PackMsg site as a widthcheck MsgRecord under ``ictx``."""
    from raft_tla_tpu_torch.analysis.widthcheck import MsgRecord
    from raft_tla_tpu_torch.ops import msgbits as mb
    declared = dict(msg.fields)
    overrides = dict(msg.overrides)
    fields = {}
    for name in (*mb.HI_FIELDS, *mb.LO_FIELDS):
        if name == "mtype":
            fields[name] = iv.const(msg.mtype)
        elif name in overrides:
            # the subfield echoes a relational fact of the consumed
            # record (the done-reply's b = a+c of the request)
            rec = ictx.menv.get(ictx.mtype)
            if rec is None or overrides[name] not in rec:
                raise E.Infeasible(overrides[name])
            fields[name] = rec[overrides[name]]
        else:
            e = declared.get(name)
            fields[name] = iv.const(0) if e is None else e.iv(ictx)
    for fname, fn in msg.facts:
        fields[fname] = fn(ictx.bounds, ictx.env, ictx.menv)
    return MsgRecord(msg.mtype, fields)


def transfer_of(adef):
    """ActionDef -> ``transfer(bounds, env, menv) -> TransferResult``,
    the callable shape ``widthcheck.TRANSFERS`` holds (and
    ``check_widths(transfers=...)`` injects)."""

    def transfer(bounds, env, menv):
        from raft_tla_tpu_torch.analysis.widthcheck import (TransferResult,
                                                            _send_writes)
        param_iv = {name: fn(bounds) for name, fn in adef.param_iv}
        writes: dict = {}

        def join_write(field, interval):
            cur = writes.get(field)
            writes[field] = interval if cur is None else cur.join(interval)

        sends = []
        # Structural, not envelope-gated: an action that CAN remove a
        # message always accounts for the emptied slot.
        has_remove = any(isinstance(op, (E.BagRemove, E.Reply))
                         for br in adef.branches for op in br.ops)
        for br in adef.branches:
            try:
                benv = env
                if br.refines:
                    benv = dict(env)
                    for field, lo, hi in br.refines:
                        # empty meet (ValueError) = branch infeasible at
                        # these bounds, e.g. truncation with log_cap 0
                        benv[field] = benv[field].meet(iv.Interval(lo, hi))
                ictx = E.IvCtx(bounds, benv, menv, param_iv, br.mtype)
                if br.mtype is not None and br.mtype not in menv:
                    raise E.Infeasible(f"mtype {br.mtype} has no record")
                branch_writes = [(u.field, u.val.iv(ictx))
                                 for u in br.updates]
                branch_sends = [_record(op.msg, ictx) for op in br.ops
                                if isinstance(op, (E.BagAdd, E.Reply))]
            except (E.Infeasible, ValueError):
                continue
            for field, interval in branch_writes:
                join_write(field, interval)
            sends.extend(branch_sends)
        if sends:
            for field, interval in _send_writes(env, tuple(sends)).items():
                join_write(field, interval)
        if has_remove:
            join_write("msgHi", iv.const(0))
            join_write("msgLo", iv.const(0))
            join_write("msgCount", iv.Interval(0, env["msgCount"].hi))
        return TransferResult(writes, tuple(sends))

    return transfer
