"""Interval abstract domain over the state schema — Pass 1's substrate; the
port's copy of ``raft_tla_tpu/analysis/intervals.py``.

A value interval ``[lo, hi]`` over-approximates the set of values an
``int32`` field element can hold; the transfer functions in
:mod:`.widthcheck` push these through the guard/update structure of
``ops/kernels``.  The domain is the classic one (Cousot & Cousot 1977)
restricted to what the kernels actually compute: add/sub with constants
and intervals, min/max, bitwise-or of non-negative sets, one-bit shifts,
and join (convex union).  Everything is exact integer arithmetic — no
widening is needed because every chain is bounded by a field capacity
and the message-envelope fixpoint (:func:`.widthcheck.message_envelope`)
is monotone over a finite lattice.

Two environments matter:

- :func:`envelope` — the *claimed inductive invariant*: the interval each
  struct field stays inside on every reachable state.  Pass 1 proves it
  closed under every transition (and that it fits the packed widths).
- :func:`expansion_envelope` — the envelope met with the StateConstraint
  (``ops/state.constraint_ok``): the input domain of a transition, because
  TLC semantics only ever *expand* constraint-satisfying states
  (config.py "capacity scheme" docstring).  This meet is exactly why the
  ``+1`` capacities suffice — drop it (see the seeded mutations) and
  Timeout/ClientRequest overflow their fields.
"""

from __future__ import annotations

import dataclasses

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.ops import state as st


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed integer interval [lo, hi]; lo <= hi always."""

    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other: "Interval | int") -> "Interval":
        o = _as_iv(other)
        return Interval(self.lo + o.lo, self.hi + o.hi)

    def __sub__(self, other: "Interval | int") -> "Interval":
        o = _as_iv(other)
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def min_(self, other: "Interval | int") -> "Interval":
        o = _as_iv(other)
        return Interval(min(self.lo, o.lo), min(self.hi, o.hi))

    def max_(self, other: "Interval | int") -> "Interval":
        o = _as_iv(other)
        return Interval(max(self.lo, o.lo), max(self.hi, o.hi))

    def join(self, other: "Interval | int") -> "Interval":
        """Convex union — the abstract `where(cond, a, b)`."""
        o = _as_iv(other)
        return Interval(min(self.lo, o.lo), max(self.hi, o.hi))

    def meet(self, other: "Interval | int") -> "Interval":
        """Intersection (guard refinement); raises on empty."""
        o = _as_iv(other)
        return Interval(max(self.lo, o.lo), min(self.hi, o.hi))

    def or_(self, other: "Interval | int") -> "Interval":
        """Bitwise-or bound for non-negative operands: x|y >= max(x, y)
        and x|y < 2^k whenever both x, y < 2^k."""
        o = _as_iv(other)
        if self.lo < 0 or o.lo < 0:
            raise ValueError("or_ requires non-negative intervals")
        hi = (1 << max(self.hi.bit_length(), o.hi.bit_length())) - 1
        return Interval(max(self.lo, o.lo), max(hi, 0))

    # -- queries -------------------------------------------------------------
    def fits_bits(self, bits: int) -> bool:
        """All values representable as `bits`-wide non-negative ints."""
        return self.lo >= 0 and self.hi <= (1 << bits) - 1

    def subset(self, other: "Interval") -> bool:
        return self.lo >= other.lo and self.hi <= other.hi

    def as_tuple(self) -> tuple:
        return (self.lo, self.hi)


def _as_iv(x) -> Interval:
    return x if isinstance(x, Interval) else Interval(int(x), int(x))


def const(v: int) -> Interval:
    return Interval(int(v), int(v))


BOOL = Interval(0, 1)


def bitmask(n_bits: int) -> Interval:
    """All n-bit masks (the vote-set encoding)."""
    return Interval(0, (1 << n_bits) - 1)


# -- state-schema environments ----------------------------------------------

def envelope(bounds: Bounds) -> dict:
    """The claimed per-field inductive interval, derived from Bounds.

    This is the width contract ``ops/bitpack.field_bits`` encodes,
    written as value sets: Pass 1 proves (a) Init is inside, (b) every
    transition maps the constraint-met envelope back into it, (c) it
    fits the packed widths.  ``allLogs`` is a raw 32-bit mask word
    (sign bit is data) and is tracked as [0, 2^32-1] with uint32
    semantics — see ``ops/bitpack.RAW_FIELDS``.
    """
    from raft_tla_tpu_torch.ops.msgbits import HI_FIELDS, LO_FIELDS
    n = bounds.n_servers
    hi_bits = max(sh + w for sh, w in HI_FIELDS.values())
    # Parity mode strips the mlog field 'g' (always 0), so the packed lo
    # word never reaches its faithful-mode range — mirror field_bits.
    lo_fields = LO_FIELDS if bounds.history else \
        {k: v for k, v in LO_FIELDS.items() if k != "g"}
    lo_bits = max(sh + w for sh, w in lo_fields.values())
    env = {
        "role": Interval(0, 2),
        "term": Interval(1, bounds.term_cap),
        "votedFor": Interval(0, n),                 # 0 = Nil, else id+1
        "commitIndex": Interval(0, bounds.log_cap),
        "logLen": Interval(0, bounds.log_cap),
        "logTerm": Interval(0, bounds.term_cap),    # 0 = padding
        "logVal": Interval(0, bounds.n_values),     # 0 = padding
        "vResp": bitmask(n),
        "vGrant": bitmask(n),
        "nextIndex": Interval(1, bounds.log_cap + 1),
        "matchIndex": Interval(0, bounds.log_cap),
        # The packed message words are checked per-subfield against the
        # shift/width tables; as whole words they span the packed range.
        "msgHi": bitmask(hi_bits),
        "msgLo": bitmask(lo_bits),
        "msgCount": Interval(0, bounds.dup_cap),
    }
    if bounds.history:
        from raft_tla_tpu_torch.ops.loguniv import LogUniverse
        uni = LogUniverse.of(bounds)
        env.update({
            "allLogs": bitmask(32),                   # raw mask words
            "vLog": Interval(0, uni.size),            # rank+1, 0 = absent
            "eTerm": Interval(0, bounds.term_cap),    # 0 = empty slot
            "eLeader": Interval(0, max(n - 1, 0)),
            "eLog": Interval(0, uni.size - 1),
            "eVotes": bitmask(n),
            "eVLog": Interval(0, uni.size),           # rank+1, 0 = absent
        })
    return env


def expansion_envelope(bounds: Bounds) -> dict:
    """envelope ∧ StateConstraint — a transition's input domain.

    Only constraint-satisfying states are ever expanded (TLC CONSTRAINT
    semantics, ``ops/state.constraint_ok``), which tightens exactly the
    three constrained axes; everything else keeps its inductive range.
    """
    env = dict(envelope(bounds))
    env["term"] = env["term"].meet(Interval(1, bounds.max_term))
    env["logLen"] = env["logLen"].meet(Interval(0, bounds.max_log))
    env["msgCount"] = env["msgCount"].meet(Interval(0, bounds.max_dup))
    return env


def init_env(bounds: Bounds) -> dict:
    """Point intervals of the unique Init state (ops/state.init_struct)."""
    struct = st.init_struct(bounds)
    return {f: Interval(int(a.min()), int(a.max())) if a.size else const(0)
            for f, a in struct.items()}
