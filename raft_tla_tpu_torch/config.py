"""Bounds and check configuration — the port's copy of ``raft_tla_tpu/config.py``.

The reference cfg binds ``Server``/``Value`` but declares no CONSTRAINT, and
the raw spec's state space is infinite; :class:`Bounds` is the state
constraint made first-class.  Capacities are one step past each bound
(``*_cap = bound + 1``): TLC generates, counts and invariant-checks a state
that violates the constraint but never expands it, and one action moves a
bound by at most one.  Exceeding a capacity is a loud failure, never a clamp.

Field names, defaults and class names are kept equal to the reference's, so
``utils/ckpt.config_digest`` gives the same digest for the same config and a
checkpoint moves between the two packages.

Scope: parity and faithful mode (``Bounds.history``: the proof-only history
variables carried as state, ops/loguniv.py), SYMMETRY on the Server and
Value axes, the registered VIEWs (models/views.py), registry invariants
and whole-line predicate expressions (frontend/predicate.py).  Everything
else raises :class:`NotImplementedError` naming the ROADMAP.md queue item
that will bring it; nothing runs something else.
"""

from __future__ import annotations

import dataclasses

# Bit widths of packed message fields (ops/msgbits.py).  Caps must fit.
_MAX_TERM_CAP = 63      # 6-bit term fields
_MAX_INDEX_CAP = 62     # 6-bit index fields; nextIndex can reach log_cap + 1
_MAX_SERVERS = 14       # 4-bit src/dst fields; votedFor uses n+1 symbols
_MAX_VALUES = 15        # 4-bit value field; values are 1..V (0 = none)
_MAX_DUP_CAP = 1 << 20  # multiplicities live in full int32 slots
# Faithful mode: log ranks+1 must fit the 14-bit mlog field and the allLogs
# bitmask must stay small (<= 32 int32 words).
_MAX_LOG_UNIVERSE = 1024


def not_ported(what: str, item: str) -> NotImplementedError:
    """The one error for a feature of the reference this port lacks."""
    return NotImplementedError(
        f"{what} is not ported to raft_tla_tpu_torch yet "
        f"(ROADMAP.md queue A: {item}); run it with raft_tla_tpu")


@dataclasses.dataclass(frozen=True)
class Bounds:
    """The model universe plus the state constraint (``max_*``)."""

    n_servers: int = 3
    n_values: int = 2
    max_term: int = 3      # constraint: \A i : currentTerm[i] <= max_term
    max_log: int = 2       # constraint: \A i : Len(log[i]) <= max_log
    max_msgs: int = 4      # constraint: Cardinality(DOMAIN messages) <= max_msgs
    max_dup: int = 1       # constraint: \A m : messages[m] <= max_dup
    # Faithful mode: carry the proof-only history variables (elections
    # raft.tla:39, allLogs :44, voterLog :77, the mlog message fields
    # :220-222/297-299) as fingerprinted state, as stock TLC does on the
    # unmodified spec.  Off (parity mode) they are stripped.
    history: bool = False
    # Capacity of the `elections` slot encoding; exceeding it is a loud
    # engine failure, never a clamp.
    max_elections: int = 6

    def __post_init__(self) -> None:
        if not (1 <= self.n_servers <= _MAX_SERVERS):
            raise ValueError(f"n_servers must be in [1,{_MAX_SERVERS}], got {self.n_servers}")
        if not (1 <= self.n_values <= _MAX_VALUES):
            raise ValueError(f"n_values must be in [1,{_MAX_VALUES}], got {self.n_values}")
        if self.max_term < 1 or self.term_cap > _MAX_TERM_CAP:
            raise ValueError(f"max_term out of range: {self.max_term}")
        if self.max_log < 0 or self.log_cap + 1 > _MAX_INDEX_CAP:
            raise ValueError(f"max_log out of range: {self.max_log}")
        if self.max_msgs < 1:
            raise ValueError(f"max_msgs must be >= 1, got {self.max_msgs}")
        if self.max_dup < 1 or self.dup_cap > _MAX_DUP_CAP:
            raise ValueError(f"max_dup out of range: {self.max_dup}")
        if self.history:
            if not (1 <= self.max_elections <= 64):
                raise ValueError(
                    f"max_elections must be in [1,64], got {self.max_elections}")
            from raft_tla_tpu_torch.ops.loguniv import LogUniverse
            uni = LogUniverse.of(self)
            if uni.size > _MAX_LOG_UNIVERSE:
                raise ValueError(
                    f"faithful mode needs a log universe <= "
                    f"{_MAX_LOG_UNIVERSE} (got {uni.size}: term_cap="
                    f"{self.term_cap} x {self.n_values} values, lengths 0.."
                    f"{self.log_cap}); shrink max_term/max_log/n_values")

    @property
    def term_cap(self) -> int:
        return self.max_term + 1

    @property
    def log_cap(self) -> int:
        return self.max_log + 1

    @property
    def msg_cap(self) -> int:
        """Number of message slots in the tensor encoding."""
        return self.max_msgs + 1

    @property
    def dup_cap(self) -> int:
        return self.max_dup + 1


@dataclasses.dataclass(frozen=True)
class CheckConfig:
    """A full checking run: universe + bounds + spec subset + invariants."""

    bounds: Bounds = dataclasses.field(default_factory=Bounds)
    spec: str = "full"                     # full | election | replication
    invariants: tuple = ("NoTwoLeaders",)  # registry names or
    #   whole-line predicate expressions (frontend/predicate.py)
    symmetry: tuple = ()                   # TLC SYMMETRY: axes of
    #   ("Server", "Value"); the dedup key is the orbit-minimal fingerprint
    chunk: int = 1024                      # frontier states expanded per step
    check_deadlock: bool = False           # TLC -deadlock analog
    view: str | None = None                # TLC VIEW analog: a registered
    #   exact view (models/views.py) folded into every dedup key

    def __post_init__(self) -> None:
        from raft_tla_tpu_torch.models.invariants import (
            HISTORY_REGISTRY, REGISTRY, _expression)
        from raft_tla_tpu_torch.models.spec import SPECS
        if not self.bounds.history:
            hist = [nm for nm in self.invariants if nm in HISTORY_REGISTRY]
            if hist:
                raise ValueError(
                    f"invariant(s) {hist} read the history variables; they "
                    "require faithful mode (Bounds.history / --faithful)")
        if self.spec not in SPECS:
            raise ValueError(f"unknown spec {self.spec!r} "
                             f"(known: {sorted(SPECS)})")
        bad = [ax for ax in self.symmetry if ax not in ("Server", "Value")]
        if bad:
            raise ValueError(
                f"SYMMETRY {bad} not supported: Server and/or Value "
                "permutation symmetry")
        if self.symmetry:
            from raft_tla_tpu_torch.ops import symmetry as sym
            if "Server" in self.symmetry:
                sym.permutations(self.bounds)        # raises past the limit
            if "Value" in self.symmetry:
                sym.value_permutations(self.bounds)
        if self.view is not None:
            from raft_tla_tpu_torch.models.views import REGISTRY as VIEWS
            if self.view not in VIEWS:
                raise ValueError(
                    f"unknown view {self.view!r} "
                    f"(known: {sorted(VIEWS)})")
        for nm in self.invariants:
            if nm not in REGISTRY:
                _expression(nm)             # ValueError if it does not parse
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
