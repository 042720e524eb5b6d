"""Exhaustive BFS over the interpreter — the port's copy of
``raft_tla_tpu/models/refbfs.py``, the pure-Python oracle behind
``--engine ref``.

This is what TLC does: breadth-first exploration from ``Init``, invariants
checked on every distinct state, CONSTRAINT gating expansion (violating
states are counted but their successors are not generated), and a
counterexample trace on invariant violation.  Every other engine must
reproduce its distinct-state count, diameter and verdicts exactly.  Its
result types are ``engine.py``'s (one definition each).
"""

from __future__ import annotations

import time
from collections import Counter

from raft_tla_tpu_torch.config import CheckConfig
from raft_tla_tpu_torch.engine import DEADLOCK, RefResult, Violation
from raft_tla_tpu_torch.models import interp, invariants, spec as S

__all__ = ["DEADLOCK", "RefResult", "Violation", "check"]


def check(config: CheckConfig,
          init_override: interp.PyState | None = None) -> RefResult:
    """Run the oracle checker; stops at the first invariant violation.

    ``init_override`` replaces ``Init`` (a testing hook: start exploration
    from a crafted state when the violation region is deep).
    """
    bounds = config.bounds
    table = S.action_table(bounds, config.spec)
    invs = [(nm, invariants.py_invariant(nm)) for nm in config.invariants]
    viewf = None
    if getattr(config, "view", None):
        from raft_tla_tpu_torch.models import views
        viewf = views.py_view(config.view)
    if config.symmetry:
        from raft_tla_tpu_torch.ops import symmetry as sym_mod
        keyf = lambda s: sym_mod.py_orbit_fingerprint(  # noqa: E731
            viewf(s, bounds) if viewf else s, bounds, config.symmetry)
    elif viewf:
        keyf = lambda s: viewf(s, bounds)                         # noqa: E731
    else:
        keyf = lambda s: s                                        # noqa: E731
    t0 = time.monotonic()

    init = init_override if init_override is not None \
        else interp.init_state(bounds)
    # key(state) -> (parent_state, action_idx) | None; with SYMMETRY the
    # key is the orbit fingerprint, so one orbit keeps one entry (TLC
    # semantics: the first-discovered member is the stored witness).
    seen = {keyf(init): None}
    levels = [1]
    coverage: Counter = Counter()
    n_transitions = 0
    violation = None

    def make_violation(nm, s):
        chain = []
        cur = s
        while cur is not None:
            entry = seen[keyf(cur)]
            chain.append((table[entry[1]].label() if entry else None, cur))
            cur = entry[0] if entry else None
        chain.reverse()
        return Violation(invariant=nm, state=s, trace=chain)

    for nm, fn in invs:
        if not fn(init, bounds):
            violation = make_violation(nm, init)

    frontier = [init] if violation is None else []
    while frontier:
        nxt = []
        for s in frontier:
            if not interp.constraint_ok(s, bounds):
                continue  # counted, invariant-checked, but not expanded
            n_succ = 0
            for aidx, t in interp.successors(s, bounds, table):
                n_succ += 1
                n_transitions += 1
                k = keyf(t)
                if k in seen:
                    continue
                seen[k] = (s, aidx)
                coverage[table[aidx].family] += 1
                for nm, fn in invs:
                    if not fn(t, bounds):
                        violation = make_violation(nm, t)
                        break
                if violation is not None:
                    break
                nxt.append(t)
            if violation is None and config.check_deadlock and n_succ == 0:
                # TLC's default deadlock check: an expanded state with no
                # successor at all (stuttering excluded).  CONSTRAINT gates
                # exploration, not enabledness, so this is pre-constraint.
                violation = make_violation(DEADLOCK, s)
            if violation is not None:
                break
        if violation is not None:
            break
        if nxt:
            levels.append(len(nxt))
        frontier = nxt

    return RefResult(
        n_states=len(seen),
        diameter=len(levels) - 1,
        n_transitions=n_transitions,
        coverage=coverage,
        violation=violation,
        levels=levels,
        wall_s=time.monotonic() - t0,
    )
