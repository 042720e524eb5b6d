"""The host engine (``--engine host``) and the result types of a check —
the port of ``raft_tla_tpu/engine.py``, with ``DEADLOCK``, ``Violation``
and ``RefResult`` of ``raft_tla_tpu/models/refbfs.py`` (one definition
each: the oracle, the host engine and the device engines share them).

The host engine is the correctness anchor the reference holds its device
engines to: level-synchronous breadth-first exploration from ``Init``,
deduplicating states by 64-bit fingerprint in a host-side set, checking
invariants on every distinct state, gating expansion on the
StateConstraint (violating states are counted and invariant-checked but
never expanded) and rebuilding a counterexample trace on violation.

The engine is model-generic, as the reference's is: it asks the registry
(frontend/registry.resolve_model) for the spec's adapter and takes its
layout, action table, step, roots and trace decoding from it.  Per chunk
of the frontier the adapter's step expands, keys and checks every
successor: for a Raft spec K1 on the card (ops/pallas_step.build_step) and
the plain torch step on the CPU; for ``twophase`` and the IR-compiled Raft
specs the torch ops compiled from the action IR, their rows keyed by K2 on
the card.  Only the small per-lane outputs (keys and masks) come back to
the host, and the rows of new states alone are gathered on the device and
copied after them.  Unlike the reference, a chunk is not padded to a fixed
shape: torch needs no static shapes.  :attr:`Engine.dedup_s` sums the wall
of the per-lane host dedup loop (the host's share of a run).

Discovery order is the oracle's (``models/refbfs.py``): frontier states
in insertion order x action lanes in ``models/spec.action_table`` order.
So state counts, per-level counts, coverage counters and the *first*
invariant violation all match it exactly.  A lane that is not ``valid``
is never read past its ``valid`` bit, as the device engines do.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

DEADLOCK = "Deadlock"      # Violation.invariant sentinel (TLC -deadlock)


@dataclasses.dataclass
class Violation:
    invariant: str          # registry name, expression text, or DEADLOCK
    state: object           # models/interp.PyState
    # Trace from Init: [(action_label | None, PyState)]; replayable by interp.
    trace: list


@dataclasses.dataclass
class EngineResult:
    n_states: int          # distinct states found (incl. constraint-violating)
    diameter: int          # BFS levels past Init that produced new states
    n_transitions: int     # enabled (state, action) pairs explored
    coverage: Counter      # action family -> distinct new states produced
    violation: Optional[Violation]
    levels: list           # new-state count per level (levels[0] = 1)
    wall_s: float
    complete: bool = True  # False: stopped before exhaustion (resumable)
    # the CLI's liveness verdicts (models/liveness.LivenessResult), one per
    # property checked after the search, in order
    liveness: list = dataclasses.field(default_factory=list)

    @property
    def states_per_sec(self) -> float:
        return self.n_states / self.wall_s if self.wall_s > 0 else float("inf")


@dataclasses.dataclass
class RefResult:
    n_states: int          # distinct states found (incl. constraint-violating)
    diameter: int          # number of BFS levels past Init with new states
    n_transitions: int     # enabled (state, action) pairs explored
    coverage: Counter      # action family -> distinct new states produced
    violation: Optional[Violation]
    levels: list           # new-state count per level (levels[0] = 1 = Init)
    wall_s: float
    # The oracle never stops early, so a returned result is always a
    # complete exploration.
    complete: bool = True
    liveness: list = dataclasses.field(default_factory=list)


class _VecStore:
    """Append-only host store of packed state vectors, random-access by
    index: every accepted state's row, addressed by its global discovery
    index, for the next level's chunks and for trace reconstruction."""

    def __init__(self, width: int):
        self._chunks: list[np.ndarray] = []
        self._offsets = [0]
        self._width = width

    def append(self, rows: np.ndarray) -> None:
        if rows.size:
            self._chunks.append(np.ascontiguousarray(rows, dtype=np.int32))
            self._offsets.append(self._offsets[-1] + rows.shape[0])

    def __len__(self) -> int:
        return self._offsets[-1]

    def get(self, idx: int) -> np.ndarray:
        c = bisect.bisect_right(self._offsets, idx) - 1
        return self._chunks[c][idx - self._offsets[c]]


class Engine:
    """The host engine for one :class:`CheckConfig`; reusable across runs.
    ``device``: where the step runs (``cuda``, the default, or ``cpu``);
    ``model``: the spec's adapter (default: the registry's)."""

    def __init__(self, config, device="cuda", model=None):
        from raft_tla_tpu_torch.frontend.registry import resolve_model
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no "
                               "GPU; pass device='cpu' to run on the CPU")
        self.config = config
        self.bounds = config.bounds
        self.model = model if model is not None \
            else resolve_model(config.spec)
        self.lay = self.model.layout(self.bounds)
        self.table = self.model.action_table(self.bounds)
        self.A = len(self.table)
        self.chunk = config.chunk
        self.step = self.model.build_step(config, self.device)
        self.dedup_s = 0.0

    # -- public API ------------------------------------------------------------

    def check(self, init_override=None) -> EngineResult:
        """Exhaustively explore; stop at the first invariant violation.
        ``init_override`` mirrors the oracle's hook (``refbfs.check``)."""
        t0 = time.monotonic()
        cfg, bounds, model = self.config, self.bounds, self.model
        B, A, W = self.chunk, self.A, self.lay.width
        inv_names = list(cfg.invariants)
        self.dedup_s = 0.0

        init_py = init_override if init_override is not None \
            else model.init_py(bounds)
        init_vec = model.to_vec(init_py, bounds)
        hi0, lo0 = model.init_fingerprint(cfg, init_py, init_vec)

        seen: set[int] = {hi0 << 32 | lo0}
        store = _VecStore(W)
        store.append(init_vec[None, :])
        parents: list = [None]          # global idx -> (parent, lane) | None
        coverage: Counter = Counter()
        levels = [1]
        n_transitions = 0
        violation: Optional[Violation] = None

        for nm in inv_names:
            if not model.py_invariant(nm)(init_py, bounds):
                violation = self._make_violation(nm, 0, store, parents)
                break

        # frontier: global indices of the states to expand this level
        frontier = [0] if violation is None and \
            model.constraint_ok(init_py, bounds) else []

        while frontier and violation is None:
            new_this_level = 0
            next_frontier: list[int] = []
            for c0 in range(0, len(frontier), B):
                gidx = frontier[c0:c0 + B]
                nb = len(gidx)
                vecs = torch.as_tensor(np.stack([store.get(g) for g in gidx]),
                                       device=self.device)
                out = self.step(vecs)
                valid = out["valid"].cpu().numpy()  # [nb, A]; lint: jit-ok host dedup, ROADMAP queue B (d) 4
                ovf = (out["overflow"] & out["valid"]).cpu().numpy()  # lint: jit-ok host dedup, ROADMAP queue B (d) 4
                keys = (out["fp_hi"].to(torch.int64) << 32  # lint: jit-ok host dedup, ROADMAP queue B (d) 4
                        | (out["fp_lo"].to(torch.int64) & 0xFFFFFFFF)
                        ).cpu().numpy().view(np.uint64)
                inv_ok = out["inv_ok"].cpu().numpy()  # [nb, A, nI]; lint: jit-ok host dedup, ROADMAP queue B (d) 4
                con_ok = out["con_ok"].cpu().numpy()  # lint: jit-ok host dedup, ROADMAP queue B (d) 4

                if ovf.any():
                    b, a = np.argwhere(ovf)[0]
                    raise RuntimeError(
                        "state-capacity overflow at "
                        f"{self.table[int(a)].label()} — bounds reasoning "
                        "violated (config.py capacity scheme)")
                # TLC's default deadlock check: an expanded state with no
                # successor (stuttering excluded).  Successors of earlier
                # rows in the chunk are recorded first — refbfs order.
                dead_limit = None
                if cfg.check_deadlock:
                    dead = ~valid.any(axis=1)
                    if dead.any():
                        dead_limit = int(np.argmax(dead)) * A

                # Dedup in discovery order: flat index = b * A + a.
                flat_keys = keys.reshape(-1)
                flat_valid = valid.reshape(-1)
                if dead_limit is not None:
                    flat_valid = flat_valid.copy()
                    flat_valid[dead_limit:] = False
                # Transitions are counted after the dead-state truncation,
                # as the oracle stops counting at the first dead state.
                n_transitions += int(flat_valid.sum())
                new_flat: list[int] = []
                h0 = time.perf_counter()
                for fi in np.nonzero(flat_valid)[0].tolist():  # lint: jit-ok host dedup, ROADMAP queue B (d) 4
                    kk = int(flat_keys[fi])
                    if kk in seen:
                        continue
                    seen.add(kk)
                    new_flat.append(fi)
                self.dedup_s += time.perf_counter() - h0
                # Truncate at the first violating new state, as the oracle
                # stops recording the instant it sees a violation.
                for t, fi in enumerate(new_flat):
                    b, a = divmod(fi, A)
                    if not inv_ok[b, a].all():
                        new_flat = new_flat[:t + 1]
                        break
                if not new_flat:
                    if dead_limit is not None:
                        violation = self._make_violation(
                            DEADLOCK, gidx[dead_limit // A], store, parents)
                        break
                    continue

                sel = torch.as_tensor(new_flat, device=self.device)
                rows = out["svecs"].reshape(nb * A, W)[sel].cpu().numpy()  # lint: jit-ok host dedup, ROADMAP queue B (d) 4
                base = len(store)
                store.append(rows)
                for t, fi in enumerate(new_flat):
                    b, a = divmod(fi, A)
                    g = base + t
                    parents.append((gidx[b], a))
                    coverage[self.table[a].family] += 1
                    new_this_level += 1
                    bad = np.nonzero(~inv_ok[b, a])[0]
                    if bad.size:
                        violation = self._make_violation(
                            inv_names[int(bad[0])], g, store, parents)
                        break
                    if con_ok[b, a]:
                        next_frontier.append(g)
                if violation is None and dead_limit is not None:
                    violation = self._make_violation(
                        DEADLOCK, gidx[dead_limit // A], store, parents)
                if violation is not None:
                    break
            if violation is not None:
                break
            if new_this_level:
                levels.append(new_this_level)
            frontier = next_frontier

        return EngineResult(
            n_states=len(store),
            diameter=len(levels) - 1,
            n_transitions=n_transitions,
            coverage=coverage,
            violation=violation,
            levels=levels,
            wall_s=time.monotonic() - t0,
        )

    # -- internals -------------------------------------------------------------

    def _make_violation(self, inv_name: str, gidx: int, store: _VecStore,
                        parents: list) -> Violation:
        """Walk the parent chain back to Init (TLC's counterexample trace)."""
        chain = []
        cur: Optional[int] = gidx
        while cur is not None:
            py = self.model.from_vec(store.get(cur), self.bounds)
            entry = parents[cur]
            label = self.table[entry[1]].label() if entry else None
            chain.append((label, py))
            cur = entry[0] if entry else None
        chain.reverse()
        return Violation(invariant=inv_name, state=chain[-1][1], trace=chain)
