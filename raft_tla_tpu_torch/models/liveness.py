"""Liveness checking under weak fairness — the port of
``raft_tla_tpu/models/liveness.py`` (``--property``, ``--wf``, cfg PROPERTY).

The reference ``Spec == Init /\\ [][Next]_vars`` has **no fairness
conjuncts** (``raft.tla:469``), so every liveness property is
vacuously refutable by stuttering.  This module makes the fairness
assumption explicit and checks eventuality properties the way TLC's
liveness checker does at its core: find a reachable *fair lasso* — a
prefix plus a cycle — that refutes the property, via SCC analysis of the
bounded behavior graph.

Semantics implemented (for a state predicate ``P``):

- ``<>P`` (EVENTUALLY): a counterexample is a fair infinite behavior never
  visiting ``P`` — a lasso entirely inside the ``~P`` region.
- ``[]<>P`` (INFINITELY-OFTEN): a counterexample's *cycle* avoids ``P``;
  the prefix may pass through ``P``.

Weak fairness, per action family (the ``\\E i : Timeout(i)``-level
disjuncts of ``Next``): ``WF(A)`` rules out behaviors where
``A`` is forever enabled but never taken.  A cycle (or a stuttering
self-loop) is **fair** iff for every assumed-fair family ``A``, the cycle
either takes an ``A``-step or contains a state where ``A`` is disabled.
Inside one SCC any finite set of such witness requirements can be realized
by a single closed walk (strong connectivity), so the SCC-level check is
exact.  The name ``Next`` means the whole relation: taking any step (or
total deadlock) satisfies it.

Bound-truncation subtlety (TLC ``CONSTRAINT`` semantics): exploration
stops at states violating the state constraint, but action *enabledness*
for fairness is judged on the spec, not the bound — an action whose only
successors fall outside the bound still counts as enabled, so a stutter at
such a state is unfair under ``WF`` of that action and is correctly
rejected as a counterexample.

The graph comes from one of three builders — :func:`explore_graph` (the
interpreter, host), :func:`engine_graph` (the device engine's BFS, K2 over
its store, then one K1 re-expansion pass) or :func:`ddd_graph` (the DDD
engine's host store, re-expanded by K1 under SYMMETRY and VIEW); the SCC
fair-lasso analysis itself is host-side and exact either way (the native
Tarjan of utils/native.scc_csr on the CSR exports).  Everything but the
two engine builders is the reference's code, verbatim.
"""

from __future__ import annotations

import dataclasses


from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.models import interp, spec as S

# -- property registry: name -> (temporal form, state predicate) -------------

EVENTUALLY = "<>"
INFINITELY_OFTEN = "[]<>"
LEADS_TO = "~>"


def _some_leader(s, bounds: Bounds) -> bool:
    return any(r == S.LEADER for r in s.role)


def _some_commit(s, bounds: Bounds) -> bool:
    return any(ci > 0 for ci in s.commitIndex)


def _some_candidate(s, bounds: Bounds) -> bool:
    return any(r == S.CANDIDATE for r in s.role)


# State-predicate registry for cfg/CLI temporal FORMULAS: name ->
# (PyState predicate, struct-of-arrays vector twin, TLA+ text for the
# --emit-tlc twin).  Registration carries TWO
# obligations, both machine-checked:
#   1. PERMUTATION-INVARIANT (reads role/commitIndex as sets) — what
#      makes the orbit-quotient check of ddd_graph sound;
#   2. VIEW-INVARIANT under every registered view (reads only
#      view-preserved fields) — what makes the view-quotient check
#      sound (tests/test_views.py::test_predicates_view_invariant
#      asserts pred(s) == pred(view(s)) over a reachable corpus for
#      every predicate x view pair; a predicate reading vote sets
#      would fail it loudly instead of silently mis-evaluating on
#      first-reached representatives).
# The vector twins evaluate over unpacked chunks with a leading batch
# dim (a million PyState materializations just to test
# ``any(role == Leader)`` is the host loop the graph exports exist to
# avoid).
PREDICATES = {
    "SomeLeader": (
        _some_leader,
        lambda st_, b: (st_["role"] == S.LEADER).any(-1),
        "\\E i \\in Server : state[i] = Leader"),
    "SomeCandidate": (
        _some_candidate,
        lambda st_, b: (st_["role"] == S.CANDIDATE).any(-1),
        "\\E i \\in Server : state[i] = Candidate"),
    "SomeCommit": (
        _some_commit,
        lambda st_, b: (st_["commitIndex"] > 0).any(-1),
        "\\E i \\in Server : commitIndex[i] > 0"),
}

PROPERTIES = {
    # Raft's headline liveness claims, both refutable even under full weak
    # fairness (dueling candidates / fault churn) — finding the refuting
    # lasso is the point.
    "EventuallyLeader": (EVENTUALLY, _some_leader),
    "EventuallyCommit": (EVENTUALLY, _some_commit),
    "InfinitelyOftenLeader": (INFINITELY_OFTEN, _some_leader),
}

# the named properties, expressed over the predicate registry (what
# parse_property resolves them to)
_NAMED = {
    "EventuallyLeader": (EVENTUALLY, ("SomeLeader",)),
    "EventuallyCommit": (EVENTUALLY, ("SomeCommit",)),
    "InfinitelyOftenLeader": (INFINITELY_OFTEN, ("SomeLeader",)),
}

# back-compat alias (older call sites key vectorized masks by property
# name; new code keys by predicate name through PREDICATES)
_STRUCT_PREDICATES = {
    nm: PREDICATES[preds[0]][1] for nm, (_f, preds) in _NAMED.items()
}


@dataclasses.dataclass(frozen=True)
class PropSpec:
    """A resolved temporal property: a registered name or a parsed
    formula of one of the three supported shapes."""

    text: str           # display form (the input string)
    form: str           # EVENTUALLY | INFINITELY_OFTEN | LEADS_TO
    pred_names: tuple   # 1 predicate (<>P, []<>P) or 2 (P ~> Q)

    def preds(self):
        return tuple(PREDICATES[nm][0] for nm in self.pred_names)


def parse_property(text: str) -> PropSpec:
    """Resolve a cfg/CLI PROPERTY entry: a registered property name
    (``EventuallyLeader``), or a temporal formula ``<>P`` / ``[]<>P`` /
    ``P ~> Q`` over registered predicate names (TLC's PROPERTY grammar
    restricted to the shapes the lasso checker decides)."""
    t = " ".join(text.split())
    if t in _NAMED:
        form, preds = _NAMED[t]
        return PropSpec(text=t, form=form, pred_names=preds)

    def _pred(nm):
        nm = nm.strip()
        if nm not in PREDICATES:
            raise ValueError(
                f"unknown predicate {nm!r} in PROPERTY {text!r}; "
                f"registry: {sorted(PREDICATES)}")
        return nm

    if "~>" in t:
        lhs, _, rhs = t.partition("~>")
        if not lhs.strip() or not rhs.strip():
            raise ValueError(f"malformed PROPERTY {text!r}: "
                             "expected 'P ~> Q'")
        return PropSpec(text=t, form=LEADS_TO,
                        pred_names=(_pred(lhs), _pred(rhs)))
    if t.startswith("[]<>"):
        return PropSpec(text=t, form=INFINITELY_OFTEN,
                        pred_names=(_pred(t[4:]),))
    if t.startswith("<>"):
        return PropSpec(text=t, form=EVENTUALLY,
                        pred_names=(_pred(t[2:]),))
    raise ValueError(
        f"unknown PROPERTY {text!r}: not a registered property "
        f"({sorted(_NAMED)}) nor a formula of shape '<>P', '[]<>P' or "
        f"'P ~> Q' over registered predicates ({sorted(PREDICATES)})")


@dataclasses.dataclass
class LassoViolation:
    prop: str
    # [(action_label | None, state)] — label None on the first element.
    prefix: list
    # The repeating part; cycle[0] follows prefix[-1], and the step after
    # cycle[-1] returns to cycle[0].
    cycle: list


@dataclasses.dataclass
class LivenessResult:
    prop: str
    holds: bool
    violation: LassoViolation | None
    n_states: int
    n_edges: int
    n_sccs_checked: int


def explore_graph(config: CheckConfig):
    """The bounded behavior graph: states, labeled edges, enabled families.

    Returns ``(states, edges, enabled, expanded)`` where ``states`` is a
    list of PyStates in discovery order, ``edges[u] = [(aidx, v), ...]``
    over in-bound states only, ``enabled[u]`` is the set of action families
    with any enabled instance at u (spec-level, including out-of-bound
    successors — see module docstring), and ``expanded[u]`` says whether u
    satisfied the constraint (was expanded).
    """
    bounds = config.bounds
    table = S.action_table(bounds, config.spec)
    init = interp.init_state(bounds)
    index = {init: 0}
    states = [init]
    edges: list = [[]]
    enabled: list = [set()]
    expanded = [True]
    frontier = [0]
    while frontier:
        nxt = []
        for u in frontier:
            s = states[u]
            if not interp.constraint_ok(s, bounds):
                expanded[u] = False
                continue
            for aidx, t in interp.successors(s, bounds, table):
                enabled[u].add(table[aidx].family)
                v = index.get(t)
                if v is None:
                    v = len(states)
                    index[t] = v
                    states.append(t)
                    edges.append([])
                    enabled.append(set())
                    expanded.append(True)
                    nxt.append(v)
                edges[u].append((aidx, v))
        frontier = nxt
    # Enabledness must be spec-level even for unexpanded states.
    for u, s in enumerate(states):
        if not expanded[u]:
            for aidx, _t in interp.successors(s, bounds, table):
                enabled[u].add(table[aidx].family)
    return states, edges, enabled, expanded


def _csr_export(n, sorted_keys, order, expanded_arr, fams, fam_idx,
                chunks, missing_msg):
    """Shared CSR edge/enabled assembly for the engine graph exports:
    ``chunks`` yields ``(u_offset, valid[nb, A] bool, keys[nb, A]
    u64)``; successor keys resolve by binary search over
    ``sorted_keys`` (no per-state Python objects)."""
    import numpy as np

    en_mat = np.zeros((n, len(fams)), bool)
    e_u, e_a, e_v = [], [], []
    for u_off, valid, keys in chunks:
        b_idx, a_idx = np.nonzero(valid)
        u_idx = (u_off + b_idx).astype(np.int64)
        en_mat[u_idx, fam_idx[a_idx]] = True
        m = expanded_arr[u_idx]
        ub, ab = u_idx[m], a_idx[m].astype(np.int32)
        sk = keys[b_idx[m], ab]
        pos = np.searchsorted(sorted_keys, sk)
        if not np.array_equal(sorted_keys[np.minimum(pos, n - 1)], sk):
            raise RuntimeError(missing_msg)
        e_u.append(ub)
        e_a.append(ab)
        e_v.append(order[pos].astype(np.int64))
    u_all = np.concatenate(e_u) if e_u else np.zeros(0, np.int64)
    a_all = np.concatenate(e_a) if e_a else np.zeros(0, np.int32)
    v_all = np.concatenate(e_v) if e_v else np.zeros(0, np.int64)
    # u_all is globally nondecreasing by construction (chunks ascend,
    # np.nonzero is row-major), so CSR needs no sort — just verify
    if u_all.size and (np.diff(u_all) < 0).any():
        raise AssertionError("graph export: edge sources out of order")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(u_all, minlength=n), out=indptr[1:])
    return _CSREdges(indptr, a_all, v_all), _EnabledSets(en_mat, fams)


def _reexpand(step, n: int, B: int, A: int, load, device):
    """The graph exports' re-expansion: ``step`` (K1 on the card, the plain
    step on the CPU) over rows ``[0, n)`` in chunks of ``B``; yields
    ``(u_offset, valid bool[nb, A], keys uint64[nb, A])`` in row order, as
    :func:`_csr_export` consumes them.  Only ``valid``, ``fp_hi`` and
    ``fp_lo`` are read; a lane that is not valid holds no key.

    ``load(c0, nb) -> (rows, dev)`` gives the chunk's rows: a tensor on
    ``device`` (``dev`` None), or host int32 rows to upload (``dev`` a
    function from the uploaded tensor to the step's int32[nb, W] input).
    On the card each chunk is launched, and its next chunk's rows read,
    uploaded from pinned memory on a copy stream and launched, before the
    host waits for it: the host's key resolution of chunk k overlaps the
    card's work on chunk k + 1."""
    import numpy as np
    import torch

    from raft_tla_tpu_torch.utils import keyset

    def keys_of(hi, lo):
        return keyset.pack_keys(np.asarray(hi).view(np.uint32),
                                np.asarray(lo).view(np.uint32))

    device = torch.device(device)
    if device.type != "cuda":
        for c0 in range(0, n, B):
            nb = min(B, n - c0)
            rows, dev = load(c0, nb)
            x = dev(torch.from_numpy(rows)) if dev is not None else rows
            out = step(x)
            yield (c0, out["valid"].numpy(),  # lint: jit-ok CPU path, no device
                   keys_of(out["fp_hi"].numpy(), out["fp_lo"].numpy()))  # lint: jit-ok CPU path, no device
        return

    copy = torch.cuda.Stream(device)
    comp = torch.cuda.current_stream(device)
    slots = [{} for _ in range(2)]

    def pinned(slot, name, shape, dtype):
        t = slot.get(name)
        if t is None or t.shape[0] < shape[0]:
            t = slot[name] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return t[:shape[0]]

    def issue(k):
        c0 = k * B
        nb = min(B, n - c0)
        slot = slots[k % 2]
        rows, dev = load(c0, nb)
        if dev is not None:
            host = pinned(slot, "in", rows.shape, torch.int32)
            host.numpy()[...] = rows  # lint: jit-ok pinned host buffer, a view
            with torch.cuda.stream(copy):
                x = host.to(device, non_blocking=True)
            comp.wait_stream(copy)
            x.record_stream(comp)
            rows = dev(x)
        out = step(rows)
        res = [pinned(slot, nm, (nb, A), out[nm].dtype)
               for nm in ("valid", "fp_hi", "fp_lo")]
        for dst, nm in zip(res, ("valid", "fp_hi", "fp_lo")):
            dst.copy_(out[nm], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(comp)
        return c0, res, ev

    nk = -(-n // B)
    pending = issue(0) if nk else None
    for k in range(nk):
        nxt = issue(k + 1) if k + 1 < nk else None
        c0, (va, fh, fl), ev = pending
        ev.synchronize()
        yield c0, va.numpy().copy(), keys_of(fh.numpy(), fl.numpy())  # lint: jit-ok pinned buffers, after ev.synchronize()
        pending = nxt


def engine_graph(config: CheckConfig, caps=None, device="cuda",
                 stats: dict | None = None):
    """:func:`explore_graph` at the card's speed: the same ``(states,
    edges, enabled, expanded)`` from a device-engine run.

    The device engine (device_engine.py) runs the BFS with its store kept
    (``retain_carry``); K2 (ops/pallas_fp.fingerprint_rows) keys every
    stored row in one call; then ONE re-expansion pass of K1
    (ops/pallas_step.build_step, no symmetry, no view) over the store emits
    every labeled edge, resolving successor keys by binary search over the
    sorted keys (CSR edges and a per-family enabled matrix — check()'s
    fast path).  The store is row for row the JAX engine's, so the CSR
    arrays are the reference's.  ``states`` is a lazy :class:`StatesView`
    over the store's rows copied to the host (the reference builds one
    Python state a row; the view builds one when a lasso is rendered and
    evaluates predicates vectorized).  ``stats``, if given, receives the
    walls of the search, the keys and the re-expansion.

    The raw (unquotiented) graph only: orbit-level liveness under SYMMETRY
    goes through :func:`ddd_graph`.
    """
    import dataclasses as _dc

    import numpy as np

    from raft_tla_tpu_torch.device_engine import DeviceEngine
    from raft_tla_tpu_torch.ops import pallas_fp, pallas_step
    from raft_tla_tpu_torch.ops import state as st
    from raft_tla_tpu_torch.utils import keyset

    if config.symmetry:
        raise ValueError(
            "engine_graph builds the raw behavior graph; SYMMETRY "
            "quotients are not sound for liveness here — run without")
    # Safety stops (invariants/deadlock) would truncate the graph; the
    # liveness pass wants the whole bounded space.
    cfg = _dc.replace(config, invariants=(), check_deadlock=False)
    clock = _Walls(stats, device)
    eng = DeviceEngine(cfg, caps, device=device)
    res = eng.check(retain_carry=True)
    clock.lap("search_s")
    carry = eng.retained_carry
    n = res.n_states
    bounds = cfg.bounds
    lay = st.Layout.of(bounds)
    table = eng.table
    A, B = eng.A, cfg.chunk

    store = carry["store"][:n].clone()
    expanded_arr = carry["conflag"][:n].cpu().numpy().astype(bool)
    # Everything needed is copied out: release the carry (store and dedup
    # table) before the re-expansion allocates its own working set.
    eng.retained_carry = eng.carry = carry = None
    del eng

    hi, lo = pallas_fp.fingerprint_rows(store)       # K2, all n rows
    rkeys = keyset.pack_keys(hi.cpu().numpy().view(np.uint32),
                             lo.cpu().numpy().view(np.uint32))
    order = np.argsort(rkeys)
    sorted_keys = rkeys[order]
    rows = store.cpu().numpy()
    clock.lap("keys_s")

    step = pallas_step.build_step(bounds, cfg.spec, (), device)
    fams = sorted({inst.family for inst in table})
    fam_idx = np.asarray([fams.index(inst.family) for inst in table],
                         np.int32)
    edges, enabled = _csr_export(
        n, sorted_keys, order, expanded_arr, fams, fam_idx,
        _reexpand(step, n, B, A,
                  lambda c0, nb: (store[c0:c0 + nb], None), device),
        "engine_graph: successor key missing from the store — BFS "
        "incomplete?")
    clock.lap("export_s")
    states = StatesView(_ArrayRows(rows), _UNPACKED, lay, bounds, n)
    return states, edges, enabled, expanded_arr


class _Walls:
    """Host walls of a graph export's stages into ``stats`` (the card
    synchronized at each lap); nothing without ``stats``."""

    def __init__(self, stats, device):
        import time

        import torch
        self._stats, self._dev = stats, torch.device(device)
        self._time, self._torch = time, torch
        self._t = time.monotonic()

    def lap(self, name: str) -> None:
        if self._stats is None:
            return
        if self._dev.type == "cuda":
            self._torch.cuda.synchronize(self._dev)
        now = self._time.monotonic()
        self._stats[name] = now - self._t
        self._t = now


class _ArrayRows:
    """Unpacked rows in host memory with the read interface of a store."""

    def __init__(self, rows):
        self._rows = rows

    def read(self, start: int, n: int):
        return self._rows[start:start + n]

    def close(self) -> None:
        self._rows = None


class _Unpacked:
    """The schema of rows that are already unpacked."""

    @staticmethod
    def unpack(rows, _xp):
        return rows


_UNPACKED = _Unpacked()


class StatesView:
    """Lazy state access over a retained DDD host store: ``states[u]``
    materializes one PyState on demand (trace rendering), ``mask(prop)``
    evaluates a registered predicate vectorized over packed-row chunks
    (the scale path — no per-state Python objects)."""

    def __init__(self, host, schema, lay, bounds, n: int,
                 batch: int = 1 << 14):
        import numpy as np

        self._host, self._schema, self._lay = host, schema, lay
        self._bounds, self._n, self._batch = bounds, n, batch
        self._np = np

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, u: int):
        from raft_tla_tpu_torch.ops import state as st

        np = self._np
        row = self._schema.unpack(self._host.read(int(u), 1), np)[0]
        return interp.from_struct(st.unpack(row, self._lay),
                                  self._bounds)

    def mask(self, prop: str):
        """Vectorized ``[n]`` bool array of a predicate (by PREDICATES
        name, or property name for back-compat); falls back to the
        scalar predicate when no vector twin is registered."""
        from raft_tla_tpu_torch.ops import state as st

        np = self._np
        fn = PREDICATES[prop][1] if prop in PREDICATES \
            else _STRUCT_PREDICATES.get(prop)
        if fn is None:
            _form, pred = PROPERTIES[prop]
            return np.asarray([pred(self[u], self._bounds)
                               for u in range(self._n)], bool)
        out = np.zeros((self._n,), bool)
        for c0 in range(0, self._n, self._batch):
            nb = min(self._batch, self._n - c0)
            vecs = self._schema.unpack(self._host.read(c0, nb), np)
            out[c0:c0 + nb] = fn(st.unpack(vecs, self._lay),
                                 self._bounds)
        return out

    def close(self) -> None:
        self._host.close()



def ddd_graph(config: CheckConfig, caps=None, device="cuda",
              stats: dict | None = None):
    """:func:`engine_graph` on the DDD architecture — graph exports past
    every device-table ceiling, SYMMETRY and VIEW included.

    Runs the DDD engine (exact dedup in host RAM) with its stores kept
    (``retain_store``), and re-expands the stored rows chunk by chunk with
    K1 under the run's SYMMETRY and VIEW (the engine's own step): the
    packed rows are uploaded, unpacked on the card (ops/bitpack) and
    expanded, and successor keys resolve through the key log.  Returns
    ``(states, edges, enabled, expanded)`` where ``states`` is a lazy
    :class:`StatesView` (``check`` uses its vectorized predicate mask);
    the caller closes it.  ``stats``, as for :func:`engine_graph`.

    **Symmetry soundness** (why this builder accepts what engine_graph
    rejects): under SYMMETRY the engine's graph IS the orbit quotient,
    and for this module's fairness semantics the quotient check is
    exact, by the standard argument —

    - every registered predicate is permutation-invariant (set-level
      reads of role/commitIndex), so the ~P region is a union of orbits;
    - WF is per action FAMILY, and families are permutation-closed, so
      family-enabledness is orbit-invariant;
    - a fair lasso in the full graph projects to a fair lasso in the
      quotient (steps project to steps, labels keep their family,
      disabledness is orbit-invariant); conversely a fair quotient cycle
      lifts: replay its actions from any concrete member — each leg
      lands in the next orbit, and after at most |G| traversals the
      concrete walk revisits a state, closing a concrete cycle that
      takes the same family steps (and visits permuted copies of the
      same disabled-witness orbits), hence is fair.

    The rendered counterexample is therefore a QUOTIENT lasso: each
    shown state is an orbit representative, and consecutive steps are
    real transitions modulo a server/value permutation — the same
    witness form TLC prints for symmetric liveness runs.

    **View soundness**: every registered view is a bisimulation
    (models/views.py), which is strictly stronger than what the symmetry
    argument needs — view-equivalent states enable the same families and
    their successors stay view-equivalent, so fair lassos project to the
    view quotient and lift back step for step, and every registered
    predicate reads only view-preserved fields (role/commitIndex).  The
    stored rows are full first-reached representatives (the view folds
    into the dedup key only), so predicate masks and rendered witnesses
    are evaluated on real states.
    """
    import dataclasses as _dc

    import numpy as np
    import torch

    from raft_tla_tpu_torch.ddd_engine import DDDEngine
    from raft_tla_tpu_torch.utils import keyset

    cfg = _dc.replace(config, invariants=(), check_deadlock=False)
    clock = _Walls(stats, device)
    eng = DDDEngine(cfg, caps, device=device)
    eng.check(retain_store=True)
    clock.lap("search_s")
    host, constore, keystore, n = eng.retained
    eng.retained = None
    bounds = cfg.bounds
    lay, schema = eng.lay, eng.schema
    table = eng.table
    A, B = eng.A, cfg.chunk

    # the key log's columns are (lo, hi) uint32, as the reference's
    kw = keystore.read(0, n).view(np.uint32)
    keys = keyset.pack_keys(kw[:, 1], kw[:, 0])
    order = np.argsort(keys)
    sorted_keys = keys[order]
    expanded = constore.read(0, n)[:, 0].astype(bool)
    constore.close()
    keystore.close()
    clock.lap("keys_s")

    fams = sorted({inst.family for inst in table})
    fam_idx = np.asarray([fams.index(inst.family) for inst in table],
                         np.int32)
    edges, enabled = _csr_export(
        n, sorted_keys, order, expanded, fams, fam_idx,
        _reexpand(eng.step, n, B, A,
                  lambda c0, nb: (host.read(c0, nb),
                                  lambda x: schema.unpack(x, torch)),
                  device),
        "ddd_graph: successor key missing from the key log — store "
        "corrupt")
    clock.lap("export_s")

    states = StatesView(host, schema, lay, bounds, n)
    return states, edges, enabled, expanded


class _CSREdges:
    """``edges[u] -> [(aidx, v), ...]`` materialized on demand from CSR
    arrays — 12 B/edge flat storage instead of per-node Python lists of
    tuple objects.  Supports exactly the access patterns
    :func:`check` uses (indexing, ``len``, iteration)."""

    def __init__(self, indptr, aidx, vidx):
        self._indptr, self._aidx, self._vidx = indptr, aidx, vidx

    @property
    def n_edges(self) -> int:
        return int(self._indptr[-1])

    def __len__(self):
        return len(self._indptr) - 1

    def __getitem__(self, u):
        if u < 0 or u >= len(self):
            raise IndexError(u)
        s, e = self._indptr[u], self._indptr[u + 1]
        return list(zip(self._aidx[s:e].tolist(),
                        self._vidx[s:e].tolist()))


class _EnabledSets:
    """``enabled[u] -> {family, ...}`` view over an ``[n, F]`` bool
    matrix (one byte per (state, family) instead of a Python set per
    state)."""

    def __init__(self, mat, fams):
        self._mat, self._fams = mat, fams

    def __len__(self):
        return self._mat.shape[0]

    def __getitem__(self, u):
        if u < 0 or u >= len(self):
            raise IndexError(u)
        row = self._mat[u]
        return {f for f, b in zip(self._fams, row) if b}


def _sccs(n: int, adj) -> list:
    """Iterative Tarjan; returns SCCs as lists of node ids."""
    UNVISITED = -1
    low = [UNVISITED] * n
    num = [UNVISITED] * n
    on_stack = [False] * n
    stack: list = []
    out = []
    counter = 0
    for root in range(n):
        if num[root] != UNVISITED:
            continue
        work = [(root, 0)]
        while work:
            u, pi = work[-1]
            if pi == 0:
                num[u] = low[u] = counter
                counter += 1
                stack.append(u)
                on_stack[u] = True
            recurse = False
            for i in range(pi, len(adj[u])):
                v = adj[u][i]
                if num[v] == UNVISITED:
                    work[-1] = (u, i + 1)
                    work.append((v, 0))
                    recurse = True
                    break
                if on_stack[v]:
                    low[u] = min(low[u], num[v])
            if recurse:
                continue
            if low[u] == num[u]:
                comp = []
                while True:
                    v = stack.pop()
                    on_stack[v] = False
                    comp.append(v)
                    if v == u:
                        break
                out.append(comp)
            work.pop()
            if work:
                p, _ = work[-1]
                low[p] = min(low[p], low[u])
    return out


def _path(adj_labeled, src: int, dsts: set):
    """BFS path src -> (first reachable of dsts); [(aidx, node), ...]."""
    hit = _path_multi(adj_labeled, [src], dsts)
    return hit[1] if hit is not None else None



def _path_multi(adj_labeled, srcs, dsts):
    """BFS from MANY sources: ``(origin_src, [(aidx, node), ...])`` to
    the first reachable member of ``dsts``, or None."""
    prev = {}
    frontier = []
    for s in srcs:
        if s in prev:
            continue
        prev[s] = None
        if s in dsts:
            return s, []
        frontier.append(s)
    while frontier:
        nxt = []
        for u in frontier:
            for aidx, v in adj_labeled[u]:
                if v in prev:
                    continue
                prev[v] = (u, aidx)
                if v in dsts:
                    path = []
                    cur = v
                    while prev[cur] is not None:
                        pu, pa = prev[cur]
                        path.append((pa, cur))
                        cur = pu
                    path.reverse()
                    return cur, path
                nxt.append(v)
        frontier = nxt
    return None


def _leadsto_prefix(full_adj, sub_adj, seeds, entry):
    """Two-leg prefix for a refuted ``P ~> Q``: Init -> (any states) ->
    a P-and-not-Q seed -> (~Q states only) -> the lasso entry.  The
    second leg runs first (multi-source, so it picks a seed that
    actually reaches the entry inside the restricted region)."""
    hit = _path_multi(sub_adj, seeds, {entry})
    if hit is None:
        raise RuntimeError(         # entry ∈ reach(seeds) by construction
            "leads-to prefix: lasso entry unreachable from seeds")
    origin, leg2 = hit
    leg1 = _path(full_adj, 0, {origin}) or []
    return leg1 + leg2


def _csr_reach(indptr, dst, src0, n):
    """Vectorized BFS reachability over a CSR digraph: bool[n] with
    reach[srcs]=True; ``src0`` is one root or an array of roots
    (multi-source, the ~> seed set); per-round cost proportional to the
    DELTA frontier's edges (ragged-arange gather), total O(E)."""
    import numpy as np

    reach = np.zeros(n, bool)
    srcs = np.atleast_1d(np.asarray(src0, np.int64))
    if srcs.size == 0:
        return reach
    reach[srcs] = True
    delta = srcs
    while delta.size:
        starts = indptr[delta]
        lens = indptr[delta + 1] - starts
        total = int(lens.sum())
        if not total:
            break
        base = np.repeat(starts, lens)
        offs = np.arange(total, dtype=np.int64) \
            - np.repeat(np.cumsum(lens) - lens, lens)
        targets = dst[base + offs]
        new = np.unique(targets[~reach[targets]])
        reach[new] = True
        delta = new
    return reach


class _LazyAdj:
    """``adj[u] -> [(aidx, v), ...]`` computed on demand from CSR arrays
    with an optional destination filter — the adjacency view
    :func:`_path` walks during counterexample rendering (only refuted
    verdicts pay for it)."""

    def __init__(self, indptr, aidx, dst, dst_ok=None):
        self._indptr, self._aidx, self._dst = indptr, aidx, dst
        self._dst_ok = dst_ok

    def __getitem__(self, u):
        s0, e0 = int(self._indptr[u]), int(self._indptr[u + 1])
        a = self._aidx[s0:e0]
        v = self._dst[s0:e0]
        if self._dst_ok is not None:
            m = self._dst_ok(v)
            a, v = a[m], v[m]
        return list(zip(a.tolist(), v.tolist()))


def _fair_witness(nodes, wf, table, enabled, sub_labeled_of):
    """If a fair cycle exists through ``nodes``, a witness per WF family
    (('edge', u, aidx, v) or ('disabled', u)); None otherwise.  The
    shared semantics of check()'s fair_here (one definition for the
    list and CSR paths)."""
    node_set = set(nodes)
    wit = {}
    for fam in wf:
        found = None
        for u in nodes:
            lst = sub_labeled_of(u)
            if fam == "Next":
                hit = next(((a, v) for a, v in lst if v in node_set),
                           None)
                if hit is not None:
                    found = ("edge", u, hit[0], hit[1])
                    break
                if not enabled[u]:
                    found = ("disabled", u)
                    break
            else:
                hit = next(((a, v) for a, v in lst
                            if v in node_set
                            and table[a].family == fam), None)
                if hit is not None:
                    found = ("edge", u, hit[0], hit[1])
                    break
                if fam not in enabled[u]:
                    found = ("disabled", u)
                    break
        if found is None:
            return None
        wit[fam] = found
    return wit


def _render_lasso(states, table, best, reach_adj, scc_adj,
                  prefix_steps=None):
    """Prefix + witness-visiting cycle for a refuted verdict (the
    rendering block shared by both check paths).  ``prefix_steps``
    overrides the default root->entry search (the ~> two-leg prefix)."""
    nodes, wit, entry = best
    if prefix_steps is None:
        prefix_steps = _path(reach_adj, 0, {entry}) or []
    prefix = [(None, states[0])] + [
        (table[a].label(), states[v]) for a, v in prefix_steps]
    cycle = []
    cur = entry
    for fam, w in wit.items():
        if w[0] == "edge":
            _kind, u, a, v = w
            for pa, pv in (_path(scc_adj, cur, {u}) or []):
                cycle.append((table[pa].label(), states[pv]))
            cycle.append((table[a].label(), states[v]))
            cur = v
        else:                               # ("disabled", u): visit u
            _kind, u = w
            for pa, pv in (_path(scc_adj, cur, {u}) or []):
                cycle.append((table[pa].label(), states[pv]))
            cur = u
    for pa, pv in (_path(scc_adj, cur, {entry}) or []):
        cycle.append((table[pa].label(), states[pv]))
    if not cycle:
        cycle = [("<stutter>", states[entry])]
    return cycle, prefix


def _check_csr(config, pspec, wf, states, edges, enabled, n,
               n_edges) -> LivenessResult:
    """The array fast path of :func:`check` for CSR graph exports
    (liveness at 1e7-1e8-state scale): C++
    Tarjan SCC over the target-restricted CSR (utils/native.scc_csr),
    vectorized reachability and stutter/singleton filtering; only
    nontrivial candidate SCCs (size >= 2 or self-loop, intersecting the
    reachable region) enter the per-node Python witness search, whose
    semantics are shared with the list path (_fair_witness)."""
    import numpy as np

    form = pspec.form
    prop = pspec.text
    bounds = config.bounds
    table = S.action_table(bounds, config.spec)
    indptr = edges._indptr
    aidx = edges._aidx
    vidx = edges._vidx.astype(np.int64, copy=False)

    def _mask(pred_name):
        if isinstance(states, StatesView):
            return np.asarray(states.mask(pred_name), bool)
        fn = PREDICATES[pred_name][0]
        return np.asarray([fn(s, bounds) for s in states], bool)

    p_mask = _mask(pspec.pred_names[0])
    tgt_mask = _mask(pspec.pred_names[1]) if form == LEADS_TO else p_mask
    allowed = ~tgt_mask

    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = allowed[src] & allowed[vidx]
    cnt = np.bincount(src[keep], minlength=n)
    indptr2 = np.zeros(n + 1, np.int64)
    np.cumsum(cnt, out=indptr2[1:])
    dst2 = vidx[keep]                      # src-major order preserved
    a2 = aidx[keep]
    src2 = src[keep]

    from raft_tla_tpu_torch.utils import native as native_mod
    comp, ncomp = native_mod.scc_csr(indptr2, dst2)

    def sub_labeled_of(u):
        s0, e0 = int(indptr2[u]), int(indptr2[u + 1])
        return list(zip(a2[s0:e0].tolist(), dst2[s0:e0].tolist()))

    seeds = None
    if form == EVENTUALLY:
        reach_ok = bool(allowed[0])
        reach = _csr_reach(indptr2, dst2, 0, n) if reach_ok \
            else np.zeros(n, bool)
        reach_adj = _LazyAdj(indptr2, a2, dst2)
    elif form == INFINITELY_OFTEN:
        reach = _csr_reach(indptr, vidx, 0, n)
        reach_adj = _LazyAdj(indptr, aidx, vidx)
    else:                                           # LEADS_TO
        full = _csr_reach(indptr, vidx, 0, n)
        seeds = np.nonzero(full & p_mask & allowed)[0]
        reach = _csr_reach(indptr2, dst2, seeds, n)
        reach_adj = _LazyAdj(indptr2, a2, dst2)

    cand_nodes = reach & allowed
    n_checked = 0
    best = None

    # (a) stuttering lassos, vectorized over the enabled matrix when the
    # export provides one (_EnabledSets); per-family disabledness
    if hasattr(enabled, "_mat"):
        mat = enabled._mat
        fams = enabled._fams
        stut = np.ones(n, bool)
        for fam in wf:
            if fam == "Next":
                stut &= ~mat.any(axis=1)
            elif fam in fams:
                stut &= ~mat[:, fams.index(fam)]
            # else: family absent from this spec subset -> disabled
            # everywhere -> no constraint (the list path's
            # `fam not in enabled[u]` reads the same way)
    else:
        stut = np.asarray(
            [all((not enabled[u]) if fam == "Next"
                 else (fam not in enabled[u]) for fam in wf)
             for u in range(n)], bool)
    hits = np.nonzero(cand_nodes & stut)[0]
    if hits.size:
        u = int(hits[0])
        n_checked += int((np.nonzero(cand_nodes)[0] <= u).sum())
        best = ([u], {fam: ("disabled", u) for fam in wf}, u)
    else:
        n_checked += int(cand_nodes.sum())

    # (b) real cycles: nontrivial SCCs of the restricted graph that
    # intersect the reachable region
    if best is None:
        sizes = np.bincount(comp, minlength=ncomp)
        has_self = np.zeros(sizes.shape[0], bool)
        self_e = src2 == dst2
        if self_e.any():
            has_self[np.unique(comp[src2[self_e]])] = True
        reach_comps = np.unique(comp[cand_nodes]) if cand_nodes.any() \
            else np.zeros(0, np.int64)
        cyc = (sizes >= 2) | has_self
        order_nodes = np.argsort(comp, kind="stable")
        bounds_ = np.zeros(sizes.shape[0] + 1, np.int64)
        np.cumsum(sizes, out=bounds_[1:])
        for c in reach_comps.tolist():
            if not cyc[c]:
                continue
            n_checked += 1
            nodes = order_nodes[bounds_[c]:bounds_[c + 1]].tolist()  # lint: jit-ok numpy array, no device
            wit = _fair_witness(nodes, wf, table, enabled,
                                sub_labeled_of)
            if wit is not None:
                entry = next(u for u in nodes if reach[u])
                best = (nodes, wit, entry)
                break

    if best is None:
        return LivenessResult(prop=prop, holds=True, violation=None,
                              n_states=n, n_edges=n_edges,
                              n_sccs_checked=n_checked)

    in_scc = np.zeros(n, bool)
    in_scc[best[0]] = True
    scc_adj = _LazyAdj(indptr2, a2, dst2, dst_ok=lambda v: in_scc[v])
    prefix_steps = None
    if form == LEADS_TO:
        prefix_steps = _leadsto_prefix(
            _LazyAdj(indptr, aidx, vidx), reach_adj, seeds.tolist(),
            best[2])
    cycle, prefix = _render_lasso(states, table, best, reach_adj,
                                  scc_adj, prefix_steps=prefix_steps)
    violation = LassoViolation(prop=prop, prefix=prefix, cycle=cycle)
    return LivenessResult(prop=prop, holds=False, violation=violation,
                          n_states=n, n_edges=n_edges,
                          n_sccs_checked=n_checked)


def check(config: CheckConfig, prop: str,
          wf: tuple = ("Next",), graph=None) -> LivenessResult:
    """Check ``prop`` under weak fairness of the given action families.

    ``wf`` entries are action family names (``spec.ALL_FAMILIES``) or
    ``"Next"`` for the whole relation; ``wf=()`` assumes no fairness, under
    which any eventuality is refuted by pure stuttering (the reference
    spec's actual situation, ``raft.tla:469``).  ``graph`` accepts a
    prebuilt :func:`explore_graph` result so several properties can share
    one (dominant-cost) exploration.
    """
    pspec = parse_property(prop)
    form = pspec.form
    bounds = config.bounds
    table = S.action_table(bounds, config.spec)
    for fam in wf:
        if fam != "Next" and fam not in S.ALL_FAMILIES:
            raise ValueError(f"unknown WF action family {fam!r}")

    states, edges, enabled, expanded = graph if graph is not None \
        else explore_graph(config)
    n = len(states)
    # O(1) for CSR exports, O(n) list walk otherwise — never O(edges)
    n_edges = edges.n_edges if hasattr(edges, "n_edges") \
        else sum(map(len, edges))
    if hasattr(edges, "_indptr"):
        # CSR graph export (ddd_graph): the array fast path — C++ SCC,
        # vectorized reach/stutter, Python only on nontrivial SCCs
        return _check_csr(config, pspec, wf, states, edges, enabled, n,
                          n_edges)

    def _mask(pred_name):
        if isinstance(states, StatesView):
            return states.mask(pred_name)
        fn = PREDICATES[pred_name][0]
        return [fn(s, bounds) for s in states]

    # The candidate cycle region: ~target states (target = P for <>P /
    # []<>P, Q for P ~> Q); cycle edges must stay inside it.
    p_mask = _mask(pspec.pred_names[0])
    tgt_mask = _mask(pspec.pred_names[1]) if form == LEADS_TO else p_mask
    allowed = [not p for p in tgt_mask]
    # one edges[u] materialization per node (CSR exports rebuild the
    # tuple list per access); sub derives from sub_labeled
    sub_labeled = [[(a, v) for a, v in edges[u] if allowed[v]]
                   if allowed[u] else [] for u in range(n)]
    sub = [[v for _a, v in lst] for lst in sub_labeled]

    def fair_here(nodes: list) -> dict | None:
        """If a fair cycle exists through these nodes, witness per WF
        family: ('edge', u, aidx, v) or ('disabled', u); None otherwise."""
        node_set = set(nodes)
        wit = {}
        for fam in wf:
            found = None
            for u in nodes:
                if fam == "Next":
                    if any(v in node_set for _a, v in sub_labeled[u]):
                        a, v = next((a, v) for a, v in sub_labeled[u]
                                    if v in node_set)
                        found = ("edge", u, a, v)
                        break
                    if not enabled[u]:
                        found = ("disabled", u)
                        break
                else:
                    hit = next((
                        (a, v) for a, v in sub_labeled[u]
                        if v in node_set and table[a].family == fam), None)
                    if hit is not None:
                        found = ("edge", u, hit[0], hit[1])
                        break
                    if fam not in enabled[u]:
                        found = ("disabled", u)
                        break
            if found is None:
                return None
            wit[fam] = found
        return wit

    def _bfs(adj, srcs):
        seen = set(srcs)
        frontier = list(srcs)
        while frontier:
            nxt = []
            for u in frontier:
                for _a, v in adj[u]:
                    if v not in seen:
                        seen.add(v)
                        nxt.append(v)
            frontier = nxt
        return seen

    # Reachability of the lasso's loop node: for <>P the whole prefix
    # must avoid P; for []<>P any path does; for P ~> Q the lasso must
    # be reachable from some (reachable) P-state through ~Q states only
    # — the suffix after that P occurrence never meets Q.
    seeds = None
    if form == EVENTUALLY:
        reach_adj = sub_labeled if allowed[0] else [[]] * n
        reach = _bfs(sub_labeled, [0] if allowed[0] else [])
    elif form == INFINITELY_OFTEN:
        reach_adj = edges
        reach = _bfs(edges, [0])
    else:                                           # LEADS_TO
        full = _bfs(edges, [0])
        seeds = sorted(u for u in full if p_mask[u] and allowed[u])
        reach = _bfs(sub_labeled, seeds)
        reach_adj = sub_labeled     # prefix rendered in two legs below

    def stutter_witness(u: int) -> dict | None:
        """Pure stutter at u: fair iff every wf family is disabled there."""
        wit = {}
        for fam in wf:
            dis = (not enabled[u]) if fam == "Next" \
                else (fam not in enabled[u])
            if not dis:
                return None
            wit[fam] = ("disabled", u)
        return wit

    n_checked = 0
    best = None
    # (a) stuttering lassos: any reachable ~P state where fairness cannot
    # force a step (with wf=() that is every such state — the reference
    # spec's fairness-free reality).
    for u in sorted(reach):
        if not allowed[u]:
            continue
        n_checked += 1
        wit = stutter_witness(u)
        if wit is not None:
            best = ([u], wit, u)
            break
    # (b) real cycles: fair SCCs of the ~P subgraph.
    if best is None:
        for comp in _sccs(n, sub):
            comp_r = [u for u in comp if u in reach]
            if not comp_r:
                continue
            has_cycle = len(comp) > 1 or any(
                v == comp[0] for v in sub[comp[0]])
            if not has_cycle:
                continue
            n_checked += 1
            wit = fair_here(comp)
            if wit is not None:
                best = (comp, wit, comp_r[0])
                break

    if best is None:
        return LivenessResult(prop=prop, holds=True, violation=None,
                              n_states=n, n_edges=n_edges,
                              n_sccs_checked=n_checked)

    nodes, wit, entry = best
    node_set = set(nodes)
    # Cycle: a closed walk from entry visiting EVERY fairness witness —
    # each edge-witness is traversed, and each disabled-witness node is
    # visited (a walk that skipped one could itself be unfair for that
    # family: forever enabled along the walk, never taken).  Routing stays
    # strictly inside the SCC (strong connectivity guarantees the legs).
    scc_adj = [[(a, v) for a, v in sub_labeled[u] if v in node_set]
               if u in node_set else [] for u in range(n)]
    prefix_steps = _leadsto_prefix(edges, sub_labeled, seeds, entry) \
        if form == LEADS_TO else None
    cycle, prefix = _render_lasso(states, table, best, reach_adj,
                                  scc_adj, prefix_steps=prefix_steps)
    violation = LassoViolation(prop=prop, prefix=prefix, cycle=cycle)
    return LivenessResult(prop=prop, holds=False, violation=violation,
                          n_states=n, n_edges=n_edges,
                          n_sccs_checked=n_checked)
