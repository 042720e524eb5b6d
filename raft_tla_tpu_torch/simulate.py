"""Simulation mode — TLC's ``-simulate`` on the card; the port of
``raft_tla_tpu/simulate.py``.

Where exhaustive BFS enumerates the bounded state space, simulation mode
samples random *behaviors*: walks from ``Init`` taking uniformly-random
enabled actions, invariants checked on every generated state, up to a depth
bound per behavior, restarting until a behavior quota is met or a violation
is found.  A batch of walkers advances in lockstep: one walker step is one
launch of the fused step (K1, ``csrc/step.cu``, on a CUDA device; the plain
torch step on the CPU) over the walkers' rows ``[walkers, W]``, followed by
torch ops that sample one enabled lane per walker, gather that lane's row,
invariant bits, constraint bit and overflow bit, and record the lane into a
per-walker history ring so a violating walk replays exactly.

Behavior-end rules (TLC semantics, as the reference's):

- **depth bound reached** — behavior complete, walker resets to Init;
- **no enabled action** — with ``check_deadlock`` the run aborts with the
  walk as counterexample (exit 11 at the CLI); otherwise the behavior
  completes and the walker resets;
- **StateConstraint violation** — the successor is still generated and
  invariant-checked (CONSTRAINT gates exploration, not generation), then
  the behavior ends and the walker resets;
- **invariant violation** — the run stops; the trace is rebuilt by
  replaying the recorded lanes through the host interpreter, so the
  reported behavior is exact.  A violation and a deadlock in the same
  dispatch report the violation.

Randomness is counter-based: walker ``g`` at global step ``t`` draws
``splitmix64(key_g + t * GOLDEN)`` masked to 32 bits, with ``key_g`` folded
from the seed and ``g`` (:func:`walker_keys`, :func:`draw`), and takes the
k-th enabled lane, ``k = (u32 * n_enabled) >> 32``.  So the same seed gives
the same walks on the CPU and on the card, K1 and the plain step give
bit-equal walks, and the fleet (``fleet/``) with unit weights walks the
same walks.  Walks differ from the JAX package's (which draws with
``jax.random``) by design.

K1 leaves the outputs of invalid lanes unwritten, so every gathered
``inv_ok``/``con_ok``/``overflow`` is masked by the walker's ``enabled``
bit, where the reference masks it.  The step in which the first violation
or deadlock occurs is the last one that moves: a device-side ``stopped``
flag turns the rest of the dispatch into no-ops, so the host reads the
carry once per dispatch (``fetch="fused"``: the scalars stacked into one
int64 tensor, one copy); ``fetch="legacy"`` keeps the reference's
per-field reads.  Counters are int64 (the reference's int32 ones wrap past
2^31 sampled transitions).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from raft_tla_tpu_torch.config import CheckConfig
from raft_tla_tpu_torch.engine import DEADLOCK, Violation
from raft_tla_tpu_torch.frontend.registry import resolve_model

_U64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
BIG = (1 << 62)       # "no step yet" / "no walker" sentinel of the carry


def _s64(x: int) -> int:
    """A uint64 value as the int64 of the same bits."""
    x &= _U64
    return x - (1 << 64) if x >> 63 else x


def mix64(x: int) -> int:
    """splitmix64's finaliser on a Python int (the reference for
    :func:`_mix`)."""
    x &= _U64
    x = ((x ^ (x >> 30)) * _MIX1) & _U64
    x = ((x ^ (x >> 27)) * _MIX2) & _U64
    return x ^ (x >> 31)


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 tensors holding uint64 bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """:func:`mix64` on int64 tensors (multiplies wrap mod 2^64)."""
    z = (z ^ _srl(z, 30)) * _s64(_MIX1)
    z = (z ^ _srl(z, 27)) * _s64(_MIX2)
    return z ^ _srl(z, 31)


def walker_keys(seed: int, walkers: int, device) -> torch.Tensor:
    """int64 ``[walkers]``: walker ``g``'s stream key, folded from the seed
    and ``g`` alone (never from a device layout)."""
    gid = torch.arange(walkers, dtype=torch.int64, device=device)
    return _mix(gid * _s64(_GOLDEN) + _s64(mix64(seed)))


def draw(keys: torch.Tensor, step: int) -> torch.Tensor:
    """int64 ``[walkers]`` in ``[0, 2^32)``: each walker's draw at global
    step ``step``."""
    return _mix(keys + _s64((step + 1) * _GOLDEN)) & 0xFFFFFFFF


def pick_lanes(valid: torch.Tensor, u: torch.Tensor) -> tuple:
    """``(lane, enabled)``: the k-th enabled lane of each row with ``k =
    (u * n_enabled) >> 32``, uniform over the enabled lanes (lane 0 where
    none is)."""
    n_en = valid.sum(-1)
    k = (u * n_en) >> 32
    lane = (valid.cumsum(-1) <= k.unsqueeze(-1)).sum(-1)
    enabled = n_en > 0
    return torch.where(enabled, lane, 0), enabled


def gather_lane(out: dict, lane: torch.Tensor, enabled: torch.Tensor):
    """The taken lane's ``(row, inv_ok, con_ok, overflow)`` from the fused
    step's outputs; the bits of a walker with no enabled lane are masked
    (``inv_ok``/``con_ok`` true, ``overflow`` false), since K1 leaves an
    invalid lane's outputs unwritten."""
    rows = torch.arange(lane.shape[0], device=lane.device)
    pick = out["svecs"][rows, lane]
    inv = torch.where(enabled.unsqueeze(-1), out["inv_ok"][rows, lane], True)
    con = torch.where(enabled, out["con_ok"][rows, lane], True)
    ovf = torch.where(enabled, out["overflow"][rows, lane], False)
    return pick, inv, con, ovf


def record_lane(hist: torch.Tensor, hlen: torch.Tensor, lane: torch.Tensor,
                moved: torch.Tensor) -> None:
    """Write ``lane`` at position ``hlen`` of the history ring of each
    walker that ``moved`` (in place)."""
    idx = hlen.clamp(max=hist.shape[1] - 1).unsqueeze(-1)
    old = hist.gather(1, idx)
    hist.scatter_(1, idx, torch.where(moved.unsqueeze(-1),
                                      lane.unsqueeze(-1).to(hist.dtype), old))


def first_false(ok: torch.Tensor) -> torch.Tensor:
    """Index of the first false entry along the last axis (0 if none)."""
    if ok.shape[-1] == 0:
        return torch.zeros(ok.shape[:-1], dtype=torch.int64, device=ok.device)
    return (~ok).to(torch.uint8).argmax(-1)  # 1-bit flags as uint8 for argmax


class Stepped(NamedTuple):
    """What one :func:`walker_step` did, for the engine's counters."""

    lane: torch.Tensor      # the lane each walker drew
    live: torch.Tensor      # the walkers that took it
    done: torch.Tensor      # the walkers whose behavior ended (reset)
    deepest: torch.Tensor   # the longest walk after the step (0-dim)
    overflow: torch.Tensor  # a taken lane overflowed the encoding (0-dim)


def walker_step(step_fn, w, keys: torch.Tensor, init: torch.Tensor,
                depth: int, pick, active: torch.Tensor, verdict) -> Stepped:
    """Advance the walkers of the carry ``w`` (its ``vecs``, ``hist``,
    ``hlen`` and ``step``, in place) by one step: one fused-step launch on
    the rows, the lane ``pick(valid, u) -> (lane, enabled)`` draws with
    this step's draws ``u``, and the behavior-end rule.  Only ``active``
    walkers move; ``verdict(live, stuck, inv_ok)``, called while
    ``w.step`` is still the step being taken, records the engine's
    violations and deadlocks and returns the walkers to freeze (their row
    and history stay as they are, for the replay)."""
    out = step_fn(w.vecs)
    lane, enabled = pick(out["valid"], draw(keys, w.step))
    live = enabled & active
    stuck = ~enabled & active
    row, inv, con, ovf = gather_lane(out, lane, live)
    frozen = verdict(live, stuck, inv)
    record_lane(w.hist, w.hlen, lane, live)
    hlen2 = w.hlen + live
    # behavior end: depth bound, constraint-violating successor, or
    # (without check_deadlock) a stuck walker.
    done = ~frozen & ((live & (~con | (hlen2 >= depth))) | stuck)
    w.vecs = torch.where(frozen.unsqueeze(-1), w.vecs, torch.where(
        done.unsqueeze(-1), init,
        torch.where(live.unsqueeze(-1), row, w.vecs)))
    w.hlen = torch.where(frozen, hlen2, torch.where(done, 0, hlen2))
    w.step += 1
    return Stepped(lane, live, done, hlen2.max(), ovf.any())


def check_walker_memory(walkers: int, A: int, W: int, n_inv: int,
                        depth: int, device) -> None:
    """Refuse a walker count whose step outputs (K1's ``[walkers, A, W]``
    successors and per-lane bits) and walker state will not fit the card's
    free memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    per = A * (4 * W + 11 + n_inv) + 16 * A + 4 * (3 * W + depth) + 64
    free, _total = torch.cuda.mem_get_info(device)
    fit = int(free * 0.9) // per
    if walkers > fit:
        raise ValueError(
            f"{walkers} walkers need {walkers * per / 2**30:.2f} GiB of "
            f"device memory (the fused step's outputs over A={A} lanes of "
            f"W={W} words, and the walker state), but the card has "
            f"{free / 2**30:.2f} GiB free: use at most {fit} walkers")


def check_shape(walkers: int, depth: int, steps: int) -> None:
    for name, v in (("walkers", walkers), ("depth", depth),
                    ("steps_per_dispatch", steps)):
        if v < 1:
            raise ValueError(f"{name} must be >= 1, got {v}")


def replay(model, table, bounds, init_py, lanes, hlen: int) -> list:
    """Rebuild a walk exactly through the model's host interpreter."""
    chain = [(None, init_py)]
    cur = init_py
    for k in range(hlen):
        a = table[int(lanes[k])]
        nxt = model.host_apply(cur, a, bounds)
        if nxt is None:
            raise RuntimeError(f"recorded lane {a.label()} is not enabled "
                               f"on replay at step {k + 1}")
        chain.append((a.label(), nxt))
        cur = nxt
    return chain


def init_violation(model, config: CheckConfig, init_py) -> Optional[Violation]:
    """The first invariant that Init itself violates, if any."""
    for nm in config.invariants:
        if not model.py_invariant(nm)(init_py, config.bounds):
            return Violation(nm, init_py, [(None, init_py)])
    return None


@dataclasses.dataclass
class SimResult:
    n_behaviors: int       # completed behaviors (depth/constraint-ended)
    n_states: int          # states generated (not deduplicated)
    max_depth_seen: int
    violation: Optional[Violation]
    wall_s: float

    @property
    def states_per_sec(self) -> float:
        return self.n_states / self.wall_s if self.wall_s > 0 else float("inf")


@dataclasses.dataclass
class Walk:
    """The walkers' carry on the device: rows, lane histories, walk
    lengths, and the 0-dim counters and verdict words."""

    vecs: torch.Tensor      # int32 [walkers, W]
    hist: torch.Tensor      # int32 [walkers, depth]: lanes taken
    hlen: torch.Tensor      # int64 [walkers]
    n_beh: torch.Tensor
    n_st: torch.Tensor
    maxd: torch.Tensor
    viol_w: torch.Tensor    # first violating walker, -1 if none
    viol_i: torch.Tensor    # its first violated invariant
    dead_w: torch.Tensor    # first deadlocked walker, -1 if none
    fail: torch.Tensor      # a taken lane overflowed the encoding
    stopped: torch.Tensor   # the rest of the dispatch is a no-op
    step: int = 0           # global steps issued


class Simulator:
    """Batched random-behavior generator for one :class:`CheckConfig`.

    ``device``: ``"cuda"`` (K1 per walker step) or ``"cpu"`` (the plain
    step).  ``fetch`` selects the host-side carry readback: ``"fused"``
    (default) one copy per dispatch; ``"legacy"`` one read per field.
    :attr:`fetches` counts the host reads, :attr:`dispatches` the
    dispatches.
    """

    def __init__(self, config: CheckConfig, walkers: int = 1024,
                 depth: int = 100, steps_per_dispatch: int = 64,
                 seed: int = 0, fetch: str = "fused", device="cuda"):
        if config.symmetry:
            raise ValueError("simulation mode ignores SYMMETRY; run without")
        if fetch not in ("fused", "legacy"):
            raise ValueError(f"fetch must be 'fused' or 'legacy': {fetch!r}")
        check_shape(walkers, depth, steps_per_dispatch)
        self.config = config
        self.bounds = config.bounds
        self.model = resolve_model(config.spec)
        self.width, _pack, _unpack = self.model.sim_codec(self.bounds)
        self.table = self.model.action_table(self.bounds)
        self.A = len(self.table)
        self.walkers = walkers
        self.depth = depth
        self.steps = steps_per_dispatch
        self.seed = seed
        self.fetch = fetch
        self.device = torch.device(device)
        self.step_fn = self.model.sim_step(config, self.device)
        check_walker_memory(walkers, self.A, self.width,
                            len(config.invariants), depth, self.device)
        self._keys = walker_keys(seed, walkers, self.device)
        self._ar = torch.arange(walkers, device=self.device)
        self.fetches = 0
        self.dispatches = 0

    def start(self, init_py=None) -> Walk:
        """Every walker at Init (``init_py``, default the model's)."""
        if init_py is None:
            init_py = self.model.init_py(self.bounds)
        self._init = torch.as_tensor(
            self.model.to_vec(init_py, self.bounds),
            dtype=torch.int32).to(self.device)
        i64 = dict(dtype=torch.int64, device=self.device)
        zero = lambda: torch.zeros((), **i64)          # noqa: E731
        return Walk(
            vecs=self._init.expand(self.walkers, self.width).clone(),
            hist=torch.zeros((self.walkers, self.depth), dtype=torch.int32,
                             device=self.device),
            hlen=torch.zeros((self.walkers,), **i64),
            n_beh=zero(), n_st=zero(), maxd=zero(),
            viol_w=zero() - 1, viol_i=zero(), dead_w=zero() - 1,
            fail=torch.zeros((), dtype=torch.bool, device=self.device),
            stopped=torch.zeros((), dtype=torch.bool, device=self.device))

    def one_step(self, w: Walk) -> None:
        """Advance every walker by one step (in place); a no-op once the
        carry is stopped."""
        ar = self._ar

        def verdict(live, stuck, inv):
            # the first deadlocked and the first violating walker freeze
            if self.config.check_deadlock:
                first_dead = torch.where(stuck, ar, BIG).min()
                new_dead = (first_dead < BIG) & (w.dead_w < 0)
                w.dead_w = torch.where(new_dead, first_dead, w.dead_w)
            first_bad = torch.where(live & ~inv.all(-1), ar, BIG).min()
            new_viol = (first_bad < BIG) & (w.viol_w < 0)
            w.viol_w = torch.where(new_viol, first_bad, w.viol_w)
            bidx = first_bad.clamp(max=self.walkers - 1)
            w.viol_i = torch.where(new_viol, first_false(inv[bidx]),
                                   w.viol_i)
            return (ar == w.viol_w) | (ar == w.dead_w)

        s = walker_step(self.step_fn, w, self._keys, self._init, self.depth,
                        pick_lanes, ~w.stopped, verdict)
        w.fail = w.fail | s.overflow
        w.maxd = torch.maximum(w.maxd, s.deepest)
        w.n_st = w.n_st + s.live.sum()
        w.n_beh = w.n_beh + s.done.sum()
        w.stopped = w.stopped | (w.viol_w >= 0) | (w.dead_w >= 0) | w.fail

    def dispatch(self, w: Walk) -> tuple:
        """``steps_per_dispatch`` steps, then the carry's scalars on the
        host: ``(fail, n_beh, n_st, maxd, viol_w, viol_i, dead_w)``."""
        for _ in range(self.steps):
            self.one_step(w)
        self.dispatches += 1
        fields = (w.fail, w.n_beh, w.n_st, w.maxd, w.viol_w, w.viol_i,
                  w.dead_w)
        if self.fetch == "legacy":
            self.fetches += len(fields)
            return tuple(int(x) for x in fields)
        self.fetches += 1
        return tuple(torch.stack([x.to(torch.int64) for x in fields])  # lint: jit-ok the one fused fetch a dispatch
                     .cpu().tolist())

    def run(self, n_behaviors: int, init_override=None,
            max_wall_s: float | None = None, on_progress=None,
            events: str | None = None) -> SimResult:
        t0 = time.monotonic()
        # The telemetry facade the exhaustive engines drive: one segment
        # record per dispatch, a run_start/run_end envelope; ``level``
        # carries the deepest walk seen.
        from raft_tla_tpu_torch.obs import RunTelemetry
        tel = RunTelemetry("simulate", config=self.config,
                           on_progress=on_progress, events=events, t0=t0)
        init_py = init_override if init_override is not None \
            else self.model.init_py(self.bounds)
        tel.run_start()
        viol = init_violation(self.model, self.config, init_py)
        if viol is not None:
            res = SimResult(0, 1, 0, viol, time.monotonic() - t0)
            self._end_telemetry(tel, res, complete=True)
            return res
        w = self.start(init_py)
        while True:
            failh, nb, nst, mx, vw, vi, dw = self.dispatch(w)
            if failh:
                tel.stop_requested("tensor-encoding overflow",
                                   source="simulate")
                tel.close()
                raise RuntimeError(
                    "simulation aborted: a sampled transition overflowed "
                    "the tensor encoding — bounds reasoning violated "
                    "(config.py capacity scheme)")
            if tel.active:
                tel.segment(nst, mx, nst)
            if vw >= 0 or dw >= 0:
                # both in one dispatch (different walkers): report the
                # invariant violation, whose walk is the one replayed
                k = vw if vw >= 0 else dw
                name = self.config.invariants[vi] if vw >= 0 else DEADLOCK
                lanes, hl = w.hist[k].cpu().tolist(), int(w.hlen[k])  # lint: jit-ok once, at the violation
                trace = replay(self.model, self.table, self.bounds,
                               init_py, lanes, hl)
                res = SimResult(
                    n_behaviors=nb, n_states=nst, max_depth_seen=mx,
                    violation=Violation(name, trace[-1][1], trace),
                    wall_s=time.monotonic() - t0)
                self._end_telemetry(tel, res, complete=True)
                return res
            if nb >= n_behaviors:
                complete = True
                break
            if max_wall_s is not None and \
                    time.monotonic() - t0 > max_wall_s:
                complete = False    # wall-bounded partial run
                break
        res = SimResult(n_behaviors=nb, n_states=nst, max_depth_seen=mx,
                        violation=None, wall_s=time.monotonic() - t0)
        self._end_telemetry(tel, res, complete=complete)
        return res

    def _end_telemetry(self, tel, res: SimResult, complete: bool) -> None:
        """Per-field run_end of a statistical run (obs schema v3 ``sim``)."""
        tel.run_end_sim(
            n_states=res.n_states, n_behaviors=res.n_behaviors,
            max_depth=res.max_depth_seen, wall_s=res.wall_s,
            complete=complete, violation=res.violation,
            sim={"sampled_transitions": res.n_states,
                 "max_depth": res.max_depth_seen,
                 "walkers": self.walkers,
                 "per_invariant": {nm: res.n_states
                                   for nm in self.config.invariants}})
        tel.close()


def simulate(config: CheckConfig, n_behaviors: int = 1000, **kw) -> SimResult:
    """One-shot convenience mirroring the engines' ``check``."""
    run_kw = {k: kw.pop(k) for k in ("init_override", "max_wall_s")
              if k in kw}
    return Simulator(config, **kw).run(n_behaviors, **run_kw)
