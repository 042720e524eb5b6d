"""The walker fleet on one card — the port of
``raft_tla_tpu/fleet/engine.py`` (its mesh cut to one device; a fleet over
more devices is ROADMAP.md queue A item 11 (c)).

The fleet advances every walker by ``steps_per_dispatch`` lockstep steps a
dispatch, each step one launch of the fused step (K1 on the card), and
reads a few scalars and the per-lane visit counts back in one copy a
dispatch.  Its contracts are the reference's:

- every walker owns a counter-based stream folded from the seed and its
  walker id alone (``simulate.walker_keys``/``draw``), never from a device
  layout;
- there is no fleet-wide stop: a violating or deadlocked walker freezes
  individually (its history stays replayable) while the rest keep walking,
  so every counter is a sum of per-walker terms;
- the reported violation is the least ``(step, walker)`` over the frozen
  walkers.

Sampling: each enabled lane weighs its action family's scenario weight
(``fault_weights``, default 1.0), times the steering factor ``(1 +
visits/mean)^-tau`` from the visit counts at the start of the dispatch (the
reference's ``logits -= tau * log1p(visits/mean)``).  A walker whose
enabled lanes all weigh 0 draws uniformly over them instead (weights are
sampling policy, never enabledness: no false deadlock).  The draw is an
inverse CDF in float64 over the same 32-bit uniform as the solo simulator,
so with unit weights and ``tau = 0`` the fleet walks the
:class:`~raft_tla_tpu_torch.simulate.Simulator`'s walks.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from raft_tla_tpu_torch.config import CheckConfig, not_ported
from raft_tla_tpu_torch.engine import DEADLOCK, Violation
from raft_tla_tpu_torch.frontend.registry import resolve_model
from raft_tla_tpu_torch.simulate import (
    BIG, check_shape, check_walker_memory, first_false, init_violation,
    replay, walker_keys, walker_step)


@dataclasses.dataclass
class FleetResult:
    """What a fleet run established — statistical, so the confidence
    block (states checked per invariant, coverage entropy) travels with
    the counts instead of masquerading as an exhaustive proof."""

    n_behaviors: int         # completed behaviors across the fleet
    n_states: int            # sampled transitions (states generated)
    max_depth_seen: int
    violation: Optional[Violation]
    wall_s: float
    n_devices: int
    walkers: int
    steer_tau: float
    coverage: dict           # action family -> sampled-transition count
    coverage_entropy: float  # normalized entropy of the action histogram
    device_states: list      # per-device sampled transitions (cumulative)
    walks: Optional[tuple] = None   # (hist, hlen) np arrays on request

    @property
    def states_per_sec(self) -> float:
        return self.n_states / self.wall_s if self.wall_s > 0 else float("inf")

    def confidence(self, invariants=()) -> dict:
        """The run_end ``sim`` payload (obs schema v3)."""
        return {
            "sampled_transitions": self.n_states,
            "max_depth": self.max_depth_seen,
            "walkers": self.walkers,
            "n_devices": self.n_devices,
            "coverage_entropy": round(self.coverage_entropy, 4),
            "steer_tau": self.steer_tau,
            "per_invariant": {nm: self.n_states for nm in invariants},
        }


@dataclasses.dataclass
class FleetWalk:
    """The fleet's carry on the device: rows, lane histories, walk
    lengths, and each walker's verdict (``BIG`` where it has none)."""

    vecs: torch.Tensor       # int32 [walkers, W]
    hist: torch.Tensor       # int32 [walkers, depth]: lanes taken
    hlen: torch.Tensor       # int64 [walkers]
    viol_step: torch.Tensor  # int64 [walkers]: step of its violation
    viol_inv: torch.Tensor   # int64 [walkers]: its first violated invariant
    dead_step: torch.Tensor  # int64 [walkers]: step of its deadlock
    step: int = 0            # global steps issued


def _coverage_entropy(counts: np.ndarray) -> float:
    """Normalized Shannon entropy of the per-action visit histogram:
    1.0 = uniform over all A lanes, 0.0 = a single lane (or no data)."""
    total = float(counts.sum())
    if total <= 0 or len(counts) < 2:
        return 0.0
    p = counts[counts > 0] / total
    return float(-(p * np.log(p)).sum() / math.log(len(counts)))


def pick_weighted(valid: torch.Tensor, u: torch.Tensor,
                  weights: torch.Tensor) -> tuple:
    """``(lane, enabled)``: an inverse-CDF draw over the enabled lanes
    weighted by ``weights`` (float64 ``[A]``) with ``u / 2^32`` as the
    uniform; uniform over the enabled lanes of a row where they all weigh
    0.  With unit weights it is :func:`simulate.pick_lanes` exactly."""
    cs = torch.where(valid, weights, 0.0).cumsum(-1)
    use = cs[:, -1:] > 0
    cs = torch.where(use, cs, valid.cumsum(-1).to(cs.dtype))
    target = u.to(cs.dtype) * cs[:, -1] / 2.0 ** 32
    lane = (cs <= target.unsqueeze(-1)).sum(-1)
    enabled = valid.any(-1)
    return torch.where(enabled, lane.clamp(max=valid.shape[1] - 1), 0), \
        enabled


def mesh_devices(mesh: int | None) -> int:
    """The device count of ``mesh`` (None or a count: one card); more
    than one is not ported."""
    n = 1 if mesh is None else mesh
    if n != 1:
        raise not_ported(f"a walker fleet over {n} devices",
                         "item 11 (c), the paged shard engine and the fleet")
    return n


class FleetSimulator:
    """Batched random-behavior generator on one card.

    ``walkers`` is the fleet size; results are a pure function of (seed,
    walkers, depth, steps_per_dispatch, weights, tau).  ``steer_tau`` > 0
    turns on coverage steering; ``fault_weights`` maps action-family names
    to sampling weights (missing families weigh 1.0).  ``mesh`` must be
    None or one device.
    """

    def __init__(self, config: CheckConfig, mesh: int | None = None,
                 walkers: int = 1024, depth: int = 100,
                 steps_per_dispatch: int = 64, seed: int = 0,
                 steer_tau: float = 0.0, fault_weights: dict | None = None,
                 device="cuda"):
        if config.symmetry:
            raise ValueError("simulation mode ignores SYMMETRY; run without")
        check_shape(walkers, depth, steps_per_dispatch)
        self.config = config
        self.bounds = config.bounds
        self.model = resolve_model(config.spec)
        self.n_devices = mesh_devices(mesh)
        self.width, _pack, _unpack = self.model.sim_codec(self.bounds)
        self.table = self.model.action_table(self.bounds)
        self.A = len(self.table)
        self.walkers = walkers
        self.depth = depth
        self.steps = steps_per_dispatch
        self.seed = seed
        self.steer_tau = float(steer_tau)
        self.fault_weights = dict(fault_weights or {})
        self._weight_vec(None)       # validate constructor weights loudly
        self.device = torch.device(device)
        self.step_fn = self.model.sim_step(config, self.device)
        check_walker_memory(walkers, self.A, self.width,
                            len(config.invariants), depth, self.device)
        self._keys = walker_keys(seed, walkers, self.device)
        self.fetches = 0
        self.dispatches = 0

    def _weight_vec(self, fault_weights: dict | None) -> np.ndarray:
        """Family-weight dict -> per-lane vector, validated loudly."""
        fw = self.fault_weights if fault_weights is None else fault_weights
        fams = {a.family for a in self.table}
        unknown = sorted(set(fw) - fams)
        if unknown:
            raise ValueError(
                f"unknown action families {unknown} for spec "
                f"{self.config.spec!r} (known: {', '.join(sorted(fams))})")
        bad = sorted(f for f, w in fw.items() if w < 0)
        if bad:
            raise ValueError(f"negative fault weights for {bad}")
        return np.asarray([fw.get(a.family, 1.0) for a in self.table],
                          dtype=np.float64)

    def _segment_weights(self, wvec: np.ndarray,
                         cov_total: np.ndarray) -> torch.Tensor:
        """The dispatch's lane weights: scenario weights times the steering
        factor from the visit counts at the dispatch's start."""
        w = wvec
        if self.steer_tau:          # 0.0 leaves the weights exactly as set
            r = cov_total / max(float(cov_total.mean()), 1.0)  # lint: jit-ok numpy array, no device read
            w = wvec * np.exp(-self.steer_tau * np.log1p(r))
        return torch.as_tensor(w, dtype=torch.float64).to(self.device)

    def _dispatch(self, c: FleetWalk, weights: torch.Tensor) -> list:
        """``steps_per_dispatch`` steps of every walker (in place on the
        carry ``c``), then one copy of the dispatch's summary: behaviors,
        states, deepest walk, overflow, the least violating ``(step,
        walker)`` and its invariant, the least deadlocked ``(step,
        walker)``, and the A lane visit counts."""
        dev = self.device
        ar = torch.arange(self.walkers, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        d_beh, d_st, maxd = zero, zero, zero
        fail = torch.zeros((), dtype=torch.bool, device=dev)
        cov = torch.zeros(self.A, dtype=torch.int64, device=dev)

        def pick(valid, u):
            return pick_weighted(valid, u, weights)

        def verdict(live, stuck, inv):
            # each violating or deadlocked walker freezes on its own
            if self.config.check_deadlock:
                c.dead_step = torch.where(stuck & (c.dead_step == BIG),
                                          c.step, c.dead_step)
            new_viol = live & ~inv.all(-1) & (c.viol_step == BIG)
            c.viol_step = torch.where(new_viol, c.step, c.viol_step)
            c.viol_inv = torch.where(new_viol, first_false(inv), c.viol_inv)
            return (c.viol_step < BIG) | (c.dead_step < BIG)

        for _ in range(self.steps):
            frozen = (c.viol_step < BIG) | (c.dead_step < BIG)
            s = walker_step(self.step_fn, c, self._keys, self._init,
                            self.depth, pick, ~frozen, verdict)
            fail = fail | s.overflow
            maxd = torch.maximum(maxd, s.deepest)
            d_st = d_st + s.live.sum()
            d_beh = d_beh + s.done.sum()
            cov.index_add_(0, s.lane, s.live.to(torch.int64))
        self.dispatches += 1

        def least(steps):
            smin = steps.min()
            return smin, torch.where(steps == smin, ar, BIG).min()

        vmin, vgid = least(c.viol_step)
        vinv = c.viol_inv[vgid.clamp(max=self.walkers - 1)]
        dmin, dgid = least(c.dead_step)
        self.fetches += 1
        return torch.cat([torch.stack([d_beh, d_st, maxd, fail.long(), vmin,  # lint: jit-ok the one fused fetch a dispatch
                                       vgid, vinv, dmin, dgid]),
                          cov]).cpu().tolist()

    def run(self, n_behaviors: int, init_override=None,
            max_wall_s: float | None = None, on_progress=None,
            events: str | None = None, fault_weights: dict | None = None,
            snapshot_walks: bool = False) -> FleetResult:
        t0 = time.monotonic()
        from raft_tla_tpu_torch.obs import RunTelemetry
        tel = RunTelemetry("fleet", config=self.config,
                           on_progress=on_progress, events=events,
                           n_devices=self.n_devices, t0=t0)
        init_py = init_override if init_override is not None \
            else self.model.init_py(self.bounds)
        tel.run_start()
        viol = init_violation(self.model, self.config, init_py)
        if viol is not None:
            res = self._result(0, 1, 0, viol, t0, np.zeros(self.A, np.int64),
                               [0] * self.n_devices)
            self._end(tel, res, complete=True)
            return res

        wvec = self._weight_vec(fault_weights)
        dev = self.device
        self._init = torch.as_tensor(
            self.model.to_vec(init_py, self.bounds),
            dtype=torch.int32).to(dev)
        i64 = dict(dtype=torch.int64, device=dev)
        c = FleetWalk(
            vecs=self._init.expand(self.walkers, self.width).clone(),
            hist=torch.zeros((self.walkers, self.depth), dtype=torch.int32,
                             device=dev),
            hlen=torch.zeros((self.walkers,), **i64),
            viol_step=torch.full((self.walkers,), BIG, **i64),
            viol_inv=torch.zeros((self.walkers,), **i64),
            dead_step=torch.full((self.walkers,), BIG, **i64))
        cov_total = np.zeros(self.A, np.int64)
        dev_states = [0] * self.n_devices
        nb = nst = mx = 0
        complete = True
        while True:
            seg_t0 = time.monotonic()
            s = self._dispatch(c, self._segment_weights(wvec, cov_total))
            d_beh, d_st, maxd, failh, vmin, vgid, vinv, dmin, dgid = s[:9]
            seg_wall = max(time.monotonic() - seg_t0, 1e-9)
            nb += d_beh
            nst += d_st
            mx = max(mx, maxd)
            cov_total += np.asarray(s[9:], np.int64)
            dev_states[0] += d_st
            if failh:
                tel.stop_requested("tensor-encoding overflow",
                                   source="fleet")
                tel.close()
                raise RuntimeError(
                    "fleet simulation aborted: a sampled transition "
                    "overflowed the tensor encoding — bounds reasoning "
                    "violated (config.py capacity scheme)")
            if tel.active:
                tel.segment(nst, mx, nst,
                            device_rates=[round(float(d_st) / seg_wall, 1)])
            if vmin < BIG or dmin < BIG:
                viol = vmin < BIG
                k = vgid if viol else dgid
                name = self.config.invariants[vinv] if viol else DEADLOCK
                trace = replay(self.model, self.table, self.bounds, init_py,
                               c.hist[k].cpu().tolist(), int(c.hlen[k]))  # lint: jit-ok once, at the violation
                res = self._result(nb, nst, mx,
                                   Violation(name, trace[-1][1], trace),
                                   t0, cov_total, dev_states)
                if snapshot_walks:
                    res.walks = self._walks(c)
                self._end(tel, res, complete=True)
                return res
            if nb >= n_behaviors:
                break
            if max_wall_s is not None and \
                    time.monotonic() - t0 > max_wall_s:
                complete = False     # wall-bounded partial run
                break
        res = self._result(nb, nst, mx, None, t0, cov_total, dev_states)
        if snapshot_walks:
            res.walks = self._walks(c)
        self._end(tel, res, complete=complete)
        return res

    @staticmethod
    def _walks(c: FleetWalk) -> tuple:
        return c.hist.cpu().numpy(), c.hlen.cpu().numpy()  # lint: jit-ok once, at the end of the run

    def _result(self, nb, nst, mx, violation, t0, cov_total,
                dev_states) -> FleetResult:
        by_family: dict = {}
        for inst, cnt in zip(self.table, cov_total):
            by_family[inst.family] = by_family.get(inst.family, 0) \
                + int(cnt)
        return FleetResult(
            n_behaviors=nb, n_states=nst, max_depth_seen=mx,
            violation=violation, wall_s=time.monotonic() - t0,
            n_devices=self.n_devices, walkers=self.walkers,
            steer_tau=self.steer_tau, coverage=by_family,
            coverage_entropy=_coverage_entropy(np.asarray(cov_total)),
            device_states=list(dev_states))

    def _end(self, tel, res: FleetResult, complete: bool) -> None:
        tel.run_end_sim(
            n_states=res.n_states, n_behaviors=res.n_behaviors,
            max_depth=res.max_depth_seen, wall_s=res.wall_s,
            complete=complete, violation=res.violation,
            sim=res.confidence(self.config.invariants))
        tel.close()
