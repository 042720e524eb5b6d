"""Simulation of the 5-server election on the card, at three walker counts.

    python3 tools/simulate_run.py [--seconds 120] [--out FILE]

The universe is ``runs/MC5s2v.cfg`` without its SYMMETRY line (simulation
replays concrete states): 5 servers, 2 values, the election spec at t2 l0
m2 (the DDD engine's elect5 universe, W = 104), invariant NoTwoLeaders,
depth 100, seed 7.  For 8,192, 32,768 and 131,072 walkers, one JSON line
each with:

- a run of ``--seconds`` through ``Simulator.run(max_wall_s=...)``:
  behaviors, states, deepest walk, states/s, K1 launches (one a walker
  step), host fetches a dispatch, peak device memory;
- the walker step's time: the run's wall a step (what the run pays); the
  host wall a step of each of ten 64-step dispatches after it, each
  ended by its fetch (median, least and most); K1 alone on the walkers'
  rows (CUDA events, the card held busy while the host queues); and,
  over one more dispatch under torch.profiler, the card's busy time and
  its kernel launches a step, with the kernels by name.  The card's idle
  share is one less its busy time over the run's wall a step; the share
  of the profiled dispatch's own wall (the profiler stretches it) is
  given beside it.

Then the card's name and power limit.  Runs on the card only; imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WALKERS = (8192, 32768, 131072)
STEPS = 64
TIMED = 10      # dispatches timed one by one after the run


def cfg_path() -> str:
    out = ROOT / "build" / "simulate_run"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "MC5s2v_nosym.cfg"
    text = (ROOT / "runs" / "MC5s2v.cfg").read_text()
    lines = [ln for ln in text.splitlines(True)
             if not ln.startswith("SYMMETRY")]
    path.write_text("".join("INVARIANTS NoTwoLeaders\n"
                            if ln.startswith("INVARIANTS") else ln
                            for ln in lines))
    return str(path)


def device_kernels(events) -> dict:
    """``{kernel: (device ms, launches)}`` from a profiler's averages (its
    CUDA events; the kernels run on one stream, so their times add up to
    the busy time)."""
    from torch.autograd import DeviceType
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in events if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def run_case(config, walkers: int, seconds: float, emit) -> None:
    import torch

    from chip_smoke import cuda_ms
    from raft_tla_tpu_torch.ops import pallas_step
    from raft_tla_tpu_torch.simulate import Simulator

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = Simulator(config, walkers=walkers, depth=100,
                    steps_per_dispatch=STEPS, seed=7)
    pallas_step.launches = 0
    res = sim.run(10**15, max_wall_s=seconds)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, fetches, dispatches = (pallas_step.launches, sim.fetches,
                                     sim.dispatches)
    steps = sim.steps * dispatches
    run_ms = res.wall_s / steps * 1e3
    # the step's time on rows the walk reached, dispatch by dispatch
    w = sim.start()
    sim.dispatch(w)
    timed = []
    for _ in range(TIMED):
        t0 = time.monotonic()
        sim.dispatch(w)
        timed.append((time.monotonic() - t0) / STEPS * 1e3)
    timed.sort()
    k1_ms, k1_spread = cuda_ms(lambda: sim.step_fn(w.vecs), 10)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        sim.dispatch(w)
        torch.cuda.synchronize()
        prof_ms = (time.monotonic() - t0) / STEPS * 1e3
    by_kernel = device_kernels(prof.key_averages())
    busy = sum(ms for ms, _n in by_kernel.values()) / STEPS
    kernels = sum(n for _ms, n in by_kernel.values()) / STEPS
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    emit({"walkers": walkers, "seconds": seconds,
          "behaviors": res.n_behaviors, "states": res.n_states,
          "deepest": res.max_depth_seen,
          "states_per_sec": round(res.states_per_sec, 1),
          "wall_s": round(res.wall_s, 2), "k1_launches": launches,
          "walker_steps": steps, "fetches": fetches,
          "dispatches": dispatches,
          "violation": res.violation.invariant if res.violation else None,
          "run_step_ms": round(run_ms, 4),
          "timed_step_ms": [round(timed[TIMED // 2], 4),
                            round(timed[0], 4), round(timed[-1], 4)],
          "k1_ms": round(k1_ms, 4), "k1_spread_ms": round(k1_spread, 4),
          "busy_ms_per_step": round(busy, 4),
          "kernels_per_step": round(kernels, 2),
          "idle_share": round(1 - busy / run_ms, 4),
          "profiled_step_ms": round(prof_ms, 4),
          "profiled_idle_share": round(1 - busy / prof_ms, 4),
          "kernels_ms_per_step": {k[:60]: round(v[0] / STEPS, 4)
                                  for k, v in top},
          "peak_gib": round(peak, 3)})
    if launches != steps or fetches != dispatches:
        raise SystemExit(f"simulate_run: K1 launches {launches} for {steps} "
                         f"steps, {fetches} fetches for {dispatches} "
                         "dispatches")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=120.0,
                   help="wall of each run (default 120)")
    p.add_argument("--out", type=Path, default=None,
                   help="also append the JSON lines here")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("simulate_run: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    from raft_tla_tpu_torch import check
    config = check.config_of(check.build_argparser().parse_args(
        [cfg_path(), "--spec", "election", "--max-term", "2",
         "--max-log", "0", "--max-msgs", "2"]))
    sink = None
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        sink = args.out.open("a")

    def emit(d):
        line = json.dumps(d)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for walkers in WALKERS:
        run_case(config, walkers, args.seconds, emit)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
