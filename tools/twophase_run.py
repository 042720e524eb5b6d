"""Two-phase commit at full size on the card: the host engine, then
simulation.

    python3 tools/twophase_run.py [--rms 8] [--seconds 60] [--cpu-check]
                                  [--out FILE]

The model is ``--spec twophase`` (frontend/twophase.py: the schema step
compiled from the action IR, its rows keyed by K2) with ``CONSTANT RM =
{r1..rN}`` and ``INVARIANT TCConsistent``.  At N = 8: W = 27 words a row,
A = 42 lanes a state.  One JSON line each:

- ``search``: ``python -m raft_tla_tpu_torch.check CFG --spec twophase
  --engine host --chunk 8192`` in-process: the counts, held to the JAX
  package's oracle where it has one (7 and 8 RMs, pinned below; any other
  N is reported ``"verified": null``), the wall and states/s, the chunks,
  K2's launches (one a chunk; K1, the plain fingerprint and the plain step
  none), the host's per-lane dedup loop's seconds and share of the search;
  with ``--cpu-check`` the same search on the CPU after it, whose counts
  and levels must be equal (``cpu-check``; ~11 min at 9 RMs on 8 cores);
- ``chunk``: one full chunk of reachable rows through the schema step:
  K2 alone on its successor rows (CUDA events, the card held busy while
  the host queues), the whole step, and under torch.profiler the card's
  busy time and kernel launches a step, the kernels by name;
- ``simulate``: ``Simulator.run(max_wall_s=--seconds)`` at 131,072
  walkers, depth 100, seed 7: behaviors, sampled states, states/s, schema
  steps (one a walker step, no K2: a walk dedups nothing).

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

CHUNK = 8192
WALKERS = 131072
# The JAX package's oracle (raft_tla_tpu.frontend.twophase.reference_check,
# on the CPU: 23 s at 7 RMs, 155 s at 8): states, diameter, transitions,
# new states per BFS level.
ORACLE = {
    7: (296_448, 22, 2_744_705,
        [1, 15, 105, 462, 1456, 3570, 7259, 12861, 20449, 29372, 37772,
         42924, 42651, 36785, 27371, 17447, 9436, 4277, 1603, 490, 119, 21,
         2]),
    8: (1_745_408, 25, 18_507_777,
        [1, 17, 136, 688, 2500, 7056, 16408, 32972, 59254, 96816, 143840,
         192656, 230412, 244342, 228712, 188304, 135833, 85377, 46392,
         21560, 8456, 2758, 736, 156, 24, 2]),
}


def cfg_path(rms: int, invariant: str = "TCConsistent") -> str:
    out = ROOT / "build" / "twophase_run"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"2pc{rms}.cfg"
    rm = ", ".join(f"r{i + 1}" for i in range(rms))
    path.write_text(f"SPECIFICATION Spec\nCONSTANT RM = {{{rm}}}\n"
                    f"INVARIANT {invariant}\n")
    return str(path)


def search(rms: int, emit, device: str = "cuda") -> tuple:
    """The exhaustive check through the CLI on ``device``: ``(config,
    result)``."""
    import torch

    from chip_smoke import run_cli, tp_counts, tp_reset
    tp_reset()
    t0 = time.monotonic()
    code, eng, res, out = run_cli([cfg_path(rms), "--spec", "twophase",
                                   "--engine", "host", "--chunk",
                                   str(CHUNK), "--device", device])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = tp_counts()
    if res is None:
        raise SystemExit(f"twophase_run: exit {code}: {out[-600:]}")
    got = (res.n_states, res.diameter, res.n_transitions)
    want = ORACLE.get(rms)
    chunks = sum(-(-n // CHUNK) for n in res.levels)
    emit({"phase": "search", "device": device, "rms": rms, "exit": code,
          "states": res.n_states, "diameter": res.diameter,
          "transitions": res.n_transitions, "levels": res.levels,
          "verified": None if want is None else
          (got == want[:3] and res.levels == want[3]),
          "wall_s": round(wall, 3), "search_s": round(res.wall_s, 3),
          "states_per_sec": round(res.n_states / res.wall_s, 1),
          "chunks": chunks, "launches": launches,
          "dedup_s": round(eng.dedup_s, 3),
          "dedup_share": round(eng.dedup_s / res.wall_s, 4)})
    if code != 0 or (want is not None and (got != want[:3]
                                           or res.levels != want[3])):
        raise SystemExit(f"twophase_run: {got} {res.levels}, want {want}")
    if device == "cuda" and (launches["fingerprint"] != chunks
                             or launches["step"]
                             or launches["plain fingerprint"]
                             or launches["plain step"]):
        raise SystemExit(f"twophase_run: launches {launches}")
    return eng.config, res


def device_kernels(events) -> dict:
    """``{kernel: (device ms, launches)}`` from a profiler's averages."""
    from torch.autograd import DeviceType
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in events if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def chunk(config, emit) -> None:
    import torch

    from chip_smoke import DEV, cuda_ms, tp_rows
    from raft_tla_tpu_torch.frontend.registry import resolve_model
    from raft_tla_tpu_torch.ops import pallas_fp
    model = resolve_model("twophase")
    b = config.bounds
    step = model.build_step(config, DEV)
    rows = tp_rows(step, model, b, CHUNK)
    out = step(rows)
    W = model.layout(b).width
    flat = out["svecs"].reshape(-1, W).contiguous()
    k2_ms, k2_spread = cuda_ms(lambda: pallas_fp.fingerprint_rows(flat), 50)
    step_ms, step_spread = cuda_ms(lambda: step(rows), 5, trials=3,
                                   hold=False)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(rows)
        torch.cuda.synchronize()
    by_kernel = device_kernels(prof.key_averages())
    busy = sum(ms for ms, _n in by_kernel.values()) / 5
    launches = sum(n for _ms, n in by_kernel.values()) / 5
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "chunk", "rows": len(rows), "lanes": out["valid"].shape[1],
          "width": W, "valid_lanes": int(out["valid"].sum()),
          "k2_rows": flat.shape[0], "k2_ms": round(k2_ms, 4),
          "k2_spread_ms": round(k2_spread, 4),
          "step_ms": round(step_ms, 4), "step_spread_ms": round(step_spread,
                                                               4),
          "busy_ms_per_step": round(busy, 4),
          "kernels_per_step": round(launches, 1),
          "kernels_ms_per_step": {k: round(v[0] / 5, 4)
                                  for k, v in top}})


def simulate(config, seconds: float, emit) -> None:
    import torch

    from chip_smoke import tp_counts, tp_reset
    from raft_tla_tpu_torch.simulate import Simulator
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = Simulator(config, walkers=WALKERS, depth=100, seed=7)
    tp_reset()
    res = sim.run(10**15, max_wall_s=seconds)
    launches = tp_counts()
    steps = sim.steps * sim.dispatches
    emit({"phase": "simulate", "walkers": WALKERS, "seconds": seconds,
          "behaviors": res.n_behaviors, "states": res.n_states,
          "deepest": res.max_depth_seen,
          "states_per_sec": round(res.states_per_sec, 1),
          "wall_s": round(res.wall_s, 2), "walker_steps": steps,
          "step_ms": round(res.wall_s / steps * 1e3, 4),
          "launches": launches, "fetches": sim.fetches,
          "dispatches": sim.dispatches,
          "violation": res.violation.invariant if res.violation else None,
          "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
    if launches["schema step"] != steps or launches["fingerprint"] \
            or launches["step"] or res.violation is not None:
        raise SystemExit(f"twophase_run: simulation {launches}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rms", type=int, default=8,
                   help="resource managers (default 8)")
    p.add_argument("--seconds", type=float, default=60.0,
                   help="wall of the simulation (default 60; 0 skips it)")
    p.add_argument("--cpu-check", action="store_true",
                   help="also run the search on the CPU (the plain "
                        "fingerprint, the machine's cores) and require "
                        "the same counts and levels: the check where no "
                        "oracle count exists")
    p.add_argument("--out", type=Path, default=None,
                   help="also append the JSON lines here")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("twophase_run: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
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

    from raft_tla_tpu_torch.ops import build, pallas_fp
    build.prebuild([(pallas_fp.SOURCE, ())])
    config, res = search(args.rms, emit)
    if args.cpu_check:
        _c, cres = search(args.rms, emit, "cpu")
        same = (cres.n_states, cres.diameter, cres.n_transitions,
                cres.levels) == (res.n_states, res.diameter,
                                 res.n_transitions, res.levels)
        emit({"phase": "cpu-check", "rms": args.rms, "equal": same})
        if not same:
            raise SystemExit("twophase_run: the card and the CPU disagree")
    chunk(config, emit)
    if args.seconds > 0:
        simulate(config, args.seconds, emit)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
