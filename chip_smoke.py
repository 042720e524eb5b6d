"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two kernels from ``raft_tla_tpu_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card, drives the port's
main path (``python -m raft_tla_tpu_torch.check``, the device engine) on
verified configurations, at the reference universe's full size and on the
flagship symmetric universe, and audits the finished stores with the
fingerprint kernel.  Imports nothing of JAX or of ``raft_tla_tpu``.

Phases (each prints a line; any failure exits non-zero):

0. the card, torch and CUDA versions; the kernel builds, in parallel, with
   the ptxas lines of the flagship and the 5- and 6-server layouts, parity
   and faithful, and K1's occupancy (blocks and warps a multiprocessor
   holds) at the two flagship layouts;
1. K1 (csrc/step.cu) against the plain step on reachable rows: four configs
   without symmetry, then the dedup-key stage at |G| = 6 (also on 8,191
   rows, a ragged last block), 12, 24, 120 and 720 and with the deadvotes
   view; then faithful mode (the history stage) at |G| = 1, 6, 12 (rank
   maps), 6 with deadvotes, and 120; then the expression stage (cfg
   INVARIANT expressions over every operator and reducer, an index that
   wraps and one that clamps, beside the registry invariants: 12 in one
   step at |G| = 1 and at |G| = 6 on a ragged block, 11 in faithful mode),
   each expression's column also against the program's plain evaluator
   (ops/predprog.evaluate); and K1's time at the flagship layout with and
   without ``commitIndex <= logLen``;
2. K2 (csrc/fingerprint.cu) against the plain fingerprint, 1,048,576 rows
   at W = 60, 110 and 113, and 1,048,573 rows at W = 60;
3. verified counts through the CLI entry (plain, SYMMETRY, VIEW and
   faithful), the seeded violations (exit 12, traces replay through the
   interpreter, the faithful trace shows the history) and a deadlock
   (exit 11); the expression ``count(role = 2) <= 1`` as a cfg invariant
   (exit 12, the trace of the registry ``NaiveNoTwoLeaders``, the verdict
   naming the expression); ``--engine ref`` and ``--engine host`` on the
   verified configurations under 10^5 states (their counts; the host
   engine launches K1 and never the plain step) and the seeded violation
   (the host engine's trace equal to the oracle's); ``--stats`` on the
   device engine (one line per segment, the reference's progress fields);
4. the reference universe (3 servers, 2 values, t2 l1 m1) to exhaustion,
   with the whole-line expression ``commitIndex <= logLen`` beside its
   three registry invariants: 15,872,151 states, diameter 53, 40,060,419
   transitions; then the store audit with K2;
5. the flagship ``runs/MC3s2v.cfg`` (the same universe at MaxMsgs 2 with
   SYMMETRY Server) to exhaustion through the CLI: 94,396,461 orbits,
   diameter 57, 258,131,266 transitions and the per-level counts of
   ``runs/flagship_r2_ddd.out``; then the store audit with K2;
6. the phase-4 universe in faithful mode with all seven invariants: first
   under SYMMETRY Server Value (1,827,985 orbits, diameter 53, 4,929,392
   transitions, the JAX package's DeviceEngine on the CPU), then without
   symmetry to exhaustion, a count no JAX run reached: it is held by the
   orbit sums (each stored representative's orbit size, counted as the
   distinct canonical rows among its 12 images by the plain permutation,
   summed per BFS level, equals that level's count), then the store audits
   and K1 against the plain step on rows from every level;
7. the faithful flagship, ``runs/MC3s2v.cfg --faithful`` (SYMMETRY Server,
   W = 113): to exhaustion, its store audit, and K1 against the plain step
   on rows from every level.  No reference count exists for it;
8. 300 chunks of the phase-5 and phase-7 runs (after their first 3,000
   and 5,000) under torch.profiler: the card's time by kernel, K1's kernel
   time per chunk inside the engine, and the card's idle share;
9. the flagship through the DDD engine (``--engine ddd``, full
   retention): phase 5's counts and levels, K1 launched on every chunk, no
   plain-step call; its wall, orbits/s, segments, chunks, host syncs per
   chunk, K1's and the filter's milliseconds per chunk (CUDA events), the
   bytes copied to the host, the host flush seconds, peak device memory
   and peak host RSS;
10. phase 4's universe through the DDD engine in frontier retention with
   every level file kept: phase 4's counts, then the audit of the ``.keys``
   log with K2 (the rows of the level files, unpacked on the card, hash to
   those keys bit for bit, pairwise distinct, as many as counted);
11. a seeded violation and a deadlock through the DDD engine in both
   retentions, each trace equal to the device engine's for the same cfg;
   then a ``--deadline`` stop with ``--checkpoint`` on phase 10's universe
   and its ``--resume``, which must give phase 10's counts;
12. the 5-server election ``runs/MC5s2v.cfg`` (SYMMETRY Server, |G| =
   120), beyond what the device engine can hold, through the DDD engine
   in frontier retention with ``--stats`` and ``--deadline``: every level
   it completes must end at the cumulative count of the JAX package's
   campaign (``runs/elect5ddd.stats``), level 20 at least.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Tolerance everywhere: bit-exact (all
outputs are int32, uint32 bits or bools).
"""

from __future__ import annotations

import contextlib
import io
import json
import resource
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
WORK = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT_OPS_PER_S = 67e12              # CUDA-core fp32 peak; int32 is no faster

# Phase-4 universe and the counts the JAX package's DeviceEngine found for
# it on the CPU (chunk 1024, Capacities(n_states=1 << 25)).
REAL = dict(servers=3, values=2, max_term=2, max_log=1, max_msgs=1,
            invariants="NoTwoLeaders LogMatching CommittedWithinLog")
REAL_EXPECT = (15_872_151, 53, 40_060_419)
# Phase 4 adds the expression twin of CommittedWithinLog on a line of its
# own (a line with an expression is one whole-line expression).
REAL_EXPR_INVARIANTS = REAL["invariants"] + "\n    commitIndex <= logLen"
MAIN_CHUNK = 8192
# The phase-4 wall on one H100 80GB HBM3 at 700 W before the dedup-key
# stage existed (four runs of this script; PERF.md), and with that stage
# but without the expression (PERF.md section 5).
REAL_WALL_BEFORE = (15.77, 18.19)
REAL_WALL_NO_EXPR = 15.76

# Expression invariants of phase 1: every operator and reducer, an index
# that wraps (votedFor - 1 is -1 for Nil), indices that clamp (logLen is
# one past the log; matchIndex + 7 past the row), int32 wrap-around.
EXPRS = ("count(role = 2) <= 1", "commitIndex <= logLen",
         "term[votedFor - 1] >= 1 \\/ votedFor = 0",
         "logTerm[logLen] <= max(term) /\\ min(logVal) >= 0",
         "term * 1073741824 * 4 = 0 => ~any(msgCount > 1)",
         "-term[0] - count(TRUE) < nextIndex[matchIndex + 7]",
         "logVal[term] /= 3")

# The reference's ProgressRecord fields (raft_tla_tpu/obs/events.py), as a
# literal: this script imports nothing of the JAX package.
PROGRESS_FIELDS = (
    "wall_s", "n_states", "level", "n_transitions", "dedup_hit_rate",
    "states_per_sec", "inc_states_per_sec", "since_resume", "coverage",
    "route_peak", "n_devices", "inv_evals", "phase_s", "device_rates",
    "bin", "inflight", "flush_backlog", "upload_wait_ms", "prefetch_hits",
    "export_rows", "dev_dedup_hits")

# Phase 5: the flagship cfg and the counts of its complete check by the
# JAX package's DDD engine (runs/flagship_r2_ddd.out, line 2).
FLAGSHIP_CFG = ROOT / "runs" / "MC3s2v.cfg"
FLAGSHIP_OUT = ROOT / "runs" / "flagship_r2_ddd.out"
FLAGSHIP_ARGS = ["--max-term", "2", "--max-log", "1", "--max-msgs", "2",
                 "--chunk", str(MAIN_CHUNK), "--cap", "100000000"]

# Faithful mode: the seven invariants, and the phase-6 counts under
# SYMMETRY Server Value (the JAX package's DeviceEngine on the CPU, chunk
# 4096).
INV7 = ("NoTwoLeaders LogMatching CommittedWithinLog LeaderCompleteness "
        "ElectionSafetyHist LeaderCompletenessHist AllLogsPrefixClosed")
FAITHFUL_SYM_EXPECT = (1_827_985, 53, 4_929_392)
# Phase 7: a store of 134,000,000 rows of W = 113 (60.6 GB), 1.062x the
# 126,130,477 orbits the run finds; below 2^27 rows the fingerprint table
# stays at 2^28 slots (2.1 GB), and the whole run fits the 80 GB card.
FAITHFUL_FLAGSHIP_ARGS = ["--faithful", "--max-term", "2", "--max-log", "1",
                          "--max-msgs", "2", "--chunk", str(MAIN_CHUNK),
                          "--cap", "134000000"]


# Phase 12: the 5-server election (BASELINE config #2) and the cumulative
# orbit count at the end of each BFS level of the JAX package's DDD
# campaign on it (the last line of each level in runs/elect5ddd.stats).
ELECT5_CFG = ROOT / "runs" / "MC5s2v.cfg"
ELECT5_ARGS = ["--spec", "election", "--max-term", "2", "--max-log", "0",
               "--max-msgs", "2", "--engine", "ddd", "--retention",
               "frontier", "--stats", "--chunk", "4096"]
ELECT5_LEVEL_ENDS = {
    1: 2, 2: 6, 3: 19, 4: 63, 5: 204, 6: 581, 7: 1354, 8: 2805, 9: 5990,
    10: 13329, 11: 27162, 12: 50744, 13: 99851, 14: 204227, 15: 374447,
    16: 653935, 17: 1276303, 18: 2386074, 19: 3862077, 20: 6914065,
    21: 13035600, 22: 20231266, 23: 33043858, 24: 61457382, 25: 92875324,
    26: 140007553, 27: 251752136, 28: 371737651, 29: 524944666,
    30: 899977148}
ELECT5_DEADLINE = 30.0          # seconds after the first harvest
STOP_DEADLINE = 1.0             # phase 11's stop, long before the end
ELECT5_MIN_LEVEL = 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, trials: int = 5, hold: bool = True) -> tuple:
    """``(median, max - min)`` over ``trials`` of the mean milliseconds of
    ``fn`` across ``reps`` back-to-back launches (CUDA events, after
    ``reps`` warm-up launches).  With ``hold`` the card first spins for
    about 0.2 ms a launch (``torch.cuda._sleep``) while the host queues
    the launches, so the time is the card's and not the host's cost of
    calling the wrapper (tens of microseconds a call)."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(400_000 * reps)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times)), max(times) - min(times)


def host_ms(fn, reps: int) -> float:
    """Host milliseconds per call of ``fn`` while the card is held busy, so
    the calls never wait for it: the wrapper's own cost."""
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000 * reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def step_bytes(B: int, A: int, W: int, n_inv: int, n_valid: int) -> int:
    """Bytes one K1 launch must move under the step contract: the rows read
    once, the ``valid`` byte of every lane, and on each of the ``n_valid``
    valid lanes its int32 successor and keys and its ``overflow``,
    ``inv_ok`` and ``con_ok`` bytes."""
    return B * W * 4 + B * A + n_valid * (W * 4 + 8 + 2 + n_inv)


def write_cfg(name: str, servers: int, values: int, invariants: str,
              symmetry: str = "") -> str:
    WORK.mkdir(parents=True, exist_ok=True)
    srv = ", ".join(f"s{i + 1}" for i in range(servers))
    val = ", ".join(f"v{i + 1}" for i in range(values))
    path = WORK / f"{name}.cfg"
    stanza = f"SYMMETRY {symmetry}\n" if symmetry else ""
    path.write_text(
        f"SPECIFICATION Spec\nINVARIANT {invariants}\n{stanza}CONSTANTS\n"
        f"    Server = {{{srv}}}\n    Value = {{{val}}}\n"
        '    Follower = "Follower"\n    Candidate = "Candidate"\n'
        '    Leader = "Leader"\n    Nil = "Nil"\n')
    return str(path)


def run_cli(argv, err=None):
    """The port's CLI in-process: (exit code, engine, result, stdout); its
    standard error goes to ``err`` when one is given."""
    from raft_tla_tpu_torch import check
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(err or sys.stderr):
        code, eng, res = check.run(argv)
    return code, eng, res, buf.getvalue()


def bounds_of(key: tuple):
    """Bounds of a layout key: five numbers (parity) or six (faithful, the
    sixth the election slots)."""
    from raft_tla_tpu_torch.config import Bounds
    if len(key) == 6:
        return Bounds(*key[:5], history=True, max_elections=key[5])
    return Bounds(*key)


def phase0():
    from raft_tla_tpu_torch.ops import build, pallas_fp, pallas_step
    from raft_tla_tpu_torch.ops import state as st
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    say(smi.stdout.strip())           # the card's name and power limit
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # (servers, values, max_term, max_log, max_msgs[, max_elections]):
    # five numbers a parity layout, six a faithful one.
    layouts = {(3, 2, 2, 1, 2), (3, 2, 2, 1, 1), (3, 1, 2, 0, 1),
               (3, 1, 2, 1, 2), (2, 1, 2, 0, 2), (2, 2, 2, 1, 2),
               (3, 1, 3, 0, 4), (1, 1, 2, 0, 2), (4, 1, 2, 0, 1),
               (5, 2, 2, 0, 2), (6, 1, 2, 0, 1),
               (3, 2, 2, 1, 2, 6), (3, 2, 2, 1, 1, 6), (5, 2, 2, 0, 2, 6),
               (2, 1, 2, 1, 2, 4), (2, 2, 2, 1, 2, 4), (3, 1, 2, 0, 1, 6),
               (3, 1, 3, 0, 4, 6)}
    jobs = {(pallas_fp.SOURCE, ())}
    for lay in layouts:
        d = pallas_step.layout_defines(bounds_of(lay))
        jobs.add((pallas_step.SOURCE, tuple(sorted(d.items()))))
    from raft_tla_tpu_torch.utils import native
    t0 = time.monotonic()
    host_lib = {}

    def build_host_store():
        native._lib()
        host_lib["s"] = time.monotonic() - t0

    gxx = threading.Thread(target=build_host_store)
    gxx.start()                        # g++ beside the nvcc builds
    build.prebuild(sorted(jobs))
    gxx.join()
    if "s" not in host_lib:
        fail("the host store (csrc/host_store.cc) did not build")
    say(f"phase 0: built {len(jobs)} kernel libraries (nvcc sm_90a, in "
        f"parallel) in {time.monotonic() - t0:.1f} s, and the DDD host "
        f"store (g++) in {host_lib['s']:.1f} s beside them")
    for key in ((3, 2, 2, 1, 1), (3, 2, 2, 1, 2), (5, 2, 2, 0, 2),
                (6, 1, 2, 0, 1), (3, 2, 2, 1, 2, 6), (5, 2, 2, 0, 2, 6)):
        d = pallas_step.layout_defines(bounds_of(key))
        say(f"ptxas step {d}: " + build.ptxas_report(
            pallas_step.SOURCE, d).replace("\n", " | "))
    say("ptxas fingerprint: " + build.ptxas_report(
        pallas_fp.SOURCE).replace("\n", " | "))
    for key in ((3, 2, 2, 1, 2), (3, 2, 2, 1, 2, 6)):
        b = bounds_of(key)
        blocks, smem = pallas_step.occupancy(b, "full", ("Server",),
                                             MAIN_CHUNK)
        say(f"occupancy step W={st.Layout.of(b).width} |G| 6, "
            f"{MAIN_CHUNK} rows: {blocks} blocks of 128 threads, "
            f"{blocks * 4} resident warps per SM, {smem} bytes of shared "
            f"memory per block")
    return smi.stdout.strip()


def reachable_rows(config, n: int, init_override=None) -> torch.Tensor:
    """``n`` rows the port's engine discovers in its first 160 chunks (a
    few levels), evenly spaced over them."""
    from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
    eng = DeviceEngine(config, Capacities(n_states=1 << 20, levels=64))
    res = eng.check(init_override=init_override, max_chunks=160)
    idx = torch.linspace(0, res.n_states - 1, min(n, res.n_states),
                         device=eng.device).long()
    return eng.carry["store"][idx].clone()


def compare_step(out, ref) -> tuple:
    """(mismatching lanes, max |difference|) under the step contract:
    ``valid`` on every lane, everything else where ``valid`` is true."""
    val = ref["valid"]
    bad = int((out["valid"] != ref["valid"]).sum())
    err = 0
    for k in ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok"):
        d = (out[k].to(torch.int64) - ref[k].to(torch.int64)).abs()
        if d.dim() > 2:
            d = d.flatten(2).amax(-1) if d.shape[2] else \
                torch.zeros(val.shape, dtype=torch.int64, device=val.device)
        d = torch.where(val, d, 0)
        bad += int((d > 0).sum())
        err = max(err, int(d.max()))
    return bad, err


def step_bound(out, n_inv: int, group: int) -> tuple:
    """K1's bound for one launch: ``(ms, "bytes" or "operations", bytes)``.

    Bytes: :func:`step_bytes`, with the valid lanes of this launch.
    Operations:
    the fingerprint arithmetic of the dedup key alone (two multiply-adds a
    word per lane of the key, plus the finaliser), on every valid lane
    for each of the ``group`` elements of its orbit scan: a lower bound, the
    permutations and the sort network uncounted."""
    B, A, W = out["svecs"].shape
    n_valid = int(out["valid"].sum())
    nbytes = step_bytes(B, A, W, n_inv, n_valid)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = n_valid * group * (4 * W + 12) / INT_OPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes


def phase1(results):
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.models import interp, spec as SP
    from raft_tla_tpu_torch.ops import kernels, pallas_step
    from raft_tla_tpu_torch.ops import state as st
    from raft_tla_tpu_torch.ops import symmetry as sym
    rep = Bounds(3, 1, 2, 1, 2)
    leader = interp.init_state(rep)._replace(
        role=(SP.LEADER, SP.FOLLOWER, SP.FOLLOWER), term=(2, 2, 2),
        votedFor=(1, 1, 1))
    full5 = ("NoTwoLeaders", "LogMatching", "CommittedWithinLog",
             "LeaderCompleteness", "NaiveNoTwoLeaders")
    flag = Bounds(3, 2, 2, 1, 2)
    fflag = bounds_of((3, 2, 2, 1, 2, 6))
    inv7 = tuple(INV7.split())
    # (name, bounds, spec, invariants, start, symmetry, view, rows)
    cases = [
        ("full 3s/2v t2 l1 m2", flag, "full", full5, None, (), None,
         MAIN_CHUNK),
        ("full 3s/2v t2 l1 m1", Bounds(3, 2, 2, 1, 1), "full",
         ("NoTwoLeaders", "LogMatching", "CommittedWithinLog"), None, (),
         None, MAIN_CHUNK),
        ("election 3s/1v t2 l0 m1", Bounds(3, 1, 2, 0, 1), "election",
         ("NoTwoLeaders",), None, (), None, MAIN_CHUNK),
        ("replication 3s/1v t2 l1 m2", rep, "replication",
         ("LogMatching", "CommittedWithinLog", "LeaderCompleteness"), leader,
         (), None, MAIN_CHUNK),
        ("full 3s/2v t2 l1 m2, Server", flag, "full", full5, None,
         ("Server",), None, MAIN_CHUNK),
        ("full 3s/2v t2 l1 m2, Server, ragged", flag, "full", full5, None,
         ("Server",), None, MAIN_CHUNK - 1),
        ("full 3s/2v t2 l1 m2, Server x Value", flag, "full", full5, None,
         ("Server", "Value"), None, MAIN_CHUNK),
        ("full 3s/2v t2 l1 m2, Server, deadvotes", flag, "full", full5, None,
         ("Server",), "deadvotes", MAIN_CHUNK),
        ("election 4s/1v t2 l0 m1, Server", Bounds(4, 1, 2, 0, 1),
         "election", ("NoTwoLeaders",), None, ("Server",), None, MAIN_CHUNK),
        ("election 5s/2v t2 l0 m2, Server", Bounds(5, 2, 2, 0, 2),
         "election", ("NoTwoLeaders",), None, ("Server",), None, 1024),
        ("election 6s/1v t2 l0 m1, Server", Bounds(6, 1, 2, 0, 1),
         "election", ("NoTwoLeaders",), None, ("Server",), None, 256),
        ("faithful full 3s/2v t2 l1 m2", fflag, "full", inv7, None, (), None,
         MAIN_CHUNK),
        ("faithful full 3s/2v t2 l1 m2, Server", fflag, "full", inv7, None,
         ("Server",), None, MAIN_CHUNK),
        ("faithful full 3s/2v t2 l1 m2, Server x Value", fflag, "full", inv7,
         None, ("Server", "Value"), None, MAIN_CHUNK),
        ("faithful full 3s/2v t2 l1 m2, Server, deadvotes", fflag, "full",
         inv7, None, ("Server",), "deadvotes", MAIN_CHUNK),
        ("faithful election 5s/2v t2 l0 m2, Server",
         bounds_of((5, 2, 2, 0, 2, 6)), "election", inv7, None, ("Server",),
         None, 1024),
    ]
    dev = torch.device("cuda")
    results["step_cases"] = []
    for name, b, spec, invs, start, axes, view, n in cases:
        cfg = CheckConfig(bounds=b, spec=spec, invariants=invs, chunk=1024)
        rows = reachable_rows(cfg, n, start)
        k1 = pallas_step.build_step(b, spec, invs, dev, symmetry=axes,
                                    view=view)
        plain = kernels.build_step(b, spec, invs, axes, view)
        out, ref = k1(rows), plain(rows)
        torch.cuda.synchronize()
        bad, err = compare_step(out, ref)
        B, A, W = out["svecs"].shape
        P, Q = sym.group_sizes(b, axes)
        reps = 20 if P * Q <= 24 else 3
        ms, spread = cuda_ms(lambda: k1(rows), reps)
        host = host_ms(lambda: k1(rows), reps)
        plain_ms, _ = cuda_ms(lambda: plain(rows), 1 if P * Q > 24 else 2,
                              trials=1 if P * Q > 24 else 3, hold=False)
        bound, by, nbytes = step_bound(out, len(invs), P * Q)
        say(f"phase 1: K1 {name}: |G| {P * Q}, rows {B} lanes {B * A} "
            f"(A={A}, W={W}) valid {int(ref['valid'].sum())} mismatches "
            f"{bad} max_abs_err {err}; K1 {ms:.4f} ms (spread {spread:.4f}; "
            f"the host's call {host:.4f} ms), plain {plain_ms:.2f} ms per "
            f"launch; bound {bound:.4f} ms "
            f"({by}; {nbytes} bytes)")
        if bad:
            fail(f"K1 disagrees with the plain step on {name}")
        results["step_cases"].append(dict(
            name=name, group=P * Q, rows=B, ms=ms, spread=spread,
            host_ms=host, plain_ms=plain_ms, bound_ms=bound, bound_by=by))
        if name == "full 3s/2v t2 l1 m2, Server":   # the phase-5 layout
            results["step"] = dict(
                mismatches=bad, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)
        else:
            results.setdefault("step_err", 0)
            results["step_err"] = max(results["step_err"], err)
    expression_stage(results, flag, fflag, full5, inv7)


def expression_stage(results, flag, fflag, full5, inv7) -> None:
    """K1's expression stage against the plain step and against the
    program's plain evaluator; then K1's time with and without one
    expression at the flagship layout, in turns."""
    from raft_tla_tpu_torch.config import CheckConfig
    from raft_tla_tpu_torch.models import invariants as inv_mod
    from raft_tla_tpu_torch.ops import kernels, pallas_step, predprog
    from raft_tla_tpu_torch.ops import state as st
    dev = torch.device("cuda")
    cases = [
        ("full 3s/2v t2 l1 m2, 12 invariants", flag, full5, full5 + EXPRS,
         (), MAIN_CHUNK),
        ("full 3s/2v t2 l1 m2, Server, 12 invariants, ragged", flag, full5,
         full5 + EXPRS, ("Server",), MAIN_CHUNK - 1),
        ("faithful full 3s/2v t2 l1 m2, 11 invariants", fflag, inv7,
         inv7 + EXPRS[:3] + ("max(term) <= 1",), (), MAIN_CHUNK),
    ]
    for name, b, base, invs, axes, n in cases:
        rows = reachable_rows(CheckConfig(bounds=b, spec="full",
                                          invariants=base, chunk=1024), n)
        out = pallas_step.build_step(b, "full", invs, dev,
                                     symmetry=axes)(rows)
        ref = kernels.build_step(b, "full", invs, axes)(rows)
        torch.cuda.synchronize()
        bad, err = compare_step(out, ref)
        val = ref["valid"]
        succ, got = ref["svecs"][val], out["inv_ok"][val]
        lay = st.Layout.of(b)
        stage_bad = false_lanes = 0
        for c, text in enumerate(invs):
            if text in inv_mod.REGISTRY:
                continue
            prog = predprog.compile_program(inv_mod._expression(text), lay)
            want = predprog.evaluate(prog, succ)
            stage_bad += int((got[:, c] != want).sum())
            false_lanes += int((~want).sum())
        say(f"phase 1: K1 expression stage, {name}: rows {rows.shape[0]}, "
            f"valid {int(val.sum())}, {len(invs)} invariants of which "
            f"{len(invs) - len(base)} expressions (false on {false_lanes} "
            f"lane-expression pairs); mismatches against the plain step "
            f"{bad}, max_abs_err {err}; against the program's plain "
            f"evaluator {stage_bad}")
        if bad or stage_bad:
            fail(f"K1's expression stage disagrees on {name}")
        results["step_err"] = max(results.get("step_err", 0), err)
    b = flag
    rows = reachable_rows(CheckConfig(bounds=b, spec="full",
                                      invariants=full5, chunk=1024),
                          MAIN_CHUNK)
    without = pallas_step.build_step(b, "full", full5, dev,
                                     symmetry=("Server",))
    with_expr = pallas_step.build_step(b, "full",
                                       full5 + ("commitIndex <= logLen",),
                                       dev, symmetry=("Server",))
    times = [cuda_ms(lambda: fn(rows), 20)[0]
             for fn in (without, with_expr, with_expr, without)]
    say(f"phase 1: K1 at the flagship layout, |G| 6, {MAIN_CHUNK} rows, "
        f"five registry invariants without / with commitIndex <= logLen "
        f"(in turns: without, with, with, without): "
        + ", ".join(f"{x:.4f}" for x in times) + " ms")
    results["expr_stage_ms"] = times


def phase2(results):
    # The flagship's row width (the kernels line reports it), phase 6's and
    # phase 7's, and a row count that is not a multiple of a block's rows.
    results["fingerprint"] = fingerprint_case(60)
    fingerprint_case(110)
    fingerprint_case(113)
    fingerprint_case(60, (1 << 20) - 3)


def fingerprint_case(W: int, B: int = 1 << 20) -> dict:
    from raft_tla_tpu_torch.ops import fingerprint as fpr, pallas_fp
    rng = np.random.default_rng(20260501)
    rows = torch.as_tensor(rng.integers(-2**31, 2**31, size=(B, W),
                                        dtype=np.int64).astype(np.int32),
                           device="cuda")
    consts = fpr.torch_constants(W, rows.device)
    hi, lo = pallas_fp.fingerprint_rows(rows)
    rh, rl = fpr.fingerprint(rows, consts)
    torch.cuda.synchronize()
    bad = int(((hi != rh) | (lo != rl)).sum())
    err = int(torch.maximum((hi.to(torch.int64) - rh).abs(),
                            (lo.to(torch.int64) - rl).abs()).max())
    ms, spread = cuda_ms(lambda: pallas_fp.fingerprint_rows(rows), 50)
    plain_ms, _ = cuda_ms(lambda: fpr.fingerprint(rows, consts), 5, trials=3,
                          hold=False)
    nbytes = B * W * 4 + 2 * B * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, B * (4 * W + 12) / INT_OPS_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    say(f"phase 2: K2 {B} rows x W={W}: mismatches {bad}; K2 {ms:.4f} ms "
        f"(spread {spread:.4f}) "
        f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms; bound "
        f"{bound:.4f} ms")
    if bad:
        fail("K2 disagrees with the plain fingerprint")
    return dict(mismatches=bad, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def seeded_violation(symmetry: tuple, faithful: bool = False) -> None:
    """The seeded NaiveNoTwoLeaders violation (a crafted start state, the
    case of the JAX package's tests/test_symmetry.py:117 under SYMMETRY):
    exit 12, and the trace replays through the interpreter; in faithful
    mode the rendered trace shows the history variables."""
    from raft_tla_tpu_torch import check
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
    from raft_tla_tpu_torch.models import interp, spec as SP
    from raft_tla_tpu_torch.ops import msgbits as mb
    from raft_tla_tpu_torch.utils.render import render_trace
    b = Bounds(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4,
               history=faithful)
    start = interp.init_state(b)._replace(
        role=(SP.LEADER, SP.FOLLOWER, SP.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=(((mb.rv_response(3, 1, 1, 2)), 1),))
    cfgv = CheckConfig(bounds=b, spec="election",
                       invariants=("NaiveNoTwoLeaders",), symmetry=symmetry,
                       chunk=256)
    res = DeviceEngine(cfgv, Capacities(n_states=1 << 15, levels=64)
                       ).check(init_override=start)
    code = check.verdict_code(res)
    trace = res.violation.trace if res.violation else []
    replays = bool(trace) and trace[0][1] == start and all(
        cur in [t for _i, t in interp.successors(prev, b, spec="election")]
        for (_l, prev), (_l2, cur) in zip(trace, trace[1:]))
    text = render_trace(res.violation, b) if res.violation else ""
    history = all(f"/\\ {v} = " in text
                  for v in ("elections", "allLogs", "voterLog"))
    say(f"phase 3: seeded NaiveNoTwoLeaders violation, symmetry "
        f"{symmetry or '()'}{', faithful' if faithful else ''}: exit {code}, "
        f"trace length {len(trace)}, replays through interp.successors: "
        f"{replays}, trace shows the history variables: {history}")
    if code != check.EXIT_VIOLATION or not replays or history != faithful:
        fail(f"seeded violation, symmetry {symmetry}, faithful {faithful}")


def phase3(results):
    from raft_tla_tpu_torch import check
    # (name, servers, values, spec, (t, l, m), cfg SYMMETRY, extra flags,
    #  verified count, verified diameter or None)
    verified = [
        ("election 2s/1v t2 l0 m2", 2, 1, "election", (2, 0, 2), "", [],
         3014, 17),
        ("election-3s 3s/1v t2 l0 m1", 3, 1, "election", (2, 0, 1), "", [],
         142538, 31),
        ("full 2s/2v t2 l1 m2", 2, 2, "full", (2, 1, 2), "", [], 74897, 32),
        ("election 2s/1v t2 l0 m2, SYMMETRY Server", 2, 1, "election",
         (2, 0, 2), "Server", [], 1514, 17),
        ("election 3s/1v t2 l0 m1, SYMMETRY Server", 3, 1, "election",
         (2, 0, 1), "Server", [], 23902, 31),
        ("election 3s/1v t2 l0 m1, --view deadvotes", 3, 1, "election",
         (2, 0, 1), "", ["--view", "deadvotes"], 129134, None),
        ("full 2s/2v t2 l1 m2, --symmetry", 2, 2, "full", (2, 1, 2), "",
         ["--symmetry"], 37472, 32),
        ("full 2s/2v t2 l1 m2, SYMMETRY SymValue", 2, 2, "full", (2, 1, 2),
         "SymValue", [], 50515, 32),
        ("full 2s/2v t2 l1 m2, SYMMETRY SymServerValue", 2, 2, "full",
         (2, 1, 2), "SymServerValue", [], 25281, 32),
        ("election 4s/1v t2 l0 m1, SYMMETRY Server", 4, 1, "election",
         (2, 0, 1), "Server", [], 5607847, None),
    ]
    # Faithful mode, all seven invariants (JAX counts: tests/test_history.py,
    # tests/test_symmetry.py, RESULTS.md; the 3-server ones from the JAX
    # DeviceEngine on the CPU), with the transitions where they are known.
    fa4 = ["--faithful", "--max-elections", "4"]
    faithful = [
        ("faithful full 2s/1v t2 l1 m2", 2, 1, "full", (2, 1, 2), "", fa4,
         53398, 32, None),
        ("faithful full 2s/2v t2 l1 m2", 2, 2, "full", (2, 1, 2), "", fa4,
         84572, 32, None),
        ("faithful full 2s/2v, SYMMETRY Server Value", 2, 2, "full",
         (2, 1, 2), "Server Value", fa4, 28121, 32, None),
        ("faithful full 2s/1v, SYMMETRY Server", 2, 1, "full", (2, 1, 2),
         "Server", fa4, 26723, 32, None),
        ("faithful election 3s/1v t2 l0 m1", 3, 1, "election", (2, 0, 1), "",
         ["--faithful"], 159413, 31, 266328),
        ("faithful election 3s/1v t2 l0 m1, SYMMETRY Server", 3, 1,
         "election", (2, 0, 1), "Server", ["--faithful"], 26725, 31, 44811),
    ]
    rows = [r + (None, "NoTwoLeaders") for r in verified] \
        + [r + (INV7,) for r in faithful]
    for (name, n, v, spec, (mt, ml, mm), stanza, extra, want_n,
         want_d, want_t, invs) in rows:
        tag = "".join(c for c in f"v{n}{v}{spec}{stanza}{''.join(extra)}"
                      if c.isalnum())
        cfg = write_cfg(tag, n, v, invs, stanza)
        big = want_n > 1_000_000
        t0 = time.monotonic()
        code, _eng, res, out = run_cli([
            cfg, "--spec", spec, "--max-term", str(mt), "--max-log", str(ml),
            "--max-msgs", str(mm), "--chunk", str(MAIN_CHUNK if big else 4096),
            "--cap", str(1 << 23 if big else 1 << 18), *extra])
        wall = time.monotonic() - t0
        got = (res.n_states, res.diameter, res.n_transitions) if res else None
        say(f"phase 3: {name}: exit {code}, states/diameter/transitions "
            f"{got} (verified {want_n}/{want_d if want_d else '-'}/"
            f"{want_t if want_t else '-'}), {wall:.2f} s")
        if code != 0 or got is None or got[0] != want_n \
                or (want_d is not None and got[1] != want_d) \
                or (want_t is not None and got[2] != want_t):
            fail(f"{name}: {out[-400:]}")
    seeded_violation(())
    seeded_violation(("Server",))
    seeded_violation((), faithful=True)
    cfg = write_cfg("deadlock1s", 1, 1, "NoTwoLeaders")
    code, _e, res, out = run_cli([cfg, "--spec", "election", "--deadlock",
                                  "--max-term", "2", "--max-log", "0",
                                  "--max-msgs", "2"])
    say(f"phase 3: 1-server election --deadlock: exit {code}")
    if code != check.EXIT_DEADLOCK or "Deadlock reached" not in out:
        fail(f"deadlock: {out[-400:]}")
    expression_violation()
    other_engines(rows, results)
    device_stats()


def expression_violation() -> None:
    """``count(role = 2) <= 1`` as a cfg expression: the registry
    ``NaiveNoTwoLeaders``'s violation, state for state, named by its
    text."""
    argv = ["--spec", "election", "--max-term", "3", "--max-log", "0",
            "--max-msgs", "1", "--chunk", "1024", "--cap", str(1 << 22)]
    runs = []
    for inv in ("NaiveNoTwoLeaders", "count(role = 2) <= 1"):
        cfg = write_cfg("expr" if "(" in inv else "naive", 3, 1, inv)
        code, _e, res, out = run_cli([cfg, *argv])
        runs.append((code, res, out))
    (c1, r1, _o1), (c2, r2, o2) = runs
    same = r1.violation is not None and r2.violation is not None \
        and r1.violation.trace == r2.violation.trace
    named = "Error: Invariant count(role = 2) <= 1 is violated." in o2
    say(f"phase 3: count(role = 2) <= 1 as a cfg expression: exit {c2} "
        f"after {r2.n_states} states (NaiveNoTwoLeaders: exit {c1} after "
        f"{r1.n_states}); traces equal state for state: {same} "
        f"({len(r2.violation.trace) if r2.violation else 0} states); "
        f"the verdict names the expression: {named}")
    if c1 != c2 or c2 != 12 or not same or not named \
            or r1.n_states != r2.n_states:
        fail("the expression violation differs from the registry one")


def other_engines(rows, results) -> None:
    """``--engine ref`` and ``--engine host`` on the verified
    configurations under 10^5 states (the oracle on a cheap subset: its
    orbit keys cost milliseconds a state), then the seeded violation."""
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.engine import Engine
    from raft_tla_tpu_torch.models import interp, refbfs, spec as SP
    from raft_tla_tpu_torch.ops import kernels, pallas_fp, pallas_step
    from raft_tla_tpu_torch.ops import msgbits as mb
    t0 = time.monotonic()
    pallas_step.launches = pallas_fp.launches = kernels.calls = 0
    ref_names = ("election 2s/1v t2 l0 m2", "full 2s/2v t2 l1 m2",
                 "election 2s/1v t2 l0 m2, SYMMETRY Server")
    for (name, n, v, spec, (mt, ml, mm), stanza, extra, want_n,
         want_d, want_t, invs) in rows:
        if want_n >= 100_000:
            continue
        tag = "".join(c for c in f"v{n}{v}{spec}{stanza}{''.join(extra)}"
                      if c.isalnum())
        cfg = write_cfg(tag, n, v, invs, stanza)
        for engine in ("host", "ref") if name in ref_names else ("host",):
            t1 = time.monotonic()
            code, _eng, res, out = run_cli([
                cfg, "--spec", spec, "--max-term", str(mt), "--max-log",
                str(ml), "--max-msgs", str(mm), "--chunk", "4096",
                "--engine", engine, *extra])
            got = (res.n_states, res.diameter, res.n_transitions) \
                if res else None
            say(f"phase 3: --engine {engine}, {name}: exit {code}, "
                f"states/diameter/transitions {got}, "
                f"{time.monotonic() - t1:.2f} s")
            if code != 0 or got is None or got[0] != want_n \
                    or (want_d is not None and got[1] != want_d) \
                    or (want_t is not None and got[2] != want_t):
                fail(f"--engine {engine}, {name}: {out[-400:]}")
    b = Bounds(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)
    start = interp.init_state(b)._replace(
        role=(SP.LEADER, SP.FOLLOWER, SP.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=(((mb.rv_response(3, 1, 1, 2)), 1),))
    cfgv = CheckConfig(bounds=b, spec="election",
                       invariants=("NaiveNoTwoLeaders",), chunk=256)
    want = refbfs.check(cfgv, init_override=start)
    got = Engine(cfgv).check(init_override=start)
    same = got.violation is not None and want.violation is not None \
        and got.violation.trace == want.violation.trace \
        and (got.n_states, got.levels, got.n_transitions) == \
        (want.n_states, want.levels, want.n_transitions)
    launches = {"step": pallas_step.launches,
                "fingerprint": pallas_fp.launches,
                "plain step": kernels.calls}
    say(f"phase 3: seeded NaiveNoTwoLeaders violation, --engine host on "
        f"the card against the oracle: states {got.n_states}, trace of "
        f"{len(got.violation.trace) if got.violation else 0} states, equal "
        f"to the oracle's: {same}; the host engine's runs: K1 launches "
        f"{launches['step']}, K2 launches {launches['fingerprint']}, plain "
        f"step calls {launches['plain step']}; "
        f"{time.monotonic() - t0:.1f} s")
    if not same:
        fail("the host engine's seeded violation differs from the oracle's")
    if launches["step"] < 1 or launches["plain step"]:
        fail(f"the host engine did not run on K1 alone: {launches}")
    results["launches_phase3_host"] = launches


def device_stats() -> None:
    """``--stats`` on the device engine: one line per segment, the
    reference's progress fields."""
    err = io.StringIO()
    cfg = write_cfg("stats", 2, 2, "NoTwoLeaders")
    code, eng, res, out = run_cli([
        cfg, "--spec", "full", "--max-term", "2", "--max-log", "1",
        "--max-msgs", "2", "--chunk", "64", "--stats"], err)
    lines = [json.loads(ln) for ln in err.getvalue().splitlines()
             if ln.startswith("{")]
    want = {"wall_s", "n_states", "level", "n_transitions", "dedup_hit_rate",
            "states_per_sec", "inc_states_per_sec", "since_resume",
            "coverage", "inv_evals"}
    keys_ok = bool(lines) and all(
        want <= set(d) <= set(PROGRESS_FIELDS) for d in lines)
    segs = eng.stats.get("segments", 0) if eng else 0
    say(f"phase 3: --stats --engine device: exit {code}, {len(lines)} "
        f"lines for {segs} segments of {eng.stats['chunks'] if eng else 0} "
        f"chunks, keys {sorted(lines[-1]) if lines else None} among the "
        f"reference's fields: {keys_ok}; last line n_states "
        f"{lines[-1]['n_states'] if lines else None}")
    if code != 0 or not keys_ok or len(lines) != segs \
            or (lines[-1]["n_states"], res.n_states) != (74897, 74897):
        fail("--stats on the device engine")


def audit_store(eng, n_states: int, label: str) -> None:
    """The stored rows' raw keys by K2 equal the plain version's, are
    pairwise distinct, and are as many as the states counted."""
    from raft_tla_tpu_torch.ops import fingerprint as fpr, pallas_fp
    store = eng.carry["store"][:n_states]
    consts = fpr.torch_constants(store.shape[1], store.device)
    keys, bad = [], 0
    for s in range(0, store.shape[0], 1 << 21):
        blk = store[s:s + (1 << 21)]
        hi, lo = pallas_fp.fingerprint_rows(blk)
        rh, rl = fpr.fingerprint(blk, consts)
        bad += int(((hi != rh) | (lo != rl)).sum())
        keys.append(hi.to(torch.int64) * (1 << 32)
                    + (lo.to(torch.int64) & 0xFFFFFFFF))
    k = torch.sort(torch.cat(keys)).values
    del keys
    dup = int((k[1:] == k[:-1]).sum())
    say(f"{label}: store audit with K2: {k.numel()} rows, mismatches {bad}, "
        f"duplicate keys {dup}")
    if bad or dup or k.numel() != n_states:
        fail(f"{label}: store audit")


def drive(argv, label: str, err=None) -> tuple:
    """One run of the main path through the CLI, the launch counts set to
    0 just before it and read just after: ``(code, eng, res, out, wall,
    launches)``."""
    from raft_tla_tpu_torch.ops import kernels, pallas_fp, pallas_step
    from raft_tla_tpu_torch.ops import symmetry as sym
    pallas_step.launches = 0
    pallas_fp.launches = 0
    sym.plain_calls = 0
    kernels.calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    code, eng, res, out = run_cli(argv, err)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"step": pallas_step.launches,
                "fingerprint": pallas_fp.launches,
                "plain orbit key": sym.plain_calls,
                "plain step": kernels.calls}
    if res is None:
        fail(f"{label}: {out[-600:]}")
    return code, eng, res, out, wall, launches


def report_run(label: str, eng, res, wall: float, launches: dict) -> None:
    st = eng.stats
    chunks = st["chunks"]
    say(f"{label}: wall {wall:.2f} s, {res.n_states / wall:,.0f} states/s; "
        f"chunks {chunks}, K1 launches {launches['step']}, K2 launches "
        f"{launches['fingerprint']}, plain orbit-key calls "
        f"{launches['plain orbit key']}, plain step calls "
        f"{launches['plain step']}; K1 {1e3 * st['step_s'] / chunks:.4f} "
        f"ms/chunk, dedup {1e3 * st['dedup_s'] / chunks:.3f} ms/chunk; "
        f"host syncs "
        f"{st['syncs'] / chunks:.2f}/chunk; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase4(results):
    cfg = write_cfg("real-expr", REAL["servers"], REAL["values"],
                    REAL_EXPR_INVARIANTS)
    argv = [cfg, "--spec", "full", "--max-term", str(REAL["max_term"]),
            "--max-log", str(REAL["max_log"]), "--max-msgs",
            str(REAL["max_msgs"]), "--chunk", str(MAIN_CHUNK),
            "--cap", str(1 << 25), "--levels", "128"]
    code, eng, res, out, wall, launches = drive(argv, "real-size run")
    got = (res.n_states, res.diameter, res.n_transitions)
    say(f"phase 4: real size full 3s/2v t2 l1 m1, invariants "
        f"{', '.join(eng.config.invariants)}: exit {code}; states "
        f"{got[0]}, diameter {got[1]}, transitions {got[2]} (expected "
        f"{REAL_EXPECT}); K1 runs its orbit loop at |G| = 1 and the "
        f"expression stage on every valid lane; wall {wall:.2f} s, without "
        f"the expression {REAL_WALL_NO_EXPR} s, before the dedup-key stage "
        f"{REAL_WALL_BEFORE[0]}-{REAL_WALL_BEFORE[1]} s")
    report_run("phase 4", eng, res, wall, launches)
    if code != 0 or got != REAL_EXPECT:
        fail("real-size counts differ from the reference")
    if launches["step"] < 1 or launches["fingerprint"] < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    audit_store(eng, res.n_states, "phase 4")
    results["launches_phase4"] = launches


def flagship_levels() -> list:
    line = FLAGSHIP_OUT.read_text().splitlines()[1]
    return json.loads(line)["levels"]


def phase5(results):
    want_levels = flagship_levels()
    want = (94_396_461, 57, 258_131_266)
    argv = [str(FLAGSHIP_CFG), *FLAGSHIP_ARGS]
    code, eng, res, out, wall, launches = drive(argv, "flagship run")
    got = (res.n_states, res.diameter, res.n_transitions)
    say(f"phase 5: flagship {FLAGSHIP_CFG.name} {' '.join(FLAGSHIP_ARGS)}: "
        f"exit {code}; orbits {got[0]}, diameter {got[1]}, transitions "
        f"{got[2]} (expected {want}); levels equal to "
        f"{FLAGSHIP_OUT.name}: {res.levels == want_levels}")
    report_run("phase 5", eng, res, wall, launches)
    if code != 0 or got != want or res.levels != want_levels:
        fail("flagship counts differ from the reference")
    if launches["step"] < 1 or launches["plain orbit key"] != 0:
        fail(f"the flagship run did not key through K1: {launches}")
    audit_store(eng, res.n_states, "phase 5")
    results["launches_phase5"] = launches
    results["flagship_wall"] = wall


def level_rows(store, levels: list, n: int) -> torch.Tensor:
    """Up to ``n`` rows of a finished store, evenly spaced within every BFS
    level (``levels[k]`` rows at level k, in store order)."""
    per = max(1, n // len(levels))
    idx, start = [], 0
    for cnt in levels:
        k = min(per, cnt)
        idx.append(torch.linspace(start, start + cnt - 1, k,
                                  dtype=torch.float64).long())
        start += cnt
    return store[torch.cat(idx).to(store.device)].clone()


def k1_on_levels(eng, res, label: str) -> None:
    """K1 against the plain step on rows from every level of a run."""
    from raft_tla_tpu_torch.ops import kernels, pallas_step
    cfg = eng.config
    rows = level_rows(eng.carry["store"], res.levels, MAIN_CHUNK)
    args = (cfg.bounds, cfg.spec, tuple(cfg.invariants))
    out = pallas_step.build_step(*args, rows.device,
                                 symmetry=tuple(cfg.symmetry),
                                 view=cfg.view)(rows)
    ref = kernels.build_step(*args, tuple(cfg.symmetry), cfg.view)(rows)
    torch.cuda.synchronize()
    bad, err = compare_step(out, ref)
    say(f"{label}: K1 against the plain step on {rows.shape[0]} rows from "
        f"all {len(res.levels)} levels: valid {int(ref['valid'].sum())}, "
        f"mismatches {bad}, max_abs_err {err}")
    if bad:
        fail(f"{label}: K1 disagrees with the plain step")


def phase6(results):
    """The phase-4 universe in faithful mode, with and without symmetry."""
    from raft_tla_tpu_torch.ops import symmetry as sym
    base = ["--spec", "full", "--faithful", "--max-term",
            str(REAL["max_term"]), "--max-log", str(REAL["max_log"]),
            "--max-msgs", str(REAL["max_msgs"]), "--chunk", str(MAIN_CHUNK),
            "--levels", "128"]
    cfg = write_cfg("real-faithful-sym", REAL["servers"], REAL["values"],
                    INV7, "Server Value")
    code, eng, res, out, wall, launches = drive(
        [cfg, *base, "--cap", str(1 << 22)], "faithful symmetric run")
    got = (res.n_states, res.diameter, res.n_transitions)
    say(f"phase 6: faithful full 3s/2v t2 l1 m1, seven invariants, SYMMETRY "
        f"Server Value: exit {code}; orbits {got[0]}, diameter {got[1]}, "
        f"transitions {got[2]} (expected {FAITHFUL_SYM_EXPECT})")
    report_run("phase 6 (Server x Value)", eng, res, wall, launches)
    if code != 0 or got != FAITHFUL_SYM_EXPECT:
        fail("faithful symmetric counts differ from the reference")
    if launches["step"] < 1 or launches["plain orbit key"] \
            or launches["plain step"]:
        fail(f"the faithful symmetric run did not go through K1: {launches}")
    audit_store(eng, res.n_states, "phase 6 (Server x Value)")
    results["launches_phase6_sym"] = launches
    # Each representative's orbit size, summed per level.
    t0 = time.monotonic()
    store, sums, start = eng.carry["store"], [], 0
    for cnt in res.levels:
        tot = 0
        for a in range(start, start + cnt, 1 << 16):
            blk = store[a:min(a + (1 << 16), start + cnt)]
            tot += int(sym.orbit_sizes(blk, eng.bounds,
                                       ("Server", "Value")).sum())
        sums.append(tot)
        start += cnt
    say(f"phase 6: orbit sizes of the {res.n_states} representatives (plain "
        f"permutation, exact rows) summed per level: {sum(sums)} states in "
        f"{len(sums)} levels, {time.monotonic() - t0:.1f} s")
    del eng, store
    torch.cuda.empty_cache()

    cfg = write_cfg("real-faithful", REAL["servers"], REAL["values"], INV7)
    code, eng, res, out, wall, launches = drive(
        [cfg, *base, "--cap", str(1 << 25)], "faithful real-size run")
    got = (res.n_states, res.diameter, res.n_transitions)
    say(f"phase 6: faithful full 3s/2v t2 l1 m1, seven invariants, no "
        f"symmetry: exit {code}; states {got[0]}, diameter {got[1]}, "
        f"transitions {got[2]}; levels equal to the orbit sums: "
        f"{res.levels == sums}")
    report_run("phase 6", eng, res, wall, launches)
    if code != 0 or res.levels != sums or res.diameter != \
            FAITHFUL_SYM_EXPECT[1]:
        fail("faithful real-size levels differ from the orbit sums")
    if launches["step"] < 1 or launches["fingerprint"] < 1 \
            or launches["plain step"]:
        fail(f"a kernel of the faithful path never launched: {launches}")
    audit_store(eng, res.n_states, "phase 6")
    k1_on_levels(eng, res, "phase 6")
    results["launches_phase6"] = launches
    results["faithful_real"] = got


def phase7(results):
    """The faithful flagship: runs/MC3s2v.cfg --faithful."""
    argv = [str(FLAGSHIP_CFG), *FAITHFUL_FLAGSHIP_ARGS]
    code, eng, res, out, wall, launches = drive(argv, "faithful flagship")
    got = (res.n_states, res.diameter, res.n_transitions)
    say(f"phase 7: faithful flagship {FLAGSHIP_CFG.name} "
        f"{' '.join(FAITHFUL_FLAGSHIP_ARGS)}: exit {code}; orbits {got[0]}, "
        f"diameter {got[1]}, transitions {got[2]}; levels {res.levels}")
    report_run("phase 7", eng, res, wall, launches)
    if code != 0:
        fail(f"faithful flagship: {out[-600:]}")
    if launches["step"] < 1 or launches["plain orbit key"] \
            or launches["plain step"]:
        fail(f"the faithful flagship did not key through K1: {launches}")
    audit_store(eng, res.n_states, "phase 7")
    k1_on_levels(eng, res, "phase 7")
    results["launches_phase7"] = launches


def profile_window(label: str, argv: list, skip: int, window: int) -> None:
    """``window`` chunks of the CLI run ``argv``, after its first ``skip``,
    under torch.profiler: the card's time by kernel, K1's per chunk, and
    the card's idle share of the window's wall (host clock, synchronised;
    the kernels run on one stream, so their times add up to the busy
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from raft_tla_tpu_torch import check
    from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
    args = check.build_argparser().parse_args([str(a) for a in argv])
    eng = DeviceEngine(check.config_of(args),
                       Capacities(n_states=args.cap, levels=args.levels))
    eng.check(max_chunks=skip)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng._run(max_chunks=window)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev[e.key] = e.self_device_time_total / 1e3       # ms
    busy = sum(dev.values())
    if not dev:
        say(f"{label}: the profiler showed no device time (not measured)")
        return
    k1 = sum(t for k, t in dev.items() if "step_kernel" in k)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    say(f"{label}: chunks {skip}-{skip + window - 1}, wall "
        f"{wall / window:.4f} ms/chunk, card busy {busy / window:.4f} "
        f"ms/chunk, idle share {1 - busy / wall:.4f}; K1 kernel "
        f"{k1 / window:.4f} ms/chunk; top kernels (ms/chunk): " + "; ".join(
            f"{k[:60]} {t / window:.4f}" for k, t in top))
    del eng
    torch.cuda.empty_cache()


def phase8() -> None:
    """The flagship and the faithful flagship, mid-run, profiled."""
    profile_window("phase 8: phase 5's run", [FLAGSHIP_CFG, *FLAGSHIP_ARGS],
                   3000, 300)
    profile_window("phase 8: phase 7's run",
                   [FLAGSHIP_CFG, *FAITHFUL_FLAGSHIP_ARGS], 5000, 300)


def host_rss_gib() -> float:
    """Peak resident memory of this process so far (GiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def report_ddd(label: str, eng, res, wall: float, launches: dict) -> dict:
    """The DDD engine's per-run numbers (``eng.stats``) on one line."""
    st = eng.stats
    chunks = max(1, st["chunks"])
    row = dict(wall=wall, rate=res.n_states / wall, segments=st["segments"],
               chunks=st["chunks"], syncs_per_chunk=st["syncs"] / chunks,
               k1_ms=1e3 * st["step_s"] / chunks,
               filter_ms=1e3 * st["filter_s"] / chunks,
               d2h_bytes=st["d2h_bytes"], flush_s=st["flush_s"],
               flush_wait_s=st["flush_wait_s"],
               peak_dev_gib=torch.cuda.max_memory_allocated() / 2**30,
               peak_rss_gib=host_rss_gib(), launches=launches["step"])
    say(f"{label}: wall {wall:.2f} s, {row['rate']:,.0f} states/s; "
        f"segments {row['segments']}, chunks {row['chunks']}, host syncs "
        f"{row['syncs_per_chunk']:.3f}/chunk; K1 {row['k1_ms']:.4f} "
        f"ms/chunk, filter {row['filter_ms']:.4f} ms/chunk (CUDA events); "
        f"copied to the host {row['d2h_bytes']} bytes; host flush "
        f"{row['flush_s']:.2f} s, of it {row['flush_wait_s']:.2f} s on or "
        f"waited for by the main loop; K1 launches {launches['step']}, K2 "
        f"launches {launches['fingerprint']}, plain step calls "
        f"{launches['plain step']}, plain orbit-key calls "
        f"{launches['plain orbit key']}; peak device memory "
        f"{row['peak_dev_gib']:.2f} GiB, peak host RSS so far "
        f"{row['peak_rss_gib']:.2f} GiB")
    if launches["step"] != st["chunks"] or launches["plain step"] \
            or launches["plain orbit key"]:
        fail(f"{label}: K1 did not run every chunk alone: {launches}, "
             f"{st['chunks']} chunks")
    return row


def phase9(results):
    """The flagship through the DDD engine."""
    want_levels = flagship_levels()
    want = (94_396_461, 57, 258_131_266)
    argv = [str(FLAGSHIP_CFG), *FLAGSHIP_ARGS, "--engine", "ddd"]
    code, eng, res, out, wall, launches = drive(argv, "DDD flagship run")
    got = (res.n_states, res.diameter, res.n_transitions)
    say(f"phase 9: flagship {FLAGSHIP_CFG.name} {' '.join(FLAGSHIP_ARGS)} "
        f"--engine ddd: exit {code}; orbits {got[0]}, diameter {got[1]}, "
        f"transitions {got[2]} (expected {want}); levels equal to "
        f"{FLAGSHIP_OUT.name}: {res.levels == want_levels}")
    results["ddd_phase9"] = report_ddd("phase 9", eng, res, wall, launches)
    if code != 0 or got != want or res.levels != want_levels:
        fail("DDD flagship counts differ from the reference")
    results["launches_phase9"] = launches


def audit_level_files(prefix: str, schema, n_states: int,
                      label: str) -> int:
    """The rows of every level file, unpacked on the card, hash with K2 to
    the ``.keys`` log bit for bit (and K2 equals the plain fingerprint);
    the keys are pairwise distinct and as many as counted.  Returns K2's
    launches."""
    from raft_tla_tpu_torch.ops import fingerprint as fpr, pallas_fp
    # by size: a run that ends closes its files without a final header
    keys = np.fromfile(prefix + ".keys", np.int32, offset=16).reshape(-1, 2)
    rows, i = [], 1
    while Path(f"{prefix}.rowsL{i}").exists():
        rows.append(np.fromfile(f"{prefix}.rowsL{i}", np.int32,
                                offset=16).reshape(-1, schema.P))
        i += 1
    rows = np.concatenate(rows)
    if rows.shape[0] != n_states or keys.shape[0] != n_states:
        fail(f"{label}: level files hold {rows.shape[0]} rows and the key "
             f"log {keys.shape[0]} keys for {n_states} states")
    pallas_fp.launches = 0
    consts = fpr.torch_constants(schema.W, DEV)
    bad = off = 0
    for a in range(0, n_states, 1 << 21):
        vec = schema.unpack(torch.as_tensor(rows[a:a + (1 << 21)],
                                            device=DEV), torch)
        hi, lo = pallas_fp.fingerprint_rows(vec)
        rh, rl = fpr.fingerprint(vec, consts)
        k = torch.as_tensor(keys[a:a + (1 << 21)], device=DEV)
        bad += int(((hi != rh) | (lo != rl)).sum())
        off += int(((hi != k[:, 1]) | (lo != k[:, 0])).sum())
    k64 = np.sort(keys.view(np.uint64).ravel())
    dup = int((k64[1:] == k64[:-1]).sum())
    n_k2 = pallas_fp.launches
    say(f"{label}: key-log audit with K2: {n_states} rows of {i - 1} level "
        f"files, K2 against the plain fingerprint mismatches {bad}, keys "
        f"differing from the log {off}, duplicate keys {dup}, K2 launches "
        f"{n_k2}")
    if bad or off or dup:
        fail(f"{label}: key-log audit")
    return n_k2


def real_argv(*extra) -> list:
    cfg = write_cfg("real", REAL["servers"], REAL["values"],
                    REAL["invariants"])
    return [cfg, "--spec", "full", "--max-term", str(REAL["max_term"]),
            "--max-log", str(REAL["max_log"]), "--max-msgs",
            str(REAL["max_msgs"]), "--chunk", str(MAIN_CHUNK), "--cap",
            str(1 << 25), "--levels", "128", "--engine", "ddd", *extra]


def clear_snapshot(prefix: Path) -> None:
    prefix.parent.mkdir(parents=True, exist_ok=True)
    for f in prefix.parent.glob(prefix.name + "*"):
        f.unlink()


def phase10(results):
    """Phase 4's universe through DDD in frontier retention, every level
    file kept, then the key-log audit with K2."""
    prefix = WORK / "p10"
    clear_snapshot(prefix)
    code, eng, res, out, wall, launches = drive(
        real_argv("--retention", "frontier", "--keep-levels",
                  "--checkpoint", str(prefix)), "DDD frontier run")
    got = (res.n_states, res.diameter, res.n_transitions)
    say(f"phase 10: full 3s/2v t2 l1 m1 --engine ddd --retention frontier "
        f"--keep-levels: exit {code}; states {got[0]}, diameter {got[1]}, "
        f"transitions {got[2]} (expected {REAL_EXPECT})")
    results["ddd_phase10"] = report_ddd("phase 10", eng, res, wall,
                                        launches)
    if code != 0 or got != REAL_EXPECT:
        fail("DDD frontier counts differ from the reference")
    results["launches_phase10"] = launches
    # the audit runs after the path: its K2 launches are its own key
    results["audit_launches_phase10"] = {
        "step": 0, "fingerprint": audit_level_files(
            str(prefix), eng.schema, res.n_states, "phase 10")}
    clear_snapshot(prefix)


def phase11():
    """Violation and deadlock traces against the device engine's; a
    deadline stop and its resume."""
    from raft_tla_tpu_torch import check
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
    from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
    from raft_tla_tpu_torch.engine import DEADLOCK
    from raft_tla_tpu_torch.models import interp, spec as SP
    from raft_tla_tpu_torch.ops import msgbits as mb
    b = Bounds(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)
    start = interp.init_state(b)._replace(
        role=(SP.LEADER, SP.FOLLOWER, SP.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=(((mb.rv_response(3, 1, 1, 2)), 1),))
    b1 = Bounds(n_servers=1, n_values=1, max_term=2, max_log=0, max_msgs=2)
    cases = [
        ("seeded NaiveNoTwoLeaders", CheckConfig(
            bounds=b, spec="election", invariants=("NaiveNoTwoLeaders",),
            chunk=256), start, "NaiveNoTwoLeaders"),
        ("1-server election --deadlock", CheckConfig(
            bounds=b1, spec="election", invariants=("NoTwoLeaders",),
            chunk=256, check_deadlock=True), None, DEADLOCK)]
    for name, cfg, init, want in cases:
        ref = DeviceEngine(cfg, Capacities(n_states=1 << 15, levels=64)
                           ).check(init_override=init).violation
        A = len(SP.action_table(cfg.bounds, cfg.spec))
        counts = []
        for retention in ("full", "frontier"):
            prefix = WORK / f"p11-{retention}"
            clear_snapshot(prefix)
            eng = DDDEngine(cfg, DDDCapacities(
                table=1 << 16, seg_rows=max(1 << 19, 2 * cfg.chunk * A),
                levels=64, retention=retention,
                keep_levels=retention == "frontier"))
            res = eng.check(init_override=init, checkpoint=str(prefix))
            v = res.violation
            same = v is not None and v.invariant == want == ref.invariant \
                and v.trace == ref.trace
            counts.append(res.n_states)
            say(f"phase 11: {name}, {retention} retention: "
                f"{v.invariant if v else None} after {res.n_states} "
                f"states, trace of {len(v.trace) if v else 0} states equal "
                f"to the device engine's: {same}")
            if not same:
                fail(f"{name}: the DDD trace differs ({retention})")
            clear_snapshot(prefix)
        if counts[0] != counts[1]:
            fail(f"{name}: the two retentions stop at {counts}")
    prefix = WORK / "p11-deadline"
    clear_snapshot(prefix)
    snap = ["--retention", "frontier", "--checkpoint", str(prefix)]
    t0 = time.monotonic()
    code, _e, res, out = run_cli(real_argv(*snap, "--deadline",
                                           str(STOP_DEADLINE)))
    part = (res.n_states, res.complete) if res else None
    code2, _e, res2, out2 = run_cli(real_argv(*snap, "--resume",
                                              str(prefix)))
    got = (res2.n_states, res2.diameter, res2.n_transitions) if res2 \
        else None
    say(f"phase 11: phase 10's universe, --deadline {STOP_DEADLINE:g}: "
        f"exit {code} at "
        f"{part}; --resume: exit {code2}, {got} (expected {REAL_EXPECT}); "
        f"{time.monotonic() - t0:.1f} s")
    if code != check.EXIT_STOPPED or part is None or part[1] \
            or code2 != 0 or got != REAL_EXPECT:
        fail("deadline stop and resume: " + out[-300:] + out2[-300:])
    clear_snapshot(prefix)


def phase12(results):
    """The 5-server election through DDD, against the JAX campaign's
    per-level counts."""
    err = io.StringIO()
    argv = [str(ELECT5_CFG), *ELECT5_ARGS, "--deadline",
            str(ELECT5_DEADLINE)]
    code, eng, res, out, wall, launches = drive(argv, "elect5 run", err)
    lines = [json.loads(ln) for ln in err.getvalue().splitlines()
             if ln.startswith("{")]
    ends = {}
    for d in lines:
        ends[d["level"]] = d["n_states"]
    done = [lv for lv in sorted(ends) if lv + 1 in ends
            or (res.complete and lv == max(ends))]
    bad = [(lv, ends[lv], ELECT5_LEVEL_ENDS.get(lv)) for lv in done
           if ends[lv] != ELECT5_LEVEL_ENDS.get(lv)]
    walls = {d["level"]: d["wall_s"] for d in lines}
    by_level = [(lv, round((ends[lv] - ends[lv - 1])
                           / max(walls[lv] - walls[lv - 1], 1e-9)))
                for lv in done if lv - 1 in ends]
    say(f"phase 12: {ELECT5_CFG.name} {' '.join(ELECT5_ARGS)} --deadline "
        f"{ELECT5_DEADLINE:g}: exit {code}; {res.n_states} orbits, "
        f"levels completed {done[-1] if done else 0}, each equal to "
        f"runs/elect5ddd.stats: {not bad}; orbits/s by level "
        f"{by_level}")
    results["ddd_phase12"] = report_ddd("phase 12", eng, res, wall,
                                        launches)
    results["ddd_phase12"]["level"] = done[-1] if done else 0
    if code not in (0, 14) or bad or not done \
            or done[-1] < ELECT5_MIN_LEVEL:
        fail(f"elect5 levels differ or fell short: {bad}, {done[-1:]}")
    results["launches_phase12"] = launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    if not FLAGSHIP_CFG.exists() or not FLAGSHIP_OUT.exists():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    phases = [phase1, phase2, phase3, phase4, phase5, phase6, phase7,
              phase8, phase9, phase10, phase11, phase12]
    t_all = time.monotonic()
    card = phase0()
    results = {}
    for k, fn in enumerate(phases, 1):
        t0 = time.monotonic()
        fn(results) if fn.__code__.co_argcount else fn()
        say(f"phase {k} took {time.monotonic() - t0:.1f} s")
    results["step"]["max_abs_err"] = max(results["step"]["max_abs_err"],
                                         results.get("step_err", 0))
    # launches: the flagship's run (phase 5) for K1; for K2, which keys
    # Init only on runs without symmetry, the phase-4 run.
    results["step"]["launches"] = results["launches_phase5"]["step"]
    results["fingerprint"]["launches"] = \
        results["launches_phase4"]["fingerprint"]
    meta = {
        "step": ("cuda", "raft_tla_tpu_torch/csrc/step.cu",
                 "raft_tla_tpu/ops/pallas_step.py:131"),
        "fingerprint": ("cuda", "raft_tla_tpu_torch/csrc/fingerprint.cu",
                        "raft_tla_tpu/ops/pallas_fp.py:80"),
    }
    kernels = []
    for name, (route, src, repl) in meta.items():
        r = results[name]
        kernels.append({
            "name": name, "route": route, "source": src, "replaces": repl,
            "launches": r["launches"],
            # phase 4's K1 launches each ran the expression stage
            "launches_by_path": {
                {"phase4": "phase4_expression"}.get(path, path):
                    results[f"launches_{path}"][name]
                for path in ("phase3_host", "phase4", "phase5",
                             "phase6_sym", "phase6", "phase7", "phase9",
                             "phase10", "phase12")},
            "audit_launches": {
                "phase10": results["audit_launches_phase10"][name]},
            "mismatches": r["mismatches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    say(f"total {time.monotonic() - t_all:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
