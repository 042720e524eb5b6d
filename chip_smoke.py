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
   campaign (``runs/elect5ddd.stats``), level 20 at least;
13. liveness through the CLI (``--property EventuallyLeader``): 13a, the
   3-server election (t2 l0 m1) through the device engine's graph export
   (K2 over the store, K1 re-expansion), 142,538 states and 238,302 edges,
   holding under WF(Next) and refuted under ``--wf none`` (exit 13, the
   stutter at Init); 13b, the 4-server election under SYMMETRY Server
   (|G| = 24) through ``--engine ddd`` and the DDD graph export, 5,607,847
   orbits and 9,916,035 edges with the verdicts and SCC counts of
   ``runs/liveness_4s.out`` under WF(Next), no fairness and WF(Timeout);
   K2 and K1 against their plain versions on rows of the two universes.
   ``tools/liveness_run.py`` runs all six verdicts of that file and the
   raw graph of ``runs/liveness_2m.out``;
14. run events on phase 10's universe (frontier retention): 14a, one DDD
   run with the run-event log, the phase timers and trace spans (``--events
   --phase-timers --trace``, the host dedup pass at 2^18 candidates so the
   background flush thread takes batches), just after the same engine run
   without them (the timers' cost): phase 10's counts, every line valid,
   one ``run_end``, the last record of each level at phase 10's cumulative
   count and each ``level_end`` at the first record of the next level,
   each phase's total within the wall, the trace report attributing the
   main thread and ``raft-tla-flush``, and a Chrome trace export; 14b, the
   same universe as a supervised campaign under chaos (a snapshot at every
   window boundary, two SIGKILLs, a truncated snapshot quarantined and the
   previous generation restored), ending at phase 10's counts, with the K1
   launches each child reports.  ``tools/campaign_run.py`` runs elect5 as a
   campaign;
15. simulation on ``runs/MC3s2v.cfg`` without its SYMMETRY line at the
   CLI's default bounds (t3 l2 m4 d1, W = 72, A = 48): 15a, ``--simulate
   100000 --depth 100 --walkers 8192 --seed 7`` through the CLI (exit 0,
   one K1 launch a walker step, one host fetch a dispatch); 15b, two
   dispatches of 16 steps through K1 and through the plain step on the
   card, lane histories, walk lengths, rows and counts bit-equal, the
   draws equal on the card and the CPU, 256 walks replayed through the
   interpreter to their rows, and K1's time a step against the whole
   step's; 15c, the seeded NaiveNoTwoLeaders start (exit 12 in the first
   dispatch, the trace replays, two leaders) and the 1-server election
   with ``--deadlock`` (exit 11); 15d, the fleet at 1,024 walkers,
   unsteered its walks equal to those of 15a's first 1,024 walkers, then
   ``--steer 1.5 --fault-weights Restart=2,DropMessage=0.5`` through the
   CLI with a higher coverage entropy.  ``tools/simulate_run.py`` runs
   elect5 at up to 131,072 walkers;
16. the spec frontend: 16a, two-phase commit (``--spec twophase``, the
   schema step compiled from the action IR) at 7 RMs through ``--engine
   host --chunk 8192``: the JAX oracle's 296,448 states, diameter 22,
   2,744,705 transitions and levels, K2 launched once a chunk and neither
   K1 nor the plain fingerprint nor the plain step ever; then K2 against
   the plain fingerprint on one chunk's successor rows (W = 24, A = 37);
   16b, the seeded violations ``~(msgCommit = 1)`` at 3 RMs and
   ``~any(rmState = 2)`` at 2 RMs (exit 12, traces that replay through
   ``apply_instance`` and equal the CPU run's); 16c, the IR-compiled Raft
   step (``ir-full``, keyed by K2) against K1 on 8,192 reachable rows at
   phase 5's layout without symmetry, and ``ir-election`` through the
   host engine on phase 3's 3-server election, equal to ``election``;
   16d, ``--simulate 20000`` on twophase at 7 RMs with 8,192 walkers, the seeded
   violation found and replayed, and the fleet at 1,024 walkers walking
   the simulator's walks.  ``tools/twophase_run.py`` runs 8 RMs.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Tolerance everywhere: bit-exact (all
outputs are int32, uint32 bits or bools).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import resource
import shutil
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


# Phase 13: liveness.  13a, the 3-server election (t2 l0 m1) through the
# device engine's graph export: 142,538 states (tests/test_liveness.py:
# 198-213); its 238,302 edges and the 97,124 SCCs checked under WF(Next)
# come from the JAX package on the CPU, in 27 s:
#   JAX_PLATFORMS=cpu python -c "from raft_tla_tpu.config import Bounds,
#   CheckConfig; from raft_tla_tpu.device_engine import Capacities; from
#   raft_tla_tpu.models import liveness as L; c = CheckConfig(bounds=Bounds(
#   n_servers=3, n_values=1, max_term=2, max_log=0, max_msgs=1), spec=
#   'election', invariants=()); g = L.engine_graph(c, Capacities(n_states=
#   1 << 18, levels=64)); r = L.check(c, 'EventuallyLeader', graph=g);
#   print(g[1].n_edges, r.holds, r.n_sccs_checked)"
# (under no fairness: refuted, 1 SCC checked, the stutter at Init).  13b,
# the 4-server election under SYMMETRY Server (|G| = 24) through the DDD
# graph export at the reference's largest whole liveness check, against the
# orbits, edges and verdicts of runs/liveness_4s.out.
LIVE3_ARGS = ["--spec", "election", "--max-term", "2", "--max-log", "0",
              "--max-msgs", "1", "--chunk", str(MAIN_CHUNK), "--cap",
              str(1 << 18), "--levels", "64"]
LIVE3_EXPECT = (142_538, 238_302, 97_124)
LIVE4_ARGS = ["--spec", "election", "--max-term", "2", "--max-log", "0",
              "--max-msgs", "1", "--symmetry", "--engine", "ddd", "--chunk",
              str(MAIN_CHUNK), "--cap", "8000000", "--levels", "128"]
LIVE4_OUT = ROOT / "runs" / "liveness_4s.out"
# 13b's verdicts through the CLI (--wf values); tools/liveness_run.py runs
# all six of runs/liveness_4s.out
LIVE4_WF = ("Next", "none", "Timeout")

# Phase 14: the host dedup pass's size (the CLI's default is 2^23
# candidates, and 2^20 is still more than any level of phase 10's universe
# streams, so the background flush thread would never take a batch).
P14_FLUSH = 1 << 18

# Phase 15: simulation on runs/MC3s2v.cfg without SYMMETRY at the CLI's
# default bounds (t3 l2 m4 d1: servers, values, max_term, max_log,
# max_msgs), the layout key of phase 0's build list.
SIM_LAYOUT = (3, 2, 3, 2, 4)
SIM_INVARIANTS = ("NoTwoLeaders", "LogMatching", "CommittedWithinLog",
                  "LeaderCompleteness")
SIM_WALKERS = 8192
SIM_ARGS = ["--simulate", "100000", "--depth", "100", "--walkers",
            str(SIM_WALKERS), "--seed", "7"]
# 15d: at 1,024 walkers 50,000 behaviors take ~7 dispatches, so the
# steering (from the counts at each dispatch's start) acts on ~6 of them;
# walker g walks the same walk in a fleet of any size.
SIM_FLEET_BEHAVIORS = 50_000
SIM_FLEET_WALKERS = 1024

# Phase 16: two-phase commit at 7 RMs and the counts of the JAX package's
# oracle on the CPU (23 s):
#   JAX_PLATFORMS=cpu python -c "from raft_tla_tpu.frontend import twophase
#   as tp; r = tp.reference_check(7); print(r.n_states, r.diameter,
#   r.n_transitions, r.levels)"
TP_RMS = 7
TP_EXPECT = (296_448, 22, 2_744_705)
TP_LEVELS = [1, 15, 105, 462, 1456, 3570, 7259, 12861, 20449, 29372, 37772,
             42924, 42651, 36785, 27371, 17447, 9436, 4277, 1603, 490, 119,
             21, 2]
# 16c: phase 3's 3-server election (t2 l0 m1), its verified count and
# diameter.
IR_ELECTION = ((3, 1, 2, 0, 1), 142_538, 31)
# 16d: every twophase walk runs to the depth bound (terminal states keep
# self-loops), so 5,000 behaviors at 1,024 walkers are ~8 dispatches.
TP_FLEET_BEHAVIORS = 5000


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
               (3, 1, 3, 0, 4, 6), SIM_LAYOUT}
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
    results["levels_phase10"] = res.levels
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


def liveness_run(argv, label: str, wf: str) -> tuple:
    """One ``--property EventuallyLeader --wf WF`` run of the CLI: ``(code,
    eng, res, verdict, walls, launches)``; ``walls`` the search's, the
    graph build's (the rest of the run) and the verdict's seconds."""
    code, eng, res, out, wall, launches = drive(
        [*argv, "--property", "EventuallyLeader", "--wf", wf], label)
    if len(res.liveness) != 1:
        fail(f"{label}: exit {code}, no liveness verdict: {out[-600:]}")
    import re
    search = float(re.search(r"transitions, ([0-9.]+)s \(", out).group(1))
    verdict = float(re.search(r"^Property .*, ([0-9.]+)s\.$", out,
                              re.M).group(1))
    walls = (search, wall - search - verdict, verdict)
    return code, eng, res, res.liveness[0], walls, launches


def expect_lasso_at_init(v, bounds) -> bool:
    """A lasso that stutters at Init: prefix Init alone, cycle its stutter."""
    from raft_tla_tpu_torch.models import interp
    init = interp.init_state(bounds)
    return v is not None and v.prefix == [(None, init)] \
        and v.cycle == [("<stutter>", init)]


def export_kernels(label, config, rows, step_args, k2: bool) -> None:
    """K1 on chunks of stored rows, as the graph exports launch it, and
    with ``k2`` K2 over all of them, against their plain versions
    (bit-exact)."""
    from raft_tla_tpu_torch.ops import fingerprint as fpr, kernels
    from raft_tla_tpu_torch.ops import pallas_fp, pallas_step
    k2_bad = 0
    if k2:
        hi, lo = pallas_fp.fingerprint_rows(rows)
        rh, rl = fpr.fingerprint(rows, fpr.torch_constants(rows.shape[1],
                                                           rows.device))
        k2_bad = int(((hi != rh) | (lo != rl)).sum())
    b, spec = config.bounds, config.spec
    step = pallas_step.build_step(b, spec, (), rows.device, **step_args)
    plain = kernels.build_step(b, spec, (), step_args.get("symmetry", ()),
                               step_args.get("view"))
    n = rows.shape[0]
    starts = sorted({0, (n // MAIN_CHUNK // 2) * MAIN_CHUNK,
                     (n - 1) // MAIN_CHUNK * MAIN_CHUNK})
    k1_bad = valid = 0
    for c0 in starts:
        chunk = rows[c0:c0 + MAIN_CHUNK]
        out, ref = step(chunk), plain(chunk)
        torch.cuda.synchronize()
        bad, _ = compare_step(out, ref)
        k1_bad += bad
        valid += int(ref["valid"].sum())
    say(f"{label}: " + (f"K2 over {n} stored rows against the plain "
                        f"fingerprint: mismatches {k2_bad}; " if k2 else "")
        + f"K1 re-expansion chunks at rows {starts} of {n} ({valid} valid "
        f"lanes) against the plain step: mismatches {k1_bad}")
    if k1_bad or k2_bad:
        fail(f"{label}: a graph-export kernel disagrees with its plain "
             "version")


def phase13(results):
    """Liveness: 13a through the device engine's graph export (K2 over the
    store, K1 re-expansion), 13b through the DDD engine's under SYMMETRY."""
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
    cfg = write_cfg("live3", 3, 1, "NoTwoLeaders")
    rows13 = {}
    for wf in ("Next", "none"):
        code, eng, res, v, walls, launches = liveness_run(
            [cfg, *LIVE3_ARGS], f"13a --wf {wf}", wf)
        chunks = eng.stats["chunks"]
        reexp = -(-v.n_states // MAIN_CHUNK)
        got = (v.n_states, v.n_edges, v.n_sccs_checked)
        say(f"phase 13a: 3-server election t2 l0 m1, EventuallyLeader under "
            f"--wf {wf}: exit {code}, holds {v.holds}, states/edges/SCCs "
            f"checked {got}; walls: search {walls[0]:.2f} s, graph build "
            f"{walls[1]:.2f} s, verdict {walls[2]:.2f} s; K1 launches "
            f"{launches['step']} (2 x {chunks} search chunks + {reexp} "
            f"re-expansion), K2 launches {launches['fingerprint']}, plain "
            f"step calls {launches['plain step']}")
        want_ok = got == LIVE3_EXPECT and v.holds and code == 0 \
            if wf == "Next" else (v.n_states, v.n_edges) == \
            LIVE3_EXPECT[:2] and not v.holds and code == 13 \
            and v.n_sccs_checked == 1 \
            and expect_lasso_at_init(v.violation, eng.config.bounds)
        if not want_ok or res.n_states != LIVE3_EXPECT[0]:
            fail(f"13a --wf {wf}: {code}, {v.holds}, {got}")
        if launches["step"] != 2 * chunks + reexp \
                or launches["fingerprint"] != 3 or launches["plain step"]:
            fail(f"13a: the export did not run through K1 and K2: "
                 f"{launches}")
        results[f"launches_phase13a_{wf}"] = launches
        rows13[wf] = walls
    results["launches_phase13a"] = results["launches_phase13a_Next"]
    results["live13a"] = rows13
    b = Bounds(n_servers=3, n_values=1, max_term=2, max_log=0, max_msgs=1)
    config = CheckConfig(bounds=b, spec="election", invariants=(),
                         chunk=MAIN_CHUNK)
    eng = DeviceEngine(config, Capacities(n_states=1 << 18, levels=64))
    res = eng.check(retain_carry=True)
    export_kernels("phase 13a", config,
                   eng.retained_carry["store"][:res.n_states].clone(), {},
                   k2=True)
    del eng

    want = {(d["prop"], tuple(d["wf"])): d
            for d in map(json.loads, LIVE4_OUT.read_text().splitlines())
            if "prop" in d}
    graph = json.loads(LIVE4_OUT.read_text().splitlines()[0])
    cfg = write_cfg("live4", 4, 1, "NoTwoLeaders")
    rows13 = {}
    for wf in LIVE4_WF:
        code, eng, res, v, walls, launches = liveness_run(
            [cfg, *LIVE4_ARGS], f"13b --wf {wf}", wf)
        w = want["EventuallyLeader", () if wf == "none" else (wf,)]
        chunks = eng.stats["chunks"]
        reexp = -(-v.n_states // MAIN_CHUNK)
        got = (v.n_states, v.n_edges, v.holds, v.n_sccs_checked)
        say(f"phase 13b: 4-server election t2 l0 m1, SYMMETRY Server, "
            f"--engine ddd, EventuallyLeader under --wf {wf}: exit {code}; "
            f"orbits/edges/holds/SCCs checked {got} (runs/liveness_4s.out: "
            f"{(w['n_states'], w['n_edges'], w['holds'], w['n_sccs_checked'])}"
            f"); walls: search {walls[0]:.2f} s, graph build {walls[1]:.2f} "
            f"s, verdict {walls[2]:.2f} s (JAX on the CPU: graph "
            f"{graph['wall_s']} s, verdict {w['wall_s']} s); K1 launches "
            f"{launches['step']} (search chunks {chunks} a run, "
            f"re-expansion {reexp}), K2 launches "
            f"{launches['fingerprint']}, plain step calls "
            f"{launches['plain step']}, plain orbit-key calls "
            f"{launches['plain orbit key']}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, peak host "
            f"RSS so far {host_rss_gib():.2f} GiB")
        if got != (w["n_states"], w["n_edges"], w["holds"],
                   w["n_sccs_checked"]) or res.n_states != w["n_states"] \
                or code != (0 if w["holds"] else 13):
            fail(f"13b --wf {wf}: counts or verdict differ from "
                 f"{LIVE4_OUT.name}")
        if launches["step"] != 2 * chunks + reexp \
                or launches["plain step"] or launches["plain orbit key"]:
            fail(f"13b: the export did not run through K1 alone: "
                 f"{launches}")
        results[f"launches_phase13b_{wf}"] = launches
        rows13[wf] = walls
    results["launches_phase13b"] = results["launches_phase13b_Next"]
    results["live13b"] = rows13
    # K1 under the run's SYMMETRY on rows of the universe (the first 160
    # chunks of its orbits, evenly spaced), against the plain orbit key
    b4 = Bounds(n_servers=4, n_values=1, max_term=2, max_log=0, max_msgs=1)
    config = CheckConfig(bounds=b4, spec="election", invariants=(),
                         symmetry=("Server",), chunk=1024)
    export_kernels("phase 13b", config,
                   reachable_rows(config, 3 * MAIN_CHUNK),
                   {"symmetry": ("Server",)}, k2=False)

def p14_run(args, config, timed: bool) -> tuple:
    """Phase 14's engine run: phase 10's universe with the host dedup pass
    at ``P14_FLUSH``; ``timed`` adds the run-event log, the phase timers
    and the trace spans.  ``(eng, res, wall, launches)``."""
    import dataclasses
    from raft_tla_tpu_torch import check
    from raft_tla_tpu_torch.ddd_engine import DDDEngine
    from raft_tla_tpu_torch.ops import kernels, pallas_fp, pallas_step
    # the gates --phase-timers and --trace set, for the timed run only
    gates = {"RAFT_TLA_PHASE_TIMERS": "1", "RAFT_TLA_TRACE": "1"} \
        if timed else {}
    os.environ.update(gates)
    try:
        eng = DDDEngine(config, dataclasses.replace(
            check.make_engine(args, config).caps, flush=P14_FLUSH),
            device=args.device)
        clear_snapshot(Path(args.checkpoint))
        pallas_step.launches = pallas_fp.launches = kernels.calls = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = eng.check(checkpoint=args.checkpoint,
                        events=args.events if timed else None)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        for k in gates:
            os.environ.pop(k, None)
    launches = {"step": pallas_step.launches,
                "fingerprint": pallas_fp.launches,
                "plain step": kernels.calls}
    if launches["step"] != eng.stats["chunks"] or launches["plain step"]:
        fail(f"phase 14a: K1 did not run every chunk alone: {launches}")
    return eng, res, wall, launches


def phase14(results):
    """14a, phase 10's universe with the run-event log, phase timers and
    spans, beside the same run without them; 14b, that universe as a
    supervised campaign under chaos."""
    phase14a(results)
    phase14b(results)


def phase14a(results):
    from raft_tla_tpu_torch import check
    from raft_tla_tpu_torch.obs import collect
    from raft_tla_tpu_torch.obs.events import validate_event
    from raft_tla_tpu_torch.obs.tracecli import main as tracecli
    work = WORK / "p14"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    log = work / "run.events"
    args = check.build_argparser().parse_args(real_argv(
        "--retention", "frontier", "--checkpoint", str(work / "s"),
        "--events", str(log), "--phase-timers", "--trace"))
    config = check.config_of(args)
    # the timers' cost: the same engine run without them first, then with
    _e, res_off, wall_off, _l = p14_run(args, config, timed=False)
    got_off = (res_off.n_states, res_off.diameter, res_off.n_transitions)
    del _e
    eng, res, wall, launches = p14_run(args, config, timed=True)
    got = (res.n_states, res.diameter, res.n_transitions)
    evs = [json.loads(ln) for ln in log.read_text().splitlines()]
    bad = [(e["event"], err) for e in evs for err in validate_event(e)]
    kinds = [e["event"] for e in evs]
    segs = [e for e in evs if e["event"] == "segment"]
    cum = np.cumsum(results["levels_phase10"]).tolist()
    last = {}
    for e in segs:
        last[e["level"]] = e["n_states"]
    off_level = [lv for lv, n in last.items() if n != cum[min(lv, len(cum)
                                                              - 1)]]
    first = {}
    for e in segs:
        first.setdefault(e["level"], e["n_states"])
    ends = [e for e in evs if e["event"] == "level_end"]
    off_end = [e["level"] for e in ends
               if e["n_states"] != first.get(e["level"] + 1)]
    exact_ends = sum(e["n_states"] == cum[e["level"] + 1] for e in ends
                     if e["level"] + 1 < len(cum))
    totals = {}
    for e in segs:
        for k, v in e.get("phase_s", {}).items():
            totals[k] = totals.get(k, 0.0) + v
    over = {k: v for k, v in totals.items() if v > wall}
    rep = collect.report(collect.collect([str(log)]))
    threads = rep["processes"][0]["threads"]
    attributed = {t: round(v["attributed_frac"], 4)
                  for t, v in threads.items()}
    trace_json = work / "trace.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rc_export = tracecli(["export", str(log), "-o", str(trace_json)])
    n_x = sum(e["ph"] == "X" for e in json.loads(
        trace_json.read_text())["traceEvents"]) if rc_export == 0 else 0
    say(f"phase 14a: phase 10's run with --events --phase-timers --trace "
        f"(host dedup pass {P14_FLUSH} candidates): states {got[0]}, "
        f"diameter {got[1]}, transitions {got[2]} (expected "
        f"{REAL_EXPECT}); {len(evs)} events ({kinds.count('segment')} "
        f"segments, {len(ends)} level_end, {kinds.count('span')} spans, "
        f"{kinds.count('run_end')} run_end), invalid {len(bad)}; last "
        f"record of each level at phase 10's cumulative count: "
        f"{not off_level}; level_end at the next level's first record: "
        f"{not off_end} ({exact_ends} of {len(ends)} also at the level's "
        f"end); K1 launches {launches['step']}, K2 {launches['fingerprint']}"
        f", plain step {launches['plain step']}")
    say(f"phase 14a: wall {wall:.2f} s timed, {wall_off:.2f} s untimed "
        f"(the same engine run without the three flags, just before it; "
        f"states, diameter, transitions {got_off}); phase seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(totals.items()))
        + f"; trace report attributed share by thread {attributed}; "
        f"tracecli export: exit {rc_export}, {n_x} spans in "
        f"{trace_json.name}")
    if got != REAL_EXPECT or got_off != REAL_EXPECT or bad \
            or kinds.count("run_end") != 1 or off_level or off_end or over \
            or rc_export or not n_x:
        fail(f"phase 14a: {bad[:3]} {off_level[:5]} {off_end[:5]} {over}")
    if not (attributed.get("MainThread", 0) > 0
            and attributed.get("raft-tla-flush", 0) > 0):
        fail(f"phase 14a: the trace report does not attribute the main "
             f"thread and raft-tla-flush: {attributed}")
    results["launches_phase14a"] = launches
    shutil.rmtree(work, ignore_errors=True)


def phase14b(results):
    """Phase 10's universe as a supervised campaign under chaos: a snapshot
    at every window boundary, the first two children SIGKILLed after their
    second ``checkpoint`` event, and the ``.keys`` stream of the newest
    snapshot truncated before the third child's verify, which must
    quarantine it and restore the previous generation."""
    from raft_tla_tpu_torch.campaign.chaos import (ChaosMonkey,
                                                   child_launches,
                                                   final_record)
    from raft_tla_tpu_torch.campaign.supervisor import (CampaignPolicy,
                                                        CampaignSpec,
                                                        Supervisor)
    work = WORK / "p14b"
    shutil.rmtree(work, ignore_errors=True)
    cfg = write_cfg("real", REAL["servers"], REAL["values"],
                    REAL["invariants"])
    spec = CampaignSpec(
        cfg_path=cfg, spec="full", window=1 << 20, chunk=MAIN_CHUNK,
        levels=128, cap=1 << 25,
        options={k: REAL[k] for k in ("max_term", "max_log", "max_msgs")},
        extra_args=("--retention", "frontier"))
    monkey = ChaosMonkey(kills={0: ("kill", 2), 1: ("kill", 2)},
                         truncations={2: ".keys"})
    spawned = {}

    def on_spawn(sup, proc, attempt):
        spawned[proc.pid] = (attempt, time.time())
        monkey.spawn_hook(sup, proc, attempt)

    sup = Supervisor(spec, str(work), policy=CampaignPolicy(
        checkpoint_every_s=0.0, backoff_base_s=0.0, grace_s=10.0,
        poll_s=0.05), spawn_hook=on_spawn,
        pre_verify_hook=monkey.pre_verify_hook)
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        res = sup.run()
    wall = time.monotonic() - t0
    end = final_record(sup.events_path) or {}
    got = (end.get("n_states"), end.get("diameter"),
           end.get("n_transitions"))
    # each child's run_start (its pid, the count it resumed at) and the
    # furthest count its events reached
    by_pid, cur = {}, None
    for ln in open(sup.events_path):
        e = json.loads(ln)
        if e["event"] == "run_start":
            cur = by_pid[e["pid"]] = {"start": e,
                                      "reached": e.get("n_states", 1)}
        elif cur is not None and e["event"] in ("segment", "checkpoint",
                                                 "run_end"):
            cur["reached"] = max(cur["reached"], e.get("n_states", 0))
    lives = sorted((spawned[pid][0], pid, d) for pid, d in by_pid.items())
    start_s = [round(d["start"]["ts"] - spawned[pid][1], 2)
               for _a, pid, d in lives]
    redone = [prev[2]["reached"] - d["start"].get("n_states", 1)
              for prev, (_a, _p, d) in zip(lives, lives[1:])]
    truncated = [os.path.basename(t[1]) for t in monkey.truncated]
    # the children's own kernel launches (a SIGKILLed child reports none)
    reported = child_launches(str(work))
    launches = {name: sum(n[name] for n in reported if n)
                for name in ("step", "fingerprint")}
    say(f"phase 14b: phase 10's universe as a campaign: {res.outcome} after "
        f"{res.attempts} spawns, {len(monkey.fired)} SIGKILLs "
        f"{monkey.fired}, truncated {truncated}, quarantined "
        f"{len(res.quarantined)}; final states {got[0]}, diameter {got[1]}, "
        f"transitions {got[2]} (expected {REAL_EXPECT}); spawn to "
        f"run_start s by child {start_s} (child 0 a fresh start, the others "
        f"reload a snapshot); states redone after each kill {redone}; "
        f"resumed at {[d['start'].get('n_states') for _a, _p, d in lives]}; "
        f"kernel launches reported by child {reported}; wall {wall:.1f} s")
    if res.outcome != "ok" or got != REAL_EXPECT \
            or len(monkey.fired) != 2 or not monkey.truncated \
            or not res.quarantined or res.attempts != 3 \
            or "restored generation" not in said.getvalue():
        fail(f"phase 14b: {res} {said.getvalue()[-800:]}")
    if not reported or reported[-1] is None or not reported[-1]["step"]:
        fail(f"phase 14b: the last child reported no K1 launch: {reported}")
    results["launches_phase14b_campaign"] = launches
    shutil.rmtree(work, ignore_errors=True)


def sim_cfg() -> str:
    """``runs/MC3s2v.cfg`` with its SYMMETRY line dropped, in a temporary
    copy: simulation replays concrete states."""
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / "MC3s2v_nosym.cfg"
    path.write_text("".join(ln for ln in FLAGSHIP_CFG.read_text()
                            .splitlines(True)
                            if not ln.startswith("SYMMETRY")))
    return str(path)


def sim_config():
    """15a's universe as a ``CheckConfig``: the flagship's four invariants,
    the CLI's default bounds."""
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    return CheckConfig(bounds=Bounds(*SIM_LAYOUT), spec="full",
                       invariants=SIM_INVARIANTS)


def sim_cli(label: str, argv: list) -> tuple:
    """A simulation through the CLI with the kernel counts set to 0 just
    before it and read just after: ``(code, sim, res, out, launches,
    wall, peak GiB)``."""
    from raft_tla_tpu_torch.ops import kernels, pallas_fp, pallas_step
    err = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    pallas_step.launches = pallas_fp.launches = kernels.calls = 0
    t0 = time.monotonic()
    code, sim, res, out = run_cli(argv, err)
    wall = time.monotonic() - t0
    launches = {"step": pallas_step.launches,
                "fingerprint": pallas_fp.launches,
                "plain step": kernels.calls}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if sim is None or res is None:
        fail(f"{label}: exit {code}: {out[-400:]} {err.getvalue()[-400:]}")
    steps = sim.steps * sim.dispatches
    say(f"{label}: exit {code}, {res.n_behaviors} behaviors, "
        f"{res.n_states} states, deepest {res.max_depth_seen}, "
        f"{res.states_per_sec:,.0f} states/s ({res.wall_s:.2f} s in the "
        f"run, {wall:.2f} s with the build), K1 launches "
        f"{launches['step']} for {steps} walker steps, plain step "
        f"{launches['plain step']}, host fetches {sim.fetches} over "
        f"{sim.dispatches} dispatches, peak device memory {peak:.2f} GiB")
    if launches["step"] != steps or not steps or launches["plain step"] \
            or sim.fetches != sim.dispatches:
        fail(f"{label}: K1 did not drive every walker step alone, or the "
             f"host read more than once a dispatch: {launches}")
    return code, sim, res, out, launches, wall, peak


def phase15(results):
    """Simulation (``--simulate``) and the walker fleet (``--fleet``) on
    the card: 15a the CLI on the reference universe, 15b K1's walk
    against the plain step's, 15c a seeded violation and a deadlock,
    15d the fleet."""
    phase15a(results)
    phase15b(results)
    phase15c()
    phase15d(results)


def phase15a(results):
    code, sim, res, out, launches, _wall, peak = sim_cli(
        "phase 15a: --simulate 100000 --depth 100 --walkers 8192 --seed 7 "
        "on runs/MC3s2v.cfg without SYMMETRY (t3 l2 m4 d1)",
        [sim_cfg()] + SIM_ARGS)
    if code != 0 or "No error has been found" not in out \
            or res.n_behaviors < int(SIM_ARGS[1]) \
            or not 0 < res.max_depth_seen <= 100:
        fail(f"phase 15a: {out[-600:]}")
    results["launches_phase15"] = launches
    results["sim15a"] = {"behaviors": res.n_behaviors,
                         "states": res.n_states,
                         "states_per_sec": res.states_per_sec,
                         "dispatches": sim.dispatches, "peak_gib": peak}


def phase15b(results):
    """The walker step of 15a, two dispatches of 16 steps at 8,192
    walkers, through K1 and through the plain step on the card: lane
    histories, walk lengths, rows and counts bit-equal; 256 walks replayed
    through the interpreter reach their rows; the draw equal on the card
    and on the CPU; K1's time per step against the whole step's."""
    from raft_tla_tpu_torch.models import interp
    from raft_tla_tpu_torch.ops import kernels
    from raft_tla_tpu_torch.simulate import (Simulator, draw, replay,
                                             walker_keys)
    config = sim_config()
    plain = kernels.build_step(config.bounds, "full", SIM_INVARIANTS)
    walks, wall = [], {}
    for name in ("K1", "plain", "plain", "K1"):
        sim = Simulator(config, walkers=SIM_WALKERS, depth=100,
                        steps_per_dispatch=16, seed=7)
        if name == "plain":
            sim.step_fn = plain
        w = sim.start()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        counts = [sim.dispatch(w) for _ in range(2)]
        torch.cuda.synchronize()
        wall.setdefault(name, []).append((time.monotonic() - t0) / 32e-3)
        walks.append((name, w, counts))
    _n, wk, ck = walks[0]
    bad = 0
    for _p, wp, cp in walks[1:]:
        bad += sum(int((a != b).sum()) for a, b in (
            (wk.hist, wp.hist), (wk.hlen, wp.hlen), (wk.vecs, wp.vecs)))
        bad += sum(x != y for x, y in zip(ck, cp))
    keys = walker_keys(7, SIM_WALKERS, DEV)
    ckeys = walker_keys(7, SIM_WALKERS, "cpu")
    bad_draw = sum(int((draw(keys, t).cpu() != draw(ckeys, t)).sum())
                   for t in (0, 1, 31, 10**9))
    b = config.bounds
    table = sim.table
    init = interp.init_state(b)
    hist, hlen, vecs = wk.hist.cpu(), wk.hlen.cpu(), wk.vecs.cpu()
    idx = range(0, SIM_WALKERS, SIM_WALKERS // 256)
    bad_replay = sum(
        not np.array_equal(interp.to_vec(replay(
            sim.model, table, b, init, hist[g].tolist(),
            int(hlen[g]))[-1][1], b), vecs[g].numpy()) for g in idx)
    k1_ms, k1_spread = cuda_ms(lambda: sim.step_fn(wk.vecs), 20)
    step_ms = float(np.median(wall["K1"]))
    plain_ms = float(np.median(wall["plain"]))
    say(f"phase 15b: {SIM_WALKERS} walkers, 2 dispatches of 16 steps, K1 "
        f"against the plain step on the card: {bad} mismatches (lane "
        f"histories, walk lengths, rows, counts {ck[-1]}); draws card vs "
        f"CPU: {bad_draw} mismatches; 256 walks replayed through the "
        f"interpreter: {bad_replay} rows differ; whole step "
        f"{step_ms:.3f} ms (K1 route, runs {wall['K1']}), K1 alone "
        f"{k1_ms:.4f} ms (spread {k1_spread:.4f}) at [{SIM_WALKERS}, "
        f"{sim.width}], the plain route's step {plain_ms:.3f} ms")
    if bad or bad_draw or bad_replay:
        fail("phase 15b: K1's walk differs from the plain step's")
    results["sim15b"] = {"step_ms": step_ms, "k1_ms": k1_ms,
                         "plain_step_ms": plain_ms}


def phase15c():
    """The Simulator API on the seeded NaiveNoTwoLeaders start carried to
    15a's universe: a violation in the first dispatch whose trace replays
    through ``interp.successors`` and ends with two leaders; then the
    1-server election with ``--deadlock`` through the CLI: exit 11."""
    from raft_tla_tpu_torch import check
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.models import interp, spec as SP
    from raft_tla_tpu_torch.ops import msgbits as mb
    from raft_tla_tpu_torch.simulate import Simulator
    b = sim_config().bounds
    start = interp.init_state(b)._replace(
        role=(SP.LEADER, SP.FOLLOWER, SP.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=((mb.rv_response(3, 1, 1, 2), 1),))
    config = CheckConfig(bounds=b, spec="full",
                         invariants=("NaiveNoTwoLeaders",))
    sim = Simulator(config, walkers=SIM_WALKERS, depth=100, seed=7)
    res = sim.run(10**7, init_override=start)
    v = res.violation
    trace = v.trace if v else []
    table = SP.action_table(b, "full")
    replays = bool(trace) and trace[0] == (None, start) and all(
        (label, cur) in [(table[k].label(), t) for k, t in
                         interp.successors(prev, b, table)]
        for (_l, prev), (label, cur) in zip(trace, trace[1:]))
    leaders = sum(x == SP.LEADER for x in trace[-1][1].role) if trace else 0
    say(f"phase 15c: seeded NaiveNoTwoLeaders start, {SIM_WALKERS} walkers: "
        f"{v.invariant if v else None} after {sim.dispatches} dispatch(es), "
        f"trace {[label for label, _s in trace]}, replays through "
        f"interp.successors: {replays}, leaders at the end {leaders}")
    if not v or v.invariant != "NaiveNoTwoLeaders" or sim.dispatches != 1 \
            or not replays or leaders < 2:
        fail("phase 15c: the seeded violation")
    cfg = write_cfg("deadlock1s", 1, 1, "NoTwoLeaders")
    code, _s, dres, out, _l, _w, _p = sim_cli(
        "phase 15c: 1-server election --deadlock --simulate", [
            cfg, "--spec", "election", "--deadlock", "--max-term", "2",
            "--max-log", "0", "--max-msgs", "2", "--simulate", "1000",
            "--depth", "30", "--walkers", "1024", "--seed", "0"])
    dead = dres.violation.state if dres.violation else None
    stuck = dead is not None and not list(interp.successors(
        dead, Bounds(n_servers=1, n_values=1, max_term=2, max_log=0,
                     max_msgs=2), spec="election"))
    if code != check.EXIT_DEADLOCK or "Deadlock reached" not in out \
            or not stuck:
        fail(f"phase 15c: deadlock: {out[-400:]}")


def phase15d(results):
    """The fleet on 15a's universe, 50,000 behaviors at 1,024 walkers:
    unsteered (unit weights, tau 0) its walks equal those of 15a's first
    1,024 walkers after as many dispatches of the Simulator at 8,192; then
    steered with scenario weights through the CLI, whose coverage entropy
    must be higher."""
    import re
    from raft_tla_tpu_torch.fleet import FleetSimulator
    from raft_tla_tpu_torch.simulate import Simulator
    config = sim_config()
    fl = FleetSimulator(config, walkers=SIM_FLEET_WALKERS, depth=100, seed=7)
    r = fl.run(SIM_FLEET_BEHAVIORS, snapshot_walks=True)
    sim = Simulator(config, walkers=SIM_WALKERS, depth=100, seed=7)
    w = sim.start()
    for _ in range(fl.dispatches):
        sim.dispatch(w)
    n = SIM_FLEET_WALKERS
    same = np.array_equal(r.walks[0], w.hist[:n].cpu().numpy()) \
        and np.array_equal(r.walks[1], w.hlen[:n].cpu().numpy())
    say(f"phase 15d: fleet tau 0, unit weights, {n} walkers: "
        f"{r.n_behaviors} behaviors, {r.n_states} states, {fl.dispatches} "
        f"dispatches, entropy {r.coverage_entropy:.4f}; walks equal to "
        f"those of the first {n} walkers of the Simulator at {SIM_WALKERS} "
        f"after {fl.dispatches} dispatches: {same}")
    if r.violation is not None or not same or fl.dispatches < 2:
        fail("phase 15d: the unsteered fleet's walks")
    argv = [sim_cfg()] + SIM_ARGS
    argv[argv.index("--simulate") + 1] = str(SIM_FLEET_BEHAVIORS)
    argv[argv.index("--walkers") + 1] = str(n)
    code, _f, rs, out, launches, _w, _p = sim_cli(
        "phase 15d: --fleet --steer 1.5 --fault-weights "
        "Restart=2,DropMessage=0.5", argv + [
            "--fleet", "--steer", "1.5", "--fault-weights",
            "Restart=2,DropMessage=0.5"])
    m = re.search(r"Fleet: 1 devices x (\d+) walkers, steer tau=1.5; "
                  r"action-coverage entropy ([0-9.]+)", out)
    say(f"phase 15d: steered entropy {rs.coverage_entropy:.4f} against "
        f"{r.coverage_entropy:.4f} unsteered; coverage {rs.coverage}")
    if code != 0 or not m or int(m.group(1)) != n \
            or rs.coverage_entropy <= r.coverage_entropy \
            or "held on" not in out:
        fail(f"phase 15d: {out[-600:]}")
    results["launches_phase15d_fleet"] = launches


def tp_cfg(name: str, rms: int, invariant: str) -> str:
    """A two-phase-commit cfg: ``CONSTANT RM = {r1..r<rms>}``."""
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / f"{name}.cfg"
    rm = ", ".join(f"r{i + 1}" for i in range(rms))
    path.write_text(f"SPECIFICATION Spec\nCONSTANT RM = {{{rm}}}\n"
                    f"INVARIANT {invariant}\n")
    return str(path)


def tp_reset() -> None:
    """Every kernel and plain-version count of the frontend's path to 0."""
    from raft_tla_tpu_torch.frontend import actions
    from raft_tla_tpu_torch.ops import fingerprint as fpr
    from raft_tla_tpu_torch.ops import kernels, pallas_fp, pallas_step
    pallas_step.launches = pallas_fp.launches = kernels.calls = 0
    fpr.calls = actions.calls = 0
    torch.cuda.synchronize()


def tp_counts() -> dict:
    from raft_tla_tpu_torch.frontend import actions
    from raft_tla_tpu_torch.ops import fingerprint as fpr
    from raft_tla_tpu_torch.ops import kernels, pallas_fp, pallas_step
    torch.cuda.synchronize()
    return {"step": pallas_step.launches, "fingerprint": pallas_fp.launches,
            "plain step": kernels.calls, "plain fingerprint": fpr.calls,
            "schema step": actions.calls}


def tp_replays(trace, rms: int) -> bool:
    """The trace starts at Init and each step is its label's lane applied
    by the host interpreter (``twophase.apply_instance``)."""
    from raft_tla_tpu_torch.config import Bounds
    from raft_tla_tpu_torch.frontend import twophase as tp
    b = Bounds(n_servers=rms, n_values=1)
    lanes = {a.label(): a for a in tp.action_table(b)}
    cur = tp.init_state(b)
    if not trace or trace[0] != (None, cur):
        return False
    for label, state in trace[1:]:
        cur = tp.apply_instance(cur, lanes[label], b)
        if cur != state:
            return False
    return True


def tp_rows(step, model, b, n: int) -> torch.Tensor:
    """``n`` distinct reachable rows, from Init level by level through the
    step on the card."""
    rows = torch.as_tensor(model.to_vec(model.init_py(b), b),
                           device=DEV)[None]
    while len(rows) < n:
        out = step(rows)
        rows = torch.unique(torch.cat([rows, out["svecs"][out["valid"]]]),
                            dim=0)
    return rows[torch.randperm(len(rows), device=DEV,
                               generator=torch.Generator(DEV).manual_seed(7)
                               )[:n]]


def phase16(results):
    """The spec frontend on the card (docstring item 16)."""
    for fn in (phase16a, phase16b, phase16c, phase16d):
        t0 = time.monotonic()
        fn(results) if fn.__code__.co_argcount else fn()
        say(f"{fn.__name__} took {time.monotonic() - t0:.1f} s")


def phase16a(results):
    from raft_tla_tpu_torch.frontend.registry import resolve_model
    from raft_tla_tpu_torch.ops import fingerprint as fpr, pallas_fp
    cfg = tp_cfg("2pc7", TP_RMS, "TCConsistent")
    tp_reset()
    t0 = time.monotonic()
    code, eng, res, out = run_cli([cfg, "--spec", "twophase", "--engine",
                                   "host", "--chunk", str(MAIN_CHUNK)])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = tp_counts()
    if res is None:
        fail(f"phase 16a: exit {code}: {out[-600:]}")
    chunks = sum(-(-n // MAIN_CHUNK) for n in TP_LEVELS)
    got = (res.n_states, res.diameter, res.n_transitions)
    say(f"phase 16a: twophase {TP_RMS} RMs, --engine host --chunk "
        f"{MAIN_CHUNK}: exit {code}, states/diameter/transitions {got} "
        f"(oracle {TP_EXPECT}), levels equal: {res.levels == TP_LEVELS}; "
        f"wall {wall:.2f} s with the build ({res.wall_s:.2f} s in the "
        f"search, {res.n_states / res.wall_s:,.0f} states/s), host dedup "
        f"loop {eng.dedup_s:.2f} s ({100 * eng.dedup_s / res.wall_s:.1f}% "
        f"of the search); {chunks} chunks: schema steps "
        f"{launches['schema step']}, K2 launches {launches['fingerprint']}, "
        f"K1 launches {launches['step']}, plain fingerprint calls "
        f"{launches['plain fingerprint']}, plain step calls "
        f"{launches['plain step']}")
    if code != 0 or got != TP_EXPECT or res.levels != TP_LEVELS \
            or "No error has been found" not in out:
        fail(f"phase 16a: {out[-600:]}")
    if launches["fingerprint"] != chunks or launches["schema step"] != chunks \
            or launches["step"] or launches["plain fingerprint"] \
            or launches["plain step"]:
        fail(f"phase 16a: K2 did not key every chunk alone: {launches}")
    results["launches_phase16a"] = launches
    # K2 on one chunk's successor rows against the plain fingerprint
    b = eng.config.bounds
    model = resolve_model("twophase")
    step = model.build_step(eng.config, DEV)
    rows = tp_rows(step, model, b, MAIN_CHUNK)
    out16 = step(rows)
    W = model.layout(b).width
    flat = out16["svecs"].reshape(-1, W).contiguous()
    consts = fpr.torch_constants(W, DEV)
    hi, lo = pallas_fp.fingerprint_rows(flat)
    rh, rl = fpr.fingerprint(flat, consts)
    torch.cuda.synchronize()
    bad = int(((hi != rh) | (lo != rl)).sum())
    bad += int(((out16["fp_hi"].reshape(-1) != rh)
                | (out16["fp_lo"].reshape(-1) != rl)).sum())
    err = int(torch.maximum((hi.to(torch.int64) - rh).abs(),
                            (lo.to(torch.int64) - rl).abs()).max())
    ms, spread = cuda_ms(lambda: pallas_fp.fingerprint_rows(flat), 50)
    plain_ms, _ = cuda_ms(lambda: fpr.fingerprint(flat, consts), 5,
                          trials=3, hold=False)
    step_ms, _ = cuda_ms(lambda: step(rows), 5, trials=3, hold=False)
    N = flat.shape[0]
    nbytes = N * W * 4 + 2 * N * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, N * (4 * W + 12) / INT_OPS_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    say(f"phase 16a: K2 on one chunk's successor rows [{MAIN_CHUNK} x "
        f"{out16['svecs'].shape[1]}, {W}] = {N} rows: mismatches {bad} "
        f"(against the plain fingerprint and the step's own keys); K2 "
        f"{ms:.4f} ms (spread {spread:.4f}), plain {plain_ms:.3f} ms, bound "
        f"{bound:.4f} ms; the whole schema step {step_ms:.3f} ms a chunk")
    if bad:
        fail("phase 16a: K2 disagrees with the plain fingerprint")
    results["tp16a"] = {
        "wall_s": wall, "search_s": res.wall_s,
        "states_per_sec": res.n_states / res.wall_s,
        "dedup_s": eng.dedup_s, "k2_rows": N, "k2_width": W,
        "k2_ms": ms, "k2_plain_ms": plain_ms, "k2_bound_ms": bound,
        "k2_bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "k2_max_abs_err": err, "schema_step_ms": step_ms}


def phase16b():
    """The seeded violations on the card and on the CPU: exit 12, the same
    trace and result lines, the trace replays through apply_instance."""
    import re
    cut = r", [0-9.]+s \(.*states/s\)\.$"
    for rms, inv in ((3, "~(msgCommit = 1)"), (2, "~any(rmState = 2)")):
        cfg = tp_cfg(f"2pc{rms}v", rms, inv)
        argv = [cfg, "--spec", "twophase", "--engine", "host"]
        code, _e, res, out = run_cli(argv)
        ccode, _c, cres, cout = run_cli(argv + ["--device", "cpu"])
        lines = [[re.sub(cut, "", ln) for ln in text.splitlines()]
                 for text in (out, cout)]
        trace = res.violation.trace if res and res.violation else []
        same = bool(trace) and cres is not None and cres.violation is not None \
            and trace == cres.violation.trace and lines[0] == lines[1]
        replays = tp_replays(trace, rms)
        say(f"phase 16b: twophase {rms} RMs, INVARIANT {inv}: exit {code} "
            f"(CPU {ccode}), trace {[lab for lab, _s in trace]}, equal to "
            f"the CPU run's (trace and lines): {same}, replays through "
            f"apply_instance: {replays}")
        if code != 12 or ccode != 12 or not same or not replays:
            fail(f"phase 16b: {inv}: {out[-600:]}")


def phase16c(results):
    """The IR-compiled Raft step on the card: ``ir-full`` against K1 on
    reachable rows at phase 5's layout without symmetry, then
    ``ir-election`` through the host engine against ``election``."""
    import dataclasses
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.engine import Engine
    from raft_tla_tpu_torch.frontend.registry import resolve_model
    from raft_tla_tpu_torch.ops import pallas_step
    invs = tuple(SIM_INVARIANTS)
    b = Bounds(3, 2, 2, 1, 2)
    rows = reachable_rows(CheckConfig(bounds=b, spec="full",
                                      invariants=invs), MAIN_CHUNK)
    k1 = pallas_step.build_step(b, "full", invs, DEV)
    ir = resolve_model("ir-full").build_step(
        CheckConfig(bounds=b, spec="ir-full", invariants=invs), DEV)
    tp_reset()
    got = ir(rows)
    launches = tp_counts()
    want = k1(rows)
    bad, err = compare_step(got, want)
    n_valid = int(want["valid"].sum())
    ir_ms, _ = cuda_ms(lambda: ir(rows), 3, trials=3, hold=False)
    k1_ms, _ = cuda_ms(lambda: k1(rows), 20)
    say(f"phase 16c: ir-full step on the card against K1, {len(rows)} rows "
        f"[W={rows.shape[1]}, A={want['valid'].shape[1]}], {n_valid} valid "
        f"lanes: {bad} mismatches (svecs, valid, overflow, fp_hi/fp_lo, "
        f"inv_ok, con_ok); the IR step's launches: K2 "
        f"{launches['fingerprint']}, K1 {launches['step']}, plain "
        f"fingerprint {launches['plain fingerprint']}; IR step {ir_ms:.3f} "
        f"ms, K1 {k1_ms:.4f} ms")
    if bad or launches["fingerprint"] != 1 or launches["step"] \
            or launches["plain fingerprint"]:
        fail("phase 16c: the IR step differs from K1")
    key, want_n, want_d = IR_ELECTION
    cfg = CheckConfig(bounds=Bounds(*key), spec="ir-election",
                      invariants=("NoTwoLeaders",), chunk=MAIN_CHUNK)
    runs = {}
    for spec in ("ir-election", "election"):
        tp_reset()
        r = Engine(dataclasses.replace(cfg, spec=spec)).check()
        runs[spec] = (r, tp_counts())
    (ri, li), (rh, lh) = runs["ir-election"], runs["election"]
    same = (ri.n_states, ri.diameter, ri.n_transitions, ri.levels,
            ri.coverage) == (rh.n_states, rh.diameter, rh.n_transitions,
                             rh.levels, rh.coverage)
    say(f"phase 16c: ir-election through the host engine on the card, "
        f"3s/1v t2 l0 m1: {ri.n_states} states, diameter {ri.diameter}, "
        f"{ri.n_transitions} transitions in {ri.wall_s:.2f} s (verified "
        f"{want_n}/{want_d}); equal to election's (K1, {rh.wall_s:.2f} s): "
        f"{same}; IR steps {li['plain step']}, K2 launches "
        f"{li['fingerprint']}, K1 launches {li['step']}, plain fingerprint "
        f"{li['plain fingerprint']}")
    if not same or (ri.n_states, ri.diameter) != (want_n, want_d) \
            or li["step"] or li["plain fingerprint"] \
            or li["fingerprint"] != li["plain step"] or not li["fingerprint"]:
        fail(f"phase 16c: ir-election: {li} {lh}")
    results["launches_phase16c"] = li
    results["tp16c"] = {"mismatches": bad, "max_abs_err": err,
                        "ir_step_ms": ir_ms, "k1_ms": k1_ms}


def phase16d(results):
    """Twophase simulation on the card: the CLI at 8,192 walkers, the
    seeded violation replayed, the fleet at 1,024 walkers."""
    from raft_tla_tpu_torch.config import Bounds, CheckConfig
    from raft_tla_tpu_torch.fleet import FleetSimulator
    from raft_tla_tpu_torch.simulate import Simulator
    argv = ["--spec", "twophase", "--engine", "host", "--simulate", "20000",
            "--depth", "100", "--walkers", str(SIM_WALKERS), "--seed", "7"]
    tp_reset()
    code, sim, res, out = run_cli([tp_cfg("2pc7", TP_RMS, "TCConsistent")]
                                  + argv)
    launches = tp_counts()
    steps = sim.steps * sim.dispatches if sim else 0
    say(f"phase 16d: twophase {TP_RMS} RMs --simulate 20000 --walkers "
        f"{SIM_WALKERS}: exit {code}, {res.n_behaviors if res else 0} "
        f"behaviors, {res.n_states if res else 0} states, "
        f"{res.states_per_sec if res else 0:,.0f} states/s; schema steps "
        f"{launches['schema step']} for {steps} walker steps, K2 "
        f"{launches['fingerprint']}, K1 {launches['step']}, host fetches "
        f"{sim.fetches if sim else 0} over {sim.dispatches if sim else 0} "
        f"dispatches")
    if code != 0 or "No error has been found" not in out \
            or launches["schema step"] != steps or not steps \
            or launches["step"] or launches["plain fingerprint"] \
            or sim.fetches != sim.dispatches:
        fail(f"phase 16d: {out[-600:]}")
    results["launches_phase16d"] = launches
    results["tp16d"] = {"states_per_sec": res.states_per_sec,
                        "behaviors": res.n_behaviors}
    code, _s, vres, out = run_cli([tp_cfg("2pc7v", TP_RMS,
                                          "~(msgCommit = 1)")] + argv)
    trace = vres.violation.trace if vres and vres.violation else []
    replays = tp_replays(trace, TP_RMS) and trace[-1][1].msgCommit == 1
    say(f"phase 16d: seeded violation ~(msgCommit = 1): exit {code}, walk "
        f"of {len(trace)} states, replays through apply_instance: {replays}")
    if code != 12 or not replays:
        fail(f"phase 16d: the seeded violation: {out[-600:]}")
    config = CheckConfig(bounds=Bounds(n_servers=TP_RMS, n_values=1),
                         spec="twophase", invariants=("TCConsistent",))
    fl = FleetSimulator(config, walkers=SIM_FLEET_WALKERS, depth=100, seed=7)
    r = fl.run(TP_FLEET_BEHAVIORS, snapshot_walks=True)
    s = Simulator(config, walkers=SIM_WALKERS, depth=100, seed=7)
    w = s.start()
    for _ in range(fl.dispatches):
        s.dispatch(w)
    n = SIM_FLEET_WALKERS
    same = np.array_equal(r.walks[0], w.hist[:n].cpu().numpy()) \
        and np.array_equal(r.walks[1], w.hlen[:n].cpu().numpy())
    say(f"phase 16d: fleet at {n} walkers: {r.n_behaviors} behaviors, "
        f"{r.n_states} states, {fl.dispatches} dispatches, entropy "
        f"{r.coverage_entropy:.4f}; walks equal to those of the first {n} "
        f"walkers of the Simulator at {SIM_WALKERS}: {same}")
    if r.violation is not None or not same or fl.dispatches < 2:
        fail("phase 16d: the fleet's walks")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    if not FLAGSHIP_CFG.exists() or not FLAGSHIP_OUT.exists():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    phases = [phase1, phase2, phase3, phase4, phase5, phase6, phase7,
              phase8, phase9, phase10, phase11, phase12, phase13, phase14,
              phase15, phase16]
    t_all = time.monotonic()
    card = phase0()
    results = {}
    for k, fn in enumerate(phases, 1):
        t0 = time.monotonic()
        fn(results) if fn.__code__.co_argcount else fn()
        say(f"phase {k} took {time.monotonic() - t0:.1f} s")
    results["step"]["max_abs_err"] = max(results["step"]["max_abs_err"],
                                         results.get("step_err", 0),
                                         results["tp16c"]["max_abs_err"])
    results["fingerprint"]["max_abs_err"] = max(
        results["fingerprint"]["max_abs_err"],
        results["tp16a"]["k2_max_abs_err"])
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
                             "phase10", "phase12", "phase13a", "phase13b",
                             "phase14a", "phase14b_campaign", "phase15",
                             "phase15d_fleet", "phase16a", "phase16c",
                             "phase16d")},
            "audit_launches": {
                "phase10": results["audit_launches_phase10"][name]},
            "mismatches": r["mismatches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    # K2 on the twophase path (phase 16a): one chunk's successor rows
    kernels[1]["twophase_rows"] = {
        k: results["tp16a"][k] for k in ("k2_rows", "k2_width", "k2_ms",
                                          "k2_plain_ms", "k2_bound_ms",
                                          "k2_bound_by", "k2_max_abs_err")}
    # the IR-compiled Raft step against K1 (phase 16c)
    kernels[0]["ir_step"] = results["tp16c"]
    say(f"total {time.monotonic() - t_all:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
