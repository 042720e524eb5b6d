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
   and faithful;
1. K1 (csrc/step.cu) against the plain step on reachable rows: four configs
   without symmetry, then the dedup-key stage at |G| = 6, 12, 24, 120 and
   720 and with the deadvotes view; then faithful mode (the history stage)
   at |G| = 1, 6, 12 (rank maps), 6 with deadvotes, and 120;
2. K2 (csrc/fingerprint.cu) against the plain fingerprint, 1,048,576 rows
   at W = 60 and at W = 110;
3. verified counts through the CLI entry (plain, SYMMETRY, VIEW and
   faithful), the seeded violations (exit 12, traces replay through the
   interpreter, the faithful trace shows the history) and a deadlock
   (exit 11);
4. the reference universe (3 servers, 2 values, t2 l1 m1) to exhaustion:
   15,872,151 states, diameter 53, 40,060,419 transitions; then the store
   audit with K2;
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
   on rows from every level.  No reference count exists for it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Tolerance everywhere: bit-exact (all
outputs are int32, uint32 bits or bools).
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT_OPS_PER_S = 67e12              # CUDA-core fp32 peak; int32 is no faster

# Phase-4 universe and the counts the JAX package's DeviceEngine found for
# it on the CPU (chunk 1024, Capacities(n_states=1 << 25)).
REAL = dict(servers=3, values=2, max_term=2, max_log=1, max_msgs=1,
            invariants="NoTwoLeaders LogMatching CommittedWithinLog")
REAL_EXPECT = (15_872_151, 53, 40_060_419)
MAIN_CHUNK = 8192
# The phase-4 wall on one H100 80GB HBM3 at 700 W before the dedup-key
# stage existed (four runs of this script; PERF.md).
REAL_WALL_BEFORE = (15.77, 18.19)

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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, trials: int = 5) -> tuple:
    """``(median, max - min)`` over ``trials`` of the mean milliseconds of
    ``fn`` across ``reps`` back-to-back launches (CUDA events, after
    ``reps`` warm-up launches)."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times)), max(times) - min(times)


def step_bytes(B: int, A: int, W: int, n_inv: int) -> int:
    """Bytes one K1 launch must move: the rows read once, every output
    written once (int32 svecs and keys, one byte per bool)."""
    return B * W * 4 + B * A * (W * 4 + 8 + 3 + n_inv)


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


def run_cli(argv):
    """The port's CLI in-process: (exit code, engine, result, stdout)."""
    from raft_tla_tpu_torch import check
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
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
    from raft_tla_tpu_torch.config import Bounds
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
    t0 = time.monotonic()
    build.prebuild(sorted(jobs))
    say(f"phase 0: built {len(jobs)} kernel libraries (nvcc sm_90a, in "
        f"parallel) in {time.monotonic() - t0:.1f} s")
    for key in ((3, 2, 2, 1, 1), (3, 2, 2, 1, 2), (5, 2, 2, 0, 2),
                (6, 1, 2, 0, 1), (3, 2, 2, 1, 2, 6), (5, 2, 2, 0, 2, 6)):
        d = pallas_step.layout_defines(bounds_of(key))
        say(f"ptxas step {d}: " + build.ptxas_report(
            pallas_step.SOURCE, d).replace("\n", " | "))
    say("ptxas fingerprint: " + build.ptxas_report(
        pallas_fp.SOURCE).replace("\n", " | "))
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

    Bytes: the rows read once and every output written once.  Operations:
    the fingerprint arithmetic of the dedup key alone (two multiply-adds a
    word per lane of the key, plus the finaliser), on every valid lane
    for each of the ``group`` elements of its orbit scan: a lower bound, the
    permutations and the sort network uncounted."""
    B, A, W = out["svecs"].shape
    nbytes = step_bytes(B, A, W, n_inv)
    n_valid = int(out["valid"].sum())
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
        plain_ms, _ = cuda_ms(lambda: plain(rows), 1 if P * Q > 24 else 2,
                              trials=1 if P * Q > 24 else 3)
        bound, by, nbytes = step_bound(out, len(invs), P * Q)
        say(f"phase 1: K1 {name}: |G| {P * Q}, rows {B} lanes {B * A} "
            f"(A={A}, W={W}) valid {int(ref['valid'].sum())} mismatches "
            f"{bad} max_abs_err {err}; K1 {ms:.4f} ms (spread {spread:.4f}), "
            f"plain {plain_ms:.2f} ms per launch; bound {bound:.4f} ms "
            f"({by}; {nbytes} bytes)")
        if bad:
            fail(f"K1 disagrees with the plain step on {name}")
        results["step_cases"].append(dict(
            name=name, group=P * Q, rows=B, ms=ms, spread=spread,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by))
        if name == "full 3s/2v t2 l1 m2, Server":   # the phase-5 layout
            results["step"] = dict(
                mismatches=bad, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)
        else:
            results.setdefault("step_err", 0)
            results["step_err"] = max(results["step_err"], err)


def phase2(results):
    # The flagship's row width (the kernels line reports it) and phase 6's.
    results["fingerprint"] = fingerprint_case(60)
    fingerprint_case(110)


def fingerprint_case(W: int) -> dict:
    from raft_tla_tpu_torch.ops import fingerprint as fpr, pallas_fp
    B = 1 << 20
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
    plain_ms, _ = cuda_ms(lambda: fpr.fingerprint(rows, consts), 5, trials=3)
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


def phase3():
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


def drive(argv, label: str) -> tuple:
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
    code, eng, res, out = run_cli(argv)
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
        f"{launches['plain step']}; dedup "
        f"{1e3 * st['dedup_s'] / chunks:.3f} ms/chunk; host syncs "
        f"{st['syncs'] / chunks:.2f}/chunk; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase4(results):
    cfg = write_cfg("real", REAL["servers"], REAL["values"],
                    REAL["invariants"])
    argv = [cfg, "--spec", "full", "--max-term", str(REAL["max_term"]),
            "--max-log", str(REAL["max_log"]), "--max-msgs",
            str(REAL["max_msgs"]), "--chunk", str(MAIN_CHUNK),
            "--cap", str(1 << 25), "--levels", "128"]
    code, eng, res, out, wall, launches = drive(argv, "real-size run")
    got = (res.n_states, res.diameter, res.n_transitions)
    say(f"phase 4: real size full 3s/2v t2 l1 m1: exit {code}; states "
        f"{got[0]}, diameter {got[1]}, transitions {got[2]} (expected "
        f"{REAL_EXPECT}); K1 runs its orbit loop at |G| = 1; wall before "
        f"the dedup-key stage {REAL_WALL_BEFORE[0]}-{REAL_WALL_BEFORE[1]} s")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    if not FLAGSHIP_CFG.exists() or not FLAGSHIP_OUT.exists():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    t_all = time.monotonic()
    card = phase0()
    results = {}
    phase1(results)
    phase2(results)
    phase3()
    phase4(results)
    phase5(results)
    phase6(results)
    phase7(results)
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
            "launches_by_path": {
                path: results[f"launches_{path}"][name]
                for path in ("phase4", "phase5", "phase6_sym", "phase6",
                             "phase7")},
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
