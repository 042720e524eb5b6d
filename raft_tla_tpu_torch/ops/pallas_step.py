"""The fused frontier step as a CUDA kernel — the port of
``raft_tla_tpu/ops/pallas_step.py`` (kernel K1, ``csrc/step.cu``).

:func:`build_step` returns, for a CUDA device, the launcher of the hand
kernel, and for the CPU the plain torch step (ops/kernels.build_step); there
is no gate and no fallback.  Both take ``vecs int32[B, W]`` and return the
same dict (``svecs``, ``valid``, ``overflow``, ``fp_hi``, ``fp_lo``,
``inv_ok``, ``con_ok``; keys as int32 holding the uint32 bits).  With
``symmetry`` and ``view`` set, the keys are the viewed, orbit-minimal dedup
keys: the kernel takes the group's permutations
(ops/symmetry.kernel_tables), in faithful mode under Value symmetry the
rank maps (ops/symmetry.kernel_rank_maps), and the view's code
(models/views.KERNEL_CODES); the invariants are the kernel's codes and
expression programs (ops/predprog.kernel_tables).

The orbit stage has the reference's three variants, bits of one launch
argument of the same kernel: the full scan, the prescan (raw-identical
successors of a block share one orbit scan) and sig-prune (transposition
probes, then one group element per coset of the verified stabilizer),
and both; they give the same keys (csrc/step.cu).  :func:`build_step`
resolves them from the gates at construction (ops/kernels.prescan_enabled
with the card's rule, ops/kernels.sigprune_enabled); ``launches_by``
counts the launches of each.  ``RAFT_TLA_MEGAKERNEL=off`` asks for the
reference's XLA step, which has no place on the card: the port's step on
the card is K1 and the plain step is the CPU contract, so that setting is
refused for a CUDA device.  :func:`build_step_routed` is the routed DDD
step: on the card K1's dense output, then the stable compaction in torch
ops (ops/kernels.route_compact).

The kernel is compiled per layout (servers, log capacity, message slots
and, in faithful mode, election slots, allLogs words and the log
universe's terms and values are ``-D`` macros, see csrc/step.cu) and cached
by that key.  It is held to this contract against the plain step:
``valid`` equal on every lane, every other output bit-equal where
``valid`` is true.  The kernel leaves the other outputs of an invalid lane
unwritten (``torch.empty``); every reader masks them by ``valid``, and the
plain step writes zeros there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import spec as SP
from raft_tla_tpu_torch.models import views
from raft_tla_tpu_torch.ops import build
from raft_tla_tpu_torch.ops import kernels, predprog
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym

SOURCE = "step.cu"

# Kernel launches so far, in all and by orbit-scan variant (chip_smoke.py
# reads and resets them).
VARIANTS = {"full": 0, "prescan": 1, "sigprune": 2, "both": 3}
launches = 0
launches_by = dict.fromkeys(VARIANTS, 0)
# K1's optional counters (build_step(count=True)): valid pairs, pairs whose
# orbit scan the prescan skipped, group elements keyed, probes run.
STATS = ("pairs", "prescan_skipped", "elements", "probes")

MEGAKERNEL_OFF_CUDA = (
    "--megakernel off asks for the reference's XLA step, which the port "
    "does not run on the card: its step on the card is K1 (csrc/step.cu, "
    "the megakernel's counterpart) and the plain step is the CPU contract "
    "(--device cpu)")

# The fused step's whole write surface per spec subset (the struct fields a
# successor may differ from its parent in, faithful-mode fields included) —
# the reference's FUSED_WRITES.  Hand-kept, not derived from the kernels;
# the tests check the plain step against it in both modes.
FUSED_WRITES = {
    "full": (
        "allLogs", "commitIndex", "eLeader", "eLog", "eTerm", "eVLog",
        "eVotes", "logLen", "logTerm", "logVal", "matchIndex", "msgCount",
        "msgHi", "msgLo", "nextIndex", "role", "term", "vGrant", "vLog",
        "vResp", "votedFor",
    ),
    # Receive alone already writes most of the schema.
    "election": (
        "allLogs", "commitIndex", "eLeader", "eLog", "eTerm", "eVLog",
        "eVotes", "logLen", "logTerm", "logVal", "matchIndex", "msgCount",
        "msgHi", "msgLo", "nextIndex", "role", "term", "vGrant", "vLog",
        "vResp", "votedFor",
    ),
    # No BecomeLeader: the election-history fields stay put.
    "replication": (
        "allLogs", "commitIndex", "logLen", "logTerm", "logVal",
        "matchIndex", "msgCount", "msgHi", "msgLo", "nextIndex", "role",
        "term", "vGrant", "vLog", "vResp", "votedFor",
    ),
}


def layout_defines(bounds: Bounds) -> dict:
    """The ``-D`` macros that specialise csrc/step.cu to a layout: servers,
    log capacity and message slots; in faithful mode also the election
    slots, the allLogs words and the log universe's terms and values."""
    lay = st.Layout.of(bounds)
    out = {"RT_N": lay.n, "RT_L": lay.L, "RT_S": lay.S}
    if lay.history:
        out.update(RT_E=lay.E, RT_WA=lay.Wa, RT_T=bounds.term_cap,
                   RT_V=bounds.n_values)
    return out


def _lib(bounds: Bounds):
    lib = build.library(SOURCE, layout_defines(bounds))
    lib.rt_step_width.restype = ctypes.c_int
    fn = lib.rt_step_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    W = st.Layout.of(bounds).width
    if lib.rt_step_width() != W:
        raise RuntimeError(f"step library width {lib.rt_step_width()} != "
                           f"layout width {W}")
    return fn


def occupancy(bounds: Bounds, spec: str = "full", symmetry: tuple = (),
              rows: int = 8192, variant: str = "full") -> tuple:
    """``(blocks, shared bytes)``: the K1 blocks one multiprocessor holds
    at once for a launch of ``rows`` rows of this layout and orbit-scan
    ``variant``, and the shared memory each takes
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = build.library(SOURCE, layout_defines(bounds))
    fn = lib.rt_step_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    P, Q = sym.group_sizes(bounds, symmetry)
    nv = bounds.n_values if "Value" in symmetry else 0
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(rows, len(SP.lane_table(bounds, spec)),
             P * 2 * bounds.n_servers + Q * nv, VARIANTS[variant],
             ctypes.byref(blocks), ctypes.byref(smem))
    build.check(err, "step occupancy")
    return blocks.value, smem.value


def build_step(bounds: Bounds, spec: str = "full", invariants: tuple = (),
               device="cuda", symmetry: tuple = (), view: str | None = None,
               prescan: bool | None = None, sigprune: bool | None = None,
               count: bool = False):
    """The fused step for ``device``: the K1 launcher on a CUDA device, the
    plain torch step on the CPU.  ``prescan``/``sigprune`` choose the orbit
    scan's variant (None: the gates, each with its rule for ``device``);
    without symmetry there is one scan.  ``count=True`` gives the K1
    launcher a ``stats`` tensor of the :data:`STATS` counters that its
    launches add to.  The step carries ``signature``
    (ops/kernels.step_signature), resolved here with its gates."""
    device = torch.device(device)
    signature = kernels.step_signature(bounds, spec, invariants, symmetry,
                                       view, device)
    if prescan is None:
        prescan = kernels.prescan_enabled(bounds, symmetry, device)
    if sigprune is None:
        sigprune = kernels.sigprune_enabled(bounds, symmetry)
    prescan, sigprune = bool(prescan and symmetry), bool(sigprune and symmetry)
    if device.type == "cpu":
        step = kernels.build_step(bounds, spec, invariants, symmetry, view,
                                  prescan=prescan, sigprune=sigprune)
        step.signature = signature
        return step
    if device.type != "cuda":
        raise ValueError(f"no step kernel for device {device}")
    if kernels.megakernel_setting() == "off":
        raise ValueError(MEGAKERNEL_OFF_CUDA)
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but torch sees no GPU")
    launch = _lib(bounds)
    variant = ("full", "prescan", "sigprune", "both")[prescan + 2 * sigprune]
    W = st.Layout.of(bounds).width
    table = torch.tensor(SP.lane_table(bounds, spec), dtype=torch.int32,
                         device=device).reshape(-1).contiguous()
    A = table.numel() // 5
    codes, prog = predprog.kernel_tables(tuple(invariants), bounds)
    n_inv = codes.size
    codes = torch.as_tensor(codes, device=device)
    prog = torch.as_tensor(prog, device=device)
    c = np.ascontiguousarray(fpr.lane_constants(W), dtype=np.uint32)
    consts = [(ctypes.c_uint32 * W)(*row) for row in c]   # host memory
    group = torch.as_tensor(sym.kernel_tables(bounds, symmetry),
                            device=device)
    P, Q = sym.group_sizes(bounds, symmetry)
    nv = bounds.n_values if "Value" in symmetry else 0
    rmaps = torch.as_tensor(sym.kernel_rank_maps(bounds, symmetry),
                            device=device).contiguous()
    # The launch arguments that do not change from call to call.
    fixed = (table.data_ptr(), A, ctypes.cast(consts[0], ctypes.c_void_p),
             ctypes.cast(consts[1], ctypes.c_void_p), group.data_ptr(), P, Q,
             nv, rmaps.data_ptr() if rmaps.numel() else None,
             views.KERNEL_CODES[view], codes.data_ptr() if n_inv else None,
             n_inv, prog.data_ptr(), bounds.max_term, bounds.max_log,
             bounds.max_msgs, bounds.max_dup, VARIANTS[variant])
    stats = torch.zeros(len(STATS), dtype=torch.int64, device=device) \
        if count else None
    names = ("svecs", "valid", "overflow", "fp_hi", "fp_lo", "inv_ok",
             "con_ok")

    def step(vecs):
        global launches
        if vecs.device.type != "cuda":
            raise ValueError(f"vecs on {vecs.device}, step built for {device}")
        if vecs.dtype != torch.int32 or vecs.dim() != 2 \
                or vecs.shape[1] != W:
            raise ValueError(f"vecs must be int32[B, {W}], got {vecs.dtype} "
                             f"{tuple(vecs.shape)}")
        vecs = vecs.contiguous()
        B, dev = vecs.shape[0], vecs.device
        i32, b8 = torch.int32, torch.bool
        outs = (torch.empty((B, A, W), dtype=i32, device=dev),
                torch.empty((B, A), dtype=b8, device=dev),
                torch.empty((B, A), dtype=b8, device=dev),
                torch.empty((B, A), dtype=i32, device=dev),
                torch.empty((B, A), dtype=i32, device=dev),
                torch.empty((B, A, n_inv), dtype=b8, device=dev),
                torch.empty((B, A), dtype=b8, device=dev))
        err = launch(vecs.data_ptr(), B, *fixed,
                     stats.data_ptr() if stats is not None else None,
                     *(t.data_ptr() for t in outs), build.stream_ptr(dev))
        build.check(err, "step kernel launch")
        launches += 1
        launches_by[variant] += 1
        return dict(zip(names, outs))

    step.keep = (table, consts, codes, prog, group, rmaps)  # what `fixed`
    #                                                          points to
    step.variant, step.stats = variant, stats
    step.signature = signature      # the step's identity (serve bins)
    return step


def build_step_routed(bounds: Bounds, spec: str = "full",
                      invariants: tuple = (), device="cuda",
                      symmetry: tuple = (), view: str | None = None,
                      k_rows: int = 0, prescan: bool | None = None,
                      sigprune: bool | None = None):
    """The routed step for ``device`` (ops/kernels.build_step_routed's
    contract): on a CUDA device K1's dense step, then the compaction of the
    live enabled lanes and the gathers in torch ops; the plain routed step
    on the CPU.  An unused slot's values are unwritten: readers mask by
    ``cvalid``."""
    device = torch.device(device)
    if device.type == "cpu":
        return kernels.build_step_routed(bounds, spec, invariants, symmetry,
                                         k_rows, view, sigprune=sigprune)
    K = kernels.check_routed(k_rows)
    dense = build_step(bounds, spec, invariants, device, symmetry, view,
                       prescan, sigprune)

    def step(vecs, row_ok=None):
        out = dense(vecs)
        valid = out["valid"]
        N = valid.numel()
        live = valid if row_ok is None else valid & row_ok[:, None]
        cidx, cvalid, gidx, route_ovf, n_en = kernels.route_compact(
            live.reshape(-1), K)
        return {"valid": valid, "overflow": out["overflow"], "cidx": cidx,
                "cvalid": cvalid,
                "csvecs": out["svecs"].reshape(N, -1)[gidx],
                "cfp_hi": out["fp_hi"].reshape(-1)[gidx],
                "cfp_lo": out["fp_lo"].reshape(-1)[gidx],
                "cinv_ok": out["inv_ok"].reshape(N, -1)[gidx],
                "ccon_ok": out["con_ok"].reshape(-1)[gidx],
                "route_ovf": route_ovf, "n_en": n_en}

    step.dense = dense
    return step
