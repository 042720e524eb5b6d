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
(models/views.KERNEL_CODES).

The kernel is compiled per layout (servers, log capacity, message slots
and, in faithful mode, election slots, allLogs words and the log
universe's terms and values are ``-D`` macros, see csrc/step.cu) and cached
by that key.  It is held to this contract against the plain step:
``valid`` equal on every lane, every other output bit-equal where
``valid`` is true.  Invalid lanes are written as zeros; the engine never
reads them.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import invariants as inv_mod
from raft_tla_tpu_torch.models import spec as SP
from raft_tla_tpu_torch.models import views
from raft_tla_tpu_torch.ops import build
from raft_tla_tpu_torch.ops import kernels
from raft_tla_tpu_torch.ops import pallas_fp
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym

SOURCE = "step.cu"

# Kernel launches so far (chip_smoke.py reads and resets it).
launches = 0

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
                   + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    W = st.Layout.of(bounds).width
    if lib.rt_step_width() != W:
        raise RuntimeError(f"step library width {lib.rt_step_width()} != "
                           f"layout width {W}")
    return fn


def build_step(bounds: Bounds, spec: str = "full", invariants: tuple = (),
               device="cuda", symmetry: tuple = (), view: str | None = None):
    """The fused step for ``device``: the K1 launcher on a CUDA device, the
    plain torch step on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return kernels.build_step(bounds, spec, invariants, symmetry, view)
    if device.type != "cuda":
        raise ValueError(f"no step kernel for device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but torch sees no GPU")
    launch = _lib(bounds)
    W = st.Layout.of(bounds).width
    table = torch.tensor(SP.lane_table(bounds, spec), dtype=torch.int32,
                         device=device).reshape(-1).contiguous()
    A = table.numel() // 5
    codes = [inv_mod.CODES[nm] for nm in invariants]
    n_inv = len(codes)
    inv_arr = (ctypes.c_int * max(1, n_inv))(*codes)
    consts = pallas_fp._device_constants(W, device)
    group = torch.as_tensor(sym.kernel_tables(bounds, symmetry),
                            device=device)
    P, Q = sym.group_sizes(bounds, symmetry)
    nv = bounds.n_values if "Value" in symmetry else 0
    rmaps = torch.as_tensor(sym.kernel_rank_maps(bounds, symmetry),
                            device=device).contiguous()
    view_code = views.KERNEL_CODES[view]

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
        out = {
            "svecs": torch.empty((B, A, W), dtype=torch.int32, device=dev),
            "valid": torch.empty((B, A), dtype=torch.bool, device=dev),
            "overflow": torch.empty((B, A), dtype=torch.bool, device=dev),
            "fp_hi": torch.empty((B, A), dtype=torch.int32, device=dev),
            "fp_lo": torch.empty((B, A), dtype=torch.int32, device=dev),
            "inv_ok": torch.empty((B, A, n_inv), dtype=torch.bool, device=dev),
            "con_ok": torch.empty((B, A), dtype=torch.bool, device=dev),
        }
        err = launch(vecs.data_ptr(), B, table.data_ptr(), A,
                     consts[0].data_ptr(), consts[1].data_ptr(),
                     group.data_ptr(), P, Q, nv,
                     rmaps.data_ptr() if rmaps.numel() else None, view_code,
                     ctypes.cast(inv_arr, ctypes.c_void_p), n_inv,
                     bounds.max_term, bounds.max_log, bounds.max_msgs,
                     bounds.max_dup,
                     *(out[k].data_ptr() for k in (
                         "svecs", "valid", "overflow", "fp_hi", "fp_lo",
                         "inv_ok", "con_ok")),
                     build.stream_ptr(dev))
        build.check(err, "step kernel launch")
        launches += 1
        return out

    return step

