"""The dedup key of given rows under SYMMETRY or a VIEW, as a CUDA entry of
``csrc/step.cu`` (``rt_orbit_key_launch``).

It replaces XLA code, not a Pallas kernel: ``raft_tla_tpu/ops/symmetry.py:557``
``build_orbit_fp``, which keys the IR-compiled Raft step (``ir-full``,
``ir-election``, ``ir-replication``) under SYMMETRY and VIEWs.  On the card
that key used to exist only inside K1; the entry runs K1's dedup-key stage
(the full orbit scan) on rows K1 did not compute, so the keys are K1's by
construction.

:func:`build_keyer` returns ``keyer(rows int32[N, W], valid=None) ->
(hi, lo)`` for ``ops/kernels.build_step(keyer=)``: the rows are canonical
successors, unviewed, and the key is ``min over g of
fp(canonicalize(g(view(s))))`` (the unsigned pair compared
lexicographically), as int32 tensors holding the uint32 bits.  With a
``valid`` mask ``bool[N]`` (the step's lanes) a row flagged False is
neither read nor scanned and its key is 0: a first launch lists the valid
rows, and the scan's blocks hold those alone (``valid=None``: every row
is valid).  A CUDA tensor launches the kernel; a CPU tensor runs the plain
version, :func:`plain_keys` (the view, then ``ops/symmetry.build_orbit_fp``,
or the plain fingerprint when there is no symmetry).  Nothing else chooses
between them.  The library is K1's, built per layout
(``ops/pallas_step._lib``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import views
from raft_tla_tpu_torch.ops import build
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import pallas_step
from raft_tla_tpu_torch.ops import state as st
from raft_tla_tpu_torch.ops import symmetry as sym

# Kernel launches so far (chip_smoke.py reads and resets it).
launches = 0


def _entry(bounds: Bounds):
    pallas_step._lib(bounds)         # K1's library for this layout, checked
    fn = build.library(pallas_step.SOURCE,
                       pallas_step.layout_defines(bounds)).rt_orbit_key_launch
    if fn.argtypes is None:          # first call: declare the signature
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return fn


def plain_keys(rows: torch.Tensor, bounds: Bounds, symmetry: tuple = (),
               view: str | None = None,
               valid: torch.Tensor | None = None) -> tuple:
    """The plain version: ``rows int32[N, W] -> (hi, lo)`` int32[N]; with
    ``valid``, the valid rows' keys and 0 elsewhere."""
    if valid is not None:
        hi = torch.zeros(rows.shape[:1], dtype=torch.int32,
                         device=rows.device)
        lo = torch.zeros_like(hi)
        hi[valid], lo[valid] = plain_keys(rows[valid], bounds, symmetry,
                                          view)
        return hi, lo
    lay = st.Layout.of(bounds)
    struct = st.unpack(rows, lay)
    if view:
        struct = views.torch_view(view)(struct)
    consts = fpr.torch_constants(lay.width, rows.device)
    if symmetry:
        return sym.build_orbit_fp(bounds, tuple(symmetry), consts)(struct)
    return fpr.fingerprint(st.pack(struct), consts)


def build_keyer(bounds: Bounds, symmetry: tuple = (),
                view: str | None = None):
    """``keyer(rows int32[N, W], valid=None) -> (hi, lo)``: the kernel for
    a CUDA tensor (its tables uploaded once per device), :func:`plain_keys`
    for a CPU one."""
    symmetry = tuple(symmetry)
    W = st.Layout.of(bounds).width
    P, Q = sym.group_sizes(bounds, symmetry)
    nv = bounds.n_values if "Value" in symmetry else 0
    c = np.ascontiguousarray(fpr.lane_constants(W), dtype=np.uint32)
    consts = [(ctypes.c_uint32 * W)(*row) for row in c]     # host memory
    tables: dict = {}
    entry = []

    def keyer(rows: torch.Tensor, valid: torch.Tensor | None = None) \
            -> tuple:
        global launches
        if rows.dim() != 2 or rows.dtype != torch.int32 \
                or rows.shape[1] != W:
            raise ValueError(f"rows must be int32[N, {W}], got {rows.dtype} "
                             f"{tuple(rows.shape)}")
        if valid is not None and (valid.dtype != torch.bool
                                  or valid.shape != rows.shape[:1]
                                  or valid.device != rows.device):
            raise ValueError(f"valid must be bool[{rows.shape[0]}] on "
                             f"{rows.device}")
        if rows.device.type == "cpu":
            return plain_keys(rows, bounds, symmetry, view, valid)
        if rows.device.type != "cuda":
            raise ValueError(f"no orbit-key kernel for device {rows.device}")
        dev = rows.device
        if not entry:
            entry.append(_entry(bounds))
        if dev not in tables:
            group = torch.as_tensor(sym.kernel_tables(bounds, symmetry),
                                    device=dev)
            rmaps = torch.as_tensor(sym.kernel_rank_maps(bounds, symmetry),
                                    device=dev).contiguous()
            tables[dev] = (group, rmaps)
        group, rmaps = tables[dev]
        rows = rows.contiguous()
        N = rows.shape[0]
        valid = torch.ones((N,), dtype=torch.bool, device=dev) \
            if valid is None else valid.contiguous()
        work = torch.empty((N + 1,), dtype=torch.int32,
                           device=dev)   # the valid rows' list and count
        hi = torch.empty((N,), dtype=torch.int32, device=dev)
        lo = torch.empty((N,), dtype=torch.int32, device=dev)
        err = entry[0](
            rows.data_ptr(), valid.data_ptr(), work.data_ptr(), N,
            ctypes.cast(consts[0], ctypes.c_void_p),
            ctypes.cast(consts[1], ctypes.c_void_p), group.data_ptr(), P, Q,
            nv, rmaps.data_ptr() if rmaps.numel() else None,
            views.KERNEL_CODES[view], hi.data_ptr(), lo.data_ptr(),
            build.stream_ptr(dev))
        build.check(err, "orbit-key kernel launch")
        launches += 1
        return hi, lo

    keyer.keep = consts              # what the launch's pointers point to
    return keyer
