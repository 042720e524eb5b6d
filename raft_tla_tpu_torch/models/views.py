"""Built-in state views (TLC ``VIEW``) — the port's copy of
``raft_tla_tpu/models/views.py``.

Two states are identified whenever their view values coincide: the view is
folded into the dedup key only, while the stored rows, the invariants and
the StateConstraint see the full successor.  A registered view is EXACT:
view-equivalence is a bisimulation with respect to every action, and no
registered invariant reads a field the view rewrites (the reference's
docstring carries the argument; its ``tests/test_views.py`` checks it).

``deadvotes`` zeroes ``votesResponded[i]``/``votesGranted[i]`` whenever
``state[i] /= Candidate``: every read of the vote sets in the spec is
guarded by ``state[i] = Candidate``, and every other action leaves them
alone or resets them.  The view commutes with server and value
permutations, so ``orbit_fp(view(s))`` is well defined.

:func:`py_view` maps one host state; :func:`torch_view` maps a batched
struct (ops/state.py layout, any leading dims) with the same arithmetic;
``csrc/step.cu`` applies the same rule in the step kernel (view code 1).
"""

from __future__ import annotations

import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.models import spec as S

# view name -> short description (CLI help, cfg validation)
REGISTRY = {
    "deadvotes": "zero votesResponded/votesGranted of non-Candidates "
                 "(exact: dead-variable elimination)",
}

# The fields a view rewrites before fingerprinting (analysis/cfglint
# checks invariants that read them only up to the view).
VIEW_WRITES = {
    "deadvotes": ("vResp", "vGrant"),
}

# The permutation axes a view commutes with (SYMMETRY on any other axis
# would make the viewed keys orbit-dependent).
EQUIVARIANT_AXES = {
    "deadvotes": ("Server", "Value"),
}

# The view's code in the step kernel's argument list (0 = no view).
KERNEL_CODES = {None: 0, "deadvotes": 1}


def py_view(name: str):
    """Host-side view map: PyState -> PyState."""
    if name == "deadvotes":
        def view(s, bounds: Bounds):
            vr = tuple(v if r == S.CANDIDATE else 0
                       for v, r in zip(s.vResp, s.role))
            vg = tuple(v if r == S.CANDIDATE else 0
                       for v, r in zip(s.vGrant, s.role))
            if vr == s.vResp and vg == s.vGrant:
                return s
            return s._replace(vResp=vr, vGrant=vg)

        return view
    raise ValueError(f"unknown view {name!r} (known: {sorted(REGISTRY)})")


def torch_view(name: str):
    """Batched view map on a struct of tensors — arithmetic-identical to
    :func:`py_view` (and to the reference's ``jnp_view``)."""
    if name == "deadvotes":
        def view(struct):
            cand = struct["role"] == S.CANDIDATE
            out = dict(struct)
            out["vResp"] = torch.where(cand, struct["vResp"], 0)
            out["vGrant"] = torch.where(cand, struct["vGrant"], 0)
            return out

        return view
    raise ValueError(f"unknown view {name!r} (known: {sorted(REGISTRY)})")
