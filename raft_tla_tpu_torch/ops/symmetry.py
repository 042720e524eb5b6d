"""Symmetry reduction over the Server and Value model values (TLC SYMMETRY)
— the port of ``raft_tla_tpu/ops/symmetry.py``.

The dedup key of a state becomes its **orbit-minimal fingerprint**:
``min over all group elements g of fp(canonicalize(g(s)))``, the min taken
lexicographically on the unsigned pair (hi, lo).  The min is
orbit-invariant, so states equal up to renaming share one key and one store
row: the reachable count becomes the orbit count, TLC's SYMMETRY semantics.

Permuting one state under a server permutation ``p`` (the new index of old
server j is ``p[j]``):

- per-server axes (role, term, votedFor, commitIndex, logLen, log*, vResp,
  vGrant): rows reordered by the inverse permutation;
- ``votedFor`` ids map through ``p`` (0 = Nil fixed); vote bitmasks move
  bit j to bit ``p[j]``;
- ``nextIndex``/``matchIndex`` reorder both axes;
- the ``src``/``dst`` fields of occupied message slots map through ``p``
  (empty slots stay all-zero), then the bag re-canonicalizes.

A value permutation ``q`` remaps ``logVal`` (0 = padding fixed) and the
entry-value field ``e`` of occupied message slots.  The group is
``Server x Value``, ``|G| = n! * V!``; element 0 is the identity.

Faithful mode (ops/state.HISTORY_FIELDS): log ranks carry no server ids, so
``allLogs``, ``eLog``, ``eTerm`` and ``mlog`` are fixed by ``p``;
``voterLog`` reorders both axes like ``nextIndex``, occupied election slots
map ``eLeader`` through ``p`` and bit-permute ``eVotes``, and ``eVLog``
reorders its columns.  ``q`` maps every log rank through the rank map of
:func:`_rank_maps`: ``eLog`` directly, ``vLog``/``eVLog`` in the rank+1
form (0 = absent fixed), the ``g`` field of occupied lo words, and
``allLogs`` moves bit r to bit ``rmap[r]``.  The election slots re-sort in
``canonicalize`` like the bag.

Three forms of the same arithmetic:

- :func:`orbit_fingerprint` / :func:`py_orbit_fingerprint`: one state on
  the host (numpy), used for the initial state's key
  (:func:`init_fingerprint`);
- :func:`build_orbit_fp`: the **plain** batched key in torch, a loop over
  the |G| images of :func:`group_images` (the stacked tables of
  :func:`_server_luts` / :func:`_value_luts` and the rank maps) — the
  plain version K1's orbit stage is held to; :func:`orbit_sizes` counts
  the distinct images of each row;
- ``csrc/step.cu``: K1's orbit stage on the card, fed by
  :func:`kernel_tables` and :func:`kernel_rank_maps`.

:func:`build_orbit_fp` with ``prune=True`` is sig-prune, the reference's
signature-refinement pruning (``RAFT_TLA_SIGPRUNE``, ``--sig-prune``):
exact transposition probes find the pairs of servers (and of values) that
a state's image leaves unchanged, and the scan keys one group element per
coset of the stabilizer they generate — the same minimum, bit for bit
(see :func:`pruned_orbit_fp`).  K1 runs the same probes and skips per lane
(``csrc/step.cu``).  The prescan is the step's (ops/kernels).
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from raft_tla_tpu_torch.config import Bounds
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import msgbits as mb
from raft_tla_tpu_torch.ops import state as st

MAX_SYM_SERVERS = 6      # 720 permutations
MAX_SYM_VALUES = 5       # 120 value permutations

# Calls of the plain batched orbit key (chip_smoke.py checks that the card
# path never makes one).
plain_calls = 0

_M32 = 0xFFFFFFFF


def permutations(bounds: Bounds) -> tuple:
    if bounds.n_servers > MAX_SYM_SERVERS:
        raise ValueError(
            f"Server symmetry supports at most {MAX_SYM_SERVERS} servers "
            f"(got {bounds.n_servers}: {math.factorial(bounds.n_servers)}"
            " permutations)")
    return tuple(itertools.permutations(range(bounds.n_servers)))


def value_permutations(bounds: Bounds) -> tuple:
    if bounds.n_values > MAX_SYM_VALUES:
        raise ValueError(
            f"Value symmetry supports at most {MAX_SYM_VALUES} values "
            f"(got {bounds.n_values})")
    return tuple(itertools.permutations(range(bounds.n_values)))


def group_sizes(bounds: Bounds, axes: tuple) -> tuple:
    """``(P, Q)``: server and value permutations scanned for ``axes``."""
    P = len(permutations(bounds)) if "Server" in axes else 1
    Q = len(value_permutations(bounds)) if "Value" in axes else 1
    return P, Q


def _field_mask(fields: dict, name: str) -> tuple:
    sh, w = fields[name]
    return sh, w, (1 << w) - 1


@functools.lru_cache(maxsize=None)
def _rank_maps(bounds: Bounds) -> np.ndarray:
    """int32 ``[Q, U]``: per value permutation q, each log rank -> the rank
    of the value-permuted log (faithful mode; the identity first)."""
    from raft_tla_tpu_torch.ops.loguniv import LogUniverse
    uni = LogUniverse.of(bounds)
    logs = [uni.tuple_of_id(r) for r in range(uni.size)]
    out = np.empty((len(value_permutations(bounds)), uni.size), np.int32)
    for qi, q in enumerate(value_permutations(bounds)):
        out[qi] = [uni.id_of_tuple(tuple((t, q[v - 1] + 1) for t, v in log))
                   for log in logs]
    return out


def _permute_mask(words, rmap):
    """A set-of-ranks bitmask ``[..., Wa]`` (int32 words) with bit r moved
    to bit ``rmap[r]``.  Built in int64 holding [0, 2^32): the moved bits
    are distinct, so their sum within a word is their OR."""
    torch_in = isinstance(words, torch.Tensor)
    rmap = torch.as_tensor(rmap, device=words.device).long() if torch_in \
        else np.asarray(rmap, np.int64)
    U, Wa = rmap.shape[0], words.shape[-1]
    rs = torch.arange(U, device=words.device) if torch_in else np.arange(U)
    w64 = words.long() if torch_in else words.astype(np.int64)
    bits = (w64[..., rs // 32] >> (rs % 32)) & 1                     # [.., U]
    place = (rmap // 32 == (torch.arange(Wa, device=words.device)
                            if torch_in else np.arange(Wa))[:, None]) \
        * (1 << (rmap % 32))                                         # [Wa, U]
    new = (bits.unsqueeze(-2) if torch_in else bits[..., None, :]) * place
    new = new.sum(-1)
    if torch_in:
        return fpr.u32_bits(new)
    return new.astype(np.uint32).view(np.int32)


# -- one state (numpy) ---------------------------------------------------------

def permute_values(struct: dict, q: tuple, bounds: Bounds) -> dict:
    """Apply value permutation ``q`` to one numpy state struct: ``logVal``
    contents (0 = padding fixed), the message field ``e`` of occupied
    slots and, in faithful mode, every log rank (see the module
    docstring)."""
    V = bounds.n_values
    vlut = np.asarray((0,) + tuple(q[v - 1] + 1 for v in range(1, V + 1)))
    e_sh, e_w, e_m = _field_mask(mb._LO_FIELDS, "e")
    e_lut = np.zeros((1 << e_w,), np.int64)
    e_lut[:V + 1] = vlut
    out = dict(struct)
    out["logVal"] = vlut[np.clip(struct["logVal"], 0, V)].astype(np.int32)
    lo = struct["msgLo"]
    new_lo = (lo & ~(e_m << e_sh)) | (e_lut[(lo >> e_sh) & e_m] << e_sh)
    if "allLogs" in struct:
        rmap = _rank_maps(bounds)[value_permutations(bounds).index(q)]
        U = rmap.shape[0]
        rlut1 = np.concatenate([[0], rmap + 1])
        out["vLog"] = rlut1[np.clip(struct["vLog"], 0, U)].astype(np.int32)
        out["eLog"] = rmap[np.clip(struct["eLog"], 0, U - 1)]
        out["eVLog"] = rlut1[np.clip(struct["eVLog"], 0, U)].astype(np.int32)
        g_sh, g_w, g_m = _field_mask(mb._LO_FIELDS, "g")
        g_lut = np.zeros((1 << g_w,), np.int64)
        g_lut[:U] = rmap
        new_lo = (new_lo & ~(g_m << g_sh)) \
            | (g_lut[(new_lo >> g_sh) & g_m] << g_sh)
        out["allLogs"] = _permute_mask(struct["allLogs"], rmap)
    out["msgLo"] = np.where(struct["msgCount"] > 0, new_lo,
                            lo).astype(np.int32)
    return out


def permute_struct(struct: dict, p: tuple, bounds: Bounds) -> dict:
    """Apply server permutation ``p`` to one numpy state struct (the caller
    re-canonicalizes the message bag)."""
    n = bounds.n_servers
    inv = np.asarray([p.index(k) for k in range(n)])
    vf_map = np.asarray((0,) + tuple(p[j] + 1 for j in range(n)))

    def bitperm(mask):
        out = np.zeros_like(mask)
        for j in range(n):
            out = out | (((mask >> j) & 1) << p[j])
        return out

    s_sh, _, s_m = _field_mask(mb._HI_FIELDS, "src")
    d_sh, _, d_m = _field_mask(mb._HI_FIELDS, "dst")
    p_lut = np.asarray(p + (0,) * (16 - n))
    hi = struct["msgHi"]
    new_hi = (hi & ~((s_m << s_sh) | (d_m << d_sh))) \
        | (p_lut[(hi >> s_sh) & s_m] << s_sh) \
        | (p_lut[(hi >> d_sh) & d_m] << d_sh)
    out = {
        "role": struct["role"][inv],
        "term": struct["term"][inv],
        "votedFor": vf_map[np.clip(struct["votedFor"][inv], 0, n)],
        "commitIndex": struct["commitIndex"][inv],
        "logLen": struct["logLen"][inv],
        "logTerm": struct["logTerm"][inv],
        "logVal": struct["logVal"][inv],
        "vResp": bitperm(struct["vResp"][inv]),
        "vGrant": bitperm(struct["vGrant"][inv]),
        "nextIndex": struct["nextIndex"][inv][:, inv],
        "matchIndex": struct["matchIndex"][inv][:, inv],
        "msgHi": np.where(struct["msgCount"] > 0, new_hi, hi),
        "msgLo": struct["msgLo"],
        "msgCount": struct["msgCount"],
    }
    if "eTerm" in struct:
        eocc = struct["eTerm"] > 0
        out.update({
            "allLogs": struct["allLogs"],
            "vLog": struct["vLog"][inv][:, inv],
            "eTerm": struct["eTerm"],
            "eLeader": np.where(eocc, p_lut[np.clip(struct["eLeader"], 0,
                                                    15)],
                                struct["eLeader"]),
            "eLog": struct["eLog"],
            "eVotes": np.where(eocc, bitperm(struct["eVotes"]),
                               struct["eVotes"]),
            "eVLog": struct["eVLog"][:, inv],
        })
    return {k: np.asarray(v).astype(np.int32) for k, v in out.items()}


def orbit_fingerprint(struct: dict, bounds: Bounds, consts,
                      axes: tuple = ("Server",)) -> tuple:
    """Orbit-minimal (hi, lo) uint32 key of one canonical numpy struct."""
    sperms = permutations(bounds) if "Server" in axes \
        else (tuple(range(bounds.n_servers)),)
    vqs = value_permutations(bounds) if "Value" in axes else (None,)
    best = None
    for p in sperms:
        ps = permute_struct(struct, p, bounds)
        for q in vqs:
            t = permute_values(ps, q, bounds) if q is not None else ps
            t = st.canonicalize(t)
            hi, lo = fpr.fingerprint_np(st.pack(t), consts)
            key = (int(hi), int(lo))
            if best is None or key < best:
                best = key
    return best


@functools.lru_cache(maxsize=None)
def _host_consts(width: int) -> np.ndarray:
    return fpr.lane_constants(width)


def py_orbit_fingerprint(s, bounds: Bounds, axes: tuple = ("Server",)
                         ) -> tuple:
    """Orbit key of a PyState, on the host: ``(hi, lo)`` as Python ints."""
    from raft_tla_tpu_torch.models import interp

    lay = st.Layout.of(bounds)
    struct = st.unpack(interp.to_vec(s, bounds), lay)
    return orbit_fingerprint(struct, bounds, _host_consts(lay.width), axes)


def init_fingerprint(config, init_py, init_vec) -> tuple:
    """The dedup key of the initial state, view-folded and orbit-reduced per
    the config — ``(hi, lo)`` as Python ints in [0, 2^32)."""
    from raft_tla_tpu_torch.models import interp, views

    if config.view:
        viewed = views.py_view(config.view)(init_py, config.bounds)
        if viewed is not init_py:
            init_py = viewed
            init_vec = interp.to_vec(viewed, config.bounds)
    if config.symmetry:
        return py_orbit_fingerprint(init_py, config.bounds, config.symmetry)
    hi, lo = fpr.fingerprint_np(np.asarray(init_vec, np.int32),
                                _host_consts(init_vec.shape[-1]))
    return int(hi), int(lo)


# -- stacked tables ---------------------------------------------------------

def _server_luts(bounds: Bounds) -> tuple:
    """Stacked tables for every server permutation: ``inv_idx [P, n]`` row
    gathers, ``vf_map [P, n+1]`` votedFor relabel, ``bit_lut [P, 2^n]``
    vote-bitmask permutation, ``p_lut [P, 16]`` message src/dst relabel."""
    ps = permutations(bounds)
    n, P = bounds.n_servers, len(ps)
    inv_idx = np.empty((P, n), np.int32)
    vf_map = np.empty((P, n + 1), np.int32)
    bit_lut = np.empty((P, 1 << n), np.int32)
    p_lut = np.zeros((P, 16), np.int32)
    masks = np.arange(1 << n, dtype=np.int64)
    for i, p in enumerate(ps):
        inv_idx[i] = [p.index(k) for k in range(n)]
        vf_map[i] = (0,) + tuple(p[j] + 1 for j in range(n))
        bm = np.zeros((1 << n,), np.int64)
        for j in range(n):
            bm |= ((masks >> j) & 1) << p[j]
        bit_lut[i] = bm
        p_lut[i, :n] = p
    return inv_idx, vf_map, bit_lut, p_lut


def _value_luts(bounds: Bounds) -> tuple:
    """Stacked tables per value permutation: ``vlut [Q, V+1]`` logVal
    relabel and ``e_lut [Q, 16]`` for the message entry-value field."""
    qs = value_permutations(bounds)
    V = bounds.n_values
    _, e_w, _ = _field_mask(mb._LO_FIELDS, "e")
    vlut = np.zeros((len(qs), V + 1), np.int32)
    e_lut = np.zeros((len(qs), 1 << e_w), np.int32)
    for i, q in enumerate(qs):
        vlut[i] = (0,) + tuple(q[v - 1] + 1 for v in range(1, V + 1))
        e_lut[i, :V + 1] = vlut[i]
    return vlut, e_lut


def kernel_rank_maps(bounds: Bounds, axes: tuple) -> np.ndarray:
    """K1's rank maps, int16 ``[Q, U]`` (ranks < 1,024 fit): one row per
    value permutation of the group's table; empty unless the run is
    faithful with Value symmetry."""
    if not bounds.history or "Value" not in axes:
        return np.zeros((0,), np.int16)
    return _rank_maps(bounds).astype(np.int16)  # 10-bit ranks (< 1,024) fit int16


def kernel_tables(bounds: Bounds, axes: tuple) -> np.ndarray:
    """K1's group table, int8: ``P`` rows of ``(p, inv)`` (2n bytes each;
    the identity alone when Server is off), then ``Q`` rows of ``q`` (V
    bytes each; none when Value is off).  The kernel derives every other
    table of :func:`_server_luts` / :func:`_value_luts` from these in the
    thread."""
    n = bounds.n_servers
    ps = permutations(bounds) if "Server" in axes else (tuple(range(n)),)
    qs = value_permutations(bounds) if "Value" in axes else ()
    rows = [list(p) + [p.index(k) for k in range(n)] for p in ps]
    flat = [x for r in rows for x in r] + [x for q in qs for x in q]
    return np.asarray(flat, np.int8)


# -- the plain batched key (torch) ------------------------------------------

def _lut(table, idx):
    """``table[idx]`` with the index clamped into range (a JAX gather)."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def _permute_struct_batch(s: dict, inv, vf_map, bit_lut, p_lut) -> dict:
    """Server permutation of a batched struct (leading dims ``...``), the
    permutation given as one row of each :func:`_server_luts` table."""
    def rows(a, nd):
        return a.index_select(a.dim() - nd, inv)

    s_sh, _, s_m = _field_mask(mb._HI_FIELDS, "src")
    d_sh, _, d_m = _field_mask(mb._HI_FIELDS, "dst")
    hi = s["msgHi"]
    new_hi = (hi & ~((s_m << s_sh) | (d_m << d_sh))) \
        | (_lut(p_lut, (hi >> s_sh) & s_m) << s_sh) \
        | (_lut(p_lut, (hi >> d_sh) & d_m) << d_sh)
    out = {
        "role": rows(s["role"], 1),
        "term": rows(s["term"], 1),
        "votedFor": _lut(vf_map, rows(s["votedFor"], 1)),
        "commitIndex": rows(s["commitIndex"], 1),
        "logLen": rows(s["logLen"], 1),
        "logTerm": rows(s["logTerm"], 2),
        "logVal": rows(s["logVal"], 2),
        "vResp": _lut(bit_lut, rows(s["vResp"], 1)),
        "vGrant": _lut(bit_lut, rows(s["vGrant"], 1)),
        "nextIndex": rows(rows(s["nextIndex"], 2), 1),
        "matchIndex": rows(rows(s["matchIndex"], 2), 1),
        "msgHi": torch.where(s["msgCount"] > 0, new_hi, hi),
        "msgLo": s["msgLo"],
        "msgCount": s["msgCount"],
    }
    if "eTerm" in s:
        eocc = s["eTerm"] > 0
        out.update({
            "allLogs": s["allLogs"],
            "vLog": rows(rows(s["vLog"], 2), 1),
            "eTerm": s["eTerm"],
            "eLeader": torch.where(eocc, _lut(p_lut, s["eLeader"]),
                                   s["eLeader"]),
            "eLog": s["eLog"],
            "eVotes": torch.where(eocc, _lut(bit_lut, s["eVotes"]),
                                  s["eVotes"]),
            "eVLog": rows(s["eVLog"], 1),
        })
    return out


def _permute_values_batch(s: dict, vlut, e_lut, rmap=None) -> dict:
    """Value permutation of a batched struct, one row of each
    :func:`_value_luts` table (and, in faithful mode, of the rank maps)."""
    e_sh, _, e_m = _field_mask(mb._LO_FIELDS, "e")
    lo = s["msgLo"]
    new_lo = (lo & ~(e_m << e_sh)) | (_lut(e_lut, (lo >> e_sh) & e_m) << e_sh)
    out = dict(s)
    out["logVal"] = _lut(vlut, s["logVal"])
    if "allLogs" in s:
        U = rmap.shape[0]
        rlut1 = torch.cat([rmap.new_zeros(1), rmap + 1])
        g_sh, g_w, g_m = _field_mask(mb._LO_FIELDS, "g")
        g_lut = torch.cat([rmap, rmap.new_zeros((1 << g_w) - U)])
        out["vLog"] = _lut(rlut1, s["vLog"])
        out["eLog"] = _lut(rmap, s["eLog"])
        out["eVLog"] = _lut(rlut1, s["eVLog"])
        new_lo = (new_lo & ~(g_m << g_sh)) \
            | (_lut(g_lut, (new_lo >> g_sh) & g_m) << g_sh)
        out["allLogs"] = _permute_mask(s["allLogs"], rmap)
    out["msgLo"] = torch.where(s["msgCount"] > 0, new_lo, lo)
    return out


def group_images(bounds: Bounds, axes: tuple, device):
    """``images(struct)``: a generator over the |G| = P·Q group elements
    (element k is server permutation ``k // Q`` then value permutation
    ``k % Q``) of the canonical packed image ``int32[..., W]`` of a batched
    struct — the plain permutation that K1's orbit stage is held to.
    ``images.image(struct, k)`` is element k's image alone."""
    sl = _server_luts(bounds) if "Server" in axes else None
    vl = _value_luts(bounds) if "Value" in axes else None
    sluts = tuple(torch.as_tensor(a, device=device) for a in sl) \
        if sl else None
    vluts = tuple(torch.as_tensor(a, device=device) for a in vl) \
        if vl else None
    if vluts is not None and bounds.history:
        vluts += (torch.as_tensor(_rank_maps(bounds), device=device),)
    if sluts is not None:
        sluts = (sluts[0].long(),) + sluts[1:]
    P, Q = group_sizes(bounds, axes)

    def image(struct, k):
        pi, qi = k // Q, k % Q
        t = struct
        if sluts is not None:
            t = _permute_struct_batch(t, *(a[pi] for a in sluts))
        if vluts is not None:
            t = _permute_values_batch(t, *(a[qi] for a in vluts))
        return st.pack(st.canonicalize(t))

    def images(struct):
        for k in range(P * Q):
            yield image(struct, k)

    images.image = image
    return images


# -- sig-prune (the reference's signature-refinement pruning) ---------------
#
# Servers a and b are interchangeable in a state iff the transposition
# (a b) maps the state to itself, compared as packed canonical rows (exact,
# no hashing).  The verified transpositions generate a subgroup H of the
# state's stabilizer, and g and g∘h give the same image for h in H, so the
# scan needs one element per coset gH: keep g iff it is increasing on every
# verified pair (exactly one element of each coset is).  Every distinct
# orbit member is still keyed, so the pruned minimum is the full one.
# Value permutations factor the same way: kept(p, q) = kept_s(p) & kept_v(q).
# A per-server signature (:func:`_server_sig`) is a necessary condition for
# interchangeability, so a chunk in which no state repeats a signature
# skips the server probes.  The reference's static-slot rungs serve XLA's
# static shapes; here (as in K1) the scan just skips what no lane keeps.

@functools.lru_cache(maxsize=None)
def _transposition_pairs(bounds: Bounds) -> tuple:
    """``(a, b, perm_index)`` for every server pair a < b, ``perm_index``
    locating the transposition (a b) in :func:`permutations` order."""
    ps = permutations(bounds)
    n = bounds.n_servers
    out = []
    for a in range(n):
        for b in range(a + 1, n):
            t = list(range(n))
            t[a], t[b] = b, a
            out.append((a, b, ps.index(tuple(t))))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _value_transposition_pairs(bounds: Bounds) -> tuple:
    """The value-axis counterpart of :func:`_transposition_pairs`."""
    qs = value_permutations(bounds)
    V = bounds.n_values
    out = []
    for a in range(V):
        for b in range(a + 1, V):
            t = list(range(V))
            t[a], t[b] = b, a
            out.append((a, b, qs.index(tuple(t))))
    return tuple(out)


def _pair_less_lut(perms: tuple, pairs: tuple) -> np.ndarray:
    """bool ``[P, n_pairs]``: permutation p is increasing on pair (a, b),
    ``p[a] < p[b]`` — the coset-representative condition per pair."""
    arr = np.asarray(perms, np.int32)
    return np.stack([arr[:, a] < arr[:, b] for (a, b, _) in pairs], axis=1)


def _server_sig(struct: dict) -> torch.Tensor:
    """A per-server signature ``[..., n]`` (int64 holding uint32): role,
    term, commitIndex, logLen, the votedFor class (nil, self, other), the
    vote counts and the log, mixed.  Equal signatures are necessary for two
    servers to be interchangeable; the exact probe decides."""
    def mix(h, x):
        return ((h ^ (x.long() & _M32)) * 0x9E3779B1) & _M32

    n = struct["role"].shape[-1]
    vf = struct["votedFor"]
    self_id = torch.arange(n, device=vf.device) + 1
    vf_cls = torch.where(vf == 0, 0, torch.where(vf == self_id, 1, 2))
    h = torch.full(struct["role"].shape, 0x811C9DC5, dtype=torch.int64,
                   device=vf.device)
    for f in ("role", "term", "commitIndex", "logLen"):
        h = mix(h, struct[f])
    h = mix(h, vf_cls)
    # at call time: ops/kernels imports this module
    from raft_tla_tpu_torch.ops.kernels import _popcount
    h = mix(h, _popcount(struct["vResp"]))
    h = mix(h, _popcount(struct["vGrant"]))
    lt, lv = struct["logTerm"], struct["logVal"]
    for c in range(lt.shape[-1]):
        h = mix(h, lt[..., c])
        h = mix(h, lv[..., c])
    return h


def keep_mask(bounds: Bounds, axes: tuple, struct: dict, images
              ) -> torch.Tensor:
    """bool ``[N, P*Q]``: the group elements sig-prune keys for each row of
    ``struct`` (fields ``[N, ...]``); ``images`` is :func:`group_images`'
    generator.  Element 0, the identity, is always kept."""
    P, Q = group_sizes(bounds, axes)
    N, dev = struct["role"].shape[0], struct["role"].device
    id_row = st.pack(st.canonicalize(struct))

    def keep_from(pairs, images_of, perms):
        if not pairs:
            return torch.ones((N, len(perms)), dtype=torch.bool, device=dev)
        eq = torch.stack([images_of(a, b, k) for a, b, k in pairs], 1)
        less = torch.as_tensor(_pair_less_lut(perms, pairs), device=dev)
        return ~(eq[:, None, :] & ~less[None]).any(-1)

    sig = _server_sig(struct) if "Server" in axes else None

    def server_eq(a, b, k):
        if not (sig[:, a] == sig[:, b]).any():    # nowhere interchangeable
            return torch.zeros(N, dtype=torch.bool, device=dev)
        return (images.image(struct, k * Q) == id_row).all(-1)

    def value_eq(a, b, k):
        return (images.image(struct, k) == id_row).all(-1)

    keep_s = keep_from(_transposition_pairs(bounds), server_eq,
                       permutations(bounds)) if "Server" in axes else \
        torch.ones((N, 1), dtype=torch.bool, device=dev)
    keep_v = keep_from(_value_transposition_pairs(bounds), value_eq,
                       value_permutations(bounds)) if "Value" in axes else \
        torch.ones((N, 1), dtype=torch.bool, device=dev)
    return (keep_s[:, :, None] & keep_v[:, None, :]).reshape(N, P * Q)


def build_orbit_fp(bounds: Bounds, axes: tuple, consts: torch.Tensor,
                   prune: bool = False):
    """The plain batched orbit key: ``struct[..., fields] -> (hi, lo)``
    int32 tensors holding the uint32 bits, over the leading dims.

    ``consts`` is :func:`ops.fingerprint.torch_constants` on the struct's
    device.  For each image of :func:`group_images`: fingerprint, keep the
    lexicographic min of the unsigned pair.  The comparison runs in int64
    holding values in [0, 2^32): a fused 64-bit key ``hi * 2^32 + lo``
    would overflow.  ``prune=True`` is sig-prune (:func:`pruned_orbit_fp`),
    the same keys.
    """
    images = group_images(bounds, axes, consts.device)
    P, Q = group_sizes(bounds, axes)

    def scan(struct, keep=None):
        bh = bl = None
        for k in range(P * Q):
            if keep is not None and not bool(keep[:, k].any()):  # lint: jit-ok plain version; the card scans in K1
                continue
            hi, lo = fpr.fingerprint(images.image(struct, k), consts)
            hi, lo = hi.to(torch.int64) & _M32, lo.to(torch.int64) & _M32
            if bh is None:                       # k = 0, always kept
                bh, bl = hi, lo
                continue
            take = (hi < bh) | ((hi == bh) & (lo < bl))
            if keep is not None:
                take &= keep[:, k]
            bh = torch.where(take, hi, bh)
            bl = torch.where(take, lo, bl)
        return fpr.u32_bits(bh), fpr.u32_bits(bl)

    def orbit_fp(struct):
        global plain_calls
        plain_calls += 1
        return scan(struct)

    if not prune or P * Q == 1:
        return orbit_fp

    def pruned_orbit_fp(struct):
        """Sig-prune: the keep mask of :func:`keep_mask`, then the minimum
        over each row's kept elements (an element no row keeps is not
        imaged at all)."""
        global plain_calls
        plain_calls += 1
        lead = struct["role"].shape[:-1]
        n = int(np.prod(lead)) if lead else 1
        flat = {f: a.reshape((n,) + a.shape[len(lead):])
                for f, a in struct.items()}
        hi, lo = scan(flat, keep_mask(bounds, axes, flat, images))
        return hi.reshape(lead), lo.reshape(lead)

    return pruned_orbit_fp


def orbit_sizes(vecs: torch.Tensor, bounds: Bounds, axes: tuple
                ) -> torch.Tensor:
    """The orbit size of each canonical row of ``vecs [B, W]``: the number
    of distinct canonical rows among its |G| images (exact row equality, no
    hashing).  A symmetric run's per-level sums of these equal the level
    counts of the same universe without symmetry."""
    lay = st.Layout.of(bounds)
    imgs = list(group_images(bounds, axes, vecs.device)(
        st.unpack(vecs, lay)))
    n = torch.zeros(vecs.shape[0], dtype=torch.int64, device=vecs.device)
    for a, img in enumerate(imgs):
        seen = torch.zeros_like(n, dtype=torch.bool)
        for b in range(a):
            seen |= (imgs[b] == img).all(-1)
        n += (~seen).long()
    return n
