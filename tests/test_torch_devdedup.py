"""The device dedup set of the port (``ops/devdedup``, ``--device-dedup``)
against the reference's: both backends on the same key batches (seeded
numpy), with duplicates inside and across batches, all-ones sentinel
keys, stale lanes past the cursor and, for the sorted set, truncation at
its capacity; then the DDD engine with the set on.  Tolerance: bit-exact
(keep flags, compaction, counts, the set itself).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tla_tpu.ops import devdedup as jdd

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
from raft_tla_tpu_torch.ops import devdedup as dd

torch.set_num_threads(1)


def _batches(seed=3, n_batches=4, oc=96):
    """Key batches ``(hi, lo, n)`` as uint32: a small key pool (many
    repeats), two sentinel lanes, and stale lanes from ``n`` on."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, size=(40, 2), dtype=np.uint64)
    pool[0] = [0xFFFFFFFF, 0x12345]        # hi all ones, lo not: a key
    out = []
    for k in range(n_batches):
        pick = pool[rng.integers(0, len(pool), size=oc)].astype(np.uint32)
        pick[[5, 17]] = 0xFFFFFFFF                       # sentinels
        out.append((pick[:, 0].copy(), pick[:, 1].copy(), oc - 7 * k))
    return out


@pytest.mark.parametrize("backend,capacity", [
    ("hash", 64), ("hash", 16), ("sort", 256), ("sort", 24)],
    ids=["hash", "hash-full", "sort", "sort-truncating"])
def test_filter_matches_jax(backend, capacity):
    """Batch after batch through one set: keep, the compaction prefix,
    new_n and hits equal the reference's, and so does the set."""
    state = dd.init_set(capacity, backend)
    jstate = jax.device_put(jdd.init_set(capacity, backend))
    filt = dd.make_filter(backend)
    jfilt = jax.jit(jdd.make_filter(backend))
    hits_total = 0
    for hi, lo, n in _batches():
        state, keep, idx, new_n, hits = filt(
            state, torch.as_tensor(hi.view(np.int32)),
            torch.as_tensor(lo.view(np.int32)), n)
        jstate, jkeep, jidx, jn, jhits = jfilt(
            jstate, jnp.asarray(hi), jnp.asarray(lo), jnp.int32(n))
        assert np.array_equal(keep.numpy(), np.asarray(jkeep))
        assert int(new_n) == int(jn) and int(hits) == int(jhits)
        assert np.array_equal(idx[:int(new_n)].numpy(),
                              np.asarray(jidx)[:int(jn)])
        tb = np.asarray(jstate.hi).shape[0]
        for mine, ref in ((state.hi, jstate.hi), (state.lo, jstate.lo)):
            assert np.array_equal(mine[:tb].numpy().view(np.uint32),
                                  np.asarray(ref))
        if backend == "sort":
            assert int(state.n) == int(jstate.n)
        # the sentinels and the stale lanes are never dropped or kept
        assert keep[[5, 17]].all() and not keep[n:].any()
        hits_total += int(hits)
    assert hits_total > 0


def test_backend_gate_matches_jax(monkeypatch):
    for v in ("", "auto", "on", "off", "hash", "sort", "1", "no", "YES"):
        monkeypatch.setenv(dd.ENV_DEVDEDUP, v)
        assert dd.devdedup_backend() == jdd.devdedup_backend()
    monkeypatch.setenv(dd.ENV_DEVDEDUP, "maybe")
    with pytest.raises(ValueError) as mine:
        dd.devdedup_backend()
    with pytest.raises(ValueError) as ref:
        jdd.devdedup_backend()
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="power of two"):
        dd.init_set(48, "hash")


@pytest.mark.parametrize("backend", ["hash", "sort"])
def test_engine_with_the_set(monkeypatch, backend):
    """The 2-server election (3,014 states) through the DDD engine with
    the set on: the counts and levels of the run without it; the rows it
    drops are exactly the exported rows it saves."""
    cfg = CheckConfig(bounds=Bounds(2, 1, 2, 0, 2), spec="election",
                      invariants=("NoTwoLeaders",), chunk=32)
    caps = DDDCapacities(block=256, table=1 << 6, flush=1 << 10,
                         seg_rows=1 << 12, levels=64)
    runs = {}
    for gate in ("off", backend):
        monkeypatch.setenv(dd.ENV_DEVDEDUP, gate)
        eng = DDDEngine(cfg, caps, device="cpu")
        r = eng.check()
        runs[gate] = ((r.n_states, r.diameter, r.n_transitions, r.levels,
                       dict(r.coverage)), eng.stats)
    assert runs["off"][0] == runs[backend][0]
    assert runs["off"][0][:2] == (3014, 17)
    off, on = runs["off"][1], runs[backend][1]
    assert on["dev_dedup_hits"] > 0 and off["dev_dedup_hits"] == 0
    assert off["export_rows"] == on["export_rows"] + on["dev_dedup_hits"]
