"""The DDD engine's parts (raft_tla_tpu_torch) against the JAX reference.

Bit-equal, on inputs made with numpy from fixed seeds: the packed-row
schema (numpy and torch backends) at three layouts; the lossy filter's
probe and insert over successive batches (duplicates, inactive lanes, full
buckets, in-batch slot collisions, the insert budget), table words and
stream; one segment of the port against the JAX ``_build_segment`` on the
same packed block (keys, packed rows, parents, lanes, constraint flags,
cursor, transitions, violation fields), with a violation and with a dead
row; the same segment with the step's invalid-lane outputs poisoned; the
master key sets; the native store against its NumPy twin, and the level
store's rotation and trim.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tla_tpu import ddd_engine as jddd
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.ops import bitpack as jbitpack
from raft_tla_tpu.utils import keyset as jkeyset

from raft_tla_tpu_torch import ddd_engine as ddd
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.models import interp, invariants as inv_mod
from raft_tla_tpu_torch.models import spec as SP
from raft_tla_tpu_torch.ops import bitpack, msgbits as mb
from raft_tla_tpu_torch.utils import keyset, native

torch.set_num_threads(1)

LAYOUTS = {
    "flagship": dict(n_servers=3, n_values=2, max_term=2, max_log=1,
                     max_msgs=2),
    "faithful": dict(n_servers=3, n_values=2, max_term=2, max_log=1,
                     max_msgs=2, history=True),
    "elect5": dict(n_servers=5, n_values=2, max_term=2, max_log=0,
                   max_msgs=2),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_bitschema_matches_jax(name):
    kw = LAYOUTS[name]
    js, ps = jbitpack.BitSchema(JBounds(**kw)), bitpack.BitSchema(Bounds(**kw))
    assert (js.bits == ps.bits).all() and (js.P, js.W) == (ps.P, ps.W)
    rng = np.random.default_rng(20261017)
    width = np.uint64(1) << js.bits.astype(np.uint64)
    vec = (rng.integers(0, 2**32, size=(2000, js.W), dtype=np.uint64)
           % width).astype(np.uint32).view(np.int32)
    want = np.asarray(js.pack(jnp.asarray(vec), jnp))
    assert np.array_equal(ps.pack(vec, np), want)
    assert np.array_equal(ps.pack(torch.as_tensor(vec), torch).numpy(), want)
    back = np.asarray(js.unpack(jnp.asarray(want), jnp))
    assert np.array_equal(back, vec)
    assert np.array_equal(ps.unpack(want, np), back)
    assert np.array_equal(ps.unpack(torch.as_tensor(want.copy()), torch).numpy(),
                          back)


def test_filter_insert_matches_jax(monkeypatch):
    """Six batches on a 2^7-slot (16-bucket) table: keys from a small pool
    (in-batch duplicates and re-sights), a fifth of the lanes inactive,
    low words crowding four buckets (full buckets, eviction, in-batch
    (bucket, slot) collisions); the last batch under a 64-insert budget."""
    rng = np.random.default_rng(7)
    TB = (1 << 7) // ddd.BUCKET
    jhi = jnp.full((TB, ddd.BUCKET), 0xFFFFFFFF, jnp.uint32)
    jlo = jnp.full((TB, ddd.BUCKET), 0xFFFFFFFF, jnp.uint32)
    thi = torch.full((TB + 1, ddd.BUCKET), -1, dtype=torch.int32)
    tlo = torch.full((TB + 1, ddd.BUCKET), -1, dtype=torch.int32)
    pool_hi = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    pool_lo = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    pool_lo[:150] = (pool_lo[:150] & ~np.uint32(15)) | np.uint32(3)
    pool_lo[150:200] = (pool_lo[150:200] & ~np.uint32(15)) | np.uint32(9)
    for batch in range(6):
        if batch == 5:
            monkeypatch.setattr(jddd, "_S_INS", 64)
            monkeypatch.setattr(ddd, "_S_INS", 64)
        pick = rng.integers(0, 300, 1500)
        hi, lo = pool_hi[pick], pool_lo[pick]
        active = rng.random(1500) < 0.8
        jhi, jlo, jstream = jddd._filter_insert(
            jhi, jlo, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(active))
        stream, rank = ddd.filter_insert(
            thi, tlo, torch.as_tensor(hi.view(np.int32)),
            torch.as_tensor(lo.view(np.int32)), torch.as_tensor(active))
        assert np.array_equal(stream.numpy(), np.asarray(jstream)), batch
        assert np.array_equal(rank.numpy(),
                              np.cumsum(np.asarray(jstream)) - 1)
        assert np.array_equal(thi[:TB].numpy().view(np.uint32),
                              np.asarray(jhi)), batch
        assert np.array_equal(tlo[:TB].numpy().view(np.uint32),
                              np.asarray(jlo)), batch
    assert int(np.asarray(jstream).sum()) > 0


def _bfs_levels(bounds, spec, start, depth):
    """The BFS levels of ``start`` to ``depth`` through the interpreter."""
    levels, seen = [[start]], {start}
    for _ in range(depth):
        nxt = []
        for s in levels[-1]:
            if not interp.constraint_ok(s, bounds):
                continue
            for _i, t in interp.successors(s, bounds, spec=spec):
                if t not in seen:
                    seen.add(t)
                    nxt.append(t)
        levels.append(nxt)
    return levels


SEED_START = dict(role=(SP.LEADER, SP.FOLLOWER, SP.CANDIDATE),
                  term=(2, 3, 3), votedFor=(1, 3, 0),
                  vGrant=(0b011, 0, 0b100))


def _segment_case(kind):
    """(bounds kwargs, spec, invariants, deadlock, block states)."""
    if kind == "plain":
        kw = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
        b = Bounds(**kw)
        lv = _bfs_levels(b, "election", interp.init_state(b), 8)
        return kw, "election", ("NoTwoLeaders",), False, (lv[6] + lv[7])[:200]
    if kind == "violation":
        kw = dict(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)
        b = Bounds(**kw)
        start = interp.init_state(b)._replace(
            **SEED_START, msgs=((mb.rv_response(3, 1, 1, 2), 1),))
        lv = _bfs_levels(b, "election", start, 2)
        bad = inv_mod.py_invariant("NaiveNoTwoLeaders")
        assert any(not bad(t, b) for t in lv[2])
        return kw, "election", ("NaiveNoTwoLeaders",), False, lv[0] + lv[1]
    kw = dict(n_servers=1, n_values=1, max_term=2, max_log=0, max_msgs=2)
    b = Bounds(**kw)
    lv = _bfs_levels(b, "election", interp.init_state(b), 6)
    rows = [s for lvl in lv for s in lvl]
    assert any(not list(interp.successors(s, b, spec="election"))
               and interp.constraint_ok(s, b) for s in rows)
    return kw, "election", (), True, rows


def _packed_block(kw, states, block):
    schema = bitpack.BitSchema(Bounds(**kw))
    b = Bounds(**kw)
    rows = np.zeros((block, schema.P), np.int32)
    con = np.zeros((block,), bool)
    for i, s in enumerate(states):
        rows[i] = schema.pack(np.asarray(interp.to_vec(s, b), np.int32), np)
        con[i] = interp.constraint_ok(s, b)
    return rows, con


def _port_segments(eng, rows, con, n_rows, budget, reps):
    tbl = eng.new_filter()
    bufs = ddd.SegBufs(eng.caps.seg_rows, eng.schema.P, "cpu")
    fbuf, fcon = torch.as_tensor(rows), torch.as_tensor(con)
    out, c = [], 0
    for _ in range(reps):
        c, sst = eng.run_segment(tbl, bufs, fbuf, fcon, n_rows, c, budget)
        n = sst["cursor"]
        out.append((sst, {k: v[:n].numpy().copy()
                          for k, v in bufs.dev.items()},
                    tuple(t[:-1].numpy().view(np.uint32).copy() for t in tbl),
                    c))
    return out


CHUNK, BLOCK = 16, 256


@pytest.mark.parametrize("kind", ["plain", "violation", "deadlock"])
def test_segment_matches_jax(kind):
    kw, spec, invs, dl, states = _segment_case(kind)
    rows, con = _packed_block(kw, states, BLOCK)
    n_rows = len(states)
    jcfg = JConfig(bounds=JBounds(**kw), spec=spec, invariants=invs,
                   chunk=CHUNK, check_deadlock=dl)
    A = len(SP.action_table(Bounds(**kw), spec))
    jcaps = jddd.DDDCapacities(block=BLOCK, table=1 << 7,
                               seg_rows=4 * CHUNK * A)
    jschema = jbitpack.BitSchema(JBounds(**kw))
    seg = jddd._build_segment(jcfg, jcaps, A, jschema.W, jschema)
    cfg = CheckConfig(bounds=Bounds(**kw), spec=spec, invariants=invs,
                      chunk=CHUNK, check_deadlock=dl)
    eng = ddd.DDDEngine(cfg, ddd.DDDCapacities(
        block=BLOCK, table=1 << 7, seg_rows=4 * CHUNK * A), device="cpu")
    got = _port_segments(eng, rows, con, n_rows, budget=2, reps=3)
    TB = (1 << 7) // ddd.BUCKET
    fc = jddd.FilterCarry(jnp.full((TB, 8), 0xFFFFFFFF, jnp.uint32),
                          jnp.full((TB, 8), 0xFFFFFFFF, jnp.uint32),
                          jnp.int32(0))
    OCAP = jcaps.seg_rows
    bufs = jddd.SegBufs(jnp.zeros((OCAP,), jnp.uint32),
                        jnp.zeros((OCAP,), jnp.uint32),
                        jnp.zeros((OCAP, jschema.P), jnp.int32),
                        jnp.zeros((OCAP,), jnp.int32),
                        jnp.zeros((OCAP,), jnp.int32),
                        jnp.zeros((OCAP,), bool))
    saw_viol = False
    for sst, pb, (th, tl), c in got:
        fc, bufs, js = seg(fc, bufs, jnp.asarray(rows), jnp.asarray(con),
                           jnp.int32(2), jnp.int32(n_rows))
        n = int(js.cursor)
        assert sst["cursor"] == n
        for k, want in (("okey_hi", bufs.okey_hi), ("okey_lo", bufs.okey_lo),
                        ("orows", bufs.orows), ("opar", bufs.opar),
                        ("olane", bufs.olane), ("ocon", bufs.ocon)):
            w = np.asarray(want)[:n]
            assert np.array_equal(pb[k].view(w.dtype) if w.dtype != bool
                                  else pb[k], w), k
        assert np.array_equal(th, np.asarray(fc.tbl_hi))
        assert np.array_equal(tl, np.asarray(fc.tbl_lo))
        assert c == int(fc.c)
        assert (sst["n_valid"], sst["fail"], sst["viol_kind"], sst["steps"],
                sst["done"]) == (int(js.n_valid), int(js.fail),
                                 int(js.viol_kind), int(js.steps),
                                 bool(js.done))
        if sst["viol_kind"] == 1:
            assert sst["viol_inv"] == int(js.viol_inv)
        if sst["viol_kind"] == 2:
            assert sst["dead_g"] == int(js.dead_g)
        saw_viol |= sst["viol_kind"] != 0
        if sst["viol_kind"] or sst["done"]:
            break
    assert saw_viol == (kind != "plain")


UNDEFINED = ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok")


def test_segment_with_poisoned_invalid_lanes():
    """K1 leaves every output but ``valid`` unwritten on invalid lanes: the
    segment must read them only under its mask (the plain step's zeros
    there, then seeded garbage, give the same segment)."""
    runs = []
    for kind in ("violation", "deadlock"):
        kw, spec, invs, dl, states = _segment_case(kind)
        rows, con = _packed_block(kw, states, BLOCK)
        for poison in (False, True):
            cfg = CheckConfig(bounds=Bounds(**kw), spec=spec,
                              invariants=invs, chunk=CHUNK,
                              check_deadlock=dl)
            A = len(SP.action_table(Bounds(**kw), spec))
            eng = ddd.DDDEngine(cfg, ddd.DDDCapacities(
                block=BLOCK, table=1 << 7, seg_rows=4 * CHUNK * A),
                device="cpu")
            if poison:
                eng.step = _poisoned(eng.step, np.random.default_rng(5))
            runs.append(_port_segments(eng, rows, con, len(states), 2, 3))
    for plain, bad in ((runs[0], runs[1]), (runs[2], runs[3])):
        for (s1, b1, t1, c1), (s2, b2, t2, c2) in zip(plain, bad):
            assert s1 == s2 and c1 == c2
            assert all(np.array_equal(b1[k], b2[k]) for k in b1)
            assert all(np.array_equal(x, y) for x, y in zip(t1, t2))


def _poisoned(step, rng):
    def wrapped(vecs):
        out = step(vecs)
        dead = ~out["valid"]
        for k in UNDEFINED:
            t = out[k]
            if t.dtype == torch.bool:
                noise = torch.as_tensor(rng.random(t.shape) < 0.5)
            else:
                noise = torch.as_tensor(rng.integers(
                    -2**31, 2**31, size=t.shape, dtype=np.int64
                ).astype(np.int32))
            mask = dead.reshape(dead.shape + (1,) * (t.dim() - 2))
            out[k] = torch.where(mask, noise, t)
        return out
    return wrapped


def test_master_keys_match_jax():
    rng = np.random.default_rng(11)
    masters = [keyset.MasterKeys(), keyset.PartitionedMasterKeys(
                   merge_budget=512),
               jkeyset.MasterKeys(), jkeyset.PartitionedMasterKeys(
                   merge_budget=512)]
    for m in masters:
        m.seed(12345)
    for _ in range(25):
        flush = rng.integers(0, 2**64, size=rng.integers(1, 3000),
                             dtype=np.uint64)
        flush[::3] = rng.integers(0, 4000, flush[::3].size,
                                  dtype=np.uint64) << np.uint64(50)
        got = [m.dedup(flush) for m in masters]
        assert all(np.array_equal(g, got[0]) for g in got[1:])
    assert len({len(m) for m in masters}) == 1
    assert all(np.array_equal(m.array, masters[0].array) for m in masters)
    keys = masters[0].array.copy()
    rng.shuffle(keys)
    for part in (False, True):
        m = keyset.master_from_keys(keys, partitioned=part)
        assert np.array_equal(m.array, masters[0].array)


def test_native_store_and_level_store(tmp_path):
    rng = np.random.default_rng(3)
    ours, twin = native.make_store(5), native.PyHostStore(5)
    assert isinstance(ours, native.HostStore)
    for _ in range(20):
        n = int(rng.integers(0, 300))
        rows = rng.integers(-2**31, 2**31, (n, 5), dtype=np.int64)
        par = rng.integers(-1, 10**12, n, dtype=np.int64)
        lane = rng.integers(0, 40, n).astype(np.int32)
        for s in (ours, twin):
            s.append(rows)
            s.append_links(par, lane)
    assert len(ours) == len(twin)
    for start, n in ((0, len(ours)), (7, 100), (len(ours) - 3, 3)):
        assert np.array_equal(ours.read(start, n), twin.read(start, n))
        for a, b in zip(ours.read_links(start, n), twin.read_links(start, n)):
            assert np.array_equal(a, b)
    ours.close()

    prefix = str(tmp_path / "run.rows")
    ls = native.LevelStore(prefix, 3, 1, 0, 1, reset=True)
    ls.cur.append(np.array([[1, 2, 3]], np.int32))
    ls.append(np.arange(12, dtype=np.int32).reshape(4, 3))
    ls.rotate()                                   # level 2 = rows [1, 5)
    assert (ls.cur.base, len(ls.cur), ls.nxt.base) == (1, 5, 5)
    assert np.array_equal(ls.read(2, 2), np.arange(3, 9).reshape(2, 3))
    ls.append(np.full((3, 3), 7, np.int32))
    ls.sync()
    ls.trim_next(6)                               # drop uncommitted rows
    assert len(ls) == 6
    ls.delete_old()
    assert not (tmp_path / "run.rowsL1").exists()
    assert (tmp_path / "run.rowsL2").exists()
    ls.close()
    reopened = native.FileStore(prefix + "L3", 3, 5)
    assert len(reopened) == 6 and np.array_equal(reopened.read(5, 1),
                                                 np.full((1, 3), 7))
    reopened.close()
