"""The shard engine's snapshots and ``reshard_checkpoint`` in both packages,
on the CPU.

Snapshots are the reference's ``SCarry`` arrays ``c0..c18`` under its
digest, so a search moves between the JAX ``ShardEngine`` and the port's in
both directions, mid-level included; after the same chunks the two
engines' carries are equal array for array.  The port's resharder gives the
JAX resharder's arrays (tables included: the same inserts in the same
batches) for 2 -> 4, 2 -> 1, 2 -> 8 with grown capacities and under
SYMMETRY, and refuses what the reference refuses.  Under a VIEW the
reference recomputes keys without the view, and its resharded snapshot
finds more states than the straight run (ROADMAP.md, reference caveat
C-R5); the port keys with the view and resumes to its own straight run.
"""

import io
from contextlib import redirect_stderr, redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import interp as jinterp
from raft_tla_tpu.ops import symmetry as jsym
from raft_tla_tpu.parallel import ShardCapacities as JCaps
from raft_tla_tpu.parallel import ShardEngine as JShardEngine
from raft_tla_tpu.parallel import make_mesh as jmesh
from raft_tla_tpu.parallel import reshard_checkpoint as jreshard
from raft_tla_tpu.parallel.shard_engine import make_slice_mesh as jslice

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.models import refbfs
from raft_tla_tpu_torch.parallel import (ShardCapacities, ShardEngine,
                                         make_mesh, make_slice_mesh,
                                         reshard_checkpoint)

torch.set_num_threads(1)

TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
CAPS = ShardCapacities(n_states=1 << 12, levels=64)
JCAPS = JCaps(n_states=1 << 12, levels=64)


def cfgs(**extra):
    return (JConfig(bounds=JBounds(**TOY), spec="election",
                    invariants=("NoTwoLeaders",), chunk=64, **extra),
            CheckConfig(bounds=Bounds(**TOY), spec="election",
                        invariants=("NoTwoLeaders",), chunk=64, **extra))


def jax_snapshot(path, **extra):
    """The reference tests' snapshot: a 2-device run with ``seg_chunks=8``
    and a snapshot after every segment, of which the last written (before
    the final segment) stays."""
    jc, _pc = cfgs(**extra)
    JShardEngine(jc, jmesh(2), JCAPS, seg_chunks=8).check(
        checkpoint=str(path), checkpoint_every_s=0.0)
    return str(path)


def arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "content_sha"}


def assert_arrays_equal(a, b):
    A, B = arrays(a), arrays(b)
    assert sorted(A) == sorted(B)
    for k in A:
        assert A[k].dtype == B[k].dtype and A[k].shape == B[k].shape, k
        assert np.array_equal(A[k], B[k]), k


def counts(r):
    return r.n_states, r.diameter, r.levels, r.n_transitions


@pytest.fixture(scope="module")
def ref():
    return refbfs.check(cfgs()[1])


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    return jax_snapshot(tmp_path_factory.mktemp("snap") / "m2.ckpt")


def test_jax_snapshot_resumes_in_port(snap, ref):
    _jc, pc = cfgs()
    got = ShardEngine(pc, make_mesh(2, device="cpu"), CAPS).check(resume=snap)
    assert counts(got) == counts(ref)
    assert sum(got.coverage.values()) == ref.n_states - 1


def test_port_snapshot_resumes_in_jax(tmp_path, ref):
    jc, pc = cfgs()
    ck = str(tmp_path / "p2.ckpt")
    ShardEngine(pc, make_mesh(2, device="cpu"), CAPS, seg_chunks=8).check(
        checkpoint=ck, checkpoint_every_s=0.0)
    got = JShardEngine(jc, jmesh(2), JCAPS).check(resume=ck)
    assert (got.n_states, got.diameter, got.levels, got.n_transitions) == \
        counts(ref)


def test_carry_after_k_chunks_equals_jax(tmp_path):
    """After the same 11 chunks (of 19) on the 2x4 slice mesh, the two
    engines' snapshots are equal array for array: stores, parents, lanes,
    tables, counters, the level window and the chunk cursor."""
    jc, pc = cfgs()
    init = jinterp.init_state(jc.bounds)
    hi0, lo0 = jsym.init_fingerprint(jc, init, jinterp.to_vec(init,
                                                              jc.bounds))
    jeng = JShardEngine(jc, jslice(2, 4), JCAPS)
    carry = jeng._init_carry(np.asarray(jinterp.to_vec(init, jc.bounds),
                                        np.int32), np.uint32(hi0),
                             np.uint32(lo0), True)
    steps, carry = jeng._segment(carry, jnp.int32(11))
    jeng.save_checkpoint(str(tmp_path / "j"), carry, (hi0, lo0))
    eng = ShardEngine(pc, make_slice_mesh(2, 4, device="cpu"), CAPS)
    vec = np.asarray(jinterp.to_vec(init, jc.bounds), np.int32)
    key = eng.init_key(init, vec)
    assert key == (hi0, lo0)
    eng._init_carry(vec, key, True)
    assert eng._segment(11) == int(steps) == 11
    eng.save_checkpoint(str(tmp_path / "p"), key)
    assert_arrays_equal(tmp_path / "j", tmp_path / "p")


@pytest.mark.parametrize("nd,grown", [(4, False), (1, False), (8, True)])
def test_reshard_equals_jax(snap, ref, tmp_path, nd, grown):
    """2 -> 4, 2 -> 1 and 2 -> 8 with a grown store and levels array: the
    JAX resharder's arrays exactly, resuming to the straight counts."""
    jc, pc = cfgs()
    big = dict(n_states=1 << 13, levels=96) if grown else None
    out_j, out_p = str(tmp_path / "j.ckpt"), str(tmp_path / "p.ckpt")
    jinfo = jreshard(jc, JCAPS, snap, out_j, nd,
                     caps_dst=JCaps(**big) if big else None)
    caps = ShardCapacities(**big) if big else CAPS
    info = reshard_checkpoint(pc, CAPS, snap, out_p, nd,
                              caps_dst=caps if big else None, device="cpu")
    assert info == jinfo and info["promoted_expanded"] in (True, False)
    assert_arrays_equal(out_j, out_p)
    got = ShardEngine(pc, make_mesh(nd, device="cpu"), caps).check(
        resume=out_p)
    assert counts(got) == counts(ref)


def test_reshard_symmetric_equals_jax(tmp_path):
    """Under SYMMETRY Server the keys are orbit keys (the orbit-key entry's
    plain version here): the JAX resharder's arrays, and 1,514 orbits."""
    jc, pc = cfgs(symmetry=("Server",))
    ck = jax_snapshot(tmp_path / "s2.ckpt", symmetry=("Server",))
    out_j, out_p = str(tmp_path / "j.ckpt"), str(tmp_path / "p.ckpt")
    jreshard(jc, JCAPS, ck, out_j, 8)
    reshard_checkpoint(pc, CAPS, ck, out_p, 8, device="cpu")
    assert_arrays_equal(out_j, out_p)
    got = ShardEngine(pc, make_mesh(8, device="cpu"), CAPS).check(
        resume=out_p)
    want = refbfs.check(pc)
    assert want.n_states == 1514 and counts(got) == counts(want)


def test_reshard_refusals(snap, tmp_path):
    """The reference's refusals: another config's digest, a destination
    store too small, a levels array too short, a finished run."""
    jc, pc = cfgs()
    other = CheckConfig(bounds=pc.bounds, spec="election", invariants=(),
                        chunk=64)
    with pytest.raises(ValueError, match="digest"):
        reshard_checkpoint(other, CAPS, snap, str(tmp_path / "x"), 4,
                           device="cpu")
    with pytest.raises(ValueError, match="n_states"):
        reshard_checkpoint(pc, CAPS, snap, str(tmp_path / "y"), 1,
                           caps_dst=ShardCapacities(n_states=1 << 4,
                                                    levels=64),
                           device="cpu")
    with pytest.raises(ValueError, match="levels"):
        reshard_checkpoint(pc, CAPS, snap, str(tmp_path / "z"), 2,
                           caps_dst=ShardCapacities(n_states=1 << 12,
                                                    levels=2),
                           device="cpu")
    eng = ShardEngine(pc, make_mesh(2, device="cpu"), CAPS)
    eng.check()
    done = str(tmp_path / "done.ckpt")
    eng.save_checkpoint(done, eng.init_key(
        jinterp.init_state(jc.bounds),
        np.asarray(jinterp.to_vec(jinterp.init_state(jc.bounds),
                                  jc.bounds), np.int32)))
    with pytest.raises(ValueError, match="already complete"):
        reshard_checkpoint(pc, CAPS, done, str(tmp_path / "w"), 4,
                           device="cpu")
    with pytest.raises(ValueError, match="already complete"):
        jreshard(jc, JCAPS, done, str(tmp_path / "w"), 4)


def test_view_reshard_keeps_the_view(tmp_path):
    """Under a VIEW (deadvotes) the reference's resharder keys the rows
    without the view, so its 2 -> 4 snapshot resumes past the straight
    run's count (C-R5); the port's keys fold the view and its snapshot
    resumes to the straight run's counts."""
    jc, pc = cfgs(view="deadvotes")
    straight = ShardEngine(pc, make_mesh(4, device="cpu"), CAPS).check()
    ck = jax_snapshot(tmp_path / "v2.ckpt", view="deadvotes")
    out_j, out_p = str(tmp_path / "j.ckpt"), str(tmp_path / "p.ckpt")
    jreshard(jc, JCAPS, ck, out_j, 4)
    reshard_checkpoint(pc, CAPS, ck, out_p, 4, device="cpu")
    got = ShardEngine(pc, make_mesh(4, device="cpu"), CAPS).check(
        resume=out_p)
    assert counts(got) == counts(straight)
    theirs = ShardEngine(pc, make_mesh(4, device="cpu"), CAPS).check(
        resume=out_j)
    assert theirs.n_states > straight.n_states


def test_cli_reshard_prints_the_reference_line(snap, tmp_path, ref):
    """``--reshard-to 4`` through both CLIs: the same summary line and exit
    0; the port's output then resumes through ``--engine shard --devices
    4`` to the straight counts."""
    cfg = tmp_path / "toy.cfg"
    cfg.write_text(
        "SPECIFICATION Spec\nINVARIANT NoTwoLeaders\nCONSTANTS\n"
        "    Server = {s1, s2}\n    Value = {v1}\n"
        '    Follower = "Follower"\n    Candidate = "Candidate"\n'
        '    Leader = "Leader"\n    Nil = "Nil"\n')
    base = [str(cfg), "--spec", "election", "--max-term", "2", "--max-log",
            "0", "--max-msgs", "2", "--chunk", "64", "--cap", str(1 << 12),
            "--levels", "64", "--engine", "shard", "--resume", snap]
    lines = []
    for main, extra, out in ((cli.main, ["--device", "cpu"], "p.ckpt"),
                             (jcli.main, ["--cpu"], "j.ckpt")):
        buf = io.StringIO()
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            code = main([*base, *extra, "--reshard-to", "4",
                         "--checkpoint", str(tmp_path / out)])
        assert code == 0
        lines.append(buf.getvalue().splitlines()[-1].replace(out, "OUT"))
    assert lines[0] == lines[1] and lines[0].startswith("resharded 2 -> 4")
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        code = cli.main([*base[:-1], str(tmp_path / "p.ckpt"), "--device",
                         "cpu", "--devices", "4"])
    assert code == 0
    assert f"{ref.n_states} distinct states found, diameter " \
           f"{ref.diameter}, {ref.n_transitions} transitions" in \
        buf.getvalue()
