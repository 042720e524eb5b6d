"""The port's DDD engine (on the CPU) against refbfs and the JAX DDD engine.

``DDDEngine(device="cpu")`` runs the plain torch step.  Exact equality of
states, diameter, per-level counts, transitions, coverage, violation and
trace with the pure-Python oracle ``refbfs``: with a filter small enough
to evict constantly, under SYMMETRY, in faithful mode, in frontier
retention with a trace rebuilt from the kept level files, at a seeded
violation and a deadlock, and across a ``deadline_s`` stop and resume.
Snapshots cross between the packages in both directions, in both
retentions.  The CLI's ``--engine ddd`` exit codes and refusals.
"""

import io
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from raft_tla_tpu import ddd_engine as jddd
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import interp as jinterp, refbfs
from raft_tla_tpu.ops import msgbits as jmb

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
from raft_tla_tpu_torch.engine import DEADLOCK
from raft_tla_tpu_torch.models import interp, invariants as inv_mod
from raft_tla_tpu_torch.models import spec as SP
from raft_tla_tpu_torch.ops import msgbits as mb

torch.set_num_threads(1)

TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)


def _configs(kw, spec="election", invs=("NoTwoLeaders",), chunk=32, **more):
    return (CheckConfig(bounds=Bounds(**kw), spec=spec, invariants=invs,
                        chunk=chunk, **more),
            JConfig(bounds=JBounds(**kw), spec=spec, invariants=invs,
                    chunk=chunk, **more))


def _same(got, want):
    assert (got.n_states, got.diameter, got.levels, got.n_transitions) == \
        (want.n_states, want.diameter, want.levels, want.n_transitions)
    assert dict(got.coverage) == dict(want.coverage)
    assert (got.violation is None) == (want.violation is None)


@pytest.fixture(scope="module")
def toy_ref():
    return refbfs.check(_configs(TOY)[1])


EVICTING = dict(block=256, table=1 << 7, seg_rows=4096, flush=1 << 9,
                levels=64)


@pytest.mark.parametrize("caps,gates", [
    (EVICTING, "auto"),
    (dict(block=1 << 12, table=1 << 14, seg_rows=1 << 13, flush=1 << 12,
          levels=64), "auto"),
    (EVICTING, "off")], ids=["evicting", "roomy", "evicting-inline"])
def test_election_matches_refbfs(caps, gates, toy_ref, monkeypatch):
    # "off": the inline host flush and the synchronous block upload, in
    # place of the background dedup worker and the upload prefetcher
    for env in ("RAFT_TLA_HOSTDEDUP", "RAFT_TLA_PREFETCH"):
        monkeypatch.setenv(env, gates)
    eng = DDDEngine(_configs(TOY)[0], DDDCapacities(**caps), device="cpu")
    if gates == "off":
        assert not (eng._host_dedup or eng._prefetch)
    got = eng.check()
    _same(got, toy_ref)
    assert got.n_states == 3014 and got.diameter == 17 and got.complete


def test_symmetry_and_faithful_match_refbfs():
    cfg, jcfg = _configs(TOY, symmetry=("Server",))
    caps = DDDCapacities(block=512, table=1 << 9, seg_rows=4096,
                         flush=1 << 10, levels=64)
    got = DDDEngine(cfg, caps, device="cpu").check()
    _same(got, refbfs.check(jcfg))
    assert got.n_states == 1514
    fkw = dict(TOY, history=True, max_elections=4)
    invs = ("NoTwoLeaders", "ElectionSafetyHist", "AllLogsPrefixClosed")
    cfg, jcfg = _configs(fkw, invs=invs, chunk=64)
    got = DDDEngine(cfg, caps, device="cpu").check()
    _same(got, refbfs.check(jcfg))


def _seeded():
    """The seeded NaiveNoTwoLeaders case (tests/test_ddd_engine.py)."""
    kw = dict(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)
    cfg, jcfg = _configs(kw, invs=("NaiveNoTwoLeaders",), chunk=64)
    start = interp.init_state(cfg.bounds)._replace(
        role=(SP.LEADER, SP.FOLLOWER, SP.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=((mb.rv_response(3, 1, 1, 2), 1),))
    jstart = jinterp.init_state(jcfg.bounds)._replace(
        role=start.role, term=start.term, votedFor=start.votedFor,
        vGrant=start.vGrant, msgs=((jmb.rv_response(3, 1, 1, 2), 1),))
    return cfg, jcfg, start, jstart


def _replays(trace, start, bounds, spec):
    return trace[0] == (None, start) and all(
        cur in [t for _i, t in interp.successors(prev, bounds, spec=spec)]
        for (_l, prev), (_l2, cur) in zip(trace, trace[1:]))


def test_violation_and_deadlock_stop_where_refbfs_stops():
    cfg, jcfg, start, jstart = _seeded()
    caps = DDDCapacities(block=256, table=1 << 8, seg_rows=1 << 13,
                         flush=1 << 9, levels=64)
    ref = refbfs.check(jcfg, init_override=jstart)
    got = DDDEngine(cfg, caps, device="cpu").check(init_override=start)
    assert got.violation.invariant == "NaiveNoTwoLeaders"
    assert got.n_states == ref.n_states
    assert _replays(got.violation.trace, start, cfg.bounds, "election")
    assert not inv_mod.py_invariant("NaiveNoTwoLeaders")(
        got.violation.state, cfg.bounds)
    kw = dict(n_servers=1, n_values=1, max_term=2, max_log=0, max_msgs=2)
    cfg, jcfg = _configs(kw, invs=(), chunk=16, check_deadlock=True)
    ref = refbfs.check(jcfg)
    got = DDDEngine(cfg, DDDCapacities(block=64, table=1 << 8,
                                       seg_rows=1 << 12, flush=1 << 8,
                                       levels=64), device="cpu").check()
    assert got.violation.invariant == ref.violation.invariant == DEADLOCK
    assert got.n_states == ref.n_states
    assert _replays(got.violation.trace, interp.init_state(cfg.bounds),
                    cfg.bounds, "election")


def test_frontier_keep_levels_rebuilds_the_full_trace(tmp_path):
    cfg, jcfg, start, jstart = _seeded()
    kw = dict(block=256, table=1 << 8, seg_rows=1 << 13, flush=1 << 9,
              levels=64)
    full = DDDEngine(cfg, DDDCapacities(**kw), device="cpu").check(
        init_override=start)
    got = DDDEngine(cfg, DDDCapacities(**kw, retention="frontier",
                                       keep_levels=True),
                    device="cpu").check(init_override=start,
                                        checkpoint=str(tmp_path / "f"))
    assert got.n_states == full.n_states == refbfs.check(
        jcfg, init_override=jstart).n_states
    assert got.violation.invariant == "NaiveNoTwoLeaders"
    assert len(got.violation.trace) == len(full.violation.trace)
    assert got.violation.trace[-1] == full.violation.trace[-1]
    assert _replays(got.violation.trace, start, cfg.bounds, "election")
    # without kept levels a frontier run reports the state alone
    bare = DDDEngine(cfg, DDDCapacities(**kw, retention="frontier"),
                     device="cpu").check(init_override=start)
    assert bare.violation.trace == [(None, full.violation.state)]


def test_deadline_stop_and_resume_keep_exact_counters(tmp_path, toy_ref):
    cfg, _ = _configs(TOY)
    caps = DDDCapacities(block=256, table=1 << 7, seg_rows=4096,
                         flush=1 << 9, levels=64)
    ck = str(tmp_path / "d.ckpt")
    eng = DDDEngine(cfg, caps, seg_chunks=4, device="cpu")
    part = eng.check(deadline_s=0.0, checkpoint=ck,
                     checkpoint_every_s=3600.0)
    assert not part.complete and 1 < part.n_states < 3014
    done = DDDEngine(cfg, caps, device="cpu").check(resume=ck)
    assert done.complete
    _same(done, toy_ref)


def _stopped_jax(jcfg, jcaps, path):
    eng = jddd.DDDEngine(jcfg, jcaps, seg_chunks=4)
    res = eng.check(deadline_s=0.0, checkpoint=path,
                    checkpoint_every_s=3600.0)
    assert not res.complete
    return res


@pytest.mark.parametrize("retention", ["full", "frontier"])
def test_snapshots_cross_between_the_packages(retention, tmp_path, toy_ref):
    """A JAX snapshot resumes in the port, a port snapshot resumes in JAX,
    and both finish with the oracle's results."""
    cfg, jcfg = _configs(TOY)
    kw = dict(block=256, table=1 << 8, seg_rows=4096, flush=1 << 9,
              levels=64, retention=retention)
    jcaps = jddd.DDDCapacities(**kw)
    a = str(tmp_path / "jax.ckpt")
    part = _stopped_jax(jcfg, jcaps, a)
    assert 1 < part.n_states < 3014
    ours = DDDEngine(cfg, DDDCapacities(**kw), device="cpu").check(
        resume=a, checkpoint=a)
    _same(ours, toy_ref)
    b = str(tmp_path / "port.ckpt")
    part = DDDEngine(cfg, DDDCapacities(**kw), seg_chunks=4,
                     device="cpu").check(deadline_s=0.0, checkpoint=b,
                                         checkpoint_every_s=3600.0)
    assert not part.complete and 1 < part.n_states < 3014
    theirs = jddd.DDDEngine(jcfg, jcaps).check(resume=b, checkpoint=b)
    _same(theirs, toy_ref)


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = cli.main(list(argv))
    return code, out.getvalue(), err.getvalue()


def test_cli_engine_ddd(tmp_path):
    def cfg(name, servers, inv, extra=""):
        p = tmp_path / f"{name}.cfg"
        p.write_text(
            f"SPECIFICATION Spec\nINVARIANT {inv}\n{extra}CONSTANTS\n"
            f"    Server = {{{servers}}}\n    Value = {{v1}}\n")
        return str(p)

    base = ["--engine", "ddd", "--device", "cpu", "--spec", "election",
            "--max-term", "2", "--max-log", "0", "--max-msgs", "2",
            "--chunk", "64", "--cap", "4096"]
    code, out, err = _run([cfg("ok", "s1, s2", "NoTwoLeaders"), *base,
                           "--stats"])
    assert code == cli.EXIT_OK
    assert "3014 distinct states found, diameter 17" in out
    assert '"level": 17, ' in err and '"n_states": 3014' in err
    code, out, _ = _run([cfg("dl", "s1", "NoTwoLeaders"), *base,
                         "--deadlock", "--retention", "frontier"])
    assert code == cli.EXIT_DEADLOCK and "Deadlock reached" in out
    code, out, _ = _run([cfg("bad", "s1, s2, s3", "NaiveNoTwoLeaders",
                             "SYMMETRY Server\n"),
                         "--engine", "ddd", "--device", "cpu", "--spec",
                         "election", "--max-term", "3", "--max-log", "0",
                         "--max-msgs", "1", "--chunk", "1024", "--no-trace",
                         "--view", "deadvotes"])
    assert code == cli.EXIT_VIOLATION
    assert "Invariant NaiveNoTwoLeaders is violated" in out
    c = cfg("r", "s1, s2", "NoTwoLeaders")
    for flag in ("--route", "--device-dedup", "--devdedup", "--reshard-to",
                 "--events"):
        with pytest.raises(SystemExit) as e:
            _run([c, *base, flag, "4"])
        assert e.value.code == 2
    for eng in ("paged", "streamed", "shard"):
        with pytest.raises(SystemExit):
            _run([c, "--engine", eng])
    # the DDD options are ignored by the other engines, as the reference's
    code, out, _ = _run([c, *base[2:], "--engine", "ref", "--retention",
                         "frontier", "--keep-levels", "--block", "64"])
    assert code == cli.EXIT_OK and "3014 distinct states found" in out
    if not torch.cuda.is_available():               # cuda is the default
        code, _, err = _run([c, "--engine", "ddd"])
        assert code == cli.EXIT_ERROR and "no GPU" in err
