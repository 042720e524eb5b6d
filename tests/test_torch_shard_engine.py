"""The port's shard engine (raft_tla_tpu_torch/parallel/) against the JAX
``ShardEngine``, on the CPU.

The JAX engine runs its XLA path on the conftest's 8 virtual CPU devices;
the port runs the same number of shards in one process.  Within a shard
candidates arrive in (sender, slot) order and the dedup keeps the smallest
index (the reference's determinism, ``shard_engine.py:39-49``), so at equal
mesh sizes the two engines agree exactly: counts, levels, transitions,
per-family coverage and the violation trace, state for state.  Totals also
equal the port's single-device engine and refbfs at every mesh size.
"""

import io
import re
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import interp as jinterp
from raft_tla_tpu.ops import msgbits as jmb
from raft_tla_tpu.parallel import ShardCapacities as JCaps
from raft_tla_tpu.parallel import ShardEngine as JShardEngine
from raft_tla_tpu.parallel import make_mesh as jmesh
from raft_tla_tpu.parallel.shard_engine import make_slice_mesh as jslice

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch import parallel
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
from raft_tla_tpu_torch.engine import DEADLOCK
from raft_tla_tpu_torch.models import interp, refbfs, spec as S
from raft_tla_tpu_torch.ops import msgbits as mb
from raft_tla_tpu_torch.parallel import (Mesh, ShardCapacities, ShardEngine,
                                         make_mesh, make_slice_mesh)
from raft_tla_tpu_torch.parallel.shard_engine import exchange

# The suite runs in several worker processes: one torch thread each.
torch.set_num_threads(1)

TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
FULL = dict(n_servers=2, n_values=1, max_term=2, max_log=1, max_msgs=2)
FULL_INV = ("NoTwoLeaders", "LogMatching", "CommittedWithinLog")
SEEDED = dict(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)


def cfgs(kw, spec="election", invariants=("NoTwoLeaders",), chunk=64,
         **extra):
    """The same config in both packages."""
    return (JConfig(bounds=JBounds(**kw), spec=spec, invariants=invariants,
                    chunk=chunk, **extra),
            CheckConfig(bounds=Bounds(**kw), spec=spec,
                        invariants=invariants, chunk=chunk, **extra))


def assert_same(got, want):
    """Everything an engine result reports, the trace included."""
    assert got.n_states == want.n_states
    assert got.diameter == want.diameter
    assert got.levels == want.levels
    assert got.n_transitions == want.n_transitions
    assert dict(got.coverage) == dict(want.coverage)
    assert (got.violation is None) == (want.violation is None)
    if got.violation is not None:
        assert got.violation.invariant == want.violation.invariant
        assert [(lb, repr(s)) for lb, s in got.violation.trace] == \
            [(lb, repr(s)) for lb, s in want.violation.trace]


def test_full_spec_8_shards_equal_jax():
    """The full-spec 2-server toy at 8 shards: the JAX ShardEngine's
    counts, levels, transitions and per-family coverage exactly."""
    jc, pc = cfgs(FULL, "full", FULL_INV, chunk=128)
    want = JShardEngine(jc, jmesh(8), JCaps(n_states=1 << 14,
                                            levels=64)).check()
    eng = ShardEngine(pc, make_mesh(8, device="cpu"),
                      ShardCapacities(n_states=1 << 14, levels=64))
    got = eng.check()
    assert_same(got, want)
    assert got.violation is None and got.n_states == 48_041
    assert sum(eng.stats["per_shard_states"]) == got.n_states
    assert min(eng.stats["per_shard_states"]) > 0
    for fam in (S.RESTART, S.DUPLICATE, S.DROP):
        assert got.coverage[fam] > 0


def test_seeded_violation_trace_equals_jax():
    """The seeded NaiveNoTwoLeaders start at 8 shards: JAX's trace, state
    for state and label for label, ending in two leaders."""
    jc, pc = cfgs(SEEDED, invariants=("NaiveNoTwoLeaders",), chunk=256)
    kw = dict(role=(S.LEADER, S.FOLLOWER, S.CANDIDATE), term=(2, 3, 3),
              votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100))
    start = interp.init_state(pc.bounds)._replace(
        msgs=((mb.rv_response(3, 1, 1, 2), 1),), **kw)
    jstart = jinterp.init_state(jc.bounds)._replace(
        msgs=((jmb.rv_response(3, 1, 1, 2), 1),), **kw)
    want = JShardEngine(jc, jmesh(8), JCaps(n_states=1 << 12, levels=64)
                        ).check(init_override=jstart)
    got = ShardEngine(pc, make_mesh(8, device="cpu"),
                      ShardCapacities(n_states=1 << 12, levels=64)
                      ).check(init_override=start)
    assert_same(got, want)
    v = got.violation
    assert v.invariant == "NaiveNoTwoLeaders" and v.trace[0] == (None, start)
    assert sum(r == S.LEADER for r in v.state.role) == 2


def test_slice_mesh_2x4_equals_jax():
    """The 2x4 slice mesh (the exchange in two stages): the JAX engine's
    results on its 2x4 mesh exactly, and the 1-D mesh's per-shard states
    (ownership is by flat id)."""
    jc, pc = cfgs(TOY)
    caps = ShardCapacities(n_states=1 << 12, levels=64)
    want = JShardEngine(jc, jslice(2, 4), JCaps(n_states=1 << 12,
                                                levels=64)).check()
    eng = ShardEngine(pc, make_slice_mesh(2, 4, device="cpu"), caps)
    assert_same(eng.check(), want)
    flat = ShardEngine(pc, make_mesh(8, device="cpu"), caps)
    flat.check()
    assert flat.stats["per_shard_states"] == eng.stats["per_shard_states"]


def test_counts_equal_device_engine_and_refbfs():
    """1, 2 and 8 shards explore the graph of the port's DeviceEngine and
    of refbfs: the same counts, levels and transitions."""
    _jc, pc = cfgs(TOY, chunk=32)
    ref = refbfs.check(pc)
    dev = DeviceEngine(pc, Capacities(n_states=1 << 12, levels=64),
                       device="cpu").check()
    assert (dev.n_states, dev.levels, dev.n_transitions) == \
        (ref.n_states, ref.levels, ref.n_transitions)
    for n in (1, 2, 8):
        got = ShardEngine(pc, make_mesh(n, device="cpu"),
                          ShardCapacities(n_states=1 << 12, levels=64)
                          ).check()
        assert (got.n_states, got.diameter, got.levels, got.n_transitions) \
            == (ref.n_states, ref.diameter, ref.levels, ref.n_transitions)
        assert sum(got.coverage.values()) == ref.n_states - 1


def test_deadlock_two_shards_equals_jax():
    """``check_deadlock`` on the 1-server election: JAX's deadlock, its
    trace and counts at two shards."""
    kw = dict(n_servers=1, n_values=1, max_term=2, max_log=0, max_msgs=2)
    jc, pc = cfgs(kw, chunk=16, check_deadlock=True)
    want = JShardEngine(jc, jmesh(2), JCaps(n_states=1 << 10,
                                            levels=32)).check()
    got = ShardEngine(pc, make_mesh(2, device="cpu"),
                      ShardCapacities(n_states=1 << 10, levels=32)).check()
    assert got.violation is not None and got.violation.invariant == DEADLOCK
    assert_same(got, want)


def test_loud_failures():
    """A routing depth too small for one owner's share aborts with the
    reference's text; the int32 global-id space and the chunk bound are
    checked at construction."""
    _jc, pc = cfgs(TOY, invariants=())
    with pytest.raises(RuntimeError, match="routing budget"):
        ShardEngine(pc, make_mesh(8, device="cpu"),
                    ShardCapacities(n_states=1 << 12, levels=64, send=1)
                    ).check()
    with pytest.raises(ValueError, match="int32 global-id space"):
        ShardEngine(pc, make_mesh(4, device="cpu"),
                    ShardCapacities(n_states=1 << 30))
    with pytest.raises(ValueError, match="must be >= chunk"):
        ShardEngine(pc, make_mesh(2, device="cpu"),
                    ShardCapacities(n_states=16))


def test_exchange_is_a_stable_count_sort():
    """``exchange`` against a plain loop: destination d receives, source by
    source, that source's first ``cap`` rows for d in order, then the fill;
    more than ``cap`` rows set the source's overflow flag; ``dest >=
    n_dest`` drops a row.  Two blocks of shards, as on two devices."""
    rng = np.random.default_rng(7)
    n_dest, N, cap = 3, 40, 16
    dest = rng.integers(0, n_dest + 1, size=(n_dest, N))
    dest[0, :20] = 1                # source 0 overflows destination 1
    vals = rng.integers(-99, 99, size=(n_dest, N, 2)).astype(np.int32)
    blocks = ([0, 1], [2])
    got, n_recv, ovf = exchange(
        n_dest, cap, [torch.as_tensor(dest[b]) for b in blocks],
        [[(torch.as_tensor(vals[b]), -7)] for b in blocks])
    for d in range(n_dest):
        want = np.concatenate([vals[s][dest[s] == d][:cap]
                               for s in range(n_dest)])
        b, i = (0, d) if d < 2 else (1, 0)
        recv = got[b][0][i].numpy()
        assert n_recv[d] == len(want)
        assert (recv[:len(want)] == want).all() and (recv[len(want):]
                                                     == -7).all()
    assert ovf == [bool(((dest[s][:, None] == np.arange(n_dest))
                         .sum(0) > cap).any()) for s in range(n_dest)]
    assert ovf[0] and not all(ovf)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = main(list(argv))
    return code, out.getvalue(), err.getvalue()


def _result_lines(text):
    lines = text.splitlines()
    k = next(i for i, ln in enumerate(lines) if "distinct states found" in ln)
    lines[k] = re.sub(r", [0-9.]+s \(.*states/s\)\.$", "", lines[k])
    return lines[k:]


def _cfg(tmp_path):
    path = tmp_path / "toy.cfg"
    path.write_text(
        "SPECIFICATION Spec\nINVARIANT NoTwoLeaders\nCONSTANTS\n"
        "    Server = {s1, s2}\n    Value = {v1}\n"
        '    Follower = "Follower"\n    Candidate = "Candidate"\n'
        '    Leader = "Leader"\n    Nil = "Nil"\n')
    return str(path)


TOY_ARGS = ["--spec", "election", "--max-term", "2", "--max-log", "0",
            "--max-msgs", "2", "--chunk", "64", "--coverage"]


def test_cli_shard_prints_the_reference_lines(tmp_path):
    """``--engine shard --device cpu --devices 4`` (and ``--slices 2``)
    prints the JAX CLI's result lines, coverage included, and its exit
    code; ``--stats`` gives one progress line a segment."""
    cfg = _cfg(tmp_path)
    for mesh in (["--devices", "4"], ["--devices", "4", "--slices", "2"]):
        code, out, err = _run(cli.main, [cfg, *TOY_ARGS, "--engine", "shard",
                                         "--device", "cpu", *mesh,
                                         "--stats"])
        jcode, jout, _ = _run(jcli.main, [cfg, *TOY_ARGS, "--engine",
                                          "shard", "--cpu", *mesh])
        assert code == jcode == cli.EXIT_OK
        assert _result_lines(out) == _result_lines(jout)
        assert '"n_devices": 4' in err


def test_cli_refusals(tmp_path):
    """What stays refused names its ROADMAP item; a bad mesh, a missing
    card and a stray ``--reshard-cap`` fail as the reference's do."""
    cfg = _cfg(tmp_path)
    for argv, want in (
            (["--engine", "ddd-shard"], "item 11 (b)"),
            (["--engine", "pagedshard"], "item 11 (c)"),
            (["--cp-lanes"], "item 11 (b)"),
            (["--engine", "ddd", "--reshard-to", "2"], "item 11 (b)"),
            (["--simulate", "10", "--fleet", "--devices", "2"],
             "item 11 (c)"),
            (["--engine", "shard", "--reshard-cap", "99"],
             "--reshard-cap only applies")):
        err = io.StringIO()
        with pytest.raises(SystemExit) as e, redirect_stderr(err):
            cli.main([cfg, *TOY_ARGS, "--device", "cpu", *argv])
        assert e.value.code == 2 and want in err.getvalue(), err.getvalue()
    with pytest.raises(SystemExit, match="not divisible by --slices 3"), \
            redirect_stdout(io.StringIO()):
        cli.main([cfg, *TOY_ARGS, "--engine", "shard", "--device", "cpu",
                  "--devices", "4", "--slices", "3"])
    code, _out, err = _run(cli.main, [cfg, *TOY_ARGS, "--engine", "device",
                                      "--reshard-to", "2"])
    assert code == cli.EXIT_ERROR and "--reshard-to requires" in err
    for name, item in (("DDDShardEngine", "item 11 (b)"),
                       ("PagedShardEngine", "item 11 (c)")):
        with pytest.raises(NotImplementedError, match=re.escape(item)):
            getattr(parallel, name)
    if not torch.cuda.is_available():
        code, _out, err = _run(cli.main, [cfg, *TOY_ARGS, "--engine",
                                          "shard"])
        assert code == cli.EXIT_ERROR and "no GPU" in err
        with pytest.raises(RuntimeError, match="no GPU"):
            make_mesh(2)
        with pytest.raises(RuntimeError, match="no GPU"):
            Mesh(["cuda"])
