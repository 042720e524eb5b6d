"""The port's ``ref`` and ``host`` engines against the JAX oracle, and the
CLI surface that comes with them.

``raft_tla_tpu_torch.models.refbfs`` (``--engine ref``) and the host
engine ``raft_tla_tpu_torch.engine.Engine`` (``--engine host``, on the CPU
the plain step) are held to the JAX package's ``refbfs``: states, levels,
diameter, transitions, coverage, and the first violation with its trace,
exactly.  The host engine must also give the same search when K1's invalid
lanes hold garbage (the step contract).  The CLI's engine gates keep the
reference's exit codes, and ``--stats`` lines carry the reference's
``ProgressRecord`` fields.
"""

import dataclasses
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import interp as jinterp, refbfs as jrefbfs
from raft_tla_tpu.models import spec as JS
from raft_tla_tpu.obs.events import ProgressRecord as JProgressRecord
from raft_tla_tpu.ops import msgbits as jmb

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.engine import DEADLOCK, Engine
from raft_tla_tpu_torch.models import interp, refbfs

from test_torch_cli import _result_lines, write_cfg
from test_torch_step_contract import garbage_off_valid

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

TOY = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
SEEDED = dict(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)
ELECTION_2S = ["--spec", "election", "--max-term", "2", "--max-log", "0",
               "--max-msgs", "2"]

# (name, bounds, spec, invariants, symmetry, view, deadlock)
CONFIGS = [
    ("toy", TOY, "election", ("NoTwoLeaders",), (), None, False),
    ("toy-Server", TOY, "election", ("NoTwoLeaders",), ("Server",), None,
     False),
    ("full-deadvotes", dict(n_servers=2, n_values=1, max_term=2, max_log=1,
                            max_msgs=1), "full",
     ("LogMatching", "commitIndex <= logLen"), (), "deadvotes", False),
    ("faithful", dict(TOY, history=True, max_elections=4), "election",
     ("NoTwoLeaders", "ElectionSafetyHist"), (), None, False),
    ("deadlock", dict(TOY, n_servers=1), "election", ("NoTwoLeaders",), (),
     None, True),
]


def _configs(kw, spec, invs, axes=(), view=None, deadlock=False, chunk=64):
    args = dict(spec=spec, invariants=invs, symmetry=axes, view=view,
                check_deadlock=deadlock, chunk=chunk)
    return (CheckConfig(bounds=Bounds(**kw), **args),
            JConfig(bounds=JBounds(**kw), **args))


def _port_state(s):
    return interp.PyState(**{f: getattr(s, f)
                             for f in interp.PyState.__dataclass_fields__})


def _seeded_start(b):
    return jinterp.init_state(b)._replace(
        role=(JS.LEADER, JS.FOLLOWER, JS.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=((jmb.rv_response(3, 1, 1, 2), 1),))


def assert_same_as_jax(got, want):
    assert (got.n_states, got.diameter, got.levels, got.n_transitions) == \
        (want.n_states, want.diameter, want.levels, want.n_transitions)
    assert dict(got.coverage) == dict(want.coverage)
    assert (got.violation is None) == (want.violation is None)
    if want.violation is not None:
        assert got.violation.invariant == want.violation.invariant
        assert got.violation.trace == [(lbl, _port_state(s))
                                       for lbl, s in want.violation.trace]


def _engine(name):
    if name == "ref":
        return refbfs.check
    return lambda cfg, **kw: Engine(cfg, device="cpu").check(**kw)


@pytest.mark.parametrize("engine", ["ref", "host"])
def test_engines_match_jax_refbfs(engine):
    """Plain, SYMMETRY, a VIEW with an expression, faithful mode and a
    deadlock: every result field of the JAX oracle."""
    run = _engine(engine)
    for name, kw, spec, invs, axes, view, dead in CONFIGS:
        cfg, jcfg = _configs(kw, spec, invs, axes, view, dead)
        assert_same_as_jax(run(cfg), jrefbfs.check(jcfg))
    assert refbfs.DEADLOCK == DEADLOCK == jrefbfs.DEADLOCK


@pytest.mark.parametrize("engine", ["ref", "host"])
def test_seeded_violation_matches_jax_refbfs(engine):
    """The seeded NaiveNoTwoLeaders violation (the JAX package's
    tests/test_symmetry.py:117), and its expression twin, which stops at
    the same state with the same trace."""
    run = _engine(engine)
    jstart = _seeded_start(JBounds(**SEEDED))
    traces = []
    for inv in ("NaiveNoTwoLeaders", "count(role = 2) <= 1"):
        cfg, jcfg = _configs(SEEDED, "election", (inv,), chunk=256)
        want = jrefbfs.check(jcfg, init_override=jstart)
        got = run(cfg, init_override=_port_state(jstart))
        assert_same_as_jax(got, want)
        assert got.violation.invariant == inv
        traces.append(got.violation.trace)
    assert traces[0] == traces[1]


def test_host_engine_ignores_garbage_in_invalid_lanes():
    """K1 leaves the outputs of an invalid lane unwritten: the host engine
    reads them only where ``valid`` is set."""
    for name, kw, spec, invs, axes, view, dead in CONFIGS[:3] + CONFIGS[4:]:
        cfg, _ = _configs(kw, spec, invs, axes, view, dead)
        want = Engine(cfg, device="cpu").check()
        eng = Engine(cfg, device="cpu")
        eng.step = garbage_off_valid(eng.step, seed=11)
        got = eng.check()
        assert (got.n_states, got.levels, got.n_transitions) == \
            (want.n_states, want.levels, want.n_transitions), name
        assert dict(got.coverage) == dict(want.coverage)
        assert got.violation == want.violation


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    try:
        with redirect_stdout(out), redirect_stderr(err):
            code = main(list(argv))
    except SystemExit as e:
        code = e.code
    return code, out.getvalue(), err.getvalue()


def test_engine_gates_keep_the_reference_exit_codes(tmp_path, monkeypatch):
    """DDD options are ignored by the engines that do not use them; the
    reference's refusals exit 2 (``--stats`` and ``--checkpoint`` need a
    device-class engine, ``--deadline`` the ddd engine)."""
    for env in ("RAFT_TLA_HOSTDEDUP", "RAFT_TLA_PREFETCH"):
        monkeypatch.setenv(env, "auto")     # both CLIs set them; restored
    cfg = write_cfg(tmp_path / "m.cfg")
    ck = str(tmp_path / "ck")
    cases = [
        (["--engine", "ref", "--block", "64", "--retention", "frontier",
          "--keep-levels", "--host-dedup", "on", "--prefetch", "off"], 0),
        (["--engine", "host", "--keep-levels", "--block", "128"], 0),
        (["--engine", "ref", "--stats"], 2),
        (["--engine", "host", "--stats"], 2),
        (["--engine", "ref", "--checkpoint", ck], 2),
        (["--engine", "host", "--resume", ck], 2),
        (["--engine", "ref", "--deadline", "5"], 2),
        (["--engine", "host", "--deadline", "5"], 2),
    ]
    for extra, want in cases:
        code, out, _ = _run(cli.main, [cfg, "--device", "cpu", *ELECTION_2S,
                                       *extra])
        jcode, jout, _ = _run(jcli.main, [cfg, *ELECTION_2S, *extra])
        assert code == jcode == want, extra
        if want == 0:
            assert _result_lines(out) == _result_lines(jout)
    # --keep-levels without --retention frontier: accepted, as the
    # reference does (the device engine ignores it).
    code, out, _ = _run(cli.main, [cfg, "--device", "cpu", *ELECTION_2S,
                                   "--keep-levels", "--chunk", "256"])
    assert code == 0 and "3014 distinct states found" in out


@pytest.mark.parametrize("engine", ["device", "ddd"])
def test_stats_lines_carry_the_reference_fields(tmp_path, engine,
                                               monkeypatch):
    """``--stats``: JSON lines on stderr whose keys are fields of the
    reference's ``ProgressRecord`` (read from the dataclass, no JAX run),
    the device engine's one per segment."""
    for env in ("RAFT_TLA_HOSTDEDUP", "RAFT_TLA_PREFETCH"):
        monkeypatch.setenv(env, "on")       # the DDD worker and prefetcher
    fields = {f.name for f in dataclasses.fields(JProgressRecord)}
    cfg = write_cfg(tmp_path / "m.cfg")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code, eng, res = cli.run([cfg, "--device", "cpu", "--engine", engine,
                                  *ELECTION_2S, "--chunk", "16"])
        code, eng, res = cli.run([cfg, "--device", "cpu", "--engine", engine,
                                  *ELECTION_2S, "--chunk", "16", "--stats"])
    lines = [json.loads(ln) for ln in err.getvalue().splitlines()
             if ln.startswith("{")]
    assert code == 0 and res.n_states == 3014 and lines
    want = {"wall_s", "n_states", "level", "n_transitions", "dedup_hit_rate",
            "states_per_sec", "inc_states_per_sec", "since_resume",
            "coverage", "inv_evals"}
    if engine == "ddd":
        want |= {"flush_backlog", "upload_wait_ms", "prefetch_hits",
                 "export_rows"}
    else:
        assert len(lines) == eng.stats["segments"] >= 1
    for d in lines:
        assert want <= set(d) <= fields, set(d) ^ want
        assert d["inv_evals"] == {"NoTwoLeaders": d["n_transitions"]}
    assert lines[-1]["n_states"] == 3014 and lines[-1]["level"] >= 17


def test_cli_expression_violation_matches_jax_cli(tmp_path):
    """An expression invariant that fails: exit 12, its verdict naming the
    expression, and the oracle's trace through every port engine.  The
    ``ref`` and ``host`` engines print the JAX CLI's lines for the same
    engine; a device-class engine counts the whole chunk in which it
    stopped (here --chunk 1: the oracle's states, the row's transitions)."""
    args = ["--spec", "election", "--max-term", "3", "--max-log", "0",
            "--max-msgs", "2", "--chunk", "1"]
    cfg = write_cfg(tmp_path / "x.cfg", invariant="max(term) <= 2")
    want = {}
    for engine in ("ref", "host"):
        jcode, jout, _ = _run(jcli.main, [cfg, "--engine", engine, *args])
        assert jcode == cli.EXIT_VIOLATION
        want[engine] = _result_lines(jout)
    for engine in ("ref", "host", "device", "ddd"):
        code, out, _ = _run(cli.main, [cfg, "--device", "cpu", "--engine",
                                       engine, *args])
        got = _result_lines(out)
        assert code == cli.EXIT_VIOLATION, engine
        assert got == want.get(engine, got[:1] + want["ref"][1:]), engine
    assert want["ref"][0].startswith("4 distinct states found")
    assert "Error: Invariant max(term) <= 2 is violated." in out
