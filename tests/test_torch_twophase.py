"""Two-phase commit (``--spec twophase``) in the port against the JAX
reference, on the CPU.

- the port's own oracle (``frontend/twophase.reference_check``) pinned at
  n = 1, 2, 3 and equal to the reference's level by level;
- the schema step (compiled from the action IR) equal to the reference's
  ``build_schema_step`` on every reachable row, every output;
- the host engine equal to the oracle and to the JAX ``engine.check`` at
  n = 2 and 3 (levels, transitions, coverage); the expression-violation
  trace rendered as the reference renders it;
- the CLI's result lines and exit codes equal to the JAX CLI's (a pass, a
  violation, ``--engine device`` refused, SYMMETRY refused), and
  ``--emit-tlc`` byte-equal;
- ``--simulate`` verdict lines and exit codes equal to the JAX CLI's, the
  violating walk replayed through ``apply_instance``, and the fleet's
  contracts (unsteered, the simulator's walks);
- admission's accept and reject findings equal to the reference's.

Tolerance: bit-exact.
"""

import dataclasses
import io
import re
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

import jax

from raft_tla_tpu import check as jcli
from raft_tla_tpu import engine as jengine
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.frontend import actions as jactions
from raft_tla_tpu.frontend import registry as jregistry
from raft_tla_tpu.frontend import twophase as jtp
from raft_tla_tpu.serve import jobs as jjobs

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.engine import Engine
from raft_tla_tpu_torch.fleet import FleetSimulator
from raft_tla_tpu_torch.frontend import registry
from raft_tla_tpu_torch.frontend import twophase as tp
from raft_tla_tpu_torch.serve import jobs
from raft_tla_tpu_torch.simulate import Simulator

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

# (states, diameter, transitions); 288 at n = 3 is TLC's count for TwoPhase
ORACLE = {1: (12, 4, 19), 2: (56, 7, 153), 3: (288, 10, 1145)}
INVS = ("TCConsistent", "~(msgCommit = 1)", "count(rmState = 2) <= 1")


def _cfg(tmp_path, rms="r1, r2", invariant="TCConsistent", extra="",
         name="2pc"):
    path = tmp_path / f"{name}.cfg"
    path.write_text(f"SPECIFICATION Spec\nCONSTANT RM = {{{rms}}}\n"
                    f"INVARIANT {invariant}\n{extra}")
    return str(path)


def _config(n, invariants=("TCConsistent",), **kw):
    return CheckConfig(bounds=Bounds(n_servers=n, n_values=1),
                       spec="twophase", invariants=invariants, chunk=64,
                       **kw)


def _jconfig(n, invariants=("TCConsistent",), **kw):
    return JConfig(bounds=JBounds(n_servers=n, n_values=1),
                   spec="twophase", invariants=invariants, chunk=64, **kw)


def _run(main, argv):
    """(exit code, stdout, last line of stderr) — argparse's exit too, its
    ``prog: error:`` prefix cut to ``error:``."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            code = main(list(argv))
        except SystemExit as e:
            code = e.code
    lines = err.getvalue().strip().splitlines()
    last = re.sub(r"^.*?: error: ", "error: ", lines[-1]) if lines else ""
    return code, out.getvalue(), last


def _from(text, marker, cut=None):
    """The lines from the one containing ``marker`` on, that line's times
    and rates removed (``cut``: a regex)."""
    lines = text.splitlines()
    k = next(i for i, ln in enumerate(lines) if marker in ln)
    lines[k] = re.sub(cut, "", lines[k]) if cut else marker
    return lines[k:]


def test_reference_oracle_pinned():
    for n, want in ORACLE.items():
        ref, jref = tp.reference_check(n), jtp.reference_check(n)
        assert (ref.n_states, ref.diameter, ref.n_transitions) == want
        assert ref.levels == jref.levels and ref.consistent


def test_schema_step_matches_jax_on_every_reachable_row():
    """n = 3: all 288 states, every output of every lane (A = 17)."""
    n, jb, b = 3, JBounds(n_servers=3, n_values=1), Bounds(n_servers=3,
                                                          n_values=1)
    jmodel = jregistry.resolve_model("twophase")
    preds = tuple(jmodel._predicate(nm) for nm in INVS)
    jstep = jax.jit(jactions.build_schema_step(
        jtp.SCHEMA, jtp.ACTIONS, jtp.action_table(jb), jb,
        predicates=preds))
    step = registry.resolve_model("twophase").build_step(
        _config(n, INVS), "cpu")
    seen = {tp.init_state(b)}
    frontier = list(seen)
    while frontier:
        nxt = []
        for s in frontier:
            for _label, t in tp._py_successors(s, n):
                if t not in seen:
                    seen.add(t)
                    nxt.append(t)
        frontier = nxt
    rows = np.stack([tp.to_vec(s, b) for s in sorted(seen, key=repr)])
    assert len(rows) == 288
    got = step(torch.as_tensor(rows))
    want = {k: np.asarray(v) for k, v in jstep(rows).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert np.array_equal(g.view(np.uint32) if k.startswith("fp")
                              else g, w), k
    assert dataclasses.astuple(tp.from_vec(rows[5], b)) == \
        dataclasses.astuple(jtp.from_vec(rows[5], jb))
    assert int(got["valid"].sum()) == ORACLE[3][2]


@pytest.mark.parametrize("n", [2, 3])
def test_host_engine_matches_oracle_and_jax(n):
    res = Engine(_config(n), device="cpu").check()
    jres = jengine.check(_jconfig(n))
    ref = tp.reference_check(n)
    assert res.violation is None and jres.violation is None
    assert (res.n_states, res.diameter, res.n_transitions) == ORACLE[n]
    assert res.levels == jres.levels == ref.levels
    assert res.n_transitions == jres.n_transitions
    assert dict(res.coverage) == dict(jres.coverage)


def test_expression_violation_trace_matches_jax():
    """``~any(rmState = 2)`` ("no RM ever commits") at n = 2: the same
    counts, trace and rendering as the reference's host engine."""
    inv = ("~any(rmState = 2)",)
    res = Engine(_config(2, inv), device="cpu").check()
    jres = jengine.check(_jconfig(2, inv))
    v, jv = res.violation, jres.violation
    assert v is not None and v.invariant == jv.invariant == inv[0]
    assert [lab for lab, _s in v.trace] == [lab for lab, _s in jv.trace]
    assert res.n_states == jres.n_states
    text = registry.resolve_model("twophase").render_trace(
        v, Bounds(n_servers=2, n_values=1))
    assert text == jregistry.resolve_model("twophase").render_trace(
        jv, JBounds(n_servers=2, n_values=1))
    assert tp.COMMITTED in v.state.rmState


def test_cli_lines_and_exit_codes_match_jax_cli(tmp_path):
    cut = r", [0-9.]+s \(.*states/s\)\.$"
    ok, bad = _cfg(tmp_path), _cfg(tmp_path, "r1, r2, r3",
                                   "~(msgCommit = 1)", name="v")
    for argv, want in (([ok, "--coverage"], 0), ([bad], 12)):
        argv = argv + ["--spec", "twophase"]
        code, out, _ = _run(cli.main, argv + ["--engine", "host",
                                              "--device", "cpu"])
        jcode, jout, _ = _run(jcli.main, argv + ["--engine", "host"])
        assert code == jcode == want
        assert _from(out, "distinct states found", cut) == \
            _from(jout, "distinct states found", cut)
    # the default engine and SYMMETRY: refused with the reference's text
    sym = _cfg(tmp_path, extra="SYMMETRY Server\n", name="s")
    for argv, want in (([ok], 2), ([sym, "--engine", "host"], 1),
                       ([ok, "--engine", "ref", "--simulate", "5"], 2)):
        argv = argv + ["--spec", "twophase"]
        got = _run(cli.main, argv + ["--device", "cpu"])
        jgot = _run(jcli.main, argv)
        assert (got[0], got[2]) == (jgot[0], jgot[2]) and got[0] == want, \
            (got, jgot)


def test_emit_tlc_byte_equal(tmp_path):
    ok = _cfg(tmp_path, "r1, r2, r3")
    port, ref = tmp_path / "port", tmp_path / "ref"
    code, out, _ = _run(cli.main, [ok, "--spec", "twophase", "--engine",
                                   "host", "--device", "cpu", "--emit-tlc",
                                   str(port)])
    assert code == 0 and "TLC parity artifacts" in out
    jtp.emit_tla(str(ref), JBounds(n_servers=3, n_values=1),
                 ("TCConsistent",))
    for name in ("MC2pc.tla", "MC2pc.cfg"):
        assert (port / name).read_bytes() == (ref / name).read_bytes()
    with pytest.raises(ValueError, match="expression"):
        tp.emit_tla(str(port), Bounds(n_servers=2, n_values=1),
                    ("all(rmState <= 3)",))


def test_simulate_verdicts_replay_and_fleet(tmp_path):
    """Verdict lines and exit codes of ``--simulate`` equal to the JAX
    CLI's (walks differ by design: counter-based draws); the violating walk
    replays through ``apply_instance``; the unsteered fleet walks the
    simulator's walks and replays its violation the same way."""
    sim = ["--spec", "twophase", "--engine", "host", "--simulate", "200",
           "--depth", "30",
           "--walkers", "32", "--seed", "3"]
    ok = _cfg(tmp_path, "r1, r2, r3")
    bad = _cfg(tmp_path, "r1, r2, r3", "~(msgCommit = 1)", name="v")
    for argv, want in (([ok] + sim, 0), ([bad, "--no-trace"] + sim, 12)):
        code, out, _ = _run(cli.main, argv + ["--device", "cpu"])
        jcode, jout, _ = _run(jcli.main, argv)
        assert code == jcode == want
        assert _from(out, "behaviors generated") == \
            _from(jout, "behaviors generated")
    b = Bounds(n_servers=3, n_values=1)
    config = _config(3, ("~(msgCommit = 1)",))
    res = Simulator(config, walkers=32, depth=30, seed=3,
                    device="cpu").run(200)
    v = res.violation
    cur = tp.init_state(b)
    table = {inst.label(): inst for inst in tp.action_table(b)}
    for label, state in v.trace[1:]:
        cur = tp.apply_instance(cur, table[label], b)
        assert cur == state
    assert cur.msgCommit == 1 and v.trace[0] == (None, tp.init_state(b))
    fleet = FleetSimulator(config, walkers=32, depth=30, seed=3,
                           device="cpu").run(200)
    assert fleet.violation.trace == v.trace
    clean = _config(3)
    fr = FleetSimulator(clean, walkers=32, depth=30, steps_per_dispatch=8,
                        seed=5, device="cpu").run(100, snapshot_walks=True)
    s = Simulator(clean, walkers=32, depth=30, steps_per_dispatch=8, seed=5,
                  device="cpu")
    w = s.start()
    while s.dispatch(w)[1] < 100:
        pass
    assert np.array_equal(fr.walks[0], w.hist.numpy())
    assert np.array_equal(fr.walks[1], w.hlen.numpy())
    assert fr.violation is None and sum(fr.coverage.values()) == fr.n_states


def test_admission_matches_reference(tmp_path):
    ok = _cfg(tmp_path)
    cases = {
        "accept": (ok, {}),
        "typo-spec": (ok, {"spec": "twophse"}),
        "bad-expression": (_cfg(tmp_path, invariant="all(bogus = 1)",
                                name="e"), {}),
        "symmetry": (_cfg(tmp_path, extra="SYMMETRY Server\n", name="s"),
                     {}),
        "property": (_cfg(tmp_path, extra="PROPERTY EventuallyLeader\n",
                          name="p"), {}),
        "faithful": (ok, {"faithful": True}),
        "no-rm": (_cfg(tmp_path, rms="", name="r"), {}),
    }
    reasons = {}
    for name, (path, opts) in cases.items():
        d = {"id": name, "cfg": path, "spec": "twophase", **opts}
        got = jobs.admit(jobs.CheckJob.from_dict(d))
        want = jjobs.admit(jjobs.CheckJob.from_dict(d))
        assert (got.admitted, got.reason, got.findings_text()) == \
            (want.admitted, want.reason, want.findings_text()), name
        reasons[name] = got.reason
        if got.admitted:
            assert (got.config.spec, got.config.invariants,
                    got.config.bounds.n_servers) == \
                (want.config.spec, want.config.invariants,
                 want.config.bounds.n_servers)
    assert reasons == {"accept": None, "typo-spec": "spec-unknown",
                       "bad-expression": "cfg-invalid",
                       "symmetry": "cfg-invalid",
                       "property": "cfg-invalid", "faithful": "cfg-invalid",
                       "no-rm": "cfg-invalid"}
