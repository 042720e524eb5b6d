"""The port's simulation mode (``raft_tla_tpu_torch/simulate.py``) against
the JAX package's (``raft_tla_tpu/simulate.py``), on the CPU.

The walks themselves differ by design (the port draws from a counter-based
splitmix64 stream, the reference from ``jax.random``), so the two packages
are held together where they must agree: the walker step on given rows and
lanes (bit-equal), the verdicts and the CLI's verdict lines and exit codes,
the refusals' texts, the event log's shape, and the mean walk length on a
clean universe (within 5%).  Each JAX ``Simulator`` compiles its segment
(a few seconds), so this file builds three of them: one shared by the
seeded violation and the mean walk length, and one each in the two JAX
CLI runs.
"""

import io
import json
import random
import re
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.frontend.registry import resolve_model as jresolve
from raft_tla_tpu.obs import validate_event as jvalidate
from raft_tla_tpu.simulate import Simulator as JSimulator

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.engine import DEADLOCK
from raft_tla_tpu_torch.models import interp, spec as S
from raft_tla_tpu_torch.obs import validate_event
from raft_tla_tpu_torch.ops import kernels, msgbits as mb
from raft_tla_tpu_torch.simulate import (
    Simulator, draw, gather_lane, mix64, pick_lanes, walker_keys)

torch.set_num_threads(1)

B2 = dict(n_servers=2, n_values=1, max_term=2, max_log=1, max_msgs=2)
CLEAN = dict(bounds=B2, spec="full", invariants=("NoTwoLeaders",))
# NaiveNoTwoLeaders holds on every state reachable from Init here (48,041
# states): two servers form a quorum only together, so a vote for the
# newer term demotes the older leader first.
DUO = dict(bounds=B2, spec="full", invariants=("NaiveNoTwoLeaders",))
SIM_KW = dict(walkers=128, depth=40, steps_per_dispatch=32, seed=1)


def port_config(d, **kw):
    return CheckConfig(bounds=Bounds(**d["bounds"]), spec=d["spec"],
                       invariants=d["invariants"], **kw)


def jax_config(d, **kw):
    return JConfig(bounds=JBounds(**d["bounds"]), spec=d["spec"],
                   invariants=d["invariants"], **kw)


def seeded_start():
    """One step from a NaiveNoTwoLeaders violation: server 1 leads term
    1 while server 2, a candidate in term 2, has server 1's granted vote
    in flight (the reference's engine-test seed, tests/test_simulate.py,
    cut to two servers)."""
    return interp.init_state(Bounds(**B2))._replace(
        role=(S.LEADER, S.CANDIDATE), term=(1, 2), votedFor=(1, 2),
        vGrant=(0b11, 0b10), msgs=((mb.rv_response(2, 1, 0, 1), 1),))


def jseeded_start():
    from raft_tla_tpu.models import interp as jinterp
    s = seeded_start()
    return jinterp.init_state(JBounds(**B2))._replace(
        role=s.role, term=s.term, votedFor=s.votedFor, vGrant=s.vGrant,
        msgs=s.msgs)


@pytest.fixture(scope="module")
def jsim():
    """One JAX Simulator on ``DUO``: its segment compiles once for the two
    tests that run it."""
    return JSimulator(jax_config(DUO), **SIM_KW)


def reachable(bounds, spec, n, seed):
    """``n`` states of random walks through the interpreter (a walk ends
    at a state outside the constraint, as a walker's behavior does)."""
    rng = random.Random(seed)
    table = S.action_table(bounds, spec)
    out, cur = [], interp.init_state(bounds)
    while len(out) < n:
        cur = rng.choice(list(interp.successors(cur, bounds, table)))[1]
        out.append(cur)
        if not interp.constraint_ok(cur, bounds):
            cur = interp.init_state(bounds)
    return out


@pytest.mark.parametrize("bkw,spec,invs", [
    (dict(n_servers=3, n_values=1, max_term=2, max_log=1, max_msgs=2),
     "full", ("NoTwoLeaders", "NaiveNoTwoLeaders", "LogMatching",
              "CommittedWithinLog")),
    (dict(n_servers=2, n_values=1, max_term=2, max_log=1, max_msgs=2,
          history=True, max_elections=4),
     "full", ("NoTwoLeaders", "ElectionSafetyHist", "AllLogsPrefixClosed")),
], ids=["parity", "faithful"])
def test_walker_step_matches_jax_expand(bkw, spec, invs):
    """The walker step on given rows and lanes — the taken lane's row,
    ``inv_ok``, ``con_ok`` and ``overflow``, and ``enabled`` — bit-equal to
    the reference's ``build_expand`` + ``pack`` + invariants + constraint
    (simulate.py:87-107), masked by ``enabled`` where the reference
    masks."""
    b = Bounds(**bkw)
    states = reachable(b, spec, 48, seed=1)
    vecs = torch.as_tensor(np.stack([interp.to_vec(s, b) for s in states]))
    out = kernels.build_step(b, spec, invs)(vecs)
    u = draw(walker_keys(3, len(states), "cpu"), 0)
    lane, enabled = pick_lanes(out["valid"], u)
    pick, inv, con, ovf = gather_lane(out, lane, enabled)

    jc = JConfig(bounds=JBounds(**bkw), spec=spec, invariants=invs)
    m = jresolve(spec)
    expand = m.build_sim_expand(jc)
    _w, pack, unpack = m.sim_codec(jc.bounds)
    inv_fns = m.jnp_invariants(jc)
    con_fn = m.jnp_constraint(jc.bounds)

    @jax.jit
    def jstep(v, ln):
        succs, valid, ovf_ = jax.vmap(expand)(jax.vmap(unpack)(v))
        rows = jnp.arange(v.shape[0])
        pick_s = jax.tree.map(lambda x: x[rows, ln], succs)
        en = jnp.any(valid, axis=-1)
        inv_ok = jnp.stack([jax.vmap(f)(pick_s) for f in inv_fns], -1)
        return (jax.vmap(pack)(pick_s), en,
                jnp.where(en[:, None], inv_ok, True),
                jnp.where(en, jax.vmap(con_fn)(pick_s), True),
                en & ovf_[rows, ln], valid)

    jp, jen, jinv, jcon, jovf, jvalid = (
        np.asarray(x) for x in jstep(jnp.asarray(vecs.numpy()),
                                     jnp.asarray(lane.numpy())))
    assert np.array_equal(out["valid"].numpy(), jvalid)
    assert np.array_equal(enabled.numpy(), jen) and jen.all()
    assert np.array_equal(pick.numpy(), jp)
    assert np.array_equal(inv.numpy(), jinv)
    assert np.array_equal(con.numpy(), jcon)
    assert np.array_equal(ovf.numpy(), jovf)
    # the lanes taken are the enabled lanes the draw names, and not all
    # the same lane
    assert out["valid"][torch.arange(len(states)), lane].all()
    assert len(set(lane.tolist())) > 3


def test_seeded_violation_found_by_both_packages(jsim):
    """The seeded NaiveNoTwoLeaders violation: both packages find it; the
    port's trace replays through ``interp.successors`` and ends with two
    leaders."""
    sim = Simulator(port_config(DUO), device="cpu", **SIM_KW)
    r = sim.run(100000, init_override=seeded_start())
    jr = jsim.run(100000, init_override=jseeded_start())
    assert r.violation.invariant == jr.violation.invariant == \
        "NaiveNoTwoLeaders"
    b = Bounds(**B2)
    table = S.action_table(b, "full")
    trace = r.violation.trace
    assert trace[0] == (None, seeded_start())
    for (_l, cur), (label, nxt) in zip(trace, trace[1:]):
        assert (label, nxt) in [(table[k].label(), t) for k, t in
                                interp.successors(cur, b, table)]
    assert sum(x == S.LEADER for x in trace[-1][1].role) >= 2
    assert r.violation.state == trace[-1][1]
    assert sim.dispatches == 1 and sim.fetches == 1


def test_same_seed_same_walks_other_seed_other_walks():
    def walks(seed):
        sim = Simulator(port_config(CLEAN), walkers=64, depth=16,
                        steps_per_dispatch=8, seed=seed, device="cpu")
        w = sim.start()
        counts = [sim.dispatch(w) for _ in range(3)]
        return w.hist.clone(), w.hlen.clone(), w.vecs.clone(), counts

    a, b, c = walks(7), walks(7), walks(8)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert a[3] == b[3]
    assert not torch.equal(a[0], c[0])
    # the draw is splitmix64 of (key_g + (t + 1) * golden), key_g folded
    # from the seed and the walker id
    M, G = (1 << 64) - 1, 0x9E3779B97F4A7C15
    keys = walker_keys(7, 4, "cpu")
    for g in range(4):
        key = mix64((g * G + mix64(7)) & M)
        assert int(keys[g]) & M == key
        assert int(draw(keys, 10)[g]) == mix64((key + 11 * G) & M) & \
            0xFFFFFFFF


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = main(list(argv))
    return code, out.getvalue(), err.getvalue()


def _verdict_lines(text):
    """From the ``behaviors generated`` line on, that line's counts and
    wall cut out (walks differ by design)."""
    lines = text.splitlines()
    k = next(i for i, ln in enumerate(lines) if "behaviors generated" in ln)
    return ["behaviors generated"] + lines[k + 1:]


def _cfg(tmp_path, servers="s1", extra="", name="m"):
    from test_torch_cli import write_cfg
    return write_cfg(tmp_path / f"{name}.cfg", servers=servers, extra=extra)


@pytest.mark.parametrize("deadlock", [True, False],
                         ids=["deadlock", "no-deadlock"])
def test_cli_verdict_lines_match_jax_cli(tmp_path, deadlock):
    """The 1-server election: with ``--deadlock`` every walk runs into the
    sole leader's dead end (exit 11); without it the walks reset (exit 0).
    Verdict lines and exit codes equal to the JAX CLI's."""
    argv = [_cfg(tmp_path), "--spec", "election", "--max-term", "2",
            "--max-log", "0", "--max-msgs", "1", "--simulate", "300",
            "--depth", "30", "--walkers", "32", "--seed", "0",
            "--no-trace"] + (["--deadlock"] if deadlock else [])
    code, out, _ = _run(cli.main, argv + ["--device", "cpu"])
    jcode, jout, _ = _run(jcli.main, argv + ["--engine", "ref"])
    assert code == jcode == (cli.EXIT_DEADLOCK if deadlock else cli.EXIT_OK)
    assert _verdict_lines(out) == _verdict_lines(jout)
    if deadlock:
        # the full trace ends at a state with no successor
        c, eng, res = cli.run([a for a in argv if a != "--no-trace"]
                              + ["--device", "cpu"])
        b = res.violation.state
        assert c == cli.EXIT_DEADLOCK and res.violation.invariant == DEADLOCK
        assert not list(interp.successors(b, Bounds(
            n_servers=1, n_values=1, max_term=2, max_log=0, max_msgs=1),
            spec="election"))


def test_refusals_match_jax_cli(tmp_path):
    """SYMMETRY (exit 1), ``--view`` (exit 2) and PROPERTY (exit 1) are
    refused in simulation mode with the JAX CLI's texts."""
    base = ["--spec", "election", "--max-term", "2", "--max-log", "0",
            "--max-msgs", "2", "--simulate", "10"]
    cases = [
        ([_cfg(tmp_path, "s1, s2", "SYMMETRY Server\n", "sym")] + base, 1,
         "simulation mode ignores SYMMETRY"),
        ([_cfg(tmp_path, "s1, s2", name="view"), "--view", "deadvotes"]
         + base, 2,
         "--view does not compose with --simulate"),
        ([_cfg(tmp_path, "s1, s2", "PROPERTY EventuallyLeader\n", "prop")]
         + base, 1, "cannot be checked in --simulate mode"),
    ]
    for argv, want, text in cases:
        got = [_refusal(cli.main, argv + ["--device", "cpu"]),
               _refusal(jcli.main, argv + ["--engine", "ref"])]
        assert got[0] == got[1], got
        assert got[0][0] == want and text in got[0][1], got


def _refusal(main, argv):
    """(exit code, last line of standard error) of a refused command line;
    argparse's ``prog: error:`` prefix cut to ``error:``."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            code = main(list(argv))
        except SystemExit as e:
            code = e.code
    last = err.getvalue().strip().splitlines()[-1]
    return code, re.sub(r"^.*?: error: ", "error: ", last)


def test_event_log_is_valid(tmp_path):
    """The simulation's run-event log: every line valid under the port's
    and the reference's ``validate_event``, one segment a dispatch, and
    ``run_end.sim`` holding the reference's keys."""
    path = str(tmp_path / "sim.events")
    sim = Simulator(port_config(CLEAN), device="cpu", **SIM_KW)
    r = sim.run(500, events=path)
    events = [json.loads(ln) for ln in open(path)]
    assert not [e for d in events for e in validate_event(d) + jvalidate(d)]
    assert events[0]["event"] == "run_start"
    assert events[0]["engine"] == "simulate"
    segs = [d for d in events if d["event"] == "segment"]
    assert len(segs) == sim.dispatches == sim.fetches
    end = events[-1]
    assert end["event"] == "run_end" and end["outcome"] == "ok"
    assert end["complete"] and end["n_states"] == r.n_states
    assert end["sim"] == {"sampled_transitions": r.n_states,
                          "max_depth": r.max_depth_seen, "walkers": 128,
                          "per_invariant": {"NoTwoLeaders": r.n_states},
                          "behaviors": r.n_behaviors}


def test_fused_fetch_equals_legacy():
    """One copy a dispatch changes the host reads only, never results."""
    res = {}
    for fetch in ("fused", "legacy"):
        sim = Simulator(port_config(DUO), walkers=64, depth=16,
                        steps_per_dispatch=8, seed=7, fetch=fetch,
                        device="cpu")
        r = sim.run(2000, init_override=seeded_start())
        res[fetch] = (r.violation.trace, r.n_behaviors, r.n_states,
                      r.max_depth_seen, sim.fetches / sim.dispatches)
    assert res["fused"][:4] == res["legacy"][:4]
    assert res["fused"][4] == 1 and res["legacy"][4] == 7


def test_mean_walk_length_matches_jax(jsim):
    """On the clean 2-server universe, the mean steps per behavior over
    2,000 behaviors (same walkers, depth and dispatch size) is within 5%
    of the JAX Simulator's: both sample uniformly over the enabled lanes.
    Seed to seed this mean moves by about 1% in either package (5.62-5.73
    for the port's seeds 1-6, 5.69-5.80 for the JAX package's seeds 1-3),
    so 5% leaves room for chance and still catches a biased draw."""
    r = Simulator(port_config(DUO), device="cpu", **SIM_KW).run(2000)
    jr = jsim.run(2000)
    mean, jmean = (x.n_states / x.n_behaviors for x in (r, jr))
    assert r.violation is None and jr.violation is None
    assert abs(mean - jmean) <= 0.05 * jmean, (mean, jmean)
