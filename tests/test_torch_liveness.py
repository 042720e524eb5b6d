"""The port's liveness checker (``models/liveness.py``, ``--property``,
``--wf``, cfg PROPERTY) against the JAX reference's.

The same configurations go through the JAX functions and the port's, on
the CPU: ``explore_graph`` and ``check`` (the interpreter path), then the two
engine exports, ``engine_graph`` (the device engine's store, K2's keys and
K1's re-expansion; here their plain versions) and ``ddd_graph`` (the DDD
engine's host store).  Their CSR arrays, enabled matrices, verdicts,
``n_sccs_checked`` and lassos must be equal, and every lasso must replay
through the interpreter.  The symmetric quotient's verdicts equal the raw
graph's; the native Tarjan equals its Python twin; and the CLI's verdict
lines and lassos are the JAX CLI's, with its exit codes 0 and 13.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from raft_tla_tpu import check as jcli
from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.ddd_engine import (DDDCapacities as JDDDCapacities,
                                     DDDEngine as JDDDEngine)
from raft_tla_tpu.models import liveness as jlive

from raft_tla_tpu_torch import check as cli
from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.ddd_engine import DDDCapacities, DDDEngine
from raft_tla_tpu_torch.models import interp, liveness
from raft_tla_tpu_torch.models import spec as S
from raft_tla_tpu_torch.utils import native

from test_torch_cli import ELECTION_2S, _run, write_cfg

torch.set_num_threads(1)

B2 = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)
FULL2 = dict(n_servers=2, n_values=1, max_term=2, max_log=1, max_msgs=2)
# name -> (bounds, spec, symmetry): tests/test_liveness.py's ELECTION and
# FULL, and FULL at MaxMsgs 1 (4,887 states) for the DDD export
CONFIGS = {"ELECTION": (B2, "election", ()), "FULL": (FULL2, "full", ()),
           "FULL-m1": (dict(FULL2, max_msgs=1), "full", ())}
PROPS = [("EventuallyLeader", ("Next",)), ("EventuallyLeader", ()),
         ("EventuallyCommit", ("Next",)), ("InfinitelyOftenLeader", ("Next",)),
         ("SomeCandidate ~> SomeLeader", ("Next",)),
         ("EventuallyLeader", tuple(S.SPECS["full"])),
         ("<>SomeLeader", ("Timeout", "Receive"))]


def _configs(name, symmetry=None, chunk=64):
    kw, spec, sym = CONFIGS[name]
    args = dict(spec=spec, invariants=(), chunk=chunk,
                symmetry=sym if symmetry is None else symmetry)
    return (CheckConfig(bounds=Bounds(**kw), **args),
            JConfig(bounds=JBounds(**kw), **args))


def _ddd_caps(mod):
    return mod(block=1 << 12, table=1 << 14, flush=1 << 12, levels=64)


def _state(s):
    return dataclasses.astuple(s)


def _lasso(v):
    if v is None:
        return None
    return [(label, _state(s)) for label, s in v.prefix + v.cycle], \
        len(v.prefix)


def replay_lasso(v, config):
    """prefix + cycle is a real behavior of the port's interpreter, and a
    cycle that is not a stutter closes."""
    bounds = config.bounds
    table = S.action_table(bounds, config.spec)
    seq = v.prefix + v.cycle
    assert seq[0][1] == interp.init_state(bounds)
    for (_, prev), (label, cur) in zip(seq, seq[1:]):
        if label == "<stutter>":
            assert cur == prev
            continue
        assert cur in [t for _i, t in interp.successors(prev, bounds, table)]
    if v.cycle[0][1] != v.cycle[-1][1]:
        last = v.cycle[-1][1]
        assert v.cycle[0][1] in [t for _i, t in interp.successors(
            last, bounds, table)]


def _verdicts(mod, config, graph, replay=False):
    out = []
    for prop, wf in PROPS:
        r = mod.check(config, prop, wf=wf, graph=graph)
        if replay and r.violation is not None:
            replay_lasso(r.violation, config)
        out.append((prop, wf, r.holds, r.n_states, r.n_edges,
                    r.n_sccs_checked, _lasso(r.violation)))
    return out


def _csr(graph):
    edges, enabled = graph[1], graph[2]
    return (edges._indptr.tolist(), edges._aidx.tolist(),
            edges._vidx.tolist(), enabled._mat.tolist(), enabled._fams,
            np.asarray(graph[3]).tolist())


@pytest.fixture(scope="module")
def jax_side():
    """The JAX graphs and verdicts, built once for the module."""
    out = {}
    for name in ("ELECTION", "FULL"):
        _, jcfg = _configs(name)
        g = jlive.explore_graph(jcfg)
        out["explore", name] = (g, _verdicts(jlive, jcfg, g))
    _, jcfg = _configs("ELECTION")
    g = jlive.engine_graph(jcfg)
    out["engine"] = (_csr(g), _verdicts(jlive, jcfg, g))
    _, jcfg = _configs("FULL-m1")
    g = jlive.ddd_graph(jcfg, _ddd_caps(JDDDCapacities))
    out["ddd"] = (_csr(g), _verdicts(jlive, jcfg, g))
    g[0].close()
    _, jcfg = _configs("ELECTION", symmetry=("Server",))
    g = jlive.ddd_graph(jcfg, _ddd_caps(JDDDCapacities))
    out["ddd-sym"] = (_csr(g), _verdicts(jlive, jcfg, g))
    g[0].close()
    return out


@pytest.mark.parametrize("name", ["ELECTION", "FULL"])
def test_explore_graph_and_check_match_jax(jax_side, name):
    cfg, _ = _configs(name)
    g = liveness.explore_graph(cfg)
    jg, want = jax_side["explore", name]
    assert [_state(s) for s in g[0]] == [_state(s) for s in jg[0]]
    assert g[1] == jg[1] and g[3] == jg[3]
    assert [sorted(e) for e in g[2]] == [sorted(e) for e in jg[2]]
    assert _verdicts(liveness, cfg, g, replay=True) == want


def test_engine_graph_matches_jax(jax_side):
    cfg, _ = _configs("ELECTION")
    g = liveness.engine_graph(cfg, device="cpu")
    csr, want = jax_side["engine"]
    assert _csr(g) == csr
    assert _verdicts(liveness, cfg, g, replay=True) == want
    assert any(not v[2] for v in want)
    # the interpreter's graph gives the same verdicts
    assert [v[2:] for v in _verdicts(liveness, cfg,
                                     liveness.explore_graph(cfg))] == \
        [v[2:] for v in want]


def test_ddd_graph_matches_jax(jax_side):
    cfg, _ = _configs("FULL-m1")
    g = liveness.ddd_graph(cfg, _ddd_caps(DDDCapacities), device="cpu")
    try:
        csr, want = jax_side["ddd"]
        assert _csr(g) == csr
        assert _verdicts(liveness, cfg, g, replay=True) == want
        assert any(not v[2] for v in want) and any(v[2] for v in want)
        for nm, (_f, pred) in liveness.PROPERTIES.items():
            assert g[0].mask(nm).tolist() == \
                [pred(g[0][u], cfg.bounds) for u in range(len(g[0]))]
    finally:
        g[0].close()


def test_symmetric_quotient_verdicts_match_raw(jax_side):
    raw, _ = _configs("ELECTION")
    sym, _ = _configs("ELECTION", symmetry=("Server",))
    g = liveness.ddd_graph(sym, _ddd_caps(DDDCapacities), device="cpu")
    try:
        csr, want = jax_side["ddd-sym"]
        assert _csr(g) == csr
        got = _verdicts(liveness, sym, g)
        assert got == want
        assert len(g[0]) < len(jax_side["explore", "ELECTION"][0][0])
        raw_v = _verdicts(liveness, raw, liveness.explore_graph(raw))
        assert [v[2] for v in got] == [v[2] for v in raw_v]
    finally:
        g[0].close()


def test_scc_csr_matches_the_python_twin():
    rng = np.random.default_rng(7)
    for n, m in ((1, 0), (2, 3), (50, 40), (300, 600), (2000, 5000)):
        src = np.sort(rng.integers(0, n, m))
        dst = rng.integers(0, n, m)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
        comp, k = native.scc_csr(indptr, dst)
        pcomp, pk = native.scc_csr_py(indptr, dst)
        assert k == pk and comp.tolist() == pcomp.tolist()
        assert comp.dtype == np.int64 and comp.shape == (n,)


def _property_lines(text):
    """From the first ``Property`` line on, the wall times cut out."""
    lines = text.splitlines()
    k = next(i for i, ln in enumerate(lines) if ln.startswith("Property "))
    return [re.sub(r", [0-9.]+s\.$", ".", ln) for ln in lines[k:]]


@pytest.mark.parametrize("stanza,flags,want", [
    ("PROPERTY EventuallyLeader\n", [], 0),
    ("", ["--property", "EventuallyCommit", "--property",
          "SomeCandidate ~> SomeLeader"], 13),
], ids=["holds", "refuted"])
def test_cli_property_lines_match_jax(tmp_path, stanza, flags, want):
    args = ["--spec", "full", "--max-term", "2", "--max-log", "1",
            "--max-msgs", "1"]
    cfg = write_cfg(tmp_path / "m.cfg", extra=stanza)
    if want == 0:
        args = ELECTION_2S
    code, out, err = _run(cli.main, [cfg, "--device", "cpu", "--engine",
                                     "ref", *args, *flags])
    jcode, jout, jerr = _run(jcli.main, [cfg, "--engine", "ref", *args,
                                         *flags])
    assert code == jcode == want, (err, jerr)
    assert _property_lines(out) == _property_lines(jout)
    if want:
        return
    # every engine of the port routes to a graph with the same verdicts
    for engine in ("host", "device", "ddd"):
        ecode, eout, eerr = _run(cli.main, [cfg, "--device", "cpu",
                                            "--engine", engine, *args,
                                            *flags])
        assert ecode == want, eerr
        assert _property_lines(eout)[:2] == _property_lines(out)[:2]


def test_frontier_retention_refuses_retain_store():
    cfg, jcfg = _configs("ELECTION")
    eng = DDDEngine(cfg, DDDCapacities(block=1 << 12, table=1 << 14,
                                       retention="frontier"), device="cpu")
    jeng = JDDDEngine(jcfg, JDDDCapacities(block=1 << 12, table=1 << 14,
                                           retention="frontier"))
    with pytest.raises(ValueError) as got:
        eng.check(retain_store=True)
    with pytest.raises(ValueError) as want:
        jeng.check(retain_store=True)
    assert str(got.value) == str(want.value)
    assert "needs retention='full'" in str(got.value)
