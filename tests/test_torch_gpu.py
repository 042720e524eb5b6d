"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where torch sees no CUDA device.  They import
neither JAX nor the reference, so they run on a machine that has only the
port's requirements::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

(``--noconftest``: the suite's conftest configures JAX.)  ``chip_smoke.py``
runs the same comparisons at the main path's shapes.  Tolerance: bit-exact.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
from raft_tla_tpu_torch.ops import fingerprint as fpr
from raft_tla_tpu_torch.ops import kernels, pallas_fp, pallas_step

pytestmark = pytest.mark.gpu

INVS = ("NoTwoLeaders", "NaiveNoTwoLeaders", "LogMatching",
        "CommittedWithinLog", "LeaderCompleteness")
HIST = ("ElectionSafetyHist", "LeaderCompletenessHist", "AllLogsPrefixClosed")
FAITHFUL = dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2,
                history=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("kw,spec", [
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2), "full"),
    (dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2),
     "election"),
], ids=["full-3s2v", "election-2s"])
def test_step_kernel_matches_plain_step(cuda, kw, spec):
    """``valid`` on every lane, everything else where ``valid`` is true."""
    b = Bounds(**kw)
    eng = DeviceEngine(CheckConfig(bounds=b, spec=spec, invariants=INVS,
                                   chunk=512), Capacities(n_states=1 << 18))
    res = eng.check(max_chunks=40)
    rows = eng.carry["store"][:min(res.n_states, 4096)]
    before = pallas_step.launches
    got = pallas_step.build_step(b, spec, INVS, cuda)(rows)
    want = kernels.build_step(b, spec, INVS)(rows)
    assert pallas_step.launches == before + 1
    val = want["valid"]
    assert torch.equal(got["valid"], val)
    for k in ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok"):
        diff = got[k] != want[k]
        if diff.dim() > 2:
            diff = diff.flatten(2).any(-1)
        assert not (diff & val).any(), k


@pytest.mark.parametrize("kw,spec,axes,view", [
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2),
     "full", ("Server", "Value"), "deadvotes"),
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2),
     "full", (), "deadvotes"),
    (dict(n_servers=4, n_values=1, max_term=2, max_log=0, max_msgs=1),
     "election", ("Server",), None),
    (FAITHFUL, "full", (), None),
    (FAITHFUL, "full", ("Server", "Value"), None),
    (FAITHFUL, "full", ("Server",), "deadvotes"),
], ids=["full-3s2v-ServerxValue-deadvotes", "full-3s2v-deadvotes",
        "election-4s-Server", "faithful-3s2v", "faithful-3s2v-ServerxValue",
        "faithful-3s2v-Server-deadvotes"])
def test_step_kernel_dedup_key_matches_plain_step(cuda, kw, spec, axes,
                                                 view):
    """K1's orbit and view stage, and in faithful mode its history stage:
    the same contract, keys included."""
    from raft_tla_tpu_torch.ops import symmetry as sym
    b = Bounds(**kw)
    invs = INVS + HIST if b.history else INVS
    eng = DeviceEngine(CheckConfig(bounds=b, spec=spec, invariants=invs,
                                   chunk=512), Capacities(n_states=1 << 18))
    res = eng.check(max_chunks=40)
    rows = eng.carry["store"][:min(res.n_states, 2048)]
    before = sym.plain_calls
    got = pallas_step.build_step(b, spec, invs, cuda, symmetry=axes,
                                 view=view)(rows)
    assert sym.plain_calls == before           # the card path: no plain key
    want = kernels.build_step(b, spec, invs, axes, view)(rows)
    val = want["valid"]
    assert torch.equal(got["valid"], val)
    for k in ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok"):
        diff = got[k] != want[k]
        if diff.dim() > 2:
            diff = diff.flatten(2).any(-1)
        assert not (diff & val).any(), k


def test_step_kernel_on_a_ragged_block(cuda):
    """8,191 rows: 255 full blocks of 32 rows and one of 31."""
    b = Bounds(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2)
    eng = DeviceEngine(CheckConfig(bounds=b, spec="full", invariants=INVS,
                                   chunk=1024), Capacities(n_states=1 << 18))
    res = eng.check(max_chunks=40)
    rows = eng.carry["store"][:8191]
    assert res.n_states >= 8191
    got = pallas_step.build_step(b, "full", INVS, cuda,
                                 symmetry=("Server",))(rows)
    want = kernels.build_step(b, "full", INVS, ("Server",))(rows)
    val = want["valid"]
    assert torch.equal(got["valid"], val)
    for k in ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok"):
        diff = got[k] != want[k]
        if diff.dim() > 2:
            diff = diff.flatten(2).any(-1)
        assert not (diff & val).any(), k


@pytest.mark.parametrize("n,W", [(3001, 57), (3001, 60), (3001, 110),
                                 (3001, 113), (3001, 1), (1_048_573, 60)])
def test_fingerprint_kernel_matches_plain_version(cuda, n, W):
    rng = np.random.default_rng(5)
    rows = torch.as_tensor(rng.integers(-2**31, 2**31, size=(n, W),
                                        dtype=np.int64).astype(np.int32),
                           device=cuda)
    shifted = rows.reshape(-1)[1:1 + (n - 1) * W].reshape(n - 1, W)
    for view in (rows, shifted):      # shifted: 4-byte, not 16-byte aligned
        hi, lo = pallas_fp.fingerprint_rows(view)
        rh, rl = fpr.fingerprint(view, fpr.torch_constants(W, cuda))
        assert torch.equal(hi, rh) and torch.equal(lo, rl)


def test_engine_on_the_card_reproduces_the_verified_toy(cuda):
    cfg = CheckConfig(bounds=Bounds(n_servers=2, n_values=1, max_term=2,
                                    max_log=0, max_msgs=2),
                      spec="election", invariants=("NoTwoLeaders",),
                      chunk=1024)
    res = DeviceEngine(cfg, Capacities(n_states=1 << 14)).check()
    assert (res.n_states, res.diameter, res.violation) == (3014, 17, None)


# Expression invariants covering every operator and reducer, an index that
# wraps (votedFor - 1 for Nil), one that clamps, int32 wrap-around.
EXPRS = ("count(role = 2) <= 1", "commitIndex <= logLen",
         "term[votedFor - 1] >= 1 \\/ votedFor = 0",
         "logTerm[logLen] <= max(term) /\\ min(logVal) >= 0",
         "term * 1073741824 * 4 = 0 => ~any(msgCount > 1)",
         "-term[0] - count(TRUE) < nextIndex[matchIndex + 7]",
         "logVal[term] /= 3")


@pytest.mark.parametrize("kw,axes", [
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2), ()),
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2),
     ("Server",)),
    (FAITHFUL, ()),
], ids=["full-3s2v", "full-3s2v-Server", "faithful-3s2v"])
def test_step_kernel_expression_stage_matches_plain_step(cuda, kw, axes):
    """K1's expression stage: 12 or 14 invariants, registry and expression
    interleaved, against the plain step and the program's plain
    evaluator."""
    from raft_tla_tpu_torch.models import invariants as inv_mod
    from raft_tla_tpu_torch.ops import predprog
    from raft_tla_tpu_torch.ops import state as st
    b = Bounds(**kw)
    base = INVS + HIST if b.history else INVS
    invs = base + EXPRS
    # the engine without the expressions: its Init check is the numpy
    # path, where an index past a field (matchIndex + 7) raises
    eng = DeviceEngine(CheckConfig(bounds=b, spec="full", invariants=base,
                                   chunk=512), Capacities(n_states=1 << 18))
    res = eng.check(max_chunks=40)
    rows = eng.carry["store"][:min(res.n_states, 2048)]
    got = pallas_step.build_step(b, "full", invs, cuda, symmetry=axes)(rows)
    want = kernels.build_step(b, "full", invs, axes)(rows)
    val = want["valid"]
    assert torch.equal(got["valid"], val)
    for k in ("svecs", "overflow", "fp_hi", "fp_lo", "inv_ok", "con_ok"):
        diff = got[k] != want[k]
        if diff.dim() > 2:
            diff = diff.flatten(2).any(-1)
        assert not (diff & val).any(), k
    succ = want["svecs"][val]
    lay = st.Layout.of(b)
    for c, text in enumerate(invs):
        if text in EXPRS:
            prog = predprog.compile_program(inv_mod._expression(text), lay)
            assert torch.equal(got["inv_ok"][val][:, c],
                               predprog.evaluate(prog, succ)), text


def test_host_engine_on_the_card_launches_k1(cuda):
    """``--engine host`` on the card: the verified toy, every chunk through
    K1 and none through the plain step."""
    from raft_tla_tpu_torch.engine import Engine
    cfg = CheckConfig(bounds=Bounds(n_servers=2, n_values=1, max_term=2,
                                    max_log=0, max_msgs=2),
                      spec="election", invariants=("NoTwoLeaders",),
                      chunk=256)
    k1, plain = pallas_step.launches, kernels.calls
    res = Engine(cfg).check()
    assert (res.n_states, res.diameter, res.violation) == (3014, 17, None)
    assert pallas_step.launches > k1 and kernels.calls == plain


@pytest.mark.parametrize("axes", [(), ("Server",)], ids=["engine", "ddd"])
def test_graph_exports_on_the_card_equal_the_cpu_ones(cuda, axes):
    """The liveness graph exports through K1 and K2 (``engine_graph``
    without symmetry, ``ddd_graph`` under SYMMETRY) give the CPU export's
    CSR arrays, enabled matrix and verdicts."""
    from raft_tla_tpu_torch.ddd_engine import DDDCapacities
    from raft_tla_tpu_torch.models import liveness
    cfg = CheckConfig(bounds=Bounds(n_servers=2, n_values=1, max_term=2,
                                    max_log=0, max_msgs=2),
                      spec="election", invariants=(), symmetry=axes,
                      chunk=256)
    caps = DDDCapacities(block=1 << 12, table=1 << 14, flush=1 << 12,
                         levels=64)
    graphs = []
    for dev in ("cpu", cuda):
        before = pallas_step.launches
        g = liveness.ddd_graph(cfg, caps, device=dev) if axes \
            else liveness.engine_graph(cfg, device=dev)
        graphs.append((g, pallas_step.launches - before))
    (cg, c_k1), (gg, g_k1) = graphs
    assert c_k1 == 0 and g_k1 > 0
    for a, b in zip((cg[1]._indptr, cg[1]._aidx, cg[1]._vidx, cg[2]._mat,
                     cg[3]),
                    (gg[1]._indptr, gg[1]._aidx, gg[1]._vidx, gg[2]._mat,
                     gg[3])):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for wf in (("Next",), ()):
        rc = liveness.check(cfg, "EventuallyLeader", wf=wf, graph=cg)
        rg = liveness.check(cfg, "EventuallyLeader", wf=wf, graph=gg)
        assert (rc.holds, rc.n_sccs_checked) == (rg.holds, rg.n_sccs_checked)
    if axes:
        cg[0].close()
        gg[0].close()


@pytest.mark.parametrize("fleet", [False, True], ids=["simulator", "fleet"])
def test_walks_through_k1_equal_the_plain_walks(cuda, fleet):
    """Simulation on the card: the walks (lane histories, walk lengths,
    rows, counts) through K1 equal those through the plain step on the
    card; the solo simulator's also equal the CPU's."""
    from raft_tla_tpu_torch.fleet import FleetSimulator
    from raft_tla_tpu_torch.simulate import Simulator
    b = Bounds(n_servers=3, n_values=2, max_term=3, max_log=2, max_msgs=4)
    cfg = CheckConfig(bounds=b, spec="full", invariants=INVS[:4])
    kw = dict(walkers=2048, depth=60, steps_per_dispatch=16, seed=7)
    plain = kernels.build_step(b, "full", INVS[:4])
    runs = []
    for dev, step in ((cuda, None), (cuda, plain), ("cpu", None)):
        if fleet and dev == "cpu":
            continue        # the weighted draw is float64: same device only
        cls = FleetSimulator if fleet else Simulator
        sim = cls(cfg, device=dev, **kw)
        if step is not None:
            sim.step_fn = step
        k1 = pallas_step.launches
        if fleet:
            r = sim.run(3000, snapshot_walks=True)
            runs.append((r.walks[0], r.walks[1], r.n_behaviors, r.n_states,
                         r.max_depth_seen, sorted(r.coverage.items())))
        else:
            w = sim.start()
            counts = [sim.dispatch(w) for _ in range(2)]
            runs.append((w.hist.cpu().numpy(), w.hlen.cpu().numpy(),
                         w.vecs.cpu().numpy(), counts))
        launched = pallas_step.launches - k1
        assert launched == (sim.steps * sim.dispatches if step is None
                            and dev == cuda else 0)
    for other in runs[1:]:
        for x, y in zip(runs[0], other):
            assert np.array_equal(np.asarray(x), np.asarray(y)) \
                if isinstance(x, np.ndarray) else x == y


def test_walker_count_past_the_card_is_refused(cuda):
    """A walker count whose step outputs cannot fit the card is refused
    before any launch, with the count that would fit."""
    from raft_tla_tpu_torch.simulate import Simulator
    cfg = CheckConfig(bounds=Bounds(n_servers=5, n_values=2, max_term=2,
                                    max_log=0, max_msgs=2),
                      spec="election", invariants=("NoTwoLeaders",))
    before = pallas_step.launches
    with pytest.raises(ValueError, match="use at most"):
        Simulator(cfg, walkers=1 << 24, device=cuda)
    assert pallas_step.launches == before


def test_schema_and_ir_steps_on_the_card_equal_the_cpu_ones(cuda):
    """The twophase schema step (4 RMs) and the ``ir-election`` step on the
    card against their CPU runs on the same rows: every output, the keys
    from K2 (one launch a call) and never from the plain fingerprint; then
    twophase through the host engine on the card, the oracle's counts."""
    from raft_tla_tpu_torch.engine import Engine
    from raft_tla_tpu_torch.frontend import registry, twophase as tp
    cases = [("twophase", Bounds(n_servers=4, n_values=1),
              ("TCConsistent", "count(rmState = 2) <= 1")),
             ("ir-election", Bounds(n_servers=3, n_values=1, max_term=2,
                                    max_log=0, max_msgs=2), INVS[:3])]
    for spec, b, invs in cases:
        cfg = CheckConfig(bounds=b, spec=spec, invariants=invs, chunk=256)
        model = registry.resolve_model(spec)
        cpu_step = model.build_step(cfg, "cpu")
        rows = torch.as_tensor(model.to_vec(model.init_py(b), b))[None]
        for _ in range(5):
            out = cpu_step(rows)
            nxt = torch.unique(out["svecs"][out["valid"]], dim=0)
            rows = torch.cat([rows, nxt])[-2048:]
        k2, plain = pallas_fp.launches, fpr.calls
        got = model.build_step(cfg, cuda)(rows.to(cuda))
        assert pallas_fp.launches == k2 + 1 and fpr.calls == plain
        want = cpu_step(rows)
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), v), (spec, k)
    k1, k2 = pallas_step.launches, pallas_fp.launches
    res = Engine(CheckConfig(bounds=Bounds(n_servers=4, n_values=1),
                             spec="twophase", invariants=("TCConsistent",),
                             chunk=256)).check()
    ref = tp.reference_check(4)
    assert (res.n_states, res.diameter, res.n_transitions, res.levels) == \
        (ref.n_states, ref.diameter, ref.n_transitions, ref.levels)
    assert pallas_step.launches == k1 and pallas_fp.launches > k2
