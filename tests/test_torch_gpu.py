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


def test_fingerprint_kernel_matches_plain_version(cuda):
    rng = np.random.default_rng(5)
    for W in (57, 60, 110, 1):
        rows = torch.as_tensor(rng.integers(-2**31, 2**31, size=(3001, W),
                                            dtype=np.int64).astype(np.int32),
                               device=cuda)
        hi, lo = pallas_fp.fingerprint_rows(rows)
        rh, rl = fpr.fingerprint(rows, fpr.torch_constants(W, cuda))
        assert torch.equal(hi, rh) and torch.equal(lo, rl)


def test_engine_on_the_card_reproduces_the_verified_toy(cuda):
    cfg = CheckConfig(bounds=Bounds(n_servers=2, n_values=1, max_term=2,
                                    max_log=0, max_msgs=2),
                      spec="election", invariants=("NoTwoLeaders",),
                      chunk=1024)
    res = DeviceEngine(cfg, Capacities(n_states=1 << 14)).check()
    assert (res.n_states, res.diameter, res.violation) == (3014, 17, None)
