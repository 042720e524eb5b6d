"""The orbit-key entry of K1's library and the paged and streamed engines,
on the card.

Marked ``gpu``: they skip where torch sees no CUDA device.  They import
neither JAX nor the reference::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_paged.py -q

The orbit-key entry (ops/orbit_key.py, ``rt_orbit_key_launch`` in
csrc/step.cu) is held bit-exact to its plain version (the view, then
ops/symmetry.build_orbit_fp) and to K1's own keys at |G| = 6, 12 and 120
and under a VIEW alone, unmasked and masked by the valid lanes; a
paged and a streamed run on a small universe equal the port's device
engine on the card.  ``chip_smoke.py`` phases 16c and 19 run the same at
the main path's sizes.
"""

import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.device_engine import Capacities, DeviceEngine
from raft_tla_tpu_torch.ops import orbit_key, pallas_step
from raft_tla_tpu_torch.paged_engine import PagedCapacities, PagedEngine
from raft_tla_tpu_torch.streamed_engine import (StreamedCapacities,
                                                StreamedEngine)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("kw,spec,axes,view", [
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2),
     "full", ("Server",), None),
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2),
     "full", ("Server", "Value"), "deadvotes"),
    (dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2),
     "full", (), "deadvotes"),
    (dict(n_servers=5, n_values=2, max_term=2, max_log=0, max_msgs=2),
     "election", ("Server",), None),
], ids=["G6", "G12-view", "G1-view", "G120"])
def test_orbit_key_entry_matches_plain_and_k1(cuda, kw, spec, axes, view):
    """On the valid successors alone, and on every lane's row masked by
    the valid lanes (as the IR step launches it: K1 leaves an invalid
    lane's row unwritten, so those rows hold whatever the buffer held)."""
    b = Bounds(**kw)
    eng = DeviceEngine(CheckConfig(bounds=b, spec=spec,
                                   invariants=("NoTwoLeaders",), chunk=512),
                       Capacities(n_states=1 << 18))
    res = eng.check(max_chunks=20)
    rows = eng.carry["store"][:min(res.n_states, 2048)]
    out = pallas_step.build_step(b, spec, ("NoTwoLeaders",), cuda,
                                 symmetry=axes, view=view)(rows)
    val = out["valid"]
    succ = out["svecs"][val].contiguous()
    before = orbit_key.launches
    hi, lo = orbit_key.build_keyer(b, axes, view)(succ)
    assert orbit_key.launches == before + 1
    ph, pl = orbit_key.plain_keys(succ, b, axes, view)
    assert torch.equal(hi, ph) and torch.equal(lo, pl)
    assert torch.equal(hi, out["fp_hi"][val])
    assert torch.equal(lo, out["fp_lo"][val])
    flat, fval = out["svecs"].reshape(-1, succ.shape[1]), val.reshape(-1)
    mh, ml = orbit_key.build_keyer(b, axes, view)(flat, fval)
    assert orbit_key.launches == before + 2
    ph, pl = orbit_key.plain_keys(flat, b, axes, view, fval)
    assert torch.equal(mh, ph) and torch.equal(ml, pl)
    assert torch.equal(mh[fval], hi) and torch.equal(ml[fval], lo)
    assert not mh[~fval].any() and not ml[~fval].any()


@pytest.mark.parametrize("engine", ["paged", "streamed"])
def test_ring_engines_equal_the_device_engine(cuda, engine):
    cfg = CheckConfig(bounds=Bounds(n_servers=3, n_values=1, max_term=2,
                                    max_log=0, max_msgs=1),
                      spec="election", invariants=("NoTwoLeaders",),
                      chunk=256)
    want = DeviceEngine(cfg, Capacities(n_states=1 << 18,
                                        levels=64)).check()
    before = pallas_step.launches
    if engine == "paged":
        eng = PagedEngine(cfg, PagedCapacities(ring=1 << 15, table=1 << 19,
                                               levels=64))
    else:
        eng = StreamedEngine(cfg, StreamedCapacities(
            block=1 << 13, ring=1 << 14, table=1 << 19, levels=64))
    got = eng.check()
    assert pallas_step.launches - before == eng.stats["chunks"] > 0
    assert (got.n_states, got.diameter, got.levels, got.n_transitions,
            got.coverage) == (want.n_states, want.diameter, want.levels,
                              want.n_transitions, want.coverage)
    assert got.n_states == 142_538
