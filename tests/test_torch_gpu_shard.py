"""The shard engine on the card.

Marked ``gpu``: they skip where torch sees no CUDA device.  They import
neither JAX nor the reference::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_shard.py -q

Four shards on one card (a 1-D and a 2x2 mesh, K1 on every lockstep
chunk) equal four shards on the CPU exactly: counts, levels, coverage, the
states each shard owns and a violation's trace; after the same chunks the
two carries are equal array for array; a resharded snapshot keyed on the
card (the orbit-key entry under SYMMETRY, K2 without) equals the one keyed
by the plain versions on the CPU.  ``chip_smoke.py`` phase 21 runs the same
at the main path's sizes; tests/test_torch_shard_*.py hold the CPU engine
to the JAX ShardEngine.
"""

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.models import interp, spec as S
from raft_tla_tpu_torch.ops import msgbits as mb
from raft_tla_tpu_torch.ops import orbit_key, pallas_fp, pallas_step
from raft_tla_tpu_torch.parallel import (Mesh, ShardCapacities, ShardEngine,
                                         make_mesh, reshard_checkpoint)

pytestmark = pytest.mark.gpu

FULL = CheckConfig(bounds=Bounds(n_servers=2, n_values=1, max_term=2,
                                 max_log=1, max_msgs=2), spec="full",
                   invariants=("NoTwoLeaders", "LogMatching",
                               "CommittedWithinLog"), chunk=128)
CAPS = ShardCapacities(n_states=1 << 14, levels=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _same(a, b):
    assert (a.n_states, a.diameter, a.levels, a.n_transitions) == \
        (b.n_states, b.diameter, b.levels, b.n_transitions)
    assert dict(a.coverage) == dict(b.coverage)


@pytest.mark.parametrize("slices", [1, 2])
def test_four_shards_on_the_card_equal_the_cpu(cuda, slices):
    want_eng = ShardEngine(FULL, Mesh(["cpu"] * 4, n_slices=slices), CAPS)
    want = want_eng.check()
    pallas_step.launches = 0
    eng = ShardEngine(FULL, Mesh([cuda] * 4, n_slices=slices), CAPS)
    got = eng.check()
    _same(got, want)
    assert eng.stats["per_shard_states"] == \
        want_eng.stats["per_shard_states"]
    assert pallas_step.launches == eng.stats["chunks"] > 0


def test_mesh_beyond_the_cards_is_refused(cuda):
    n = torch.cuda.device_count()
    assert make_mesh(n).size == n
    with pytest.raises(ValueError, match=f"need {n + 1} devices, have {n}"):
        make_mesh(n + 1)


def test_seeded_violation_trace_on_the_card(cuda):
    b = Bounds(n_servers=3, n_values=1, max_term=3, max_log=0, max_msgs=4)
    cfg = CheckConfig(bounds=b, spec="election",
                      invariants=("NaiveNoTwoLeaders",), chunk=256)
    start = interp.init_state(b)._replace(
        role=(S.LEADER, S.FOLLOWER, S.CANDIDATE), term=(2, 3, 3),
        votedFor=(1, 3, 0), vGrant=(0b011, 0, 0b100),
        msgs=((mb.rv_response(3, 1, 1, 2), 1),))
    caps = ShardCapacities(n_states=1 << 12, levels=64)
    want = ShardEngine(cfg, make_mesh(4, device="cpu"), caps).check(
        init_override=start)
    got = ShardEngine(cfg, Mesh([cuda] * 4), caps).check(
        init_override=start)
    _same(got, want)
    assert got.violation.trace == want.violation.trace


def _arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "content_sha"}


def test_carry_after_k_chunks_on_the_card_equals_the_cpu(cuda, tmp_path):
    init = interp.init_state(FULL.bounds)
    vec = np.asarray(interp.to_vec(init, FULL.bounds), np.int32)
    paths = []
    for mesh in (Mesh(["cpu"] * 4, n_slices=2), Mesh([cuda] * 4,
                                                     n_slices=2)):
        eng = ShardEngine(FULL, mesh, CAPS)
        key = eng.init_key(init, vec)
        eng._init_carry(vec, key, True)
        assert eng._segment(25) == 25
        paths.append(tmp_path / f"{mesh.devices[0].type}.ckpt")
        eng.save_checkpoint(str(paths[-1]), key)
    a, b = (_arrays(p) for p in paths)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("axes", [(), ("Server",)])
def test_reshard_on_the_card_equals_the_cpu(cuda, tmp_path, axes):
    cfg = CheckConfig(bounds=Bounds(n_servers=3, n_values=1, max_term=2,
                                    max_log=0, max_msgs=1),
                      spec="election", invariants=("NoTwoLeaders",),
                      symmetry=axes, chunk=256)
    caps = ShardCapacities(n_states=1 << 18, levels=64)
    ck = str(tmp_path / "w1.ckpt")
    straight = ShardEngine(cfg, Mesh([cuda]), caps, seg_chunks=8).check(
        checkpoint=ck, checkpoint_every_s=0.0)
    outs = []
    for dev in ("cpu", "cuda"):
        orbit_key.launches = pallas_fp.launches = 0
        outs.append(str(tmp_path / f"{dev}4.ckpt"))
        reshard_checkpoint(cfg, caps, ck, outs[-1], 4, device=dev)
    assert (orbit_key.launches if axes else pallas_fp.launches) > 0
    a, b = (_arrays(p) for p in outs)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    got = ShardEngine(cfg, Mesh([cuda] * 4), caps).check(resume=outs[1])
    assert (got.n_states, got.levels, got.n_transitions) == \
        (straight.n_states, straight.levels, straight.n_transitions)
