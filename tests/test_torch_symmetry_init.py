"""The host key of the initial state (``init_fingerprint``) against the JAX
reference, under SYMMETRY and the deadvotes VIEW.

Split from ``test_torch_symmetry.py`` (the plain orbit key), so that each
file holds 10 tests or fewer.  Tolerance: bit-exact (uint32 key bits).
"""

import pytest
import torch

from raft_tla_tpu.config import Bounds as JBounds, CheckConfig as JConfig
from raft_tla_tpu.models import interp as jinterp
from raft_tla_tpu.models import spec as JS
from raft_tla_tpu.ops import msgbits as jmb
from raft_tla_tpu.ops import symmetry as jsym

from raft_tla_tpu_torch.config import Bounds, CheckConfig
from raft_tla_tpu_torch.models import interp
from raft_tla_tpu_torch.ops import symmetry as sym

# The suite runs in several worker processes: one torch thread each keeps
# these small CPU tensors from competing with the other workers for cores.
torch.set_num_threads(1)

FULL3 = dict(n_servers=3, n_values=2, max_term=2, max_log=1, max_msgs=2)
ELECT2 = dict(n_servers=2, n_values=1, max_term=2, max_log=0, max_msgs=2)


@pytest.mark.parametrize("kw,axes,view", [
    (FULL3, ("Server",), None),
    (FULL3, ("Server", "Value"), "deadvotes"),
    (FULL3, ("Value",), None),
    (ELECT2, (), "deadvotes"),
    (ELECT2, (), None),
])
def test_init_fingerprint_matches_jax(kw, axes, view):
    """The host key of Init and of a crafted start state (a candidate with
    vote sets, a message in flight)."""
    jb = JBounds(**kw)
    jcfg = JConfig(bounds=jb, spec="full", invariants=(), symmetry=axes,
                   view=view)
    cfg = CheckConfig(bounds=Bounds(**kw), spec="full", invariants=(),
                      symmetry=axes, view=view)
    n = jb.n_servers
    crafted = jinterp.init_state(jb)._replace(
        role=(JS.FOLLOWER,) * (n - 1) + (JS.CANDIDATE,),
        term=(2,) * n, votedFor=(0,) * (n - 1) + (n,),
        vResp=(1,) + (0,) * (n - 2) + (0b11,),
        vGrant=(1,) + (0,) * (n - 2) + (0b10,),
        msgs=((jmb.rv_response(2, 1, 0, n - 1), 1),))
    for js in (jinterp.init_state(jb), crafted):
        ps = interp.PyState(**{f: getattr(js, f)
                               for f in interp.PyState.__dataclass_fields__})
        want = tuple(int(x) for x in jsym.init_fingerprint(
            jcfg, js, jinterp.to_vec(js, jb)))
        assert sym.init_fingerprint(cfg, ps, interp.to_vec(ps, cfg.bounds)) \
            == want
