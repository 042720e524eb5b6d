"""The parallel engines — the port of ``raft_tla_tpu/parallel/``.

The shard engine (shard_engine.py) is ported.  The reference's other
names, which it loads lazily (the DDD shard engine, the CP lanes and the
paged shard engine), raise ``config.not_ported`` naming their ROADMAP.md
item.
"""

from raft_tla_tpu_torch.config import not_ported
from raft_tla_tpu_torch.parallel.shard_engine import (  # noqa: F401
    Mesh, ShardCapacities, ShardEngine, check, make_mesh, make_slice_mesh,
    reshard_checkpoint)

_DDD_SHARD = "item 11 (b), the DDD shard engine and CP lanes"
_PAGED_SHARD = "item 11 (c), the paged shard engine and the fleet"
_LATER = {
    "DDDShardCapacities": _DDD_SHARD,
    "DDDShardEngine": _DDD_SHARD,
    "reshard_ddd_checkpoint": _DDD_SHARD,
    "build_cp_expand": _DDD_SHARD,
    "build_cp_step": _DDD_SHARD,
    "cp_lane_count": _DDD_SHARD,
    "cp_lane_map": _DDD_SHARD,
    "PagedShardCapacities": _PAGED_SHARD,
    "PagedShardEngine": _PAGED_SHARD,
}


def __getattr__(name):
    if name in _LATER:
        raise not_ported(f"parallel.{name}", _LATER[name])
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
