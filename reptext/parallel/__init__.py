"""Device mesh construction and sharding rules (dp x tp x sp)."""

from reptext.parallel.mesh import make_mesh  # noqa: F401
from reptext.parallel.partition import (  # noqa: F401
    MMDIT_PARAM_RULES,
    param_shardings,
    shard_params,
    shard_batch,
)
from reptext.parallel.sequence import (  # noqa: F401
    allgather_attention,
    joint_ring_attention_local,
    make_sp_mesh,
    ring_attention,
    sequence_parallel_forward,
    sequence_sharded_attention,
)
