"""The port's collective tier: meshes over torch.distributed and the
CollectiveChannel. Exports only what is ported; ``ring``, ``pipeline`` and
the sharded train step are still to come (ROADMAP.md)."""

from brpc_tpu_torch.parallel.mesh import (  # noqa: F401
    PartitionSpec,
    init_world,
    make_mesh,
    shard_batch,
    shard_params,
)
from brpc_tpu_torch.parallel.collective_channel import (  # noqa: F401
    CollectiveChannel,
    allreduce_benchmark,
)
