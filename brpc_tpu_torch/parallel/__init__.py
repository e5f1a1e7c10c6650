"""The port's parallel tier: meshes over torch.distributed, the
CollectiveChannel, ring and Ulysses attention, and the pipeline. The
sharded Llama train step is ``models.llama.make_train_step`` on params
laid out by ``param_specs`` (its per-rank code: ``tensor_parallel``); the
expert-parallel MoE layer is ``models.moe``."""

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
from brpc_tpu_torch.parallel.ring import (  # noqa: F401
    ring_attention,
    ulysses_attention,
)
from brpc_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: F401
