"""Load the reference's parameters and tables into the port.

``params_from_jax`` takes the tree of ``brpc_tpu.models.llama.init_params``
after the caller has turned each leaf into a numpy array (for example with
``jax.tree_util.tree_map(np.asarray, params)``), and returns the port's
params dict: the same keys, shapes and values, in ``cfg.param_dtype`` on
``device``. Both sides store weights ``[in, out]``, so nothing is transposed.

``moe_params_from_jax`` does the same for the tree of
``brpc_tpu.models.moe.init_moe_params``, f32 on ``device``.

``embedding_from_reference`` takes the table of a reference
``brpc_tpu.ps.EmbeddingShards`` as a numpy array and returns the port's
``EmbeddingShards`` with the same values, row-sharded over the same axis.
"""

from __future__ import annotations

import numpy as np
import torch

from brpc_tpu_torch.models import moe
from brpc_tpu_torch.models.llama import LlamaConfig, Params, param_shapes
from brpc_tpu_torch.parallel.mesh import PartitionSpec, axis_size, \
    shard_batch
from brpc_tpu_torch.ps import EmbeddingShards


def params_from_jax(tree: Params, cfg: LlamaConfig,
                    device: str | torch.device = "cuda") -> Params:
    """Copy a numpy tree in the reference layout to tensors on ``device``."""
    return _convert(tree, param_shapes(cfg), cfg.param_dtype, device, "")


def moe_params_from_jax(tree: Params, cfg: moe.MoeConfig,
                        device: str | torch.device = "cuda") -> Params:
    """The reference's MoE params (numpy leaves) as f32 tensors on
    ``device``."""
    return _convert(tree, moe.moe_param_shapes(cfg), torch.float32, device,
                    "")


def _convert(node, shape, dtype, device, where):
    if isinstance(shape, dict):
        if not isinstance(node, dict) or set(node) != set(shape):
            got = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"{where or 'params'}: want keys "
                             f"{sorted(shape)}, got {got}")
        return {key: _convert(node[key], shape[key], dtype, device,
                              f"{where}{key}.") for key in shape}
    # float32 first: numpy has no bfloat16, and every bf16 value is exact
    # in f32.
    array = np.asarray(node, dtype=np.float32)
    if array.shape != tuple(shape):
        raise ValueError(f"{where[:-1]}: want shape {tuple(shape)}, got "
                         f"{array.shape}")
    return torch.from_numpy(array.copy()).to(device=device, dtype=dtype)


def embedding_from_reference(table: np.ndarray, vocab: int, dim: int,
                             axis: str, mesh) -> EmbeddingShards:
    """The reference's f32 ``[vocab, dim]`` table, the same on every rank,
    as the port's table row-sharded over ``axis`` of ``mesh`` (a
    ``DeviceMesh``), each rank's rows on the mesh's device."""
    array = np.asarray(table, dtype=np.float32)
    if array.shape != (vocab, dim):
        raise ValueError(f"want a table of shape {(vocab, dim)}, got "
                         f"{array.shape}")
    if vocab % axis_size(mesh, axis):
        raise ValueError(f"vocab {vocab} not divisible by "
                         f"{axis}={axis_size(mesh, axis)}")
    return EmbeddingShards(
        shard_batch(torch.from_numpy(array), PartitionSpec(axis, None), mesh),
        vocab, dim, axis)
