"""Embedding-row kernels of the parameter server's device shard.

The port of the two device programs the reference's ``DevicePsShardServer``
launches through its native PJRT client (``cpp/device/pjrt_executable.cc``,
StableHLO, not Pallas):

- ``gather_rows(table, ids)``: ``out[i, :] = table[ids[i], :]`` (Lookup,
  ``MlirGatherRowsF32``);
- ``scatter_sub(table, ids, grads, lr)``: a NEW table,
  ``table - scatter_add(ids, lr * grads)`` (ApplyGrad,
  ``MlirScatterSubF32``), equal bit for bit to
  ``np.subtract.at(table, ids, lr * grads)``: duplicates apply one at a
  time in batch order, each step rounded as f32. The input table is never
  written: pinned readers hold older generations.

The table is f32 ``[rows, dim]``, ids int32 ``[k]``, grads f32 ``[k, dim]``
and lr an f32 scalar tensor on the table's device. On CUDA tensors each
wrapper launches its kernel of ``csrc/embedding_rows.cu`` on the current
stream and counts the launch in ``launches``; on CPU tensors it runs the
plain PyTorch version beside it. A CUDA tensor never falls back to the
plain version: the launch happens or the wrapper raises.

Ids outside ``[0, rows)`` are the caller's fault (the shard checks them
first): the plain versions raise, the kernels write zeros for such a
gathered row and skip such an update rather than touch memory outside the
table.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from brpc_tpu_torch.ops import _build

# Kernel launches by kernel; a caller sets them to 0 before a run and reads
# them after. Shard handlers launch from several threads at once.
launches = {"gather_rows": 0, "scatter_sub": 0}
_launches_mu = threading.Lock()

# Each kernel's C function and its number of pointer arguments; three ints
# (k, rows, dim) and the stream follow them.
_SYMBOLS = {"gather_rows": "brt_gather_rows_f32",
            "scatter_sub": "brt_scatter_sub_f32"}


def _check_table_ids(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"want an f32 [rows, dim] table; got "
                        f"{table.dtype} {tuple(table.shape)}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError(f"want int32 [k] ids; got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no embedding-row kernels for {table.device}")


def _check_grads_lr(table: torch.Tensor, ids: torch.Tensor,
                    grads: torch.Tensor, lr: torch.Tensor) -> None:
    want = (ids.shape[0], table.shape[1])
    if grads.dtype != torch.float32 or tuple(grads.shape) != want:
        raise TypeError(f"want f32 grads {want}; got {grads.dtype} "
                        f"{tuple(grads.shape)}")
    if lr.dtype != torch.float32 or lr.numel() != 1:
        raise TypeError(f"want an f32 scalar lr; got {lr.dtype} "
                        f"{tuple(lr.shape)}")
    if not grads.is_contiguous():
        raise ValueError("grads must be contiguous")
    if grads.device != table.device or lr.device != table.device:
        raise ValueError(f"table on {table.device}, grads on "
                         f"{grads.device}, lr on {lr.device}")


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]`` as a fresh ``[k, dim]`` tensor."""
    _check_table_ids(table, ids)
    if table.device.type == "cpu":
        return gather_rows_reference(table, ids)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    _launch("gather_rows", table, table.data_ptr(), ids.data_ptr(),
            out.data_ptr(), ids.shape[0], table.shape[0], table.shape[1])
    return out


def scatter_sub(table: torch.Tensor, ids: torch.Tensor,
                grads: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """A new table: ``table`` with ``lr * grads[i]`` subtracted from row
    ``ids[i]`` for each i in order, as ``np.subtract.at`` does."""
    _check_table_ids(table, ids)
    _check_grads_lr(table, ids, grads, lr)
    if table.device.type == "cpu":
        return scatter_sub_reference(table, ids, grads, lr)
    out = torch.empty_like(table)
    _launch("scatter_sub", table, table.data_ptr(), ids.data_ptr(),
            grads.data_ptr(), lr.data_ptr(), out.data_ptr(), ids.shape[0],
            table.shape[0], table.shape[1])
    return out


def _launch(kernel: str, table: torch.Tensor, *args) -> None:
    fn = getattr(_library(), _SYMBOLS[kernel])
    with torch.cuda.device(table.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err}")
    with _launches_mu:
        launches[kernel] += 1


def _library() -> ctypes.CDLL:
    lib = _build.load("embedding_rows")
    if lib.brt_scatter_sub_f32.argtypes is not None:
        return lib  # declared below, last: both symbols are declared
    # the kernel's pointers, then (k, rows, dim), then the stream
    lib.brt_gather_rows_f32.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.brt_gather_rows_f32.restype = ctypes.c_int
    lib.brt_scatter_sub_f32.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.brt_scatter_sub_f32.restype = ctypes.c_int
    return lib


def gather_rows_reference(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """The plain version of ``gather_rows``."""
    return table.index_select(0, ids)


def scatter_sub_reference(table: torch.Tensor, ids: torch.Tensor,
                          grads: torch.Tensor,
                          lr: torch.Tensor) -> torch.Tensor:
    """The plain version of ``scatter_sub``: one f32 product ``lr * g`` per
    gradient, then one f32 subtraction per occurrence, in batch order."""
    rows = ids.tolist()
    if rows and not 0 <= min(rows) <= max(rows) < table.shape[0]:
        raise IndexError(f"ids outside [0, {table.shape[0]})")
    out = table.clone()
    step = lr.reshape(()) * grads
    for i, row in enumerate(rows):
        out[row].sub_(step[i])
    return out
