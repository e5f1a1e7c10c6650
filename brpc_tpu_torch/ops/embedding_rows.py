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

import numpy as np
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
    """The plain version of ``gather_rows``. On the CPU numpy's ``take``
    gathers, on the calling thread alone: torch's ``index_select`` of
    such sizes fans out over its intra-op threads, from every handler
    thread of the CPU device client at once (see
    ``scatter_sub_reference``)."""
    if table.device.type != "cpu":
        return table.index_select(0, ids)
    rows = ids.numpy()
    _check_range(table, rows)
    return torch.from_numpy(table.numpy().take(rows, axis=0))


def _check_range(table: torch.Tensor, ids: np.ndarray) -> None:
    if ids.size and not 0 <= ids.min() <= ids.max() < table.shape[0]:
        raise IndexError(f"ids outside [0, {table.shape[0]})")


def scatter_sub_reference(table: torch.Tensor, ids: torch.Tensor,
                          grads: torch.Tensor,
                          lr: torch.Tensor) -> torch.Tensor:
    """The plain version of ``scatter_sub``, on host copies of the
    operands; the result goes back to the table's device.

    The CPU device client calls it from up to eight handler threads at
    once, so each step runs on the calling thread alone and only the large
    ones give the GIL up: the range check, the table's copy and the f32
    product ``lr * g`` are numpy's (torch's CPU copy and product of such
    sizes fan out over its intra-op threads from every handler at once,
    and each small torch call gives the GIL up and waits to take it back),
    and the subtractions are one ``index_add_`` with ``alpha = -1``
    (``np.subtract.at`` holds the GIL through its loop). This relies on
    ``index_add_``'s CPU kernel for a table of two dimensions (ATen's
    ``index_add_cpu_``; the installed wheel ships no ATen sources) adding
    ``alpha * step[i]`` to row ``ids[i]`` one id at a time, in batch
    order, in one f32 rounding each: ``row - step[i]``, as
    ``np.subtract.at`` computes it. On the card ``index_add_`` adds with
    atomics in no set order, hence the host.
    ``tests/test_torch_embedding_rows.py`` holds this bit-equal to
    ``np.subtract.at`` with many duplicate ids, signed zeros, subnormals
    and infinities (NaNs by place: where two meet, the payload is the
    CPU's choice).
    """
    rows = ids.cpu()
    _check_range(table, rows.numpy())
    out = torch.from_numpy(table.cpu().numpy().copy())
    step = torch.from_numpy(lr.cpu().numpy() * grads.cpu().numpy())
    return out.index_add_(0, rows, step, alpha=-1).to(table.device)
