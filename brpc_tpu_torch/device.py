"""The device fabric of the port: PyTorch tensors behind 64-bit handles.

The reference's ``rpc.DeviceClient`` and ``rpc.DeviceExecutable`` drive a
PJRT plugin through the native core (``cpp/device/``): bytes are staged
into device buffers addressed by 64-bit handles, StableHLO programs are
compiled and launched on those handles. This module keeps that surface,
the one ``ps_remote.DevicePsShardServer`` calls, over PyTorch on a CUDA
card (the default) or the CPU (``device="cpu"``, as the tests run it):

- ``stage`` copies an array to the device and returns a nonzero handle;
  ``fetch`` copies it back to the host and waits for the copy;
  ``release`` drops it. A handle names an immutable tensor: nothing here
  writes a staged buffer or a launch's output after it is registered.
- ``mlir(kind, rows, dim, k)`` writes the spec of a program, ``gather_rows``
  or ``scatter_sub``; ``compile`` reads only such specs. The programs are
  the kernels of ``ops/embedding_rows.py`` (CUDA C++ on the card, the plain
  versions on the CPU).
- ``DeviceExecutable.execute(handles)`` launches one program and registers
  its output as a new handle.

Work runs on PyTorch's current stream of the device (the default stream
on the shard's handler threads), so the caching allocator reuses a
released buffer only after the launches queued before its release.
Handles are unique in the process, as the native registry's are. Under
``BRPC_TPU_HANDLECHECK`` every client, executable and buffer is recorded
in this package's handle ledger (``analysis.handles``), with the kinds
``device_client``, ``device_executable`` and ``device_buffer``.
"""

from __future__ import annotations

import itertools
import re
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from brpc_tpu_torch.analysis import handles as _handles
from brpc_tpu_torch.analysis import race as _race
from brpc_tpu_torch.ops import embedding_rows

# Buffer handles, unique across every client of the process.
_next_handle = itertools.count(1)

_DTYPES = {"u8": np.uint8, "f32": np.float32, "i32": np.int32}

_SPEC = re.compile(r"// brpc_tpu_torch device program\n"
                   r"kind=(gather_rows|scatter_sub) rows=(\d+) dim=(\d+) "
                   r"k=(\d+)\n\Z")
# Operands of each program: (dtype, shape from rows, dim, k).
_OPERANDS = {
    "gather_rows": ((torch.float32, lambda r, d, k: (r, d)),
                    (torch.int32, lambda r, d, k: (k,))),
    "scatter_sub": ((torch.float32, lambda r, d, k: (r, d)),
                    (torch.int32, lambda r, d, k: (k,)),
                    (torch.float32, lambda r, d, k: (k, d)),
                    (torch.float32, lambda r, d, k: ())),
}


def _rpc_error(code: int, text: str) -> Exception:
    from brpc_tpu_torch.rpc import RpcError  # lazy: rpc imports this module
    return RpcError(code, text)


class DeviceExecutable:
    """One compiled program (``gather_rows`` or ``scatter_sub`` at fixed
    rows, dim and k), launched on handles of the client that compiled
    it."""

    num_outputs = 1

    def __init__(self, client: "DeviceClient", kind: str, rows: int,
                 dim: int, k: int):
        self._client: Optional[DeviceClient] = client
        self.kind = kind
        self.shape = (rows, dim, k)
        _handles.note_create("device_executable", id(self))

    def execute(self, args, nreplicas: int = 1) -> List[List[int]]:
        """args: the program's operand handles (gather_rows: table, ids;
        scatter_sub: table, ids, grads, lr). Returns ``[[output]]``; the
        caller releases the output handle."""
        if _race.enabled():
            _race.note_blocking("brt_device_execute")
        client = self._client
        if client is None:
            raise _rpc_error(22, "execute on a closed executable")
        if nreplicas != 1:
            raise _rpc_error(22, f"one replica only, got {nreplicas}")
        operands = _OPERANDS[self.kind]
        tensors = client._get(args, len(operands))
        for n, (t, (dtype, shape)) in enumerate(zip(tensors, operands)):
            want = shape(*self.shape)
            if t.dtype != dtype or tuple(t.shape) != want:
                raise _rpc_error(22, f"{self.kind} operand {n}: want "
                                     f"{dtype} {want}, got {t.dtype} "
                                     f"{tuple(t.shape)}")
        if self.kind == "gather_rows":
            out = embedding_rows.gather_rows(*tensors)
        else:
            out = embedding_rows.scatter_sub(*tensors)
        return [[client._register(out)]]

    def close(self) -> None:
        if self._client is not None:
            self._client = None
            _handles.note_destroy("device_executable", id(self))


class DeviceClient:
    """Device buffers and programs on one PyTorch device type: ``"cuda"``
    (the default; raises without a card) or ``"cpu"``."""

    def __init__(self, device: str = "cuda"):
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device client: no CUDA device")
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device client: unknown device {device!r}")
        self.device = device
        self._mu = threading.Lock()
        self._buffers: Dict[int, torch.Tensor] = {}
        self._open = True
        _handles.note_create("device_client", id(self))

    @property
    def device_count(self) -> int:
        return torch.cuda.device_count() if self.device == "cuda" else 1

    def _torch_device(self, device_index: int) -> torch.device:
        if not 0 <= device_index < self.device_count:
            raise _rpc_error(5002, f"no device {device_index} of "
                                   f"{self.device_count}")
        if self.device == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", device_index)

    def _register(self, tensor: torch.Tensor) -> int:
        handle = next(_next_handle)
        with self._mu:
            if not self._open:
                raise _rpc_error(22, "device client is closed")
            self._buffers[handle] = tensor
        _handles.note_create("device_buffer", handle)
        return handle

    def _get(self, handles, count: int) -> List[torch.Tensor]:
        if len(handles) != count:
            raise _rpc_error(22, f"want {count} operands, got "
                                 f"{len(handles)}")
        with self._mu:
            missing = [h for h in handles if h not in self._buffers]
            if missing:
                raise _rpc_error(22, f"unknown buffer handles {missing}")
            return [self._buffers[h] for h in handles]

    def stage(self, data, device_index: int = 0, dtype: str = "u8",
              dims=None) -> int:
        """Copies bytes (or a numpy array) to the device; returns a buffer
        handle. An array keeps its shape and, when ``dtype`` is left at
        ``"u8"``, its f32 or i32 type, as the reference's client does."""
        if isinstance(data, np.ndarray):
            if dims is None:
                dims = list(data.shape)
            if dtype == "u8" and data.dtype != np.uint8:
                dtype = {"float32": "f32", "int32": "i32"}.get(
                    data.dtype.name, dtype)
            raw = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        else:
            raw = np.frombuffer(data, np.uint8)
        if dims is None:
            dims = [raw.size]
        if dtype not in _DTYPES:
            raise _rpc_error(5002, f"bad dtype {dtype!r}")
        want = int(np.prod(dims, dtype=np.int64)) \
            * np.dtype(_DTYPES[dtype]).itemsize
        if want != raw.size:
            raise _rpc_error(5002, f"{raw.size} bytes do not fill {dtype} "
                                   f"{list(dims)}")
        if not raw.flags.writeable:  # torch.from_numpy wants a writable one
            raw = raw.copy()
        host = torch.from_numpy(raw.view(_DTYPES[dtype]).reshape(dims))
        # A copy on either device: the caller may write its array later.
        tensor = host.to(self._torch_device(device_index), copy=True)
        return self._register(tensor)

    def fetch(self, handle: int) -> bytes:
        """Copies the buffer behind ``handle`` to the host, waiting for the
        copy; the buffer stays until released."""
        if _race.enabled():
            _race.note_blocking("brt_device_fetch")
        (tensor,) = self._get([handle], 1)
        return tensor.cpu().numpy().tobytes()

    def release(self, handle: int) -> None:
        """Drops a buffer; an unknown handle is ignored, as the reference's
        client ignores the native refusal."""
        with self._mu:
            tensor = self._buffers.pop(handle, None)
        if tensor is not None:
            _handles.note_destroy("device_buffer", handle)

    def live(self) -> List[int]:
        """Handles of the buffers not yet released."""
        with self._mu:
            return sorted(self._buffers)

    def mlir(self, kind: str, p0: int, p1: int = 0, p2: int = 0) -> str:
        """The spec of program ``kind`` over a ``p0 x p1`` table and ``p2``
        ids, for ``compile``."""
        if kind not in _OPERANDS:
            raise ValueError(f"unknown mlir builder kind {kind!r}")
        return (f"// brpc_tpu_torch device program\n"
                f"kind={kind} rows={int(p0)} dim={int(p1)} k={int(p2)}\n")

    def compile(self, mlir_text: str,
                num_replicas: int = 1) -> DeviceExecutable:
        match = _SPEC.match(mlir_text)
        if match is None or num_replicas != 1:
            raise _rpc_error(5003, "compile takes one replica of a spec "
                                   "written by DeviceClient.mlir")
        kind, rows, dim, k = match.groups()
        return DeviceExecutable(self, kind, int(rows), int(dim), int(k))

    def close(self) -> None:
        """Drops every buffer still held; the client takes no more."""
        with self._mu:
            if not self._open:
                return
            self._open = False
            dropped = list(self._buffers)
            self._buffers.clear()
        for handle in dropped:
            _handles.note_destroy("device_buffer", handle)
        _handles.note_destroy("device_client", id(self))
