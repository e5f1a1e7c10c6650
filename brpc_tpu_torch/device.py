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
- ``mlir(kind, p0, p1, p2)`` writes the spec of a program, as the
  reference's ``brt_mlir_module`` builds it: ``gather_rows`` and
  ``scatter_sub`` over a ``p0 x p1`` table and ``p2`` ids; ``add`` and
  ``reduce_sum`` over ``[p0]``, one replica whatever ``p1`` is;
  ``all_reduce_sum`` and ``all_gather`` over ``[p0]`` on ``p1`` replicas.
  ``compile(spec, num_replicas)`` reads only such specs, for 1 up to
  ``device_count`` replicas. The programs are the kernels of
  ``ops/embedding_rows.py`` (K2, K3) and ``ops/device_programs.py`` (K4,
  K5): CUDA C++ on the card, the plain versions on the CPU.
- ``DeviceExecutable.execute(handles, nreplicas)`` takes the operands as a
  flat ``[replica][operand]`` list, runs the program on every replica
  (replica d on device d; each operand must lie there), registers replica
  d's output on device d and returns ``[[out_0], [out_1], ...]``. It
  returns once every replica has finished, as the reference's parks, so
  no peer still reads an input the caller then releases. Refusals carry
  the reference's codes: 22 for a replica count other than the compiled
  one, a stale handle or a wrong operand; 5 for a program written for
  another replica count than it was compiled for; 5003 at compile.

On the CPU (``DeviceClient("cpu", num_devices=N)``) the N devices are
virtual, as the reference's test plugin's are: a handle records the device
it was staged on, and every tensor lies in host memory.

Work runs on PyTorch's current stream of each device (the default stream
on the shard's handler threads). Handles are unique in the process, as the
native registry's are. Under
``BRPC_TPU_HANDLECHECK`` every client, executable and buffer is recorded
in this package's handle ledger (``analysis.handles``), with the kinds
``device_client``, ``device_executable`` and ``device_buffer``.
"""

from __future__ import annotations

import itertools
import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch.analysis import handles as _handles
from brpc_tpu_torch.analysis import race as _race
from brpc_tpu_torch.ops import device_programs, embedding_rows

# Buffer handles, unique across every client of the process.
_next_handle = itertools.count(1)

_DTYPES = {"u8": np.uint8, "f32": np.float32, "i32": np.int32}

_HEADER = "// brpc_tpu_torch device program\n"
_SPEC = re.compile(_HEADER + r"kind=(\w+) ((?:\w+=\d+ ?)+)\n\Z")
# Each program's parameters, in the order of the spec, and its operands on
# each replica: (dtype, shape from the parameters).
_TABLE = ("rows", "dim", "k")
_VECTOR = ("n", "replicas")
_PROGRAMS = {
    "gather_rows": (_TABLE, ((torch.float32, lambda r, d, k: (r, d)),
                             (torch.int32, lambda r, d, k: (k,)))),
    "scatter_sub": (_TABLE, ((torch.float32, lambda r, d, k: (r, d)),
                             (torch.int32, lambda r, d, k: (k,)),
                             (torch.float32, lambda r, d, k: (k, d)),
                             (torch.float32, lambda r, d, k: ()))),
    "add": (_VECTOR, ((torch.float32, lambda n, _: (n,)),) * 2),
    "reduce_sum": (_VECTOR, ((torch.float32, lambda n, _: (n,)),)),
    "all_reduce_sum": (_VECTOR, ((torch.float32, lambda n, _: (n,)),)),
    "all_gather": (_VECTOR, ((torch.float32, lambda n, _: (n,)),)),
}


def _rpc_error(code: int, text: str) -> Exception:
    from brpc_tpu_torch.rpc import RpcError  # lazy: rpc imports this module
    return RpcError(code, text)


class DeviceExecutable:
    """One compiled program, at fixed parameters and replica count,
    launched on handles of the client that compiled it."""

    num_outputs = 1

    def __init__(self, client: "DeviceClient", kind: str, params: tuple,
                 num_replicas: int):
        self._client: Optional[DeviceClient] = client
        self.kind = kind
        self.params = params  # (rows, dim, k) or (n, replicas)
        self.num_replicas = num_replicas
        _handles.note_create("device_executable", id(self))

    def execute(self, args, nreplicas: int = 1) -> List[List[int]]:
        """args: every replica's operand handles, flat ``[replica][operand]``
        (gather_rows: table, ids; scatter_sub: table, ids, grads, lr; add:
        a, b; reduce_sum, all_reduce_sum, all_gather: x). Returns
        ``[[out_d] for each replica d]`` once every replica has finished;
        the caller releases the output handles."""
        if _race.enabled():
            _race.note_blocking("brt_device_execute")
        client = self._client
        if client is None:
            raise _rpc_error(22, "execute on a closed executable")
        replicas = self.num_replicas
        if nreplicas != replicas:
            raise _rpc_error(22, f"nreplicas != {replicas}: the program runs "
                                 f"on " + ("one replica" if replicas == 1
                                           else f"{replicas} replicas"))
        names, operands = _PROGRAMS[self.kind]
        entries = client._entries(args, replicas * len(operands))
        if names is _VECTOR and self.params[1] != replicas:
            raise _rpc_error(5, f"{self.kind} is written for "
                                f"{self.params[1]} replicas, compiled for "
                                f"{replicas}")
        tensors = []
        for d in range(replicas):
            mine = entries[d * len(operands):(d + 1) * len(operands)]
            for n, ((t, where), (dtype, shape)) in enumerate(
                    zip(mine, operands)):
                want = shape(*self.params)
                if t.dtype != dtype or tuple(t.shape) != want:
                    raise _rpc_error(22, f"{self.kind} replica {d} operand "
                                         f"{n}: want {dtype} {want}, got "
                                         f"{t.dtype} {tuple(t.shape)}")
                if where != d:
                    raise _rpc_error(22, f"{self.kind} replica {d} operand "
                                         f"{n} is on device {where}, but "
                                         f"replica {d} runs on device {d}")
            tensors.append([t for t, _ in mine])
        outs = self._run(tensors)
        if outs[0].is_cuda:
            for out in outs:
                torch.cuda.current_stream(out.device).synchronize()
        return [[client._register(out, d)] for d, out in enumerate(outs)]

    def _run(self, tensors: List[List[torch.Tensor]]) -> List[torch.Tensor]:
        """Replica d's output from replica d's operands ``tensors[d]``."""
        if self.kind == "all_reduce_sum":
            return device_programs.all_reduce_sum([t for t, in tensors])
        if self.kind == "all_gather":
            return device_programs.all_gather([t for t, in tensors])
        fn = {"gather_rows": embedding_rows.gather_rows,
              "scatter_sub": embedding_rows.scatter_sub,
              "add": device_programs.add,
              "reduce_sum": device_programs.reduce_sum}[self.kind]
        return [fn(*operands) for operands in tensors]

    def close(self) -> None:
        if self._client is not None:
            self._client = None
            _handles.note_destroy("device_executable", id(self))


class DeviceClient:
    """Device buffers and programs on one PyTorch device type: ``"cuda"``
    (the default; raises without a card; one device a card) or ``"cpu"``
    (``num_devices`` virtual devices, default 1)."""

    def __init__(self, device: str = "cuda", num_devices: int = 1):
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device client: no CUDA device")
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device client: unknown device {device!r}")
        if num_devices < 1 or (device == "cuda" and num_devices != 1):
            raise ValueError(f"device client: num_devices={num_devices}; "
                             f"virtual devices exist on the cpu only, a "
                             f"cuda client has one device a card")
        self.device = device
        self._num_devices = num_devices
        self._mu = threading.Lock()
        # handle -> (tensor, index of the device it was staged or made on)
        self._buffers: Dict[int, Tuple[torch.Tensor, int]] = {}
        self._open = True
        _handles.note_create("device_client", id(self))

    @property
    def device_count(self) -> int:
        if self.device == "cuda":
            return torch.cuda.device_count()
        return self._num_devices

    def _torch_device(self, device_index: int) -> torch.device:
        if not 0 <= device_index < self.device_count:
            raise _rpc_error(5002, f"no device {device_index} of "
                                   f"{self.device_count}")
        if self.device == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", device_index)

    def _register(self, tensor: torch.Tensor, device_index: int) -> int:
        handle = next(_next_handle)
        with self._mu:
            if not self._open:
                raise _rpc_error(22, "device client is closed")
            self._buffers[handle] = (tensor, device_index)
        _handles.note_create("device_buffer", handle)
        return handle

    def _entries(self, handles,
                 count: int) -> List[Tuple[torch.Tensor, int]]:
        if len(handles) != count:
            raise _rpc_error(22, f"want {count} operands, got "
                                 f"{len(handles)}")
        with self._mu:
            missing = [h for h in handles if h not in self._buffers]
            if missing:
                raise _rpc_error(22, f"unknown buffer handles {missing}")
            return [self._buffers[h] for h in handles]

    def _get(self, handles, count: int) -> List[torch.Tensor]:
        return [t for t, _ in self._entries(handles, count)]

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
        device = self._torch_device(device_index)
        # A copy on either device: the caller may write its array later.
        # On the CPU numpy copies, on the calling thread alone: torch's
        # copy of a large buffer fans out over its intra-op threads, from
        # every handler thread of a shard at once.
        if device.type == "cpu":
            tensor = torch.from_numpy(raw.copy().view(_DTYPES[dtype])
                                      .reshape(dims))
        else:
            if not raw.flags.writeable:  # torch.from_numpy wants that
                raw = raw.copy()
            tensor = torch.from_numpy(raw.view(_DTYPES[dtype])
                                      .reshape(dims)).to(device, copy=True)
        return self._register(tensor, device_index)

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
            entry = self._buffers.pop(handle, None)
        if entry is not None:
            _handles.note_destroy("device_buffer", handle)

    def live(self) -> List[int]:
        """Handles of the buffers not yet released."""
        with self._mu:
            return sorted(self._buffers)

    def mlir(self, kind: str, p0: int, p1: int = 0, p2: int = 0) -> str:
        """The spec of program ``kind`` for ``compile``: ``gather_rows`` and
        ``scatter_sub`` over a ``p0 x p1`` table and ``p2`` ids; ``add`` and
        ``reduce_sum`` over ``[p0]`` on one replica; ``all_reduce_sum`` and
        ``all_gather`` over ``[p0]`` on ``p1`` replicas."""
        if kind not in _PROGRAMS:
            raise ValueError(f"unknown mlir builder kind {kind!r}")
        names = _PROGRAMS[kind][0]
        if names is _TABLE:
            values = (p0, p1, p2)
        else:
            values = (p0, p1 if kind in ("all_reduce_sum", "all_gather")
                      else 1)
        return _HEADER + f"kind={kind} " + " ".join(
            f"{name}={int(v)}" for name, v in zip(names, values)) + "\n"

    def compile(self, mlir_text: str,
                num_replicas: int = 1) -> DeviceExecutable:
        """The program of a spec from ``mlir``, for ``num_replicas``
        replicas (1 up to ``device_count``; K2 and K3 one only). On the
        card a multi-replica program turns on peer access between its
        devices, and fails where a pair has none."""
        match = _SPEC.match(mlir_text)
        program = _PROGRAMS.get(match.group(1)) if match else None
        fields = [f.split("=") for f in match.group(2).split()] \
            if program else []
        if program is None or \
                tuple(name for name, _ in fields) != program[0]:
            raise _rpc_error(5003, "compile takes a spec written by "
                                   "DeviceClient.mlir")
        kind = match.group(1)
        if not 1 <= num_replicas <= self.device_count:
            raise _rpc_error(5003, f"{num_replicas} replicas on "
                                   f"{self.device_count} devices")
        if program[0] is _TABLE and num_replicas != 1:
            raise _rpc_error(5003, f"{kind} runs on one replica, not "
                                   f"{num_replicas}")
        if self.device == "cuda" and num_replicas > 1:
            if num_replicas > device_programs.max_replicas():
                raise _rpc_error(5003, f"{num_replicas} replicas; the "
                                       f"kernels take at most "
                                       f"{device_programs.max_replicas()}")
            try:
                device_programs.enable_peer_access(range(num_replicas))
            except device_programs.PeerAccessError as e:
                raise _rpc_error(5003, str(e)) from e
        return DeviceExecutable(self, kind,
                                tuple(int(v) for _, v in fields),
                                num_replicas)

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
