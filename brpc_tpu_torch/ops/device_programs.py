"""The device fabric's vector programs and collectives (K4, K5).

The port of the four StableHLO programs the reference's ``DeviceClient.mlir``
builds besides K2 and K3 (``cpp/device/pjrt_executable.cc``, not Pallas):

- ``add(a, b)``: ``a + b`` over f32 ``[n]`` (``MlirAddF32``);
- ``reduce_sum(x)``: ``sum(x)`` as a 0-d f32 (``MlirReduceSumF32``), from
  an f64 sum rounded once: within one ulp of the exact sum;
- ``all_reduce_sum(xs)``: one ``[n]`` input per replica; every replica gets
  ``((0 + x_0) + x_1) + ...``, each addition rounded as f32, in replica
  order from +0.0 (``MlirAllReduceSumF32``);
- ``all_gather(xs)``: every replica gets ``concat(x_0, x_1, ...)``
  (``MlirAllGatherF32``).

Replica d's input and output lie on replica d's device. On CUDA tensors
each wrapper launches its kernel of ``csrc/device_programs.cu`` on the
current stream of its device, once for ``add`` and ``reduce_sum`` and once
a replica for the collectives, and counts each launch in ``launches``.

The collectives push: replica d's kernel stores its share into every
replica's output over peer access (NVLink). ``all_gather``'s share is d's
input, stored at ``[d * n, (d + 1) * n)`` of every output.
``all_reduce_sum`` takes one of two routes by the kernels' fixed rule on
(R, n) (``route``): the two-shot, where replica d sums slice d of every
input (``all_reduce_slices``: R slices on 4 KB boundaries, the tail in the
last) and stores the sums into slice d of every output; or the one-shot,
where replica d sums all of every input into its own output. Either way
each element is summed once, in replica order, so every replica gets the
same bytes.

A call orders itself on the calling thread: it records a ready event on
every card's current stream, then allocates every output, then makes each
replica's stream wait for every other card's ready event before its
launch. So a peer reads an input, and writes an output, only after the
work its card had queued before the call, including work on an output's
block that the caching allocator handed out right after it was freed on
that card's stream. After the launches each card's stream waits for every
replica's kernel (the join): later work on a card (reading an output, a
freed input's block handed out again, a write into an input) comes after
every push into it and every read of it, as with NCCL's stream semantics.
On CPU tensors each wrapper runs the plain PyTorch version beside it; a
CUDA tensor never falls back to it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence

import torch

from brpc_tpu_torch.ops import _build

# Kernel launches by kernel; a caller sets them to 0 before a run and reads
# them after. The device shard's handlers launch from several threads.
launches = {"add": 0, "reduce_sum": 0, "all_reduce_sum": 0, "all_gather": 0}
_launches_mu = threading.Lock()

# Ordered device pairs (device, peer) whose peer access is on.
_peers: set = set()
_peers_mu = threading.Lock()

_VOID, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PTRS = ctypes.POINTER(ctypes.c_void_p)

# The two-shot all-reduce's slices start on multiples of this many floats
# (4 KB), so each slice of an aligned vector is 16-byte aligned.
SLICE_FLOATS = 1024


class PeerAccessError(RuntimeError):
    """A device cannot reach another's memory: no collective over it."""


def _check_vector(x: torch.Tensor, what: str) -> None:
    if x.dim() != 1 or x.dtype != torch.float32:
        raise TypeError(f"{what}: want an f32 [n] vector; got {x.dtype} "
                        f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no device programs for {x.device}")


def _check_replicas(xs: Sequence[torch.Tensor], kind: str) -> None:
    if not xs:
        raise ValueError(f"{kind}: no replicas")
    for d, x in enumerate(xs):
        _check_vector(x, f"{kind} replica {d}")
        if x.shape != xs[0].shape:
            raise TypeError(f"{kind}: replica {d} has {tuple(x.shape)}, "
                            f"replica 0 {tuple(xs[0].shape)}")
    kinds = {x.device.type for x in xs}
    if len(kinds) != 1:
        raise ValueError(f"{kind}: replicas on {sorted(kinds)}")
    if xs[0].is_cuda and len(xs) > max_replicas():
        raise ValueError(f"{kind}: {len(xs)} replicas; the kernels take at "
                         f"most {max_replicas()}")


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` as a fresh ``[n]`` f32 vector on their device."""
    _check_vector(a, "add a")
    _check_vector(b, "add b")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"add: a {tuple(a.shape)} on {a.device}, b "
                         f"{tuple(b.shape)} on {b.device}")
    if a.device.type == "cpu":
        return add_reference(a, b)
    out = torch.empty_like(a)
    if a.numel():
        _launch("add", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                a.numel())
    return out


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` as a 0-d f32 tensor on its device."""
    _check_vector(x, "reduce_sum x")
    if x.device.type == "cpu":
        return reduce_sum_reference(x)
    scratch = torch.empty(_library().brt_reduce_sum_scratch_doubles(),
                          dtype=torch.float64, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _launch("reduce_sum", x.device, x.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), x.numel())
    return out


def all_reduce_sum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Replica d's output, on ``xs[d]``'s device, is the sum of every
    replica's input in replica order from +0.0."""
    _check_replicas(xs, "all_reduce_sum")
    if not xs[0].is_cuda:
        return all_reduce_sum_reference(xs)
    return _collective("all_reduce_sum", xs)


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Replica d's output, on ``xs[d]``'s device, is every replica's input
    concatenated in replica order."""
    _check_replicas(xs, "all_gather")
    if not xs[0].is_cuda:
        return all_gather_reference(xs)
    return _collective("all_gather", xs)


def all_reduce_slices(n: int, replicas: int) -> List[tuple]:
    """The two-shot all-reduce's slices of ``[0, n)``, one ``(begin, end)``
    a replica: equal runs of whole 4 KB tiles, the rest in the last one
    (every slice but the last is empty when n < replicas * 1024)."""
    per = n // replicas // SLICE_FLOATS * SLICE_FLOATS
    return [(d * per, n if d == replicas - 1 else (d + 1) * per)
            for d in range(replicas)]


def route(kind: str, replicas: int, n: int) -> str:
    """The route a collective of ``replicas`` inputs of n floats takes on
    the card: ``all_reduce_sum`` "two-shot" or "one-shot" by the kernels'
    rule, ``all_gather`` "push"."""
    if kind == "all_gather":
        return "push"
    if kind != "all_reduce_sum":
        raise ValueError(f"no route for {kind!r}")
    two_shot = _library().brt_all_reduce_two_shot(replicas, n)
    return "two-shot" if two_shot else "one-shot"


def max_replicas() -> int:
    """The most replicas a collective kernel takes (one host's NVLink
    domain)."""
    return _library().brt_device_programs_max_replicas()


def enable_peer_access(devices: Sequence[int]) -> None:
    """Turns on peer access between every ordered pair of ``devices``
    (once a pair per process); raises ``PeerAccessError`` naming a pair
    that has none."""
    lib = _library()
    with _peers_mu:
        for d in devices:
            for p in devices:
                if d == p or (d, p) in _peers:
                    continue
                err = lib.brt_enable_peer_access(d, p)
                if err == -1:
                    raise PeerAccessError(f"device {d} cannot access device "
                                          f"{p}'s memory (no peer access)")
                if err:
                    raise RuntimeError(f"enabling peer access {d} -> {p}: "
                                       f"CUDA error {err}")
                _peers.add((d, p))


def _collective(kind: str, xs: Sequence[torch.Tensor],
                two_shot: bool | None = None) -> List[torch.Tensor]:
    """One launch a replica, ordered as the module docstring says.
    ``two_shot`` None takes the kernels' rule; a bool forces an
    all-reduce route (for timing the route the rule does not take)."""
    devices = [x.device.index for x in xs]
    enable_peer_access(sorted(set(devices)))
    replicas, n = len(xs), xs[0].numel()
    ready = {}
    for dev in set(devices):
        ready[dev] = torch.cuda.Event()
        ready[dev].record(torch.cuda.current_stream(dev))
    out_numel = n if kind == "all_reduce_sum" else replicas * n
    outs = [torch.empty(out_numel, dtype=torch.float32, device=x.device)
            for x in xs]
    out_ptrs = (ctypes.c_void_p * replicas)(*[o.data_ptr() for o in outs])
    if kind == "all_reduce_sum":
        if two_shot is None:
            two_shot = route(kind, replicas, n) == "two-shot"
        in_ptrs = (ctypes.c_void_p * replicas)(*[x.data_ptr() for x in xs])
        spans = all_reduce_slices(n, replicas) if two_shot \
            else [(0, n)] * replicas
    for d, x in enumerate(xs):
        dev = x.device.index
        stream = torch.cuda.current_stream(dev)
        for other, event in ready.items():
            if other != dev:
                stream.wait_event(event)
        if kind == "all_gather":
            if n:
                _launch(kind, x.device, x.data_ptr(), out_ptrs, replicas,
                        d * n, n)
            continue
        begin, end = spans[d]
        if end > begin:
            targets = out_ptrs if two_shot else \
                (ctypes.c_void_p * 1)(outs[d].data_ptr())
            _launch(kind, x.device, in_ptrs, replicas, targets,
                    len(targets), begin, end)
    # The join: each card's stream waits for every replica's kernel, so no
    # later work on it overtakes a push into its outputs or a peer still
    # reading its input.
    done = {}
    for dev in set(devices):
        done[dev] = torch.cuda.Event()
        done[dev].record(torch.cuda.current_stream(dev))
    for dev in set(devices):
        stream = torch.cuda.current_stream(dev)
        for other, event in done.items():
            if other != dev:
                stream.wait_event(event)
    return outs


def _launch(kernel: str, device: torch.device, *args) -> None:
    fn = getattr(_library(), f"brt_{kernel}_f32")
    err = fn(*args, device.index,
             torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err}")
    with _launches_mu:
        launches[kernel] += 1


def _library() -> ctypes.CDLL:
    lib = _build.load("device_programs")
    if lib.brt_reduce_sum_scratch_doubles.argtypes is not None:
        return lib  # declared below, last: every symbol is declared
    # The kernels take their pointers (the all-reduce an array of every
    # replica's input pointer and one of the outputs it stores into, the
    # all-gather its input and every output), the range they move, the
    # device they run on and its stream.
    lib.brt_add_f32.argtypes = [_VOID, _VOID, _VOID, _LL, _INT, _VOID]
    lib.brt_add_f32.restype = ctypes.c_int
    lib.brt_reduce_sum_f32.argtypes = [_VOID, _VOID, _VOID, _LL, _INT,
                                       _VOID]
    lib.brt_reduce_sum_f32.restype = ctypes.c_int
    lib.brt_all_reduce_sum_f32.argtypes = [_PTRS, _INT, _PTRS, _INT, _LL,
                                           _LL, _INT, _VOID]
    lib.brt_all_reduce_sum_f32.restype = ctypes.c_int
    lib.brt_all_gather_f32.argtypes = [_VOID, _PTRS, _INT, _LL, _LL, _INT,
                                       _VOID]
    lib.brt_all_gather_f32.restype = ctypes.c_int
    lib.brt_all_reduce_two_shot.argtypes = [_INT, _LL]
    lib.brt_all_reduce_two_shot.restype = ctypes.c_int
    lib.brt_enable_peer_access.argtypes = [_INT, _INT]
    lib.brt_enable_peer_access.restype = ctypes.c_int
    lib.brt_device_programs_max_replicas.argtypes = []
    lib.brt_device_programs_max_replicas.restype = ctypes.c_int
    lib.brt_reduce_sum_scratch_doubles.argtypes = []
    lib.brt_reduce_sum_scratch_doubles.restype = ctypes.c_int
    return lib


def add_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of ``add``."""
    return a + b


def reduce_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``reduce_sum``: an f64 sum rounded once."""
    return x.double().sum().float()


def all_reduce_sum_reference(
        xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The plain version of ``all_reduce_sum``: on each replica's device, a
    zero vector plus every input in replica order."""
    outs = []
    for x in xs:
        acc = torch.zeros_like(x)
        for y in xs:
            acc = acc + y.to(x.device)
        outs.append(acc)
    return outs


def all_gather_reference(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The plain version of ``all_gather``: ``torch.cat`` on each replica's
    device."""
    return [torch.cat([y.to(x.device) for y in xs]) for x in xs]
