"""Flash attention: the port of ``brpc_tpu/ops/flash_attention.py``.

``flash_attention`` keeps the reference's contract: q ``[B,T,Hq,D]``, k/v
``[B,T,Hkv,D]`` -> ``[B,T,Hq*D]`` in q's dtype, query head h reads kv head
``h // (Hq // Hkv)``, blocks clip to T and a T that does not divide them
raises ``ValueError``. Beyond it, the scores' ``scale`` may be given
(``D**-0.5`` by default), and v may have a head dim of its own, as latent
attention's has: q and k at 192, v ``[B,T,Hkv,128]`` -> ``[B,T,Hq*128]``
(``HEAD_DIMS`` lists the pairs), forward only and in bf16 on CUDA.
Unlike the reference, which is forward only, it also differentiates: an
input that requires grad gives an output whose backward computes dq, dk
and dv blockwise from the saved log-sum-exp of each row, without the T x
T scores.

On CUDA tensors it launches the Hopper kernels of
``csrc/flash_attention.cu`` and counts each launch in ``launches`` (a
call made while a CUDA graph is captured launches nothing and counts
nothing, nor does the graph's replay: a trace shows its kernels). The
forward is one of two kernels, counted under its dtype: for bf16 wgmma
products on TMA tiles (128 query rows, 64-row K/V tiles, P fed to the
P·V product as two bf16 halves); for f32 mma.sync products on TMA tiles
(128 query rows, 64-row K/V tiles) in split TF32, each operand x as
tf32(x) + tf32(x - tf32(x)) and each product as three TF32 products
summed in f32, which holds the f32 bound that one TF32 product misses.
The note there says why. Where ``trains(q)`` (bf16, head dim 64 or 128)
and an input requires grad, the bf16 forward also writes each row's
log-sum-exp, and the backward launches three kernels, counted once under
``"bf16_backward"``: delta = rowsum(dO * O), then dK and dV a KV head's
128 keys at a time (its query heads summed in registers), then dQ 128
query rows at a time; wgmma products with P and dS in bf16 and every sum
in f32, deterministic (no atomics). On CUDA in f32 or at head dim 32 the
backward raises. On CPU tensors it runs ``flash_attention_reference``
and ``flash_attention_backward_reference``, the plain PyTorch versions of
the same arithmetic. The kernels pick their own tiles; ``block_q`` and
``block_k`` keep the contract and set the plain versions' K/V tile.
"""

from __future__ import annotations

import ctypes

import torch

from brpc_tpu_torch.ops import _build

# Kernel launches by kernel (its dtype), those of CUDA graph replays
# aside; a caller sets them to 0 before a run and reads them after.
launches = {"bf16": 0, "f32": 0, "bf16_backward": 0}

#: (q/k head dim, v head dim) pairs the kernels take.
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128))
SUPPORTED_HEAD_DIMS = tuple(d for d, dv in HEAD_DIMS if d == dv)
BACKWARD_HEAD_DIMS = (64, 128)
_KERNELS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MASKED = -1e30


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           block_q: int, block_k: int) -> tuple[int, int]:
    """Validate the inputs; returns the blocks clipped to T."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"want q [B,T,Hq,D], k [B,T,Hkv,D] and v "
                         f"[B,T,Hkv,Dv]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, hq, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, t, d):
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} differ "
                         f"in B, T or D")
    if hq % k.shape[2]:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {k.shape[2]}")
    if (d, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k, v) {(d, v.shape[3])} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want q, k, v all float32 or all bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    block_q, block_k = min(block_q, t), min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"seq {t} must divide blocks {block_q}/{block_k}")
    return block_q, block_k


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128,
                    scale: float | None = None) -> torch.Tensor:
    """q: [B,T,Hq,D], k: [B,T,Hkv,D], v: [B,T,Hkv,Dv] -> [B,T,Hq*Dv]
    (llama.attention contract), the scores scaled by ``scale`` (None:
    ``D**-0.5``). CUDA tensors run the kernel; CPU tensors the plain
    version. On CUDA a ``scale`` or a Dv other than D takes the bf16
    kernel: f32 raises ``ValueError``.

    When an input requires grad the output carries a ``grad_fn``: on the
    CPU it runs ``flash_attention_backward_reference``; on CUDA, where
    ``trains(q)``, v's head dim is q's and no ``scale`` is given, the
    forward also keeps each row's log-sum-exp and the backward runs the
    backward kernels; elsewhere on CUDA (f32, head dim 32 or 192, a
    ``scale``) the backward raises.
    """
    block_q, block_k = _check(q, k, v, block_q, block_k)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")
    if q.is_cuda and q.dtype != torch.bfloat16 \
            and (scale is not None or v.shape[3] != q.shape[3]):
        raise ValueError(f"no {q.dtype} kernel for a scale or a v head dim "
                         f"of its own; it runs in bf16")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, block_q, block_k, scale)
    return _forward(q, k, v, causal, block_q, block_k, scale)


def trains(q: torch.Tensor) -> bool:
    """Whether ``flash_attention`` has a kernel backward for ``q``
    [B,T,Hq,D]: a CUDA bf16 tensor whose head dim the backward takes and
    whose T the default 128-row blocks divide (or a T under 128)."""
    if q.dim() != 4 or q.device.type != "cuda" or q.dtype != torch.bfloat16:
        return False
    t, d = q.shape[1], q.shape[3]
    return d in BACKWARD_HEAD_DIMS and t > 0 and t % min(128, t) == 0


def softmax_scale(d: int, scale: float | None) -> float:
    """The scores' scale at q/k head dim ``d``: ``scale``, or ``d**-0.5``
    where it is None. Every path computes it here, the kernels' entries
    among them, so that serving, the forward that trains and the backward
    scale alike."""
    return d ** -0.5 if scale is None else float(scale)


def _forward(q, k, v, causal: bool, block_q: int, block_k: int,
             scale: float | None) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         block_q=block_q, block_k=block_k,
                                         scale=scale)
    return _launch(q, k, v, causal, scale=scale)


class _Attention(torch.autograd.Function):
    """The forward, keeping what the backward reads: q, k, v, the output
    and each row's log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, scale):
        ctx.causal, ctx.block_q, ctx.block_k = causal, block_q, block_k
        ctx.scale = scale
        if q.device.type == "cpu":
            out, lse = _reference(q, k, v, causal, block_k, scale)
        elif trains(q) and scale is None and v.shape[-1] == q.shape[-1]:
            out, lse = _launch(q, k, v, causal, keep_lse=True)
        else:
            ctx.refused = (f"flash_attention has no {q.dtype} backward at "
                           f"head dims {(q.shape[-1], v.shape[-1])} with "
                           f"scale {scale} on CUDA; it trains bf16 at head "
                           f"dims {BACKWARD_HEAD_DIMS}, scaled by D**-0.5")
            return _launch(q, k, v, causal, scale=scale)
        ctx.refused = None
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        if ctx.refused:
            raise RuntimeError(ctx.refused)
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_backward_reference(
                q, k, v, out, lse, grad, causal=ctx.causal,
                block_q=ctx.block_q, block_k=ctx.block_k, scale=ctx.scale)
        else:
            grads = _launch_backward(q, k, v, out, lse, grad, ctx.causal,
                                     ctx.scale)
        return (*grads, None, None, None, None)


def _launch(q, k, v, causal: bool, keep_lse: bool = False,
            scale: float | None = None):
    """The forward kernel's output [B,T,Hq*Dv]; with ``keep_lse`` (bf16, D
    = Dv) also the log-sum-exp, [B,Hq,T rounded up to 128] f32
    (``_launch_backward`` reads it)."""
    b, t, hq, d = q.shape
    dv = v.shape[3]
    kernel = _KERNELS[q.dtype]
    out = q.new_empty((b, t, hq, dv))
    lse = None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        dims = (b, t, hq, k.shape[2], d, int(causal))
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if keep_lse:
            lse = torch.empty((b, hq, -(-t // 128) * 128),
                              dtype=torch.float32, device=q.device)
            err = _library().brt_flash_attention_bf16_lse(
                *ptrs, lse.data_ptr(), *dims, softmax_scale(d, scale),
                stream)
        elif kernel == "bf16":
            err = _library().brt_flash_attention_bf16(
                *ptrs, *dims[:5], dv, int(causal), softmax_scale(d, scale),
                stream)
        else:
            err = _library().brt_flash_attention_f32(*ptrs, *dims, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    if not torch.cuda.is_current_stream_capturing():
        launches[kernel] += 1
    out = out.reshape(b, t, hq * dv)
    return (out, lse) if keep_lse else out


def _launch_backward(q, k, v, out, lse, grad, causal: bool,
                     scale: float | None = None) -> tuple:
    """dq, dk, dv from the backward kernels."""
    b, t, hq, d = q.shape
    grad = grad.reshape(b, t, hq, d).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        err = _library().brt_flash_attention_bf16_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            grad.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, t, hq, k.shape[2], d,
            int(causal), softmax_scale(d, scale),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    if not torch.cuda.is_current_stream_capturing():
        launches["bf16_backward"] += 1
    return dq, dk, dv


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.brt_flash_attention_bf16_backward.argtypes is not None:
        return lib  # declared below, last: every symbol is declared
    # q, k, v, out; (b, t, hq, hkv, d, causal); the stream
    lib.brt_flash_attention_f32.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.brt_flash_attention_f32.restype = ctypes.c_int
    # q, k, v, out; (b, t, hq, hkv, d, dv, causal); the scale; the stream
    lib.brt_flash_attention_bf16.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 7 + [ctypes.c_double, ctypes.c_void_p]
    lib.brt_flash_attention_bf16.restype = ctypes.c_int
    # q, k, v, out, lse; (b, t, hq, hkv, d, causal); the scale; the stream
    lib.brt_flash_attention_bf16_lse.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 6 + [ctypes.c_double, ctypes.c_void_p]
    lib.brt_flash_attention_bf16_lse.restype = ctypes.c_int
    # q, k, v, out, dout, lse, delta, dq, dk, dv; (b, t, hq, hkv, d,
    # causal); the scale; the stream
    lib.brt_flash_attention_bf16_backward.restype = ctypes.c_int
    lib.brt_flash_attention_bf16_backward.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 6 + [ctypes.c_double, ctypes.c_void_p]
    return lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              block_q: int = 128, block_k: int = 128,
                              scale: float | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 throughout, q scaled by
    ``scale`` (None: D**-0.5) before the product, masked scores -1e30, an
    online softmax over K/V tiles of ``block_k`` and ``acc / max(l,
    1e-20)`` cast to q's dtype.

    All query rows step together; a tile wholly past a row's diagonal adds
    p = 0 with alpha = 1 there, exactly as skipping it would.
    """
    block_q, block_k = _check(q, k, v, block_q, block_k)
    return _reference(q, k, v, causal, block_k, scale)[0]


def _reference(q, k, v, causal: bool, block_k: int,
               scale: float | None = None) -> tuple:
    """``flash_attention_reference``'s output and each row's log-sum-exp
    of its scaled scores, [B,Hq,T] f32."""
    b, t, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    qf = (q.float() * softmax_scale(d, scale)).view(b, t, hkv, hq // hkv, d)
    qf = qf.permute(0, 2, 3, 1, 4)                      # [B,Hkv,G,T,D]
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)     # [B,Hkv,1,T,D]
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)     # [B,Hkv,1,T,Dv]
    rows = torch.arange(t, device=q.device)[:, None]
    m = torch.full((b, hkv, hq // hkv, t, 1), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = qf.new_zeros((*qf.shape[:-1], dv))
    for k0 in range(0, t, block_k):
        s = qf @ kf[..., k0:k0 + block_k, :].transpose(-1, -2)
        if causal:
            cols = torch.arange(k0, k0 + block_k, device=q.device)[None, :]
            s = torch.where(cols <= rows, s, _MASKED)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vf[..., k0:k0 + block_k, :]
        m = m_new
    l = l.clamp_min(1e-20)
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, hq, t)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq * dv), lse


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, grad: torch.Tensor, *, causal: bool = True,
        block_q: int = 128, block_k: int = 128,
        scale: float | None = None) -> tuple:
    """The backward kernels' arithmetic in plain PyTorch: dq, dk, dv in the
    dtypes of q, k, v from the forward's output ``out`` [B,T,Hq*Dv], its
    log-sum-exp ``lse`` [B,Hq,>=T] and the output's gradient ``grad``.

    With c = ``scale`` (None: D**-0.5), delta = rowsum(dO * O) in f32; over
    K/V tiles of ``block_k``: P = exp(S - lse) with S = q k^T c in f32
    (masked pairs 0), dV = P^T dO summed over each KV head's query heads,
    dP = dO V^T, dS = P (dP - delta), dK = dS^T q c, and dQ accumulates dS
    K, times c at the end. P and dS are rounded to q's dtype before their
    products, as the kernels feed them to the tensor cores; every sum is
    f32.
    """
    block_q, block_k = _check(q, k, v, block_q, block_k)
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    scale = softmax_scale(d, scale)

    def heads(x, width):                                # [B,Hkv,G,T,width]
        x = x.float().reshape(b, t, hkv, hq // hkv, width)
        return x.permute(0, 2, 3, 1, 4)

    qf = heads(q, d)
    do, o = heads(grad, v.shape[3]), heads(out, v.shape[3])
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)     # [B,Hkv,1,T,D]
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    lse = lse[..., :t].reshape(b, hkv, hq // hkv, t, 1)
    delta = (do * o).sum(-1, keepdim=True)
    rows = torch.arange(t, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk, dv = [], []
    for k0 in range(0, t, block_k):
        kt, vt = kf[..., k0:k0 + block_k, :], vf[..., k0:k0 + block_k, :]
        p = torch.exp((qf * scale) @ kt.transpose(-1, -2) - lse)
        if causal:
            cols = torch.arange(k0, k0 + block_k, device=q.device)[None, :]
            p = torch.where(cols <= rows, p, 0.0)
        ds = p * (do @ vt.transpose(-1, -2) - delta)
        p, ds = (x.to(q.dtype).float() for x in (p, ds))
        dv.append((p.transpose(-1, -2) @ do).sum(2))
        dk.append((ds.transpose(-1, -2) @ qf).sum(2) * scale)
        dq = dq + ds @ kt
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(b, t, hq, d)
    dk = torch.cat(dk, 2).permute(0, 2, 1, 3)           # [B,T,Hkv,D]
    dv = torch.cat(dv, 2).permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
