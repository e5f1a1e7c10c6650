"""Flash attention: the port of ``brpc_tpu/ops/flash_attention.py``.

``flash_attention`` keeps the reference's contract: q ``[B,T,Hq,D]``, k/v
``[B,T,Hkv,D]`` -> ``[B,T,Hq*D]`` in q's dtype, query head h reads kv head
``h // (Hq // Hkv)``, blocks clip to T and a T that does not divide them
raises ``ValueError``. It is forward only, as the reference is.

On CUDA tensors it launches one of two Hopper kernels of
``csrc/flash_attention.cu`` and counts the launch in ``launches`` under its
dtype: for bf16 wgmma products on TMA tiles (128 query rows, 64-row K/V
tiles, P fed to the P·V product as two bf16 halves); for f32 mma.sync
products on TMA tiles (128 query rows, 64-row K/V tiles) in split TF32,
each operand x as tf32(x) + tf32(x - tf32(x)) and each product as three
TF32 products summed in f32, which holds the f32 bound that one TF32
product misses. The note there says why. On CPU tensors it runs
``flash_attention_reference``, the plain PyTorch version of the same
arithmetic. The kernels pick their own tiles; ``block_q`` and ``block_k``
keep the contract and set the plain version's K/V tile.
"""

from __future__ import annotations

import ctypes

import torch

from brpc_tpu_torch.ops import _build

# Kernel launches by kernel (its dtype); a caller sets them to 0 before a
# run and reads them after.
launches = {"bf16": 0, "f32": 0}

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_KERNELS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SYMBOLS = {"f32": "brt_flash_attention_f32",
            "bf16": "brt_flash_attention_bf16"}
_MASKED = -1e30


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           block_q: int, block_k: int) -> tuple[int, int]:
    """Validate the inputs; returns the blocks clipped to T."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,T,Hq,D] and k, v [B,T,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, hq, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, t, d):
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} differ "
                         f"in B, T or D")
    if hq % k.shape[2]:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {k.shape[2]}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
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
                    block_k: int = 128) -> torch.Tensor:
    """q: [B,T,Hq,D], k/v: [B,T,Hkv,D] -> [B,T,Hq*D] (llama.attention
    contract). CUDA tensors run the kernel; CPU tensors the plain version.

    Forward only, as the reference is: when an input requires grad the
    output carries a ``grad_fn`` whose backward raises, on either device.
    """
    block_q, block_k = _check(q, k, v, block_q, block_k)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _ForwardOnly.apply(q, k, v, causal, block_q, block_k)
    return _forward(q, k, v, causal, block_q, block_k)


def _forward(q, k, v, causal: bool, block_q: int,
             block_k: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         block_q=block_q, block_k=block_k)
    return _launch(q, k, v, causal)


class _ForwardOnly(torch.autograd.Function):
    """Runs ``_forward`` and refuses to differentiate it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        return _forward(q, k, v, causal, block_q, block_k)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "flash_attention is forward only, as the reference kernel is; "
            "training uses dense attention (attn_fn=None)")


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    b, t, hq, d = q.shape
    kernel = _KERNELS[q.dtype]
    fn = getattr(_library(), _SYMBOLS[kernel])
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, hq, k.shape[2], d, int(causal),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches[kernel] += 1
    return out.reshape(b, t, hq * d)


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.brt_flash_attention_bf16.argtypes is not None:
        return lib  # declared below, last: both symbols are declared
    # q, k, v, out; (b, t, hq, hkv, d, causal); the stream
    lib.brt_flash_attention_f32.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.brt_flash_attention_f32.restype = ctypes.c_int
    lib.brt_flash_attention_bf16.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.brt_flash_attention_bf16.restype = ctypes.c_int
    return lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              block_q: int = 128,
                              block_k: int = 128) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 throughout, q scaled by
    D**-0.5 before the product, masked scores -1e30, an online softmax over
    K/V tiles of ``block_k`` and ``acc / max(l, 1e-20)`` cast to q's dtype.

    All query rows step together; a tile wholly past a row's diagonal adds
    p = 0 with alpha = 1 there, exactly as skipping it would.
    """
    block_q, block_k = _check(q, k, v, block_q, block_k)
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    qf = (q.float() * d ** -0.5).view(b, t, hkv, hq // hkv, d)
    qf = qf.permute(0, 2, 3, 1, 4)                      # [B,Hkv,G,T,D]
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)     # [B,Hkv,1,T,D]
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    rows = torch.arange(t, device=q.device)[:, None]
    m = torch.full((b, hkv, hq // hkv, t, 1), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
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
    out = (acc / l.clamp_min(1e-20)).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq * d)
