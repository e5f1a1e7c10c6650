"""The Llama layer equations in plain float32 PyTorch, one sequence at a
time.

As the published models (Mistral-7B-v0.3, DeepSeek-LLM-7B) and their
Hugging Face code define them: RMSNorm ``x * rsqrt(mean(x²) + eps) * w``;
rotary embeddings on the halves of each head with frequencies
``theta^(-2i/D)`` and angles in float32; causal grouped-query attention
(query head h reads KV head ``h // (Hq / Hkv)``), scaled by ``D^-1/2``;
``down(silu(gate(x)) * up(x))``; a final RMSNorm and an untied LM head.
Weights are ``[in, out]`` and applied as ``x @ w``, stacked over layers.
Departures: none in the equations; attention is computed in blocks of
queries and the MLP in blocks of rows so that 32k positions fit, which
changes no value beyond the order of float32 sums.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

from portbench.model_config import ModelShape

E4M3_MAX = 448.0
# Bytes of float32 attention scores a block of queries may take.
SCORE_BLOCK_BYTES = 1 << 31
MLP_BLOCK_ROWS = 4096


@contextlib.contextmanager
def full_f32():
    """Products in true float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale (amax to 448), back
    in float32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) \
        * scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = e4m3(a), e4m3(b)
    elif precision != "f32":
        raise ValueError(f"precision {precision!r}")
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [T, H, D] at positions 0..T-1."""
    t, _, d = x.shape
    inv_freq = (theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d)).float()
    angles = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] \
        * inv_freq[None, :]
    cos = torch.cos(angles).repeat(1, 2)[:, None, :]
    sin = torch.sin(angles).repeat(1, 2)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q0: int) -> torch.Tensor:
    """Causal attention of queries at positions q0.. over keys 0..;
    q [Tq, Hq, D], k/v [Tk, Hkv, D] -> [Tq, Hq*D]."""
    tq, hq, d = q.shape
    tk, hkv, _ = k.shape
    qh = q.reshape(tq, hkv, hq // hkv, d).permute(1, 2, 0, 3)
    kh = k.permute(1, 0, 2)[:, None]
    vh = v.permute(1, 0, 2)[:, None]
    scores = (qh @ kh.transpose(-1, -2)) * d ** -0.5      # [Hkv,G,Tq,Tk]
    rows = torch.arange(q0, q0 + tq, device=q.device)[:, None]
    cols = torch.arange(tk, device=q.device)[None, :]
    scores = scores.masked_fill(cols > rows, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ vh               # [Hkv,G,Tq,D]
    return out.permute(2, 0, 1, 3).reshape(tq, hq * d)


def layer(x: torch.Tensor, lw: dict, m: ModelShape,
          precision: str = "f32") -> torch.Tensor:
    """One decoder layer over a whole sequence x [T, h]."""
    t = x.shape[0]
    y = rms_norm(x, lw["attn_norm"], m.norm_eps)
    q = rope(mm(y, lw["wq"], precision).view(t, m.heads, m.head_dim),
             m.rope_theta)
    k = rope(mm(y, lw["wk"], precision).view(t, m.kv_heads, m.head_dim),
             m.rope_theta)
    v = mm(y, lw["wv"], precision).view(t, m.kv_heads, m.head_dim)
    del y
    block = max(1, min(t, SCORE_BLOCK_BYTES // (4 * m.heads * t)))
    attn = torch.cat([attention(q[q0:q0 + block], k[:q0 + block],
                                v[:q0 + block], q0)
                      for q0 in range(0, t, block)])
    del q, k, v
    x = x + mm(attn, lw["wo"], precision)
    del attn
    return x + torch.cat([_mlp(x[r:r + MLP_BLOCK_ROWS], lw, m, precision)
                          for r in range(0, t, MLP_BLOCK_ROWS)])


def _mlp(x, lw, m, precision):
    y = rms_norm(x, lw["mlp_norm"], m.norm_eps)
    return mm(F.silu(mm(y, lw["w_gate"], precision))
              * mm(y, lw["w_up"], precision), lw["w_down"], precision)


def layer_weights(w: dict, i: int) -> dict:
    return {name: stack[i] for name, stack in w["layers"].items()}


def hidden(w: dict, tokens: torch.Tensor, m: ModelShape,
           precision: str = "f32") -> torch.Tensor:
    """The final norm's output for one sequence of token ids [T]."""
    x = w["embed"][tokens]
    for i in range(m.layers):
        x = layer(x, layer_weights(w, i), m, precision)
    return rms_norm(x, w["final_norm"], m.norm_eps)


def logits_at(w: dict, tokens: torch.Tensor, positions: torch.Tensor,
              m: ModelShape, precision: str = "f32") -> torch.Tensor:
    """Logits [len(positions), vocab] of one sequence [T] at the given
    positions, without gradients."""
    with torch.no_grad(), full_f32():
        x = hidden(w, tokens, m, precision)[positions]
        return mm(x, w["lm_head"], precision)


def sequence_loss(w: dict, tokens: torch.Tensor, m: ModelShape,
                  precision: str = "f32") -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence [T] (the last
    position predicts nothing)."""
    x = hidden(w, tokens, m, precision)[:-1]
    logits = mm(x, w["lm_head"], precision)
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, tokens[1:, None]).squeeze(-1)).mean()
