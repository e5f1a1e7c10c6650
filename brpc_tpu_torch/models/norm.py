"""RMSNorm, the norm of every block the port runs (``models.llama``'s
layers and head, and ``models.mla``'s latent)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Reduce in f32, cast to x's dtype, then scale by w in that dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w
