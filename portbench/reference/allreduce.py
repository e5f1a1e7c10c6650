"""The reference all-reduce: every replica's vector summed in replica
order from +0.0, each addition rounded to ``dtype`` (float32 as the fabric
states; bfloat16 for the control)."""

from __future__ import annotations

import torch


def ordered_sum(xs, dtype=torch.float32) -> torch.Tensor:
    acc = torch.zeros(xs[0].shape, dtype=dtype, device=xs[0].device)
    for x in xs:
        acc = acc + x.to(acc.device, dtype)
    return acc.float()
