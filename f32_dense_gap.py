"""The f32 request's logits through K1 against dense attention, on one card.

The request is the f32 one of ``chip_smoke.py``'s phase 4: Llama-3-8B width,
all 32 layers, the f32 master weights drawn from seed 0 on the card, tokens
(1, 2048) from seed 1, f32 compute with TF32 off. It is served through
``flash_attention`` (K1's f32 kernel) and through dense attention
(``attn_fn=None``), and the script prints one JSON line: the card, max and
mean of |flash - dense| over the logits, max |dense|, the median latency of
``REPEATS`` requests after a warm-up, and the peak device memory. Phase 4
holds the kernel to ``DENSE_F32_MAX_ABS`` and ``DENSE_F32_MEAN_ABS``, twice
what this script printed for the f32 kernel this path had before.

``--root DIR`` imports ``brpc_tpu_torch`` from DIR instead of this
checkout, so another tree's kernel can be measured on the same card.

    python3 f32_dense_gap.py [--root DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REQUEST, REPEATS = (1, 2048), 3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("f32_dense_gap: no CUDA device", file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              dtype=torch.float32)
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    tokens = torch.randint(
        0, cfg.vocab_size, REQUEST,
        generator=torch.Generator(device="cuda").manual_seed(1),
        device="cuda")
    model = llama.LlamaModel(cfg, params, attn_fn=fa.flash_attention)
    with torch.inference_mode():
        model(tokens)  # warm-up
        seconds = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flash = model(tokens)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        dense = llama.forward(params, tokens, cfg, attn_fn=None)
        diff = (flash - dense).abs()
        print(json.dumps({
            "card": card.strip(), "root": args.root or ".",
            "package": os.path.dirname(fa.__file__),
            "max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
            "dense_max_abs": dense.abs().max().item(),
            "finite": bool(torch.isfinite(flash).all()),
            "latency_ms_median": 1e3 * statistics.median(seconds),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
