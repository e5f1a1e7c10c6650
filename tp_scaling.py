"""Times the port's Llama train step over 'tp' on the cards of one host.

The step is phase 7's of ``chip_smoke.py``: Llama-3-8B width cut to
``LAYERS`` layers, batch (1, 2048), dense attention, AdamW 3e-4, bf16
compute on f32 master weights, params and batch from fixed seeds. With
``--tp 1`` it runs unsharded on one card; with ``--tp N`` the params are
laid out by ``param_specs`` on ``make_mesh({"tp": N})`` over N cards
(NCCL, one process a card), so each card holds 1/N of every Megatron
product. Each run prints one JSON line: the median of ``STEPS`` steps
after a warm-up, tokens/s, the peak device memory, the first and last
loss, and one step under ``torch.profiler`` split into matmul, NCCL and
other kernels with the idle share of the device span.

``--rowpar`` also times, on one card, the row-parallel product at tp=2's
shape of ``w_down`` ([2048, 7168] @ [7168, 4096]) three ways: the bf16
product (rounded before any sum), the f32 product of the upcast operands
at full f32 precision, and ``parallel.functional``'s f32 product.

``--root DIR`` imports ``brpc_tpu_torch`` from DIR instead of this
checkout, so two trees can be timed in one run on the same cards.

    python3 tp_scaling.py --tp 1 2 4 --rowpar
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.multiprocessing as mp

LAYERS, BATCH, STEPS, LR = 8, (1, 2048), 5, 3e-4


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.splitlines()[0].strip()


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_step(fn) -> dict:
    """One call under ``torch.profiler``: device ms by kind of kernel and
    the idle share of the device span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        return {"kernels": 0}
    kinds = {"nccl": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.name.lower()
        kind = "nccl" if "nccl" in name else "matmul" if any(
            k in name for k in ("gemm", "xmma", "nvjet", "cutlass",
                                "sm90_")) else "other"
        kinds[kind] += e.time_range.elapsed_us() / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    return {"kernels": len(kernels), "span_ms": span,
            "idle_share": 1 - sum(kinds.values()) / span,
            **{f"{k}_ms": v for k, v in kinds.items()}}


def train(rank: int, tp: int) -> dict:
    from brpc_tpu_torch import optim
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.parallel import make_mesh, shard_batch, shard_params

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=LAYERS)
    params = llama.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, BATCH, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    if tp > 1:
        mesh = make_mesh({"tp": tp})
        params = shard_params(params, llama.param_specs(cfg), mesh)
        tokens = shard_batch(tokens, llama.batch_specs(), mesh)
    params = llama.trainable(params)
    torch.cuda.empty_cache()
    step = llama.make_train_step(cfg, optim.adamw(params, LR))
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for _ in range(1 + STEPS):  # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(params, tokens).item())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    timed = seconds[1:]
    median = statistics.median(timed)
    return {"what": "train_step", "tp": tp, "rank": rank,
            "layers": LAYERS, "batch": list(BATCH),
            "ms_median": median * 1e3, "ms_min": min(timed) * 1e3,
            "ms_max": max(timed) * 1e3, "warmup_ms": seconds[0] * 1e3,
            "tokens_per_s": BATCH[0] * BATCH[1] / median,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "first_loss": losses[0], "last_loss": losses[-1],
            "profile": profile_step(lambda: step(params, tokens))}


def rowpar() -> dict:
    from brpc_tpu_torch.parallel import functional

    g = torch.Generator(device="cuda").manual_seed(2)
    a, w, grad = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for shape in ((2048, 7168), (7168, 4096),
                                      (2048, 4096)))
    a32, w32, grad32 = a.float(), w.float(), grad.float()
    torch.set_float32_matmul_precision("highest")
    out = {"what": "row_parallel_product", "shape": [2048, 7168, 4096],
           "bf16_fwd_ms": device_ms(lambda: a @ w),
           "bf16_bwd_ms": device_ms(lambda: (grad @ w.mT, a.mT @ grad)),
           "f32_fwd_ms": device_ms(lambda: a.float() @ w.float()),
           "f32_bwd_ms": device_ms(lambda: (grad32 @ w32.mT,
                                            a32.mT @ grad32))}
    if hasattr(functional, "_f32_product"):
        exact = a32 @ w32
        fast = functional._f32_product(a, w)
        out["tf32_fwd_ms"] = device_ms(lambda: functional._f32_product(a, w))
        out["tf32_against_f32_max_rel"] = (
            (fast - exact).abs().max() / exact.abs().max()).item()
        out["bf16_against_f32_max_rel"] = (
            ((a @ w).float() - exact).abs().max() / exact.abs().max()).item()
    return out


def _rank(rank: int, tp: int, store: str, root) -> None:
    # Not ``parallel.mesh.run_world``: with ``--root`` the ranks import
    # another tree's package, which may predate that launcher (or differ
    # in it), so this script starts its own ranks.
    if root:
        sys.path.insert(0, root)
    import torch.distributed as dist

    from brpc_tpu_torch.parallel import init_world

    init_world(store, rank, tp, "cuda")
    try:
        result = train(rank, tp)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(store, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tp", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--rowpar", action="store_true")
    parser.add_argument("--root", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tp_scaling: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root) if args.root else None
    if root:
        sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    label = {"card": card(), "root": args.root or "."}
    for tp in args.tp:
        if tp > torch.cuda.device_count():
            raise SystemExit(f"--tp {tp} needs {tp} cards, "
                             f"{torch.cuda.device_count()} present")
        if tp == 1:
            result = train(0, 1)
        else:
            with tempfile.TemporaryDirectory(prefix="tp-world-") as store:
                mp.start_processes(_rank, args=(tp, store, root), nprocs=tp,
                                   start_method="spawn")
                with open(os.path.join(store, "rank0.json")) as f:
                    result = json.load(f)
        print(json.dumps({**label, **result}), flush=True)
        torch.cuda.empty_cache()
    if args.rowpar:
        print(json.dumps({**label, **rowpar()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
