"""Drive the PyTorch/CUDA port (``brpc_tpu_torch``) on one CUDA card.

Run from the root of the repository: ``python3 chip_smoke.py``. Every phase
is fatal when it fails:

1. the card's name and power limit; every kernel under
   ``brpc_tpu_torch/csrc/`` built with nvcc (one process each, all at once),
   the build time, and each kernel's registers and spills as ptxas reports
   them; beside it the native RPC core (``cpp/``) built through the port's
   ``rpc`` loader (g++), with its time;
2. each kernel against its plain PyTorch version at the shapes of the
   serving path (Llama-3-8B heads: Hq 32, Hkv 8, D 128), f32 and bf16,
   causal and not, with its time from CUDA events and the host's time to
   issue each call, its achieved TFLOP/s, its bound, the plain version's
   time and one PyTorch library call for the same function;
3. the parameter server's two kernels at Llama-3-8B's embedding table
   (128256 x 4096 f32, drawn from a seed as the shard draws it) and
   ``PS_K`` Zipf-skewed ids: the row gather bit-equal to ``index_select``,
   the ordered scatter-sub bit-equal to its plain version and to
   ``np.subtract.at`` on the host, each with its bound and plain time; each
   timed in turns with its library call (three rounds of library, kernel,
   kernel, library; median and range), the scatter-sub also with a bare
   device-to-device copy of the table, its practical floor; the
   scatter-sub again at 32 times the bucket, bit-equal to its plain version
   and timed in turns beside the same two; then the tiny
   config's forward on the card against the same forward on the CPU, in
   f32 and bf16 compute;
4. serving at Llama-3-8B width, all 32 layers, weights drawn from a seed:
   three request shapes through ``LlamaModel`` with the flash-attention
   kernel, each served ``REPEATS`` times after a warm-up and checked for
   shape, dtype, finiteness and one kernel launch per layer, with the
   median and range of latency, tokens/s and peak memory; the first
   request's logits against the dense attention path;
5. one more request of each shape under ``torch.profiler``: device time by
   kind of kernel, the attention kernel's share and the device's idle
   share over the request;
6. the tiny config trained at f32 compute, three AdamW steps on the card
   against the same three on the CPU, then a checkpoint saved after step 2
   on the card, restored into a fresh template and stepped: it must give
   the uninterrupted step 3 bit for bit;
7. training at Llama-3-8B width cut to ``TRAIN_LAYERS`` layers (AdamW's
   state for all 32 does not fit the card), dense attention as the
   reference trains: a warm-up step and ``TRAIN_STEPS`` timed steps on one
   batch, with each loss, the step time, tokens/s, peak memory, the
   model's FLOPs and AdamW's bytes against the card's peaks, then one more
   step under ``torch.profiler``. The loss must be finite and fall, no
   flash kernel may launch, and the peak must stay under the card's 80 GB;
8. the parameter server serving that table from device memory:
   ``DevicePsShardServer`` on the card, ``RemoteEmbedding`` over loopback
   RPC, a warm-up, then ``PS_PAIRS`` Lookup/ApplyGrad pairs of ``PS_K``
   ids each. Every Lookup and the final table must equal a host replay
   (``np.subtract.at`` in the same order on the seeded table) bit for bit,
   each request must launch its kernel once, and no device buffer may be
   live after the server closes. Latency, MB/s, peak memory and one
   request's split between staging, kernel, fetch and the rest (RPC and
   host work); then ``PS_THREADS`` client threads at once, each on its own
   rows, with the same exact ledger;
9. the collective PS tier at that table: ``brpc_tpu_torch.ps`` on a mesh
   (``make_mesh({"ps": 1})``) over an NCCL world of one process that meets
   through a ``FileStore``. With the kernels' counts at 0: one ``lookup``
   (bit-equal to the host's ``table[ids]``, one K2 launch), one
   ``apply_gradients`` (bit-equal to ``np.subtract.at``, one K3 launch)
   and ``PS_TRAIN_STEPS`` steps of ``make_ps_train_step`` (one K2 and one
   K3 launch each; a finite loss that falls; the first step's table
   against a host replay within ``PS_STEP_RTOL``). Then the backward's K3
   call against its plain version, each ``CollectiveChannel`` op against
   its definition, ``allreduce_benchmark`` at ``ALLREDUCE_MB`` (labelled
   with its world size: on one card its bandwidth is 0 by construction),
   the medians of ``PS_TIMED_CALLS`` calls of each entry point with the
   peak memory, and one call of each under ``torch.profiler``;
10. the model-parallel tier on a new NCCL world of one, with the kernels'
   counts at 0 for the whole phase and read at its end (no kernel of the
   repo is on these paths: each count must still be 0): (a)
   ``dryrun_multichip(1)`` with its gates (mesh dp = tp = sp = 1); (b)
   the sharded train step at Llama-3-8B width cut to ``TRAIN_LAYERS``
   layers, params laid out by ``param_specs`` on
   ``make_mesh({"tp": 1, "sp": 1})``, ring attention over 'sp' with the
   heads over 'tp', batch (1, 2048): at f32 compute its loss and every
   leaf's gradient against the unsharded step's on the same seeded params
   (run first), within ``MP_GRAD_REL``; then at bf16 with AdamW
   ``TRAIN_LR``, its first loss against phase 7's within ``MP_LOSS_TOL``,
   ``TRAIN_STEPS`` timed steps with the median, tokens/s, FLOP share and
   peak (finite, falling, under 80 GB), and one step under
   ``torch.profiler`` (the ``collective`` kind is NCCL's kernels); (c)
   ``moe_layer`` forward and backward at hidden 4096, intermediate 14336,
   8 experts, top-1, capacity factor 2.0, ``MOE_TOKENS`` tokens, bf16
   compute on f32 weights, ep = 1: median of ``MOE_STEPS`` and peak; the
   dry run's MoE shape on the card against the CPU at f32; (d)
   ``pipeline_apply`` at pp = 1 on the card against the CPU, and
   ``ring_attention`` and ``ulysses_attention`` at sp = 1 and Llama-3-8B's
   heads, (1, 2048), against dense attention at f32.

11. the device fabric's K4 and K5 programs through ``DeviceClient``
   (``stage`` on device d, ``mlir``, ``compile``, ``execute``, ``fetch``)
   at every power of two R up to the card count, at ``FABRIC_SIZES``,
   inputs drawn from a seed with -0.0, subnormals, inf and NaN planted,
   with every kernel count at 0 before and read after: ``add`` and
   ``reduce_sum`` on device 0, ``all_reduce_sum`` and ``all_gather`` over
   R replicas. Each result against a host numpy replay (``add``, the
   ordered all-reduce from +0.0 and the all-gather bit for bit, NaNs as
   NaNs; ``reduce_sum`` within one ulp of the f64 sum), every replica's
   output the same bytes, one launch a replica an ``execute``, no buffer
   live at ``close()``. Then each kernel against its plain version on the
   card, timed in turns with its library call (``torch.add``,
   ``torch.sum``, ``clone()`` at R = 1, ``torch.cuda.nccl`` at R > 1),
   with its bound, its plain time and ``execute``'s host latency.

The kernels line gives each kernel's launches by path
(``launches_by_path``), phases 10 ("model_parallel") and 11
("device_fabric") included.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Llama-3-8B attention heads; the requests' (B, T).
HQ, HKV, D = 32, 8, 128
REQUESTS = ((1, 2048), (2, 1024), (4, 512))
REPEATS = 10  # timed requests of each shape
# Kernel against plain version, elementwise. Both compute in f32 and differ
# only in the order of their sums (~1e-6). In f32 that is the bound. In
# bf16 both round the same f32 value to bf16, so they differ by at most one
# bf16 step: 2**-7 * |want|, with |want| floored at 2**-4 so that a flip
# near zero passes and a wrong value of the output's size (RMS ~0.04 at
# these shapes) does not.
F32_ATOL = 2e-5
BF16_REL, BF16_FLOOR = 2.0 ** -7, 2.0 ** -4
# Flash against dense attention over 32 bf16 layers: the two paths round
# the attention output differently (about one bf16 ulp), and each layer
# adds its own such step to the residual stream. On the H100 the port gave
# max 0.1309 and mean 0.01828 on logits of |max| 5.4 (PERF.md, PR 1); the
# bounds allow about twice that.
DENSE_MAX_ABS, DENSE_MEAN_ABS = 0.25, 0.04
# Tiny training, card against CPU, f32 compute with TF32 off. The first
# step's gradients agree per leaf within 1e-5 of the leaf's largest, as
# the port's gradients agree with the reference's on the CPU; the losses
# within the forward's f32 bound. AdamW moves nearly every param by about
# lr·sign(g) a step, so where |g| lies below the two devices' rounding of
# the gradient (1e-8 here) the two can move a param by different fractions
# of lr: the params are held per leaf by the card's update against the
# CPU's, |Δ card - Δ CPU| / |Δ CPU| in L2 norm.
TINY_TRAIN_LR, TINY_TRAIN_STEPS = 1e-3, 3
TINY_TRAIN_GRAD_REL, TINY_TRAIN_LOSS_ATOL = 1e-5, 1e-4
TINY_TRAIN_UPDATE_REL = 1e-2
# Training at 8B width: AdamW's f32 params, grads and two moments take 16 B
# a param, 115.9 GB at 32 layers; 8 layers take 32.1 GB.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, (1, 2048), 5, 3e-4
TRAIN_PEAK_LIMIT = 80e9  # bytes of device memory
ADAMW_BYTES_PER_PARAM = 28  # read p, g, m, v; write p, m, v (f32)
# The PS device shard at Llama-3-8B's embedding table, as Meta's published
# config.json gives it (vocab_size 128256, hidden_size 4096), f32: 2.10 GB.
# A request carries one sequence of 2048 tokens (33.5 MB of rows, under the
# native protocol's 64 MiB body limit), ids drawn Zipf-skewed (token
# frequencies) over a seeded permutation of the vocabulary, so that ids
# repeat; the learning rate is not a power of two.
PS_VOCAB, PS_DIM, PS_K = 128256, 4096, 2048
PS_ZIPF, PS_LR, PS_SEED = 1.1, 0.05, 0
PS_PAIRS = 8  # timed Lookup/ApplyGrad pairs, one request at a time
PS_THREADS, PS_THREAD_PAIRS = 4, 3  # the concurrent stretch
# The collective PS tier (``brpc_tpu_torch.ps`` on a mesh) at the same table
# and ids: train steps on the main run, timed calls of each entry point, and
# the allreduce benchmark's size (the reference's default).
PS_TRAIN_STEPS, PS_TIMED_CALLS, ALLREDUCE_MB = 5, 10, 64.0
# The first train step's table against a host replay in f32: the same
# products and sums, the mean's gradient rounded where torch rounds it.
PS_STEP_RTOL = 1e-6

# The model-parallel tier on a world of one. The sharded step at
# Llama-3-8B width: at f32 compute its loss and every gradient against the
# unsharded step's, each leaf by |g_sharded - g_dense| / |g_dense| (L2),
# within MP_GRAD_REL. The two differ only in the attention's order of
# normalisation (ring against dense) and the loss's order of summation:
# f32 rounding, ~1e-6 over 8 layers; a wrong factor, shard, position or
# target gives an error of order 1. At bf16 its first loss against phase
# 7's first loss (same params, same batch) within MP_LOSS_TOL relative,
# the dry run's loss gate. The MoE layer at Llama-3-8B's widths (also
# Mixtral-8x7B's published hidden 4096, intermediate 14336, 8 experts)
# with the reference's top-1 routing and capacity factor 2.0 on one
# sequence of 2048 tokens, and ring and Ulysses attention at Llama-3-8B's
# heads against dense attention at f32 (the reference's ring-against-dense
# tolerance).
MP_GRAD_REL, MP_LOSS_TOL = 1e-4, 2e-3
MOE_HIDDEN, MOE_INTERMEDIATE, MOE_EXPERTS, MOE_TOKENS = 4096, 14336, 8, 2048
MOE_STEPS = 5
MP_SMALL_TOL, MP_ATTN_TOL = 1e-5, 2e-4

# The device fabric (K4, K5) at the sizes its users move: tpu_ps's
# allreduce of 16 floats (latency), one 2048-id request's gradient block at
# Llama-3-8B width (2048 x 4096 f32, 33.5 MB, the kernels line's shape) and
# one w_down gradient of Llama-3-8B (14336 x 4096 f32, 234.9 MB).
FABRIC_SIZES = (16, 2048 * 4096, 14336 * 4096)
FABRIC_MAIN_N, FABRIC_SEED, FABRIC_EXECUTES = 2048 * 4096, 7, 5
FABRIC_KINDS = ("add", "reduce_sum", "all_reduce_sum", "all_gather")
FABRIC_SPECIALS = np.array([-0.0, 1e-40, -3e-42, np.inf, -np.inf, np.nan],
                           np.float32)
NVLINK_BYTES_PER_S = 450e9  # H100 SXM, to the other cards, each way

class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def kernel_error(got, want):
    """(max |got - want|, the worst element's |got - want| over its bound);
    the kernel agrees with its plain version when the second is <= 1."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        bound = BF16_REL * want.float().abs().clamp_min(BF16_FLOOR)
    else:
        bound = torch.full_like(err, F32_ATOL)
    return err.max().item(), (err / bound).max().item()


def time_ms(fn, iters: int, warmup: int = 2,
            devices=(0,)) -> tuple[float, float]:
    """Mean milliseconds per call over ``iters`` calls: (device time from
    CUDA events, host time to issue the call). A sleep kernel, about twice
    as long as the calls took in the warm-up, holds the device while the
    host issues them, so the events time the calls back to back on the
    device and not the host's pace of issuing them (a small kernel's
    wrapper can take longer to call than the kernel to run). With several
    ``devices`` each gets its sleep and its events, and the device time is
    the longest of theirs."""
    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    sync()
    per_call = (time.perf_counter() - t0) / warmup
    events = {}
    for d in devices:
        stream = torch.cuda.current_stream(d)
        with torch.cuda.device(d):
            torch.cuda._sleep(int(min(2 * per_call * iters, 5.0) * 2e9))
        events[d] = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
        events[d][0].record(stream)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    for d in devices:
        events[d][1].record(torch.cuda.current_stream(d))
    sync()
    return max(start.elapsed_time(end) for start, end in events.values()) \
        / iters, 1e3 * host_s / iters


def in_turns(label, fns, iters, rounds=3, devices=(0,)):
    """Times each of ``fns`` (by name) with ``time_ms`` in turns: each of
    ``rounds`` rounds runs them in order and then in reverse (library,
    kernel, kernel, library), so that a drift of the card's clock or of
    its neighbours falls on all alike. Prints and returns (median, min,
    max) of the device ms of each, over its 2 * ``rounds`` samples."""
    samples = {name: [] for name in fns}
    host = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            ms, host_ms = time_ms(fns[name], iters, devices=devices)
            samples[name].append(ms)
            host[name].append(host_ms)
    out = {name: (statistics.median(v), min(v), max(v))
           for name, v in samples.items()}
    print(f"{label} in turns, {rounds} rounds of ({', '.join(order)}, "
          f"{', '.join(order[::-1])}), {iters} calls a sample: " + " ".join(
              f"{name}_ms median={m:.4f} min={lo:.4f} max={hi:.4f} "
              f"host_ms={statistics.median(host[name]):.4f}"
              for name, (m, lo, hi) in out.items()))
    return out


def attention_ops(b, t, causal):
    """4·B·Hq·D operations for each (query, key) pair the mask keeps."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 4 * b * HQ * D * pairs


def attention_bound(b, t, causal, dtype):
    """(ms, what bounds it): the operations of the (query, key) pairs the
    mask keeps against the peak for the dtype, or q, k, v and o moved once
    against the memory rate, whichever takes longer."""
    ops = attention_ops(b, t, causal)
    nbytes = (2 * b * t * HQ * D + 2 * b * t * HKV * D) * dtype.itemsize
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_build():
    from brpc_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(build_native_core)
        t0 = time.perf_counter()
        logs = _build.build()
        print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.3f} s")
        native.result()
    for log in logs.values():
        for line in ptxas_report(log):
            print(f"ptxas {line}")
    return card


def build_native_core():
    """The native RPC core through the port's loader, built from ``cpp/``
    when the checkout has no library yet."""
    from brpc_tpu_torch import rpc

    t0 = time.perf_counter()
    rpc._load()
    built = rpc.native_build or {"toolchain": "nothing (found built)",
                                 "seconds": 0.0}
    print(f"native core: built by {built['toolchain']} in "
          f"{built['seconds']:.3f} s on {os.cpu_count()} cores (loaded in "
          f"{time.perf_counter() - t0:.3f} s)")


def ptxas_report(log):
    """One line per kernel from nvcc's ``-Xptxas -v`` output: registers,
    spill bytes and static shared memory."""
    lines, name, spills = [], None, ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spills = m.group(1), ""
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = f"spill_stores={m.group(1)} spill_loads={m.group(2)}"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name}: registers={m.group(1)} {spills} "
                         f"static_smem={smem.group(1) if smem else 0}")
            name = None
    return lines


def phase_kernels():
    """Kernel against plain at the serving shapes; returns the timings."""
    from brpc_tpu_torch.ops import flash_attention as fa

    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, t in REQUESTS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, t, h, D), generator=gen,
                                   device="cuda").to(dtype)
                       for h in (HQ, HKV, HKV))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal)
                want = fa.flash_attention_reference(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err, of_tol = kernel_error(got, want)
                name = f"{str(dtype)[6:]} causal={causal} B={b} T={t}"
                check(of_tol <= 1.0,
                      f"flash_attention {name}: max |err| {err}, worst "
                      f"element at {of_tol} of its bound")
                ms, host_ms = time_ms(
                    lambda: fa.flash_attention(q, k, v, causal=causal), 20)
                plain_ms, _ = time_ms(lambda: fa.flash_attention_reference(
                    q, k, v, causal=causal), 3, warmup=1)
                library_ms, library_host_ms = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
                bound_ms, bound_by = attention_bound(b, t, causal, dtype)
                tflops = attention_ops(b, t, causal) / ms / 1e9
                rows[(b, t, dtype, causal)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms)
                print(f"flash_attention {name}: max_abs_err={err:.3e} "
                      f"err_of_tolerance={of_tol:.4f} ms={ms:.4f} "
                      f"host_ms={host_ms:.4f} tflops={tflops:.1f} "
                      f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                      f"library_host_ms={library_host_ms:.4f} "
                      f"bound_ms={bound_ms:.4f} "
                      f"({bound_by}) of_bound={bound_ms / ms:.4f}")
    return rows


def phase_tiny():
    """The tiny config on the card against the same forward on the CPU."""
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.ops.flash_attention import flash_attention
    from brpc_tpu_torch.utils.tree import tree_map

    tokens = torch.randint(0, 512, (2, 64),
                           generator=torch.Generator().manual_seed(0))
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 0.1)):
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=dtype)
        params = llama.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        want = llama.forward(params, tokens, cfg, flash_attention)
        got = llama.forward(tree_map(lambda t: t.cuda(), params),
                            tokens.cuda(), cfg, flash_attention).cpu()
        err = (got - want).abs().max().item()
        print(f"tiny forward {str(dtype)[6:]}: card against CPU max |err| "
              f"{err:.3e} (bound {tol})")
        check(err <= tol, f"tiny forward {dtype}: {err} > {tol}")
    # Ids past both ends of the vocabulary are clamped as jnp clamps them,
    # on the card too (no device-side assert); such a target makes the
    # loss NaN, as the reference's.
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    params = llama.init_params(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    tokens[0, 3], tokens[1, 10] = 600, -600
    want = llama.forward(params, tokens, cfg)
    on_card = tree_map(lambda t: t.cuda(), params)
    got = llama.forward(on_card, tokens.cuda(), cfg).cpu()
    loss = llama.loss_fn(on_card, tokens.cuda(), cfg).item()
    err = (got - want).abs().max().item()
    print(f"tiny forward with out-of-vocabulary ids: card against CPU max "
          f"|err| {err:.3e} (bound 1e-4), loss {loss}")
    check(err <= 1e-4 and math.isnan(loss),
          f"out-of-vocabulary ids: {err}, loss {loss}")


def phase_serve():
    """Llama-3-8B width through the kernel; returns the launch count."""
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.ops import flash_attention as fa

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in
                   (params["embed"], params["final_norm"], params["lm_head"],
                    *params["layers"].values()))
    print(f"serve: Llama-3-8B width, {cfg.n_layers} layers, {n_params} "
          f"params ({n_params * 4 / 1e9:.3f} GB f32), init "
          f"{time.perf_counter() - t0:.3f} s")
    model = llama.LlamaModel(cfg, params, attn_fn=fa.flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(1)
    requests = [torch.randint(0, cfg.vocab_size, shape, generator=gen,
                              device="cuda") for shape in REQUESTS]
    with torch.inference_mode():
        for tokens in requests:  # warm-up: cuBLAS handles and heuristics
            model(tokens)
        torch.cuda.synchronize()

        fa.launches = 0
        for i, tokens in enumerate(requests):
            b, t = tokens.shape
            torch.cuda.reset_peak_memory_stats()
            latencies = []
            for _ in range(REPEATS):
                logits = None  # the peak counts one request's logits only
                before = fa.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = model(tokens)
                torch.cuda.synchronize()
                latencies.append(time.perf_counter() - t0)
                check(logits.shape == (b, t, cfg.vocab_size)
                      and logits.dtype == torch.float32,
                      f"request {b}x{t}: logits {logits.dtype} "
                      f"{tuple(logits.shape)}")
                check(bool(torch.isfinite(logits).all()),
                      f"request {b}x{t}: non-finite logits")
                check(fa.launches - before == cfg.n_layers,
                      f"request {b}x{t}: {fa.launches - before} kernel "
                      f"launches, want {cfg.n_layers}")
            median = statistics.median(latencies)
            print(f"request B={b} T={t} x{REPEATS}: latency_ms median="
                  f"{median * 1e3:.3f} min={min(latencies) * 1e3:.3f} "
                  f"max={max(latencies) * 1e3:.3f} tokens_per_s median="
                  f"{b * t / median:.1f} peak_mem_gb="
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} "
                  f"launches_each={cfg.n_layers}")
            if i == 0:
                compare_dense(llama, params, cfg, tokens, logits)
            del logits
        launches = fa.launches
        check(launches == len(requests) * REPEATS * cfg.n_layers,
              f"{launches} launches over {len(requests) * REPEATS} requests")
        for tokens in requests:
            profile_run(f"B={tokens.shape[0]} T={tokens.shape[1]}",
                        lambda: model(tokens))
    return launches


def compare_dense(llama, params, cfg, tokens, flash_logits):
    """One request's logits through the kernel against the dense path."""
    dense = llama.forward(params, tokens, cfg, attn_fn=None)
    diff = (flash_logits - dense).abs()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    print(f"request B={tokens.shape[0]} T={tokens.shape[1]}: flash against "
          f"dense logits max |diff| {max_abs:.4f} (bound {DENSE_MAX_ABS}), "
          f"mean {mean_abs:.5f} (bound {DENSE_MEAN_ABS}), |logits| max "
          f"{dense.abs().max().item():.3f}")
    check(max_abs <= DENSE_MAX_ABS and mean_abs <= DENSE_MEAN_ABS,
          "flash and dense logits differ beyond the bound")


# Kernel names by kind; the first pattern that matches names the kind.
KERNEL_KINDS = (("flash_attention", re.compile(r"flash_fwd")),
                ("collective", re.compile(r"nccl", re.IGNORECASE)),
                ("matmul", re.compile(r"gemm|xmma|nvjet|cutlass|sm90_")),
                ("optimizer", re.compile(r"[Aa]dam")),
                ("copy_cast", re.compile(r"copy")),
                ("other", re.compile(r"")))


def profile_run(label, fn):
    """Runs ``fn`` once under ``torch.profiler`` and prints the device time
    by kind of kernel, the idle share of the device span, the time in
    fill kernels (zeros) and the kernels that took longest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device events less the ranges the profiler marks on the device for
    # annotations such as Optimizer.step, which span kernels listed too
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    check(bool(kernels), "profiler recorded no device activity")
    by_kind = {kind: 0.0 for kind, _ in KERNEL_KINDS}
    by_name = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        kind = next(k for k, pat in KERNEL_KINDS if pat.search(e.name))
        by_kind[kind] += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = sum(by_kind.values())
    span = max(e.time_range.end for e in kernels) - \
        min(e.time_range.start for e in kernels)
    fill = sum(us for name, us in by_name.items() if "FillFunctor" in name)
    print(f"profile {label}: device_span_ms={span / 1e3:.3f} "
          f"kernel_ms={busy / 1e3:.3f} idle_share={1 - busy / span:.4f} "
          f"flash_attention_share={by_kind['flash_attention'] / span:.4f} "
          f"kernels={len(kernels)} zero_fill_ms={fill / 1e3:.3f} " + " ".join(
              f"{k}_ms={v / 1e3:.3f}" for k, v in by_kind.items()))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile top: {us / 1e3:.3f} ms {name[:100]}")


def phase_tiny_train():
    """The tiny config trained on the card against the CPU, and a resume
    from a checkpoint on the card against the uninterrupted run."""
    from brpc_tpu_torch import optim
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.utils import checkpoint
    from brpc_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    init = llama.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))

    def start(device):
        params = llama.trainable(
            tree_map(lambda t: t.to(device, copy=True), init))
        return params, optim.adamw(params, TINY_TRAIN_LR)

    def train(params, opt, steps):
        step = llama.make_train_step(cfg, opt)
        t = tokens.to(tree_leaves(params)[0].device)
        return [step(params, t).item() for _ in range(steps)]

    def first_grads(device):
        params = start(device)[0]
        llama.loss_fn(params, tokens.to(device), cfg).backward()
        return [p.grad.cpu() for p in tree_leaves(params)]

    grad_err = max((g - w).abs().max().item() / w.abs().max().item()
                   for g, w in zip(first_grads("cuda"), first_grads("cpu")))
    cpu_params, cpu_opt = start("cpu")
    want = train(cpu_params, cpu_opt, TINY_TRAIN_STEPS)
    params, opt = start("cuda")
    check(bool(opt.param_groups[0]["fused"]), "AdamW on the card not fused")
    got = train(params, opt, TINY_TRAIN_STEPS - 1)
    with tempfile.TemporaryDirectory() as ckpt:
        checkpoint.save_checkpoint(ckpt, TINY_TRAIN_STEPS - 1, {
            "params": params, "opt_state": opt.state_dict(),
            "step": TINY_TRAIN_STEPS - 1})
        got += train(params, opt, 1)
        loss_err = max(abs(a - b) for a, b in zip(got, want))
        param_err = update_err = 0.0
        for p, q, p0 in zip(tree_leaves(params), tree_leaves(cpu_params),
                            tree_leaves(init)):
            diff = p.detach().cpu() - q.detach()
            param_err = max(param_err, diff.abs().max().item())
            update_err = max(update_err, (diff.norm() / (q.detach() - p0)
                                          .norm()).item())
        print(f"tiny train f32 x{TINY_TRAIN_STEPS} AdamW: card losses "
              f"{got}, CPU losses {want}; first-step grads max |err| / "
              f"max |grad| {grad_err:.3e} (bound {TINY_TRAIN_GRAD_REL}), "
              f"max |loss err| {loss_err:.3e} (bound "
              f"{TINY_TRAIN_LOSS_ATOL}), updates' relative L2 err "
              f"{update_err:.3e} (bound {TINY_TRAIN_UPDATE_REL}), max "
              f"|param err| {param_err:.3e}")
        check(grad_err <= TINY_TRAIN_GRAD_REL
              and loss_err <= TINY_TRAIN_LOSS_ATOL
              and update_err <= TINY_TRAIN_UPDATE_REL,
              "tiny training on the card differs from the CPU")

        fresh, fresh_opt = start("cuda")
        optim.init_state(fresh_opt)
        state = checkpoint.restore_checkpoint(ckpt, template={
            "params": fresh, "opt_state": fresh_opt.state_dict(),
            "step": 0})
    fresh_opt.load_state_dict(state["opt_state"])
    resumed = train(fresh, fresh_opt, 1)
    same = resumed == got[-1:] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(fresh),
                                          tree_leaves(params)))
    print(f"tiny train resume: step {state['step']} restored, step "
          f"{TINY_TRAIN_STEPS} loss {resumed[0]} against {got[-1]}, params "
          f"{'bit-equal' if same else 'DIFFER'}")
    check(same, "the resumed step differs from the uninterrupted one")


def train_flops(cfg, b, t):
    """Model FLOPs of one train step: 6 per matmul weight per token
    (forward 2, backward 4), and dense attention's two products over every
    (query, key) pair, 4·B·Hq·D·T² forward and twice that backward, per
    layer. The embedding is a gather and counts nothing."""
    h, q_out = cfg.hidden, cfg.n_heads * cfg.head_dim
    kv_out = cfg.n_kv_heads * cfg.head_dim
    per_layer = h * (q_out + 2 * kv_out) + q_out * h \
        + 3 * h * cfg.intermediate
    matmul_params = cfg.n_layers * per_layer + h * cfg.vocab_size
    attention = 12 * b * cfg.n_heads * cfg.head_dim * t * t * cfg.n_layers
    return 6 * matmul_params * b * t + attention


def phase_train():
    """Training at Llama-3-8B width, ``TRAIN_LAYERS`` layers."""
    from brpc_tpu_torch import optim
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.utils.tree import tree_leaves

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = llama.trainable(llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda"))
    opt = optim.adamw(params, TRAIN_LR)
    step = llama.make_train_step(cfg, opt)
    b, t = TRAIN_BATCH
    tokens = torch.randint(0, cfg.vocab_size, TRAIN_BATCH, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"train: Llama-3-8B width, {cfg.n_layers} of 32 layers, "
          f"{n_params} params ({n_params * 16 / 1e9:.3f} GB of f32 params, "
          f"grads and AdamW moments), batch B={b} T={t}, dense attention, "
          f"AdamW lr {TRAIN_LR} fused={opt.param_groups[0]['fused']}, init "
          f"{time.perf_counter() - t0:.3f} s")

    fa.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for _ in range(1 + TRAIN_STEPS):  # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, tokens)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    timed = seconds[1:]
    median = statistics.median(timed)
    flops = train_flops(cfg, b, t)
    adamw_bytes = ADAMW_BYTES_PER_PARAM * n_params
    flop_ms = 1e3 * flops / PEAK_FLOPS[torch.bfloat16]
    adamw_ms = 1e3 * adamw_bytes / PEAK_BYTES_PER_S
    print(f"train losses (warm-up first): {losses}")
    print(f"train step x{TRAIN_STEPS}: ms median={median * 1e3:.3f} "
          f"min={min(timed) * 1e3:.3f} max={max(timed) * 1e3:.3f} "
          f"warmup={seconds[0] * 1e3:.3f} tokens_per_s median="
          f"{b * t / median:.1f} peak_mem_gb={peak / 1e9:.3f} "
          f"flash_launches={launches}")
    print(f"train step model FLOPs {flops:.4e}: bound {flop_ms:.3f} ms at "
          f"989 TFLOP/s bf16, share of peak {flop_ms / (median * 1e3):.4f}; "
          f"AdamW moves {adamw_bytes / 1e9:.3f} GB ({ADAMW_BYTES_PER_PARAM} "
          f"B a param): {adamw_ms:.3f} ms at 3.35 TB/s")
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(launches == 0, f"{launches} flash launches while training")
    check(peak < TRAIN_PEAK_LIMIT, f"train peak {peak} bytes")
    profile_run(f"train step B={b} T={t} layers={cfg.n_layers}",
                lambda: step(params, tokens))
    return losses[0]


def seeded_table():
    """The shard's initial table, drawn as ``PsShardServer`` draws it for
    shard 0 of 1 (through float64, then scaled and cast)."""
    rng = np.random.default_rng(PS_SEED)
    return (rng.standard_normal((PS_VOCAB, PS_DIM)) * 0.02).astype(
        np.float32)


def zipf_ids(rng, perm, stride=1, offset=0):
    """``PS_K`` ids whose ranks are Zipf-distributed over ``perm``; with a
    stride, moved onto the rows ``id % stride == offset``."""
    ids = perm[(rng.zipf(PS_ZIPF, PS_K) - 1) % PS_VOCAB]
    return (ids - ids % stride + offset).astype(np.int32)


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_ps_kernels(table):
    """K2 and K3 against their plain versions at the shard's full size;
    returns their rows of the kernels line (launches filled in later)."""
    from brpc_tpu_torch.ops import embedding_rows as er

    rng = np.random.default_rng(PS_SEED + 1)
    perm = rng.permutation(PS_VOCAB)
    ids = zipf_ids(rng, perm)
    grads = rng.standard_normal((PS_K, PS_DIM)).astype(np.float32)
    unique = len(np.unique(ids))
    t = torch.from_numpy(table).cuda()
    i, g = torch.from_numpy(ids).cuda(), torch.from_numpy(grads).cuda()
    lr = torch.tensor(np.float32(PS_LR), device="cuda")
    print(f"ps kernels: table {PS_VOCAB}x{PS_DIM} f32 "
          f"({table.nbytes / 1e9:.3f} GB), k={PS_K} Zipf({PS_ZIPF}) ids, "
          f"{unique} distinct, most repeated x"
          f"{np.unique(ids, return_counts=True)[1].max()}, lr {PS_LR}")
    rows = {}

    got = er.gather_rows(t, i)
    want = er.gather_rows_reference(t, i)
    torch.cuda.synchronize()
    check(same_bits(got, want), "gather_rows differs from index_select")
    err = (got - want).abs().max().item()
    del got, want
    turns = in_turns("gather_rows", {
        "library": lambda: t.index_select(0, i),
        "kernel": lambda: er.gather_rows(t, i)}, 50)
    plain_ms, _ = time_ms(lambda: er.gather_rows_reference(t, i), 50)
    nbytes = (unique + PS_K) * PS_DIM * 4 + PS_K * 4
    rows["gather_rows"] = dict(
        max_abs_err=err, ms=turns["kernel"][0], plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
        library_ms=turns["library"][0])

    got = er.scatter_sub(t, i, g, lr)
    want = er.scatter_sub_reference(t, i, g, lr)
    torch.cuda.synchronize()
    check(same_bits(got, want), "scatter_sub differs from its plain version")
    host = table.copy()
    np.subtract.at(host, ids, PS_LR * grads)
    check(got.cpu().numpy().tobytes() == host.tobytes(),
          "scatter_sub differs from np.subtract.at")
    check(same_bits(t, torch.from_numpy(table).cuda()),
          "scatter_sub wrote its input table")
    err = (got - want).abs().max().item()
    del got, want, host
    turns = in_turns("scatter_sub", {
        "library": lambda: t.clone().index_add_(0, i, g, alpha=-PS_LR),
        "copy": lambda: torch.empty_like(t).copy_(t),
        "kernel": lambda: er.scatter_sub(t, i, g, lr)}, 10)
    plain_ms, _ = time_ms(lambda: er.scatter_sub_reference(t, i, g, lr), 2,
                          warmup=1)
    nbytes = 2 * table.nbytes + PS_K * 4 + grads.nbytes + 4
    rows["scatter_sub"] = dict(
        max_abs_err=err, ms=turns["kernel"][0], plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
        library_ms=turns["library"][0], copy_ms=turns["copy"][0])
    scatter_sub_large_bucket(t, perm, rng, lr)
    for name, row in rows.items():
        print(f"{name}: bit-equal max_abs_err={row['max_abs_err']} "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"of_bound={row['bound_ms'] / row['ms']:.4f}"
              + (f" copy_ms={row['copy_ms']:.4f} of_copy="
                 f"{row['copy_ms'] / row['ms']:.4f}" if "copy_ms" in row
                 else ""))
    del t, i, g, lr
    torch.cuda.empty_cache()
    return rows


def scatter_sub_large_bucket(t, perm, rng, lr):
    """K3 at 32 times the bucket (the shard does not cap a bucket's ids):
    bit-equal to its plain version, then timed in turns with the library
    call and the bare copy. Not in the kernels line."""
    from brpc_tpu_torch.ops import embedding_rows as er

    k = 32 * PS_K
    ids = perm[(rng.zipf(PS_ZIPF, k) - 1) % PS_VOCAB].astype(np.int32)
    i = torch.from_numpy(ids).cuda()
    g = torch.randn((k, PS_DIM), device="cuda", generator=torch.Generator(
        "cuda").manual_seed(PS_SEED))
    check(same_bits(er.scatter_sub(t, i, g, lr),
                    er.scatter_sub_reference(t, i, g, lr)),
          f"scatter_sub differs from its plain version at k={k}")
    print(f"scatter_sub k={k}: {len(np.unique(ids))} distinct, most "
          f"repeated x{np.unique(ids, return_counts=True)[1].max()}, "
          "bit-equal to its plain version")
    turns = in_turns(f"scatter_sub k={k}", {
        "library": lambda: t.clone().index_add_(0, i, g, alpha=-PS_LR),
        "copy": lambda: torch.empty_like(t).copy_(t),
        "kernel": lambda: er.scatter_sub(t, i, g, lr)}, 5)
    nbytes = 2 * t.numel() * 4 + k * 4 + g.numel() * 4 + 4
    bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    print(f"scatter_sub k={k}: bound_ms={bound_ms:.4f} (bytes) "
          f"of_bound={bound_ms / turns['kernel'][0]:.4f}")
    del i, g
    torch.cuda.empty_cache()


def phase_ps_serve(table):
    """The device shard serving Llama-3-8B's table over loopback RPC;
    returns the kernels' launches in the one-request-at-a-time stretch."""
    from brpc_tpu_torch import obs
    from brpc_tpu_torch.device import DeviceClient
    from brpc_tpu_torch.ops import embedding_rows as er
    from brpc_tpu_torch.ps_remote import DevicePsShardServer, RemoteEmbedding

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    replay = table.copy()
    dev = DeviceClient()
    t0 = time.perf_counter()
    server = DevicePsShardServer(PS_VOCAB, PS_DIM, 0, 1, lr=PS_LR,
                                 seed=PS_SEED, device_client=dev)
    emb = RemoteEmbedding([server.address], PS_VOCAB, PS_DIM,
                          timeout_ms=600000)
    print(f"ps serve: DevicePsShardServer {PS_VOCAB}x{PS_DIM} f32 in device "
          f"memory, up in {time.perf_counter() - t0:.3f} s, lr {PS_LR}, "
          f"combine off")
    try:
        check(server._dev_serving and server.table.tobytes()
              == replay.tobytes(), "the shard's seeded table differs")
        rng = np.random.default_rng(PS_SEED + 2)
        perm = rng.permutation(PS_VOCAB)
        requests = [(zipf_ids(rng, perm), rng.standard_normal(
            (PS_K, PS_DIM)).astype(np.float32)) for _ in range(PS_PAIRS + 1)]

        def lookup(ids):
            t0 = time.perf_counter()
            rows = emb.lookup(ids)
            seconds = time.perf_counter() - t0
            check(rows.tobytes() == replay[ids].tobytes(),
                  "a Lookup differs from the host replay")
            return seconds

        def apply(ids, grads):
            t0 = time.perf_counter()
            emb.apply_gradients(ids, grads)
            seconds = time.perf_counter() - t0
            np.subtract.at(replay, ids, PS_LR * grads)
            return seconds

        lookup(requests[0][0])  # warm-up: executables, first launches
        apply(*requests[0])
        for kernel in er.launches:
            er.launches[kernel] = 0
        latency = {"Lookup": [], "ApplyGrad": []}
        for ids, grads in requests[1:]:
            for method, fn, kernel in (
                    ("Lookup", lambda: lookup(ids), "gather_rows"),
                    ("ApplyGrad", lambda: apply(ids, grads), "scatter_sub")):
                before = er.launches[kernel]
                latency[method].append(fn())
                check(er.launches[kernel] == before + 1,
                      f"{method}: {er.launches[kernel] - before} launches")
        launches = dict(er.launches)
        check(launches == {"gather_rows": PS_PAIRS, "scatter_sub": PS_PAIRS},
              f"launches {launches}")
        check(server.table.tobytes() == replay.tobytes(),
              "the final table differs from the host replay")
        mb = PS_K * PS_DIM * 4 / 1e6
        for method, secs in latency.items():
            median = statistics.median(secs)
            print(f"ps {method} x{PS_PAIRS} ({mb:.1f} MB each): latency_ms "
                  f"median={median * 1e3:.3f} min={min(secs) * 1e3:.3f} "
                  f"max={max(secs) * 1e3:.3f} MB_per_s median="
                  f"{mb / median:.1f} launches_each=1")
        print(f"ps serve: {PS_PAIRS} Lookups and {PS_PAIRS} ApplyGrads "
              f"bit-equal to the host replay, final table bit-equal, "
              f"launches {launches}, peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        ids, grads = requests[1]
        request_split(dev, er, "Lookup", lambda: lookup(ids))
        request_split(dev, er, "ApplyGrad", lambda: apply(ids, grads))
        serve_concurrently(server, emb, replay, RemoteEmbedding, obs, er)
    finally:
        emb.close()
        server.close()
    live = dev.live()
    dev.close()
    check(not live, f"device buffers live after close: {live}")
    print("ps serve: no device buffer live after close")
    return launches


def request_split(dev, er, method, fn):
    """One request's host time split between staging, the kernel (the
    wrapper's call and a synchronize), the fetch and the rest: RPC, the
    client's and the handler's host work. ``fn`` returns the request's
    seconds, its checks left out. The kernel's share of the request, and
    the share of staging, kernel and fetch together (the time the device
    or its copy engines work for the request), stand in for the device's
    busy share: the profiler does not see the kernels that the shard's
    handler threads launch."""
    spent = {"stage": 0.0, "kernel": 0.0, "fetch": 0.0}

    def timed(what, call):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = call(*args, **kwargs)
            torch.cuda.synchronize()
            spent[what] += time.perf_counter() - t0
            return out
        return run

    saved = er.gather_rows, er.scatter_sub
    dev.stage, dev.fetch = timed("stage", dev.stage), timed(
        "fetch", dev.fetch)
    er.gather_rows, er.scatter_sub = (timed("kernel", f) for f in saved)
    try:
        total = fn()
    finally:
        del dev.stage, dev.fetch
        er.gather_rows, er.scatter_sub = saved
    rest = total - sum(spent.values())
    print(f"ps {method} split: total_ms={total * 1e3:.3f} " + " ".join(
        f"{k}_ms={v * 1e3:.3f}" for k, v in spent.items())
        + f" rpc_and_host_ms={rest * 1e3:.3f} kernel_share="
        f"{spent['kernel'] / total:.4f} device_share="
        f"{sum(spent.values()) / total:.4f}")


def serve_concurrently(server, emb, replay, remote_embedding, obs, er):
    """``PS_THREADS`` clients at once, each mixing Lookups and ApplyGrads
    on its own rows (ids congruent to its index mod ``PS_THREADS``): every
    row has one writer, so the replay does not depend on the order in
    which the shard installs the threads' tables. Each Lookup must equal
    the thread's replay; the final table must equal the replay."""
    wasted0 = obs.counter("ps_device_wasted_launches").get_value()
    before = dict(er.launches)
    errors = []

    def client(n):
        rng = np.random.default_rng(PS_SEED + 10 + n)
        perm = rng.permutation(PS_VOCAB)
        mine = remote_embedding([server.address], PS_VOCAB, PS_DIM,
                                timeout_ms=600000)
        try:
            for _ in range(PS_THREAD_PAIRS):
                ids = zipf_ids(rng, perm, PS_THREADS, n)
                if mine.lookup(ids).tobytes() != replay[ids].tobytes():
                    errors.append(f"thread {n}: a Lookup differs")
                grads = rng.standard_normal((PS_K, PS_DIM)).astype(
                    np.float32)
                mine.apply_gradients(ids, grads)
                np.subtract.at(replay, ids, PS_LR * grads)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"thread {n}: {e!r}")
        finally:
            mine.close()

    threads = [threading.Thread(target=client, args=(n,))
               for n in range(PS_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    seconds = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "a client hung")
    check(not errors, "; ".join(errors))
    check(server.table.tobytes() == replay.tobytes(),
          "the table after the concurrent stretch differs from the replay")
    wasted = obs.counter("ps_device_wasted_launches").get_value() - wasted0
    gathers = er.launches["gather_rows"] - before["gather_rows"]
    scatters = er.launches["scatter_sub"] - before["scatter_sub"]
    n = PS_THREADS * PS_THREAD_PAIRS
    check(gathers == n and scatters == n + wasted,
          f"concurrent launches: {gathers} gathers, {scatters} scatters, "
          f"{wasted} wasted, {n} requests of each")
    print(f"ps concurrent: {PS_THREADS} threads x {PS_THREAD_PAIRS} "
          f"Lookup/ApplyGrad pairs in {seconds:.3f} s, ledger exact, "
          f"ps_device_wasted_launches={wasted}, launches gather={gathers} "
          f"scatter={scatters}, peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")


def phase_ps_collective(table, card):
    """The collective PS tier on an NCCL world of one; returns the kernels'
    launches on its main run (lookup, apply, train steps)."""
    import torch.distributed as dist

    from brpc_tpu_torch.parallel import init_world

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="ps-world-") as store:
        t0 = time.perf_counter()
        init_world(store, 0, 1, "cuda")
        try:
            return ps_collective(table, card, time.perf_counter() - t0)
        finally:
            dist.destroy_process_group()


def ps_collective(table, card, init_s):
    import torch.distributed as dist

    from brpc_tpu_torch import ps
    from brpc_tpu_torch.models.convert import embedding_from_reference
    from brpc_tpu_torch.ops import embedding_rows as er
    from brpc_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"ps": 1})
    emb = embedding_from_reference(table, PS_VOCAB, PS_DIM, "ps", mesh)
    rng = np.random.default_rng(PS_SEED + 3)
    ids_np = zipf_ids(rng, rng.permutation(PS_VOCAB)).reshape(1, PS_K)
    grads_np = rng.standard_normal((1, PS_K, PS_DIM)).astype(np.float32)
    ids, grads = torch.from_numpy(ids_np).cuda(), torch.from_numpy(
        grads_np).cuda()
    targets = torch.zeros((1, PS_K, PS_DIM), device="cuda")
    print(f"ps collective: NCCL world of {dist.get_world_size()} up in {init_s:.3f} "
          f"s, mesh {tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)}, table "
          f"{PS_VOCAB}x{PS_DIM} f32 row-sharded over 'ps', ids (1, {PS_K}) "
          f"Zipf({PS_ZIPF}), {len(np.unique(ids_np))} distinct, lr {PS_LR}, "
          f"MSE to zero targets")
    step = ps.make_ps_train_step("ps", "dp", mesh, PS_LR)

    for kernel in er.launches:
        er.launches[kernel] = 0
    rows = ps.lookup(emb, ids, mesh)
    torch.cuda.synchronize()
    check(er.launches == {"gather_rows": 1, "scatter_sub": 0},
          f"lookup launches {er.launches}")
    new = ps.apply_gradients(emb, ids, grads, mesh, lr=PS_LR).table
    torch.cuda.synchronize()
    check(er.launches == {"gather_rows": 1, "scatter_sub": 1},
          f"apply_gradients launches {er.launches}")
    losses, state, first = [], emb, None
    for _ in range(PS_TRAIN_STEPS):
        state, loss = step(state, ids, targets)
        losses.append(loss.item())
        if first is None:
            first = state.table.to_local().cpu().numpy()
    launches = dict(er.launches)
    want = {"gather_rows": 1 + PS_TRAIN_STEPS,
            "scatter_sub": 1 + PS_TRAIN_STEPS}
    check(launches == want, f"ps collective launches {launches}, want {want}")
    del state

    check(rows.cpu().numpy().tobytes() == table[ids_np].tobytes(),
          "ps.lookup differs from the host's table[ids]")
    host = table.copy()
    np.subtract.at(host, ids_np.ravel(),
                   np.float32(PS_LR) * grads_np.reshape(-1, PS_DIM))
    check(new.to_local().cpu().numpy().tobytes() == host.tobytes(),
          "ps.apply_gradients differs from np.subtract.at")
    del rows, new, host
    print(f"ps collective: lookup bit-equal to table[ids], apply_gradients "
          f"bit-equal to np.subtract.at; main run launches {launches}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"ps train losses {losses}")
    err, differ = ps_step_replay(table, ids_np, first)
    del first
    print(f"ps collective: {PS_TRAIN_STEPS} train steps, losses "
          f"{' '.join(f'{x:.9g}' for x in losses)}; first step's table "
          f"against the host replay max_abs_err={err:.3e}, {differ} "
          f"elements differ (rtol {PS_STEP_RTOL})")
    backward_against_plain(emb, ids, mesh)
    channel_ops(mesh)
    timed = {
        "lookup": lambda: ps.lookup(emb, ids, mesh),
        "apply_gradients": lambda: ps.apply_gradients(
            emb, ids, grads, mesh, lr=PS_LR),
        "train_step": lambda: step(emb, ids, targets)}
    medians = {}
    for name, fn in timed.items():
        fn()
        torch.cuda.synchronize()
        seconds = []
        for _ in range(PS_TIMED_CALLS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        medians[name] = (statistics.median(seconds), min(seconds),
                         max(seconds))
    print(f"ps collective on {card}: " + " ".join(
        f"{name}_ms median={m * 1e3:.3f} min={lo * 1e3:.3f} "
        f"max={hi * 1e3:.3f}" for name, (m, lo, hi) in medians.items())
        + f" ({PS_TIMED_CALLS} calls each) peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    for name, fn in timed.items():
        profile_run(f"ps collective {name}", fn)
    return launches


def ps_step_replay(table, ids_np, got):
    """The first train step on the host in f32: the MSE's gradient as
    torch rounds it (1/N times 2·(pred - 0)), summed into each row in batch
    order, then the table less lr times it. Returns (max |got - want|, the
    number of elements that differ)."""
    pred = table[ids_np.ravel()]
    n = np.float32(1.0 / pred.size)
    grad = np.zeros_like(table)
    np.add.at(grad, ids_np.ravel(), n * (np.float32(2.0) * pred))
    want = table - np.float32(PS_LR) * grad
    err = float(np.abs(got - want).max())
    differ = int(np.count_nonzero(got != want))
    check(np.allclose(got, want, rtol=PS_STEP_RTOL, atol=0.0),
          f"first train step: max |err| {err} beyond rtol {PS_STEP_RTOL}")
    return err, differ


def backward_against_plain(emb, ids, mesh):
    """``lookup``'s backward is K3 on a zero shard with lr = -1: that call
    against K3's plain version on the same inputs, bit for bit (not in the
    main run's counts)."""
    from brpc_tpu_torch import ps
    from brpc_tpu_torch.ops import embedding_rows as er

    table = emb.table.detach().requires_grad_(True)
    g = torch.randn((1, PS_K, PS_DIM), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(PS_SEED))
    (got,) = torch.autograd.grad(ps.lookup(
        emb._replace(table=table), ids, mesh), table, g)
    got = got.to_local()
    want = er.scatter_sub_reference(
        torch.zeros_like(got), ids.reshape(-1),
        g.reshape(PS_K, PS_DIM).contiguous(),
        torch.tensor(-1.0, device="cuda"))
    torch.cuda.synchronize()
    check(same_bits(got, want),
          "lookup's backward (K3, lr -1) differs from its plain version")
    print("ps collective: lookup's backward (K3 on a zero shard, lr -1) "
          "bit-equal to K3's plain version")


def channel_ops(mesh):
    """Each ``CollectiveChannel`` op on the card against its definition on
    a world of one, then ``allreduce_benchmark``."""
    from brpc_tpu_torch.parallel import CollectiveChannel, allreduce_benchmark

    chan = CollectiveChannel(mesh, "ps")
    x = torch.arange(64, dtype=torch.float32, device="cuda").reshape(8, 8)
    cases = {
        **{f"all_reduce_{op}": (chan.all_reduce(x, op), x.sum(0))
           for op in ("sum", "max", "min")},
        "all_reduce_inplace": (chan.all_reduce_inplace(x), x),
        "all_gather": (chan.all_gather(x), x),
        "reduce_scatter": (chan.reduce_scatter(x).full_tensor(), x),
        "broadcast": (chan.broadcast(x, 0), x),
        "shift": (chan.shift(x, 1).full_tensor(), x),
        "map_reduce": (chan.map_reduce(lambda s: (s * 2).sum(), x),
                       (x * 2).sum())}
    for name, (got, want) in cases.items():
        check(torch.equal(got, want), f"CollectiveChannel.{name} on the card")
    bench = allreduce_benchmark(mesh, "ps", size_mb=ALLREDUCE_MB)
    print(f"ps collective: CollectiveChannel {sorted(cases)} equal their "
          f"definitions on a world of {chan.num_channels}; "
          f"allreduce_benchmark {ALLREDUCE_MB} MB: world_size="
          f"{bench['world_size']} devices={bench['devices']} bytes="
          f"{bench['bytes']} ms={bench['seconds'] * 1e3:.4f} "
          f"gbps_per_chip={bench['gbps_per_chip']} (0 by construction on "
          f"one rank: not a link speed)")


def phase_model_parallel(card, dense_loss):
    """The model-parallel tier on an NCCL world of one (``dense_loss``:
    phase 7's first loss, on the params and batch of (b)); returns the
    kernels' launches over the whole phase (all 0: no kernel of the
    repo is on these paths)."""
    import torch.distributed as dist

    from brpc_tpu_torch.ops import embedding_rows as er
    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.parallel import init_world

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mp-world-") as store:
        init_world(store, 0, 1, "cuda")
        try:
            fa.launches = 0
            for kernel in er.launches:
                er.launches[kernel] = 0
            mp_dryrun()
            mp_sharded_train(card, dense_loss)
            mp_moe()
            mp_pipeline_and_attention()
            launches = {"flash_attention": fa.launches, **er.launches}
        finally:
            dist.destroy_process_group()
    check(not any(launches.values()),
          f"kernel launches on the model-parallel paths: {launches}")
    print(f"model parallel: kernel launches {launches}")
    return launches


def mp_dryrun():
    from brpc_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    line = dryrun_multichip(1)
    print(f"model parallel: dryrun_multichip(1) passed its gates in "
          f"{time.perf_counter() - t0:.3f} s")
    check(line.startswith("dryrun_multichip(1): mesh={'dp': 1, 'tp': 1, "
                          "'sp': 1} loss="), f"dry run summary {line!r}")


def mp_sharded_train(card, dense_loss):
    """The sharded step at Llama-3-8B width, ``TRAIN_LAYERS`` layers, on
    a (dp, tp, sp) = (1, 1, 1) mesh with ring attention. First its loss
    and every gradient at f32 compute against the unsharded step's on the
    same seeded params (run first; its gradients kept, its params freed);
    then the bf16 step, its first loss against phase 7's ``dense_loss``,
    timed and profiled."""
    from brpc_tpu_torch import optim
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.parallel import (PartitionSpec, make_mesh,
                                         ring_attention, shard_batch,
                                         shard_params, tensor_parallel)
    from brpc_tpu_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=TRAIN_LAYERS)
    b, t = TRAIN_BATCH
    tokens = torch.randint(0, cfg.vocab_size, TRAIN_BATCH, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    mesh = make_mesh({"tp": 1, "sp": 1})
    batch = shard_batch(tokens, PartitionSpec("dp", "sp"), mesh)

    def ring(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, axis="sp", head_axis="tp")

    def sharded(c):
        return llama.trainable(shard_params(llama.init_params(
            c, generator=torch.Generator(device="cuda").manual_seed(0),
            device="cuda"), llama.param_specs(c), mesh))

    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = llama.trainable(llama.init_params(
        f32, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda"))
    loss = llama.loss_fn(params, tokens, f32)
    loss.backward()
    want_loss, want = loss.item(), [p.grad for p in tree_leaves(params)]
    del params, loss
    torch.cuda.empty_cache()
    params = sharded(f32)
    got_loss = tensor_parallel.loss_and_grads(params, batch, f32,
                                              ring).item()
    errs = [(torch.linalg.vector_norm(p.grad.to_local() - w)
             / torch.linalg.vector_norm(w)).item()
            for p, w in zip(tree_leaves(params), want)]
    del params, want
    torch.cuda.empty_cache()
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    print(f"sharded train f32: Llama-3-8B width, {cfg.n_layers} of 32 "
          f"layers, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, ring "
          f"attention over sp with heads over tp, batch B={b} T={t}, against "
          f"the unsharded step: loss {got_loss} against {want_loss} (rel "
          f"{loss_rel:.3e}), gradients' relative L2 error per leaf "
          f"{' '.join(f'{e:.3e}' for e in errs)} (bound {MP_GRAD_REL})")
    check(loss_rel <= MP_GRAD_REL, f"sharded f32 loss {got_loss} against "
          f"{want_loss}")
    check(max(errs) <= MP_GRAD_REL, f"sharded gradients differ: {errs}")

    torch.cuda.reset_peak_memory_stats()
    params = sharded(cfg)
    torch.cuda.empty_cache()
    step = llama.make_train_step(cfg, optim.adamw(params, TRAIN_LR), ring)
    losses, seconds = [], []
    for _ in range(1 + TRAIN_STEPS):  # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    loss_err = abs(losses[0] - dense_loss) / abs(dense_loss)
    print(f"sharded train bf16, AdamW lr {TRAIN_LR}: first loss "
          f"{losses[0]} against the dense step's {dense_loss} (rel "
          f"{loss_err:.3e}, bound {MP_LOSS_TOL})")
    check(loss_err <= MP_LOSS_TOL,
          f"sharded loss {losses[0]} against {dense_loss}")
    timed = seconds[1:]
    median = statistics.median(timed)
    flops = train_flops(cfg, b, t)
    flop_ms = 1e3 * flops / PEAK_FLOPS[torch.bfloat16]
    print(f"sharded train losses (warm-up first): {losses}")
    print(f"sharded train step x{TRAIN_STEPS} on {card}: ms median="
          f"{median * 1e3:.3f} min={min(timed) * 1e3:.3f} "
          f"max={max(timed) * 1e3:.3f} warmup={seconds[0] * 1e3:.3f} "
          f"tokens_per_s median={b * t / median:.1f} peak_mem_gb="
          f"{peak / 1e9:.3f} flop_share={flop_ms / (median * 1e3):.4f}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"sharded loss did not fall: {losses}")
    check(peak < TRAIN_PEAK_LIMIT, f"sharded train peak {peak} bytes")
    profile_run(f"sharded train step B={b} T={t} layers={cfg.n_layers}",
                lambda: step(params, batch))
    del params, step
    torch.cuda.empty_cache()


def mp_moe():
    """``moe_layer`` forward and backward at the flagship's widths on
    ep=1, bf16 compute on f32 master weights; then the dry run's MoE
    shape on the card against the CPU at f32."""
    from brpc_tpu_torch.models import llama, moe
    from brpc_tpu_torch.parallel import make_mesh, shard_params

    mesh = make_mesh({"ep": 1})
    cfg = moe.MoeConfig(hidden=MOE_HIDDEN, intermediate=MOE_INTERMEDIATE,
                        n_experts=MOE_EXPERTS, capacity_factor=2.0)
    torch.cuda.reset_peak_memory_stats()
    params = llama.trainable(shard_params(moe.init_moe_params(
        cfg, generator=torch.Generator("cuda").manual_seed(0)),
        moe.moe_param_specs(), mesh))
    x = torch.randn((1, MOE_TOKENS, MOE_HIDDEN), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))

    def fwd_bwd():
        out, aux = moe.moe_layer(params, x, cfg)
        loss = torch.mean(out ** 2) + 0.01 * aux
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss, grads

    loss, grads = fwd_bwd()  # warm-up
    check(math.isfinite(loss.item()) and all(
        bool(torch.isfinite(g.to_local()).all()) for g in grads),
          "MoE loss or gradients not finite")
    del grads
    seconds = []
    for _ in range(MOE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    cap = max(1, int(cfg.capacity_factor * MOE_TOKENS / MOE_EXPERTS))
    print(f"moe: hidden {MOE_HIDDEN} intermediate {MOE_INTERMEDIATE} "
          f"{MOE_EXPERTS} experts, top-1, capacity {cap} a expert, "
          f"{MOE_TOKENS} tokens, bf16 compute, ep=1: forward+backward x"
          f"{MOE_STEPS} ms median={statistics.median(seconds) * 1e3:.3f} "
          f"min={min(seconds) * 1e3:.3f} max={max(seconds) * 1e3:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} "
          f"loss={loss.item():.6f}")
    del params, x, loss
    torch.cuda.empty_cache()

    small = moe.MoeConfig(hidden=64, intermediate=128, n_experts=4,
                          dtype=torch.float32)
    init = moe.init_moe_params(small, generator=torch.Generator()
                               .manual_seed(1), device="cpu")
    results = {}
    for device in ("cuda", "cpu"):
        p = {k: v.to(device, copy=True).requires_grad_(True)
             for k, v in init.items()}
        out, aux = moe.moe_layer(p, torch.ones((2, 16, 64), device=device),
                                 small)
        grads = torch.autograd.grad(torch.mean(out ** 2) + 0.01 * aux,
                                    list(p.values()))
        results[device] = [out, aux, *grads]
    err = max((a.cpu() - b).abs().max().item()
              for a, b in zip(results["cuda"], results["cpu"]))
    print(f"moe: the dry run's shape (hidden 64, intermediate 128, 4 "
          f"experts, f32) on the card against the CPU, output, aux and "
          f"gradients max |err| {err:.3e} (bound {MP_SMALL_TOL})")
    check(err <= MP_SMALL_TOL, f"MoE card against CPU: {err}")


def mp_pipeline_and_attention():
    """``pipeline_apply`` at pp=1 on the card against the CPU, then ring
    and Ulysses attention at sp=1 and Llama-3-8B's heads against dense
    attention, f32."""
    from brpc_tpu_torch.models import llama
    from brpc_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                         ring_attention, ulysses_attention)
    from brpc_tpu_torch.parallel.pipeline import pipeline_apply_local

    gen = torch.Generator().manual_seed(2)
    w = torch.randn((1, 16, 16), generator=gen) * 0.3
    x = torch.randn((16, 16), generator=gen)

    def stage(p, m):
        return torch.tanh(m @ p)

    got = pipeline_apply(stage, w.cuda(), x.cuda(), mesh=make_mesh({"pp": 1}),
                         axis="pp", microbatches=8).full_tensor().cpu()
    want = pipeline_apply_local(stage, w[0], x, None, 0, 8)
    err = (got - want).abs().max().item()
    print(f"pipeline: pp=1, 8 microbatches, card against CPU max |err| "
          f"{err:.3e} (bound {MP_SMALL_TOL})")
    check(err <= MP_SMALL_TOL and torch.allclose(
        want, torch.tanh(x @ w[0])), f"pipeline card against CPU: {err}")

    b, t = TRAIN_BATCH
    gen = torch.Generator("cuda").manual_seed(3)
    q, k, v = (torch.randn((b, t, h, D), generator=gen, device="cuda")
               for h in (HQ, HKV, HKV))
    mesh = make_mesh({"sp": 1})
    for causal in (True, False):
        dense = llama.attention(q, k, v, causal=causal)
        for name, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention)):
            got = fn(q, k, v, mesh=mesh, axis="sp", causal=causal)
            err = (got.to_local() - dense).abs().max().item()
            print(f"{name}_attention sp=1 causal={causal} B={b} T={t} "
                  f"Hq={HQ} Hkv={HKV} D={D} f32: against dense max |err| "
                  f"{err:.3e} (bound {MP_ATTN_TOL})")
            check(err <= MP_ATTN_TOL, f"{name} against dense: {err}")
    del q, k, v
    torch.cuda.empty_cache()


def fabric_draw(rng, n, specials=True):
    """``[n]`` f32 normals with -0.0 and subnormals (and, with
    ``specials``, +-inf and NaN) planted at seeded positions, about one
    plant in 40 floats, at least one."""
    x = rng.standard_normal(n, dtype=np.float32)
    plants = FABRIC_SPECIALS if specials else FABRIC_SPECIALS[:3]
    count = min(n, len(plants) * -(-n // 240))
    x[rng.choice(n, count, replace=False)] = np.resize(plants, count)
    return x


def same_floats(got, want):
    """Bit for bit, except that any NaN equals any NaN (the card's
    arithmetic makes its canonical NaN; x86 keeps an operand's payload)."""
    nan = np.isnan(want)
    return got.shape == want.shape and np.array_equal(np.isnan(got), nan) \
        and got[~nan].tobytes() == want[~nan].tobytes()


def within_ulp(got, want64):
    """``got`` (f32) within one f32 ulp of the f64 ``want64``; NaN where it
    is NaN, the same inf where it is inf."""
    if np.isnan(want64) or np.isinf(want64):
        return bool(np.isnan(got)) if np.isnan(want64) else got == want64
    want = np.float32(want64)
    return abs(float(got) - float(want64)) <= float(np.spacing(abs(want)))


def fabric_replicas():
    """Every power of two up to the card count."""
    return [r for r in (1, 2, 4, 8) if r <= torch.cuda.device_count()]


def phase_device_fabric():
    """Phase 11; returns (every kernel's launches on the fabric's main
    drive, the four fabric kernels' rows of the kernels line)."""
    from brpc_tpu_torch.ops import device_programs as dp
    from brpc_tpu_torch.ops import embedding_rows as er
    from brpc_tpu_torch.ops import flash_attention as fa

    counts = fabric_replicas()
    rng = np.random.default_rng(FABRIC_SEED)
    inputs = {n: ([fabric_draw(rng, n) for _ in range(max(counts[-1], 2))],
                  fabric_draw(rng, n, specials=False))
              for n in FABRIC_SIZES}
    print(f"device fabric: {torch.cuda.device_count()} cards, replicas "
          f"{counts}, n {list(FABRIC_SIZES)}")
    torch.cuda.empty_cache()
    fa.launches = 0
    for table in (er.launches, dp.launches):
        for kernel in table:
            table[kernel] = 0
    t0 = time.perf_counter()
    expected = fabric_drive(inputs, counts)
    launches = {"flash_attention": fa.launches, **er.launches,
                **dp.launches}
    print(f"device fabric: main drive {time.perf_counter() - t0:.3f} s, "
          f"kernel launches {launches}")
    check(launches == {**{k: 0 for k in launches}, **expected},
          f"fabric launches {launches}, want {expected}")
    rows = {}
    for n in FABRIC_SIZES:
        for r in counts:
            rows.update(fabric_kernels(inputs[n], n, r))
    del inputs
    torch.cuda.empty_cache()
    # add and reduce_sum run on one replica; the collectives' row is at
    # the most replicas of the run
    return launches, {kind: rows[(kind, FABRIC_MAIN_N, counts[-1] if kind
                                  in ("all_reduce_sum", "all_gather")
                                  else 1)] for kind in FABRIC_KINDS}


def fabric_drive(inputs, counts):
    """The fabric's main path: each program through ``DeviceClient`` at
    every size and replica count, each result against its host replay;
    returns the launches it must have made."""
    from brpc_tpu_torch.device import DeviceClient

    expected = dict.fromkeys(FABRIC_KINDS, 0)
    dev = DeviceClient()

    def run(kind, n, replicas, arrays):
        staged = [[dev.stage(a, device_index=d) for a in ops]
                  for d, ops in enumerate(arrays)]
        exe = dev.compile(dev.mlir(kind, n, replicas), replicas)
        outs = exe.execute([h for ops in staged for h in ops], replicas)
        got = [np.frombuffer(dev.fetch(h), np.float32) for (h,) in outs]
        for h in [h for (h,) in outs] + [h for ops in staged for h in ops]:
            dev.release(h)
        exe.close()
        expected[kind] += replicas
        return got

    try:
        for n in FABRIC_SIZES:
            fabric_check_size(run, n, *inputs[n], counts)
        check(dev.live() == [], f"buffers live before close: {dev.live()}")
    finally:
        dev.close()
    check(dev.live() == [], "buffers live after close")
    return expected


@np.errstate(invalid="ignore")  # inf - inf in the replays, as on the card
def fabric_check_size(run, n, xs, finite, counts):
    (got,) = run("add", n, 1, [(xs[0], xs[1])])
    check(same_floats(got, xs[0] + xs[1]),
          f"add n={n} differs from the host's a + b")
    for x, what in ((xs[0], "planted"), (finite, "finite")):
        (got,) = run("reduce_sum", n, 1, [(x,)])
        want = np.sum(x, dtype=np.float64)
        check(got.shape == (1,) and within_ulp(got[0], want),
              f"reduce_sum n={n} {what}: {got} against the f64 sum {want}")
    for r in counts:
        want = np.zeros(n, np.float32)
        for x in xs[:r]:
            want = want + x  # in replica order from +0.0
        got = run("all_reduce_sum", n, r, [(x,) for x in xs[:r]])
        check(all(g.tobytes() == got[0].tobytes() for g in got),
              f"all_reduce_sum n={n} R={r}: replicas differ")
        check(same_floats(got[0], want),
              f"all_reduce_sum n={n} R={r} differs from the ordered host sum")
        if r == 1:
            check(not np.signbit(got[0][xs[0] == 0]).any(),
                  "all_reduce_sum R=1 kept a -0.0")
        got = run("all_gather", n, r, [(x,) for x in xs[:r]])
        want = np.concatenate(xs[:r])
        check(all(g.tobytes() == want.tobytes() for g in got),
              f"all_gather n={n} R={r} differs from the host's "
              f"concatenation")
    print(f"device fabric n={n}: add, reduce_sum (planted, finite), "
          f"all_reduce_sum and all_gather at R={counts} equal their host "
          f"replays; every replica the same bytes")


def fabric_kernels(inputs, n, r):
    """Each fabric kernel at size n and r replicas against its plain
    version on the card, timed in turns with its library call; returns
    their rows by (kind, n, r). add and reduce_sum run at r = 1 only."""
    from brpc_tpu_torch.device import DeviceClient
    from brpc_tpu_torch.ops import device_programs as dp

    xs, finite = inputs
    ts = [torch.from_numpy(x).to(f"cuda:{d}") for d, x in enumerate(xs[:r])]
    devices = list(range(r))
    rows = {}

    def compare(got, want):
        got, want = got.cpu().numpy(), want.cpu().numpy()
        check(same_floats(got, want),
              f"n={n} R={r}: kernel against plain version")
        finite_at = np.isfinite(want)
        return float(np.abs(got[finite_at].astype(np.float64)
                            - want[finite_at]).max(initial=0.0))

    def host_execute_ms(kind, arrays):
        dev = DeviceClient()
        try:
            staged = [dev.stage(a, device_index=d)
                      for d, ops in enumerate(arrays) for a in ops]
            exe = dev.compile(dev.mlir(kind, n, len(arrays)), len(arrays))
            samples = []
            for _ in range(FABRIC_EXECUTES + 1):
                t0 = time.perf_counter()
                outs = exe.execute(staged, len(arrays))
                samples.append(1e3 * (time.perf_counter() - t0))
                for (h,) in outs:
                    dev.release(h)
            exe.close()
            return statistics.median(samples[1:])
        finally:
            dev.close()

    def row(kind, err, turns, plain, nbytes, link_bytes, host_ms):
        bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                             link_bytes / NVLINK_BYTES_PER_S)
        ms, lo, hi = turns["kernel"]
        rows[(kind, n, r)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_ms,
            bound_by="bytes", library_ms=turns["library"][0], replicas=r,
            n=n, execute_host_ms=host_ms)
        print(f"{kind} n={n} R={r}: max_abs_err={err:.3e} ms={ms:.4f} "
              f"({lo:.4f}-{hi:.4f}) plain_ms={plain:.4f} library_ms="
              f"{turns['library'][0]:.4f} bound_ms={bound_ms:.4f} (bytes) "
              f"of_bound={bound_ms / ms:.4f} execute_host_ms={host_ms:.4f}")

    iters = 50 if n <= FABRIC_MAIN_N else 10
    if r == 1:
        a, b = ts[0], torch.from_numpy(xs[1]).cuda()
        fin = torch.from_numpy(finite).cuda()
        err = compare(dp.add(a, b), dp.add_reference(a, b))
        turns = in_turns(f"add n={n}", {
            "library": lambda: torch.add(a, b),
            "kernel": lambda: dp.add(a, b)}, iters)
        plain, _ = time_ms(lambda: dp.add_reference(a, b), iters)
        row("add", err, turns, plain, 3 * 4 * n, 0,
            host_execute_ms("add", [(xs[0], xs[1])]))
        got = dp.reduce_sum(fin)
        check(torch.equal(got, dp.reduce_sum(fin)),
              f"reduce_sum n={n}: two launches differ")
        want = dp.reduce_sum_reference(fin)
        check(within_ulp(got.item(), want.double().item()),
              f"reduce_sum n={n}: {got.item()} against plain {want.item()}")
        turns = in_turns(f"reduce_sum n={n}", {
            "library": lambda: torch.sum(fin),
            "kernel": lambda: dp.reduce_sum(fin)}, iters)
        plain, _ = time_ms(lambda: dp.reduce_sum_reference(fin), iters)
        row("reduce_sum", abs(got.item() - want.item()), turns, plain,
            4 * n + 4, 0, host_execute_ms("reduce_sum", [(finite,)]))
        del a, b, fin

    # the collectives: NCCL's in place on copies of the inputs
    copies = [t.clone() for t in ts]
    gathered = [torch.empty(r * n, device=t.device) for t in ts]
    if r == 1:
        library = {"all_reduce_sum": lambda: ts[0].clone(),
                   "all_gather": lambda: ts[0].clone()}
    else:
        import torch.cuda.nccl as nccl
        library = {"all_reduce_sum": lambda: nccl.all_reduce(copies),
                   "all_gather": lambda: nccl.all_gather(ts, gathered)}
    links = {"all_reduce_sum": 2 * (r - 1) / r * 4 * n,
             "all_gather": (r - 1) * 4 * n}
    hbm = {"all_reduce_sum": 2 * 4 * n, "all_gather": (r + 1) * 4 * n}
    for kind in ("all_reduce_sum", "all_gather"):
        kernel = getattr(dp, kind)
        plain_fn = getattr(dp, f"{kind}_reference")
        got = kernel(ts)
        for d in devices:
            torch.cuda.synchronize(d)
        check(all(torch.equal(g.view(torch.int32).cpu(),
                              got[0].view(torch.int32).cpu())
                  for g in got), f"{kind} n={n} R={r}: replicas differ")
        want = plain_fn(ts)
        err = max(compare(g, w) for g, w in zip(got, want))
        del got, want
        turns = in_turns(f"{kind} n={n} R={r}", {
            "library": library[kind], "kernel": lambda: kernel(ts)},
            iters, devices=devices)
        plain, _ = time_ms(lambda: plain_fn(ts), max(iters // 10, 2),
                           devices=devices)
        row(kind, err, turns, plain, hbm[kind], links[kind],
            host_execute_ms(kind, [(x,) for x in xs[:r]]))
    del ts, copies, gathered
    return rows


def fabric_line(fabric_rows, fabric_launches):
    """The fabric's four rows of the kernels line."""
    source = "brpc_tpu_torch/csrc/device_programs.cu"
    lines = {"add": 54, "reduce_sum": 64, "all_reduce_sum": 76,
             "all_gather": 87}
    designs = {
        "add": "StableHLO device program, not Pallas; one grid-stride "
               "pass, float4 where aligned",
        "reduce_sum": "StableHLO device program, not Pallas; f64 per "
                      "thread, fixed-order block trees, two passes",
        "all_reduce_sum": "StableHLO device program, not Pallas; one-shot: "
                          "each replica reads every input over peer "
                          "access and sums in replica order",
        "all_gather": "StableHLO device program, not Pallas; each replica "
                      "copies every input over peer access"}
    return [{
        "name": kind, "route": "cuda", "source": source,
        "replaces": f"cpp/device/pjrt_executable.cc:{lines[kind]}",
        "design": designs[kind], "launches": fabric_launches[kind],
        "launches_by_path": {"device_fabric": fabric_launches[kind]},
        **fabric_rows[kind]} for kind in FABRIC_KINDS]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # f32 products in full f32: the plain versions are the yardstick.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cudnn")

    card = phase_build()
    rows = phase_kernels()
    t0 = time.perf_counter()
    table = seeded_table()
    print(f"ps: seeded table drawn on the host in "
          f"{time.perf_counter() - t0:.3f} s")
    ps_rows = phase_ps_kernels(table)
    phase_tiny()
    launches = phase_serve()
    phase_tiny_train()
    dense_loss = phase_train()
    ps_launches = phase_ps_serve(table)
    collective = phase_ps_collective(table, card)
    model_parallel = phase_model_parallel(card, dense_loss)
    fabric, fabric_rows = phase_device_fabric()

    b, t = REQUESTS[0]
    row = rows[(b, t, torch.bfloat16, True)]
    source = "brpc_tpu_torch/csrc/embedding_rows.cu"
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "brpc_tpu_torch/csrc/flash_attention.cu",
        "replaces": "brpc_tpu/ops/flash_attention.py:71",
        "design": "wgmma+tma, split-p", "launches": launches,
        "launches_by_path": {"serve": launches, "model_parallel":
                             model_parallel["flash_attention"],
                             "device_fabric": fabric["flash_attention"]},
        **row}, {
        "name": "gather_rows", "route": "cuda", "source": source,
        "replaces": "cpp/device/pjrt_executable.cc:100",
        "design": "StableHLO device program, not Pallas; a block per id",
        "launches": ps_launches["gather_rows"] + collective["gather_rows"],
        "launches_by_path": {"ps_serve": ps_launches["gather_rows"],
                             "ps_collective": collective["gather_rows"],
                             "model_parallel": model_parallel["gather_rows"],
                             "device_fabric": fabric["gather_rows"]},
        **ps_rows["gather_rows"]}, {
        "name": "scatter_sub", "route": "cuda", "source": source,
        "replaces": "cpp/device/pjrt_executable.cc:121",
        "design": "StableHLO device program, not Pallas; one pass over "
                  "the table in 32 KB tiles, ids grouped and sorted per "
                  "tile in shared memory",
        "launches": ps_launches["scatter_sub"] + collective["scatter_sub"],
        "launches_by_path": {"ps_serve": ps_launches["scatter_sub"],
                             "ps_collective": collective["scatter_sub"],
                             "model_parallel": model_parallel["scatter_sub"],
                             "device_fabric": fabric["scatter_sub"]},
        **ps_rows["scatter_sub"]}, *fabric_line(fabric_rows, fabric)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
