"""Data-parallel gradient sync through the device fabric's all-reduce.

Each of the cell's cards holds one replica's whole flat f32 gradient of
the configuration's model, drawn from the seed. A round is one sync: the
gradient in buckets of ``bucket_mb`` MiB, each summed over the replicas by
``brpc_tpu_torch.ops.device_programs.all_reduce_sum``, one call a bucket,
back to back, from one process that drives every card.

Check: the outputs of every replica for ``check.buckets`` buckets drawn
from the seed (the last, shorter one among them), kept from the first and
from the last sync of the window. Once the window has closed and the
gradients are freed, the plain reference sums each bucket's inputs, made
again from the seed, in replica order in float32, as the fabric states;
the number compared is how many floats differ in any bit
(``mismatched_floats``), with the limit 0.
"""

from __future__ import annotations

import dataclasses
import gc
import random

import torch

from portbench import counts, weights
from portbench.model_config import model_shape
from portbench.reference.allreduce import ordered_sum


@dataclasses.dataclass
class Layout:
    n: int          # floats of one replica's gradient
    bucket: int     # floats of a full bucket
    chunk: int      # floats made in one call of the generator
    spans: list     # [begin, end) of each bucket
    checked: list   # indices of the buckets whose outputs are checked


def layout(cell) -> Layout:
    traffic = cell.traffic
    n = counts.n_params(model_shape(cell.config))
    bucket = int(traffic["bucket_mb"] * (1 << 20)) // counts.F32_BYTES
    spans = counts.buckets(n, bucket)
    rng = random.Random(weights.sub_seed(cell.seed, "check"))
    checked = sorted(rng.sample(range(len(spans) - 1),
                                traffic["check"]["buckets"] - 1)) \
        + [len(spans) - 1]
    return Layout(n, bucket, traffic["chunk_buckets"] * bucket, spans,
                  checked)


def bucket_inputs(cell, lay: Layout, i: int, devices: list) -> list:
    """Bucket i of every replica's gradient, made again from the seed,
    replica d's on ``devices[d]``."""
    begin, end = lay.spans[i]
    chunk, offset = divmod(begin, lay.chunk)
    out = []
    for d, device in enumerate(devices):
        data = torch.empty(min(lay.chunk, lay.n - chunk * lay.chunk),
                           dtype=torch.float32, device=device)
        weights.gradient_chunk(data, cell.seed, d, chunk)
        out.append(data[offset:offset + end - begin].clone())
        del data
    return out


@dataclasses.dataclass
class State:
    cell: object
    layout: Layout
    grads: list
    views: list
    kept: dict


def setup(cell):
    from brpc_tpu_torch.ops import device_programs

    if cell.traffic["replicas"] != len(cell.devices):
        raise ValueError(f"the mix has {cell.traffic['replicas']} replicas; "
                         f"the cell {len(cell.devices)} cards")
    lay = layout(cell)
    grads = []
    for d, device in enumerate(cell.devices):
        grad = torch.empty(lay.n, dtype=torch.float32, device=device)
        for c, begin in enumerate(range(0, lay.n, lay.chunk)):
            weights.gradient_chunk(grad[begin:begin + lay.chunk], cell.seed,
                                   d, c)
        grads.append(grad)
    views = [[g[begin:end] for g in grads] for begin, end in lay.spans]
    cell.mark("gradients")
    for xs in {len(xs[0]): xs for xs in views}.values():  # each size once
        device_programs.all_reduce_sum(xs)
    return State(cell, lay, grads, views, {})


def run_round(state: State, index: int) -> list:
    from brpc_tpu_torch.ops.device_programs import all_reduce_sum

    spans, checked = state.cell.spans, set(state.layout.checked)
    kept, units = {}, []
    with spans("sync"):
        for i, xs in enumerate(state.views):
            with spans("all_reduce_sum"):
                outs = all_reduce_sum(xs)
            if i in checked:
                kept[i] = outs
            units.append({"n": xs[0].numel(), "ok": len(outs) == len(xs)})
    state.kept["first" if index == 0 else "last"] = kept
    return units


def check(state: State) -> list:
    cell, lay = state.cell, state.layout
    state.grads = state.views = None
    gc.collect()
    for d in cell.devices:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    mismatched = 0
    for i in lay.checked:
        want = ordered_sum(bucket_inputs(cell, lay, i, cell.devices))
        for kept in state.kept.values():
            for out in kept[i]:
                mismatched += int((out.view(torch.int32)
                                   != want.to(out.device).view(torch.int32))
                                  .sum())
    return [("mismatched_floats", mismatched,
             cell.traffic["limits"]["mismatched_floats"])]
