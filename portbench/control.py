"""The controls and planted faults that set each cell's limits.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed, at the cell's own size, this reads every number the cell
compares with the reference standing in for the program, computed one
step below the configured precision (float8 e4m3 products for the
bfloat16 the configurations state; bfloat16 sums for the fabric's
float32), and, for the faults a cell can have, with the fault planted in
the reference: half of the batch left out (training), the exchange
between cards left out (gradient sync). The benchmark's runs never run
this; ``PERF.md`` records its readings beside each limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root: Path, workload: str, seed: int, device) -> dict:
    """{reading: {number: value}} for one seed; ``device`` holds every
    replica's data in turn."""
    import torch

    from portbench import harness, weights
    from portbench.model_config import model_shape

    cell, runner = harness.load_cell(root, workload, seed, [device])
    kind = cell.traffic["kind"]
    shape = model_shape(cell.config)
    if kind == "prefill":
        from portbench.reference.llama import logits_at

        w = weights.llama_weights(shape, seed, device)
        gap = 0.0
        for (index, c, k), positions in sorted(runner._plan(cell).items()):
            length, count = cell.traffic["classes"][c]
            tokens = runner._pool(cell, shape, c, length, count)[
                (index % runner.POOL_ROUNDS) * count + k]
            at = torch.tensor(positions, device=device)
            for b in range(tokens.shape[0]):
                want = logits_at(w, tokens[b], at, shape)
                got = logits_at(w, tokens[b], at, shape, precision="fp8")
                gap = max(gap, runner.served_token_gap(got, want))
        return {"control_fp8": {"served_token_gap": gap}}
    if kind == "train":
        from portbench.reference.train import follow

        steps = cell.traffic["check"]["steps"]
        batches = list(runner._batches(cell, shape)[:steps])
        want = follow(shape, seed, batches, cell.traffic, device)
        out = {}
        for label, kw in (("control_fp8", {"precision": "fp8"}),
                          ("fault_half_batch", {"rows": [0]})):
            got = follow(shape, seed, batches, cell.traffic, device, **kw)
            out[label] = runner.compare(got, want)
        return out
    if kind == "grad_sync":
        from portbench.reference.allreduce import ordered_sum

        lay = runner.layout(cell)
        replicas = [device] * cell.traffic["replicas"]
        out = {"control_bf16": {"mismatched_floats": 0},
               "fault_no_exchange": {"mismatched_floats": 0}}
        for i in lay.checked:
            xs = runner.bucket_inputs(cell, lay, i, replicas)
            want = ordered_sum(xs).view(torch.int32)
            low = ordered_sum(xs, torch.bfloat16).view(torch.int32)
            out["control_bf16"]["mismatched_floats"] += int(
                (low != want).sum())
            out["fault_no_exchange"]["mismatched_floats"] += sum(
                int((x.view(torch.int32) != want).sum()) for x in xs)
        return out
    raise ValueError(f"no control for kind {kind!r}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(ROOT, args.workload, seed,
                                     torch.device("cuda", 0))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
