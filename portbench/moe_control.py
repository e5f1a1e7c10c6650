"""The controls and planted faults that set an expert cell's limits.

    python3 portbench/moe_control.py --workload <cell> --seeds 11,12,13

For each seed, at the cell's own size, on the requests and positions the
cell samples, this reads the numbers the cell compares
(``runners/moe_prefill.compare``) with the plain reference standing in
for the program: computed one step below the configured bfloat16 (float8
e4m3 operands in every product, the router's too: ``control_fp8``), and
with a fault planted in its expert layer: each token routed to one
expert (``fault_top1``), the second expert's term left out
(``fault_drop_second``), the top two probabilities kept without their
renormalisation (``fault_no_renorm``). Each line also gives the gaps at
a few quantiles and the share of routing choices that differ from the
float32 reference's. The benchmark's runs never run this; ``PERF.md``
records its readings beside each limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {"control_fp8": {"precision": "fp8"}, "fault_top1": {"k": 1},
            "fault_drop_second": {"drop_second": True},
            "fault_no_renorm": {"renormalise": False}}


def readings(root: Path, workload: str, seed: int, device) -> dict:
    """{reading: {number: value, "summary": text}} for one seed."""
    import torch

    from portbench import harness
    from portbench.moe_config import moe_shape

    cell, runner = harness.load_cell(root, workload, seed, [device])
    m = moe_shape(cell.config)
    prefill = runner._prefill
    seqs = []
    for (index, c, k), positions in sorted(prefill._plan(cell).items()):
        length, count = cell.traffic["classes"][c]
        batch = prefill._pool(cell, m, c, length, count)[
            (index % prefill.POOL_ROUNDS) * count + k]
        at = torch.tensor(positions, device=device)
        seqs += [((index, c, k), b, batch, at)
                 for b in range(batch.shape[0])]
    want, *got = runner.reference_pass(cell, m, seqs,
                                       ({}, *VARIANTS.values()))
    out = {}
    for label, variant in zip(VARIANTS, got):
        logits = [x for x, _ in variant]
        out[label] = {name: value for name, value, _ in runner.compare(
            logits, [x for x, _ in want], cell.traffic)}
        out[label]["summary"] = runner.summary(
            logits, want, [e for _, e in variant])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("moe_control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(ROOT, args.workload, seed,
                                     torch.device("cuda", 0))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
