"""The controls and planted faults that set a DeepSeek-V2 cell's limits.

    python3 portbench/mla_control.py --workload <cell> --seeds 11,12,13

For each seed, at the cell's own size, on the requests and positions the
cell samples, this reads the numbers the cell compares
(``runners/mla_prefill.compare``) with the plain reference standing in
for the program: computed one step below the configured bfloat16 (float8
e4m3 operands in every product, the router's too: ``control_fp8``), and
with a fault planted in it: rope at the plain frequencies, without YaRN
(``fault_plain_rope``), the scores scaled without YaRN's mscale²
(``fault_no_mscale``), the shared experts left out (``fault_no_shared``),
each token routed to one expert fewer (``fault_top_k_less_one``). Each
line also gives the gaps and the logits' relative errors at a few
quantiles and the share of routing choices that differ from the float32
reference's, and for each control the verdict the harness's rule gives
(correct where every number is finite and at or under its limit) with
the numbers over their limits. It exits 1 if any control would be
correct, since the limits would then not tell it from the program. The
benchmark's runs never run this; ``PERF.md`` records its readings beside
each limit.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def variants(m) -> dict:
    return {"control_fp8": {"precision": "fp8"},
            "fault_plain_rope": {"yarn": False},
            "fault_no_mscale": {"mscale": False},
            "fault_no_shared": {"shared": False},
            "fault_top_k_less_one": {"k": m.per_token - 1}}


def readings(root: Path, workload: str, seed: int, device) -> dict:
    """{reading: {number: value, "summary": text}} for one seed."""
    import torch

    from portbench import harness
    from portbench.mla_config import mla_shape

    cell, runner = harness.load_cell(root, workload, seed, [device])
    m = mla_shape(cell.config)
    prefill = runner._prefill
    seqs = []
    for (index, c, k), positions in sorted(prefill._plan(cell).items()):
        length, count = cell.traffic["classes"][c]
        batch = prefill._pool(cell, m, c, length, count)[
            (index % prefill.POOL_ROUNDS) * count + k]
        at = torch.tensor(positions, device=device)
        seqs += [((index, c, k), b, batch, at)
                 for b in range(batch.shape[0])]
    planted = variants(m)
    want, *got = runner.reference_pass(cell, m, seqs,
                                       ({}, *planted.values()))
    out = {}
    for label, variant in zip(planted, got):
        logits = [x for x, _ in variant]
        checks = runner.compare(logits, [x for x, _ in want], cell.traffic)
        over = [name for name, value, limit in checks
                if not (math.isfinite(value) and value <= limit)]
        out[label] = {name: value for name, value, _ in checks}
        out[label]["verdict"] = "not correct" if over else "correct"
        out[label]["over_limits"] = over
        chosen = [e for _, e in variant]  # routing flips at the same k
        same_k = all(e.shape == w.shape for e, (_, w) in zip(chosen, want))
        out[label]["summary"] = runner.summary(logits, want,
                                               chosen if same_k else None)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("mla_control: no CUDA device", file=sys.stderr)
        return 2
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        read = readings(ROOT, args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, **read}),
              flush=True)
        passed += [(seed, label) for label, r in read.items()
                   if r["verdict"] == "correct"]
    if passed:
        print(f"mla_control: controls the limits call correct: {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
