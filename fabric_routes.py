"""Times K4a's two all-reduce routes against each other and NCCL.

``brpc_tpu_torch.ops.device_programs.all_reduce_sum`` takes the one-shot
or the two-shot by a fixed rule on (R, n) in ``csrc/device_programs.cu``
(``brt_all_reduce_two_shot``). This script is the measurement behind that
rule: at every R of ``--replicas`` (2 up to the card count) and every n
of ``--sizes``, it runs both routes through the wrapper (the route forced),
checks each bit-equal to the plain version on every replica, and times
both in turns with ``torch.cuda.nccl.all_reduce`` (``chip_smoke.in_turns``:
two rounds of NCCL, one-shot, two-shot and back). Each (R, n) prints one
JSON line: the three medians in ms, the route the rule takes and the
faster route. The first line is the cards' name and power limit.

    python3 fabric_routes.py                 # R = 2, 4 on four cards
    python3 fabric_routes.py --replicas 2 --sizes 65536 8388608
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from brpc_tpu_torch.ops import device_programs as dp

SIZES = (16, 4096, 65536, 262144, 1 << 20, 1 << 22, 2048 * 4096,
         14336 * 4096)


def measure(replicas: int, n: int, rng) -> dict:
    import torch.cuda.nccl as nccl

    xs = [torch.from_numpy(chip_smoke.fabric_draw(rng, n)).to(f"cuda:{d}")
          for d in range(replicas)]
    copies = [x.clone() for x in xs]
    want = dp.all_reduce_sum_reference(xs)
    routes = {"one_shot": False, "two_shot": True}
    for name, two_shot in routes.items():
        got = dp._collective("all_reduce_sum", xs, two_shot)
        for d in range(replicas):
            torch.cuda.synchronize(d)
        chip_smoke.check(all(chip_smoke.same_floats(g.cpu().numpy(),
                                                    w.cpu().numpy())
                             for g, w in zip(got, want)),
                         f"{name} R={replicas} n={n} differs from the "
                         f"plain version")
    fns = {"nccl": lambda: nccl.all_reduce(copies)}
    for name, two_shot in routes.items():
        fns[name] = (lambda t=two_shot:
                     dp._collective("all_reduce_sum", xs, t))
    times = chip_smoke.in_turns(
        f"all_reduce_sum R={replicas} n={n}", fns,
        50 if n <= 2048 * 4096 else 10, rounds=2,
        devices=range(replicas))
    row = {"replicas": replicas, "n": n,
           **{f"{k}_ms": v[0] for k, v in times.items()},
           "rule": dp.route("all_reduce_sum", replicas, n)}
    row["faster"] = "two-shot" if row["two_shot_ms"] < row["one_shot_ms"] \
        else "one-shot"
    del xs, copies, want
    for d in range(replicas):
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--replicas", type=int, nargs="+")
    parser.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    args = parser.parse_args()
    if torch.cuda.device_count() < 2:
        print("fabric_routes: needs two CUDA devices or more",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    replicas = args.replicas or [r for r in (2, 4, 8)
                                 if r <= torch.cuda.device_count()]
    rng = np.random.default_rng(chip_smoke.FABRIC_SEED)
    for r in replicas:
        for n in args.sizes:
            print(json.dumps(measure(r, n, rng)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
