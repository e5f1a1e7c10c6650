"""Spreads of result lines, as the bounds are set from them.

    python3 portbench/spread.py runs.jsonl [more.jsonl ...]

Each file holds one run's result line a line (``run.py``'s last line of
standard output). For each file and metric this prints the median, the
spread (the distance between the first and third quartiles, as
``statistics.quantiles(values, n=4)`` gives them, over the median) and the
bound five times the spread would give.
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def metrics(lines: list) -> dict:
    out = defaultdict(list)
    for line in lines:
        for name, m in json.loads(line)["metrics"].items():
            out[name].append(m["value"])
    return out


def main(paths: list) -> int:
    for path in paths:
        with open(path) as f:
            lines = [line for line in f if line.strip()]
        for name, values in sorted(metrics(lines).items()):
            s = spread(values) if len(values) > 1 else float("nan")
            print(f"{path} {name}: n={len(values)} median="
                  f"{statistics.median(values)!r} spread={s!r} "
                  f"bound_at_5x={5 * s!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
