"""Runs one cell of the port's benchmark and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit); the last lines of standard error
repeat the checks. Exits non-zero, printing no result, where the cell's
cards are missing, the program cannot be imported, or JAX or the JAX
package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Kernel caches inside the checkout, at fixed paths.
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "portbench" / "_cache" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    try:
        result, checks, phases = harness.run(ROOT, args.workload, args.seed,
                                     args.seconds, bool(args.trace), STARTED)
    except harness.NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}; the benchmark runs "
              f"the port alone", file=sys.stderr)
        return 3
    print(phases, file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
