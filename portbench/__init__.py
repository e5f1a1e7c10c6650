"""The benchmark of the PyTorch and CUDA port (``brpc_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` in one process::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. Each piece is a file found by its name:

- ``configs/<config>.json``: a published model configuration, its source,
  the keys cut (``reduced``) and the sizes assumed;
- ``traffic/<mix>.json``: the parameters of a traffic mix, read by the
  runner its ``kind`` names (``runners/<kind>.py``);
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader a
  metric, each taking its number from the run's window (``harness.Window``).

The yardstick is frozen here, apart from the program: the weights and
inputs made from the seed (``weights.py``), the FLOP and byte counts and
the peaks (``counts.py``), the kernel classifier (``kinds.py``), the trace
reduction (``trace.py``) and the plain references (``reference/``).
"""
