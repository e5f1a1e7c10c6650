"""Twin suites, group (b): the reference's tests of the modules no other
port test imports (``limiter``, ``obs`` with ``obs.rpcz``,
``obs.status_service`` and ``obs.vars``), each file run as written against
the port (``tests/torch_twin.py``).

One case is written by hand: ``test_obs.py::test_collective_channel_counters``
runs its collectives on the port's ``CollectiveChannel`` over a gloo world
of 8 processes (``tests/torch_world.py``) in place of a JAX mesh of 8
devices, with the reference's counter assertions on every rank.
"""

import torch_world
from torch_twin import reference_runs, twin_suite  # noqa: F401


def collective_channel_counters(tmp_path):
    for got in torch_world.run("obs_counters", 8, tmp_path):
        assert int(got["all_reduce_calls"]) == 1
        assert int(got["all_reduce_bytes"]) == 64 * 4
        assert int(got["all_gather_calls"]) == 1


test_limiter = twin_suite("test_limiter.py")
test_obs = twin_suite(
    "test_obs.py",
    hand={"test_collective_channel_counters": collective_channel_counters})
