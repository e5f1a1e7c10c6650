"""Twin suites, group (c), second half: the reference's tests of
resharding, the rebalancer, naming and the PS client with JAX gradients,
each file run as written against the port (``tests/torch_twin.py``)."""

from torch_twin import reference_runs, twin_suite  # noqa: F401

test_reshard = twin_suite("test_reshard.py")
test_rebalance = twin_suite("test_rebalance.py")
test_naming_py = twin_suite("test_naming_py.py")
test_ps_remote = twin_suite("test_ps_remote.py")
