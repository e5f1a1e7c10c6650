"""Twin suites, group (c), first half: the reference's tests of the wire
registry, resilience, the PS stream and the durable ledger, each file run
as written against the port (``tests/torch_twin.py``). In the mirror of
``test_wire.py`` the lint fixture's fake package takes the port's name, as
the port's linter scans the registry of a package of that name."""

from torch_twin import reference_runs, twin_suite  # noqa: F401

test_wire = twin_suite("test_wire.py")
test_resilience = twin_suite("test_resilience.py")
test_ps_stream = twin_suite("test_ps_stream.py")
test_durable = twin_suite("test_durable.py")
