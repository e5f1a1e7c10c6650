"""Twin suite of ``tests/test_replication.py`` (replication, fencing,
failover on the CPU tier), run as written against the port
(``tests/torch_twin.py``). Some of the reference's tests there hang on
timing margins and flake in the reference too; the twin carries the same
margins, and each case runs once."""

from torch_twin import reference_runs, twin_suite  # noqa: F401

test_replication = twin_suite("test_replication.py")
