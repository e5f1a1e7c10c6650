"""brpc_tpu_torch.analysis — correctness tooling for the fiber/RPC fabric.

Four layers over the hazards the fabric creates (handlers running
concurrently on fiber workers with the GIL released across ctypes,
hand-placed locks, a truncation-prone ctypes boundary, explicit-destroy
native handles):

- **call graph** (:mod:`brpc_tpu_torch.analysis.callgraph`): a whole-package
  resolver over the tree's ASTs — module functions, methods through
  ``self``/bases, imports, ``functools.partial`` targets — that the
  static checks traverse (the lockdep/TSan polarity: interprocedural by
  construction).
- **static** (:mod:`brpc_tpu_torch.analysis.lint`, ``python -m
  brpc_tpu_torch.analysis``): an AST linter with framework-specific checks —
  ``ctypes-contract``, ``fiber-shared-state`` (handler-reachable
  mutation across modules), ``obs-guard``, ``trace-purity`` (transitive,
  with call chains, from functions handed to ``torch.compile``,
  ``torch.jit`` or a CUDA graph capture), and ``lock-order`` (static
  inversion cycles over the ``with checked_lock`` nesting graph; locks
  resolve through module/class/parameter bindings and module-level
  literal dict containers — ``LOCKS["a"]`` binds by key).
  Findings carry stable ids; ``--baseline`` diffs against an accepted
  set.  ``tests/test_torch_lint.py`` keeps the tree at zero findings
  against ``tests/torch_lint_baseline.json``.  The tool tier also has
  the wire fuzzer (:mod:`brpc_tpu_torch.analysis.fuzz`) and the
  cross-language contract checks over ``cpp/capi``
  (:mod:`brpc_tpu_torch.analysis.native`).
- **dynamic** (:mod:`brpc_tpu_torch.analysis.race`): the :func:`checked_lock`
  factory every fabric lock is created through.  Plain
  ``threading.Lock`` in steady state; under ``BRPC_TPU_RACECHECK=1`` a
  lock-order graph that confirms the static pass's cycles at runtime
  (with both acquisition stacks) and flags locks held across blocking
  ``brt_*`` calls.  ``BRPC_TPU_RACECHECK_SAMPLE=N`` keeps edge/cycle
  detection exact while sampling stack capture down to production-usable
  cost.
- **handles** (:mod:`brpc_tpu_torch.analysis.handles`): the dynamic handle
  ledger — under ``BRPC_TPU_HANDLECHECK=1``, ``rpc._load()`` wraps every
  owning ``brt_*_new``/``_destroy`` pair so live native handles are
  tracked with creation stacks (LeakSanitizer-shaped, sampling shared
  with RACECHECK), cross-checked against the C++ side's own counters
  (``brt_debug_handle_counts``).  The static complement is the
  ``handle-lifecycle`` lint check; the tier-1 leak gate in
  ``tests/conftest.py`` asserts zero net leaked handles per native
  test.

The native side carries the same tier: ``cpp/.clang-tidy``
(concurrency + bugprone) and ``cmake -DBRT_SANITIZE=thread|address``.

This module stays stdlib-only below ``obs``/``rpc`` in the import
order — both import :func:`checked_lock` from here (``lint`` and
``callgraph`` are tool-side, imported only by the CLI and tests).
"""

from brpc_tpu_torch.analysis.race import (  # noqa: F401
    CheckedLock,
    CheckedRWLock,
    RWLock,
    checked_lock,
    checked_rwlock,
    note_blocking,
)
from brpc_tpu_torch.analysis import handles  # noqa: F401
from brpc_tpu_torch.analysis import race  # noqa: F401

__all__ = ["checked_lock", "checked_rwlock", "CheckedLock",
           "CheckedRWLock", "RWLock", "note_blocking", "race", "handles"]
