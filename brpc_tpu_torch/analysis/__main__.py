"""CLI entry: ``python -m brpc_tpu_torch.analysis [paths...]
[--format=json] [--check NAME] [--baseline FILE] [--write-baseline FILE]``.

Exit 0 when clean (or every finding is suppressed by the baseline),
1 when any new check fires, 2 on usage errors (unknown ``--check``
names list the valid set) — suitable as a CI gate
(``tests/test_torch_lint.py`` runs the same pass in-process against
``tests/torch_lint_baseline.json``).
"""

import sys

from brpc_tpu_torch.analysis.lint import main

if __name__ == "__main__":
    sys.exit(main())
