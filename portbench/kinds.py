"""The kind of each device kernel, by its name.

A frozen copy of the classifier the port's chip smoke test uses
(``chip_smoke.KERNEL_KINDS``), with the device fabric's K4 and K5 named.
The first pattern that matches names the kind.
"""

from __future__ import annotations

import re

KERNEL_KINDS = (
    ("flash_attention", re.compile(r"flash_fwd")),
    ("fabric", re.compile(r"all_reduce_kernel|all_gather_kernel"
                          r"|reduce_partials_kernel|reduce_final_kernel"
                          r"|\badd_kernel")),
    ("collective", re.compile(r"nccl", re.IGNORECASE)),
    ("matmul", re.compile(r"gemm|xmma|nvjet|cutlass|sm90_")),
    ("optimizer", re.compile(r"[Aa]dam")),
    ("copy_cast", re.compile(r"copy|Memcpy")),
    ("other", re.compile(r"")),
)

K1 = re.compile(r"flash_fwd")
K4_ALL_REDUCE = re.compile(r"all_reduce_kernel")


def kind(name: str) -> str:
    return next(k for k, pattern in KERNEL_KINDS if pattern.search(name))
