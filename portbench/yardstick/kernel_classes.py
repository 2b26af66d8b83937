"""Device kernels by class, from their names in the profiler's trace.

The first rule whose pattern the name contains decides; a kernel no rule
covers is ``unclassified`` and keeps a row of its own in the breakdown.
The port's own kernels are named by their ``__global__`` functions
(``src/repro_torch/csrc``); the matrix products are cuBLAS's and
CUTLASS's (on the H100 ``nvjet*`` and ``sm90_xmma*``); PyTorch's
elementwise, reduction, indexing and copy kernels are ``at::native``'s.
"""

from __future__ import annotations

import re
from typing import List, Tuple

RULES: List[Tuple[str, "re.Pattern"]] = [
    ("k5_fwd", re.compile(r"\bflash_fwd")),
    ("k5_bwd", re.compile(r"\bbwd_(dq|dkv)")),
    ("k6", re.compile(r"\bdecode_(mma|partial|combine)")),
    ("loader", re.compile(r"\b(unsplit_reg|decode_offsets_cluster|scan_lookback|"
                          r"shuffle_reg|transpose_scalar|delta_zigzag)")),
    ("gemm", re.compile(r"nvjet|xmma|gemm|cutlass|cublas|Kernel2", re.I)),
    ("copy", re.compile(r"memcpy|memset", re.I)),
    ("elementwise", re.compile(r"at::native|elementwise|reduce|triton_|"
                               r"cunn_|softmax", re.I)),
]


def classify(name: str) -> str:
    for cls, pat in RULES:
        if pat.search(name):
            return cls
    return "unclassified"
