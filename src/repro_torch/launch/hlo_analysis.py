"""Roofline terms of a step on the card, the twin of
``repro.launch.hlo_analysis``'s ``roofline_terms``.

Not ported: ``parse_collectives`` and ``shape_bytes`` read the text of
XLA's optimized HLO, which a PyTorch program does not have.  The port's
dry-run works its collective bytes out from the parameters' placements
instead (``repro_torch.launch.dryrun``).

Hardware model: NVIDIA H100 SXM (the card's own peaks, from NVIDIA's
data sheet): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink each
way.  A card may run under a lower power limit than its 700 W and then
below these peaks: the dry-run's records carry the card's name and power
limit as ``nvidia-smi`` gives them where there is one.
"""

from __future__ import annotations

import functools
import subprocess
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card, each way


@functools.lru_cache(maxsize=None)
def card() -> str:
    """``nvidia-smi``'s name and power limit of card 0, or "no card"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "no card"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "no card"


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    collective_bytes: float,
    n_chips: int,
) -> Dict[str, float]:
    """The three roofline terms in seconds of one rank's step: its FLOPs
    over the card's peak, its HBM bytes over the memory rate, its
    collective bytes over NVLink (all per rank)."""
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    collective_s = collective_bytes / NVLINK_BW
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "n_chips": n_chips,
    }
