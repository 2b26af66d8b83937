"""The numbers that decide ``correct``, each against its limit.

Training: the loader's tokens that no corpus document explains (an
exact count, limit 0), and three gaps between the program's readings
and the reference's over the checked steps: each step's loss (the
largest absolute gap), the first step's clipped gradient, and the
parameters' change after the checked steps.  The last two are norms
taken leaf by leaf: the gap between the program's norm and the
reference's over the reference's norm of that leaf or the median leaf's,
whichever is larger, at the worst leaf.  The change leaves out leaves
whose reference gradient is under a thousandth of the median leaf's
(Adam moves those by round-off alone).  Where a cell's limits name
``grad_diff``, the first gradient is also compared whole: the norm of
the difference of the program's and the reference's, over the same
denominator, at the worst leaf (norms of gradients average rounding
away; where they cannot tell bf16 from float8, the difference can).  The
difference is read on every k-th element of a leaf (``sample_stride``:
at most 2^20 of them, all of a smaller leaf) as a share of the
reference's norm there, times the leaf's whole reference norm.
"""

from __future__ import annotations

import statistics
from typing import Dict

#: the whole first gradient is compared on every k-th element of each
#: stacked leaf, k the least that leaves at most this many
SAMPLE = 2 ** 20


def sample_stride(numel: int) -> int:
    return max(1, -(-numel // SAMPLE))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None
              ) -> Dict[str, float]:
    """Each leaf's gap: over its reference norm or the median leaf's,
    whichever is larger."""
    keys = [k for k in ref if keep is None or k in keep]
    floor = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    grad_floor = statistics.median(ref["grad"].values())
    moved = {k for k, g in ref["grad"].items() if g >= 1e-3 * grad_floor}
    out = {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": leaf_gap(prog["change"], ref["change"], moved),
    }
    if "grad_diff" in ref:
        out["grad_diff"] = max(d / max(ref["grad"][k], grad_floor)
                               for k, d in ref["grad_diff"].items())
    return out


def train_detail(prog: Dict, ref: Dict) -> Dict:
    """Each step's loss gap and each leaf's gaps (for setting limits), with
    each leaf's ``grad_diff`` where the reference has it."""
    grad_floor = statistics.median(ref["grad"].values())
    moved = {k for k, g in ref["grad"].items() if g >= 1e-3 * grad_floor}
    out = {"loss": [abs(a - b) for a, b in zip(prog["loss"], ref["loss"])],
           "grad": leaf_gaps(prog["grad"], ref["grad"]),
           "change": leaf_gaps(prog["change"], ref["change"], moved)}
    if "grad_diff" in ref:
        out["grad_diff"] = {k: d / max(ref["grad"][k], grad_floor)
                            for k, d in ref["grad_diff"].items()}
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """``{name: {"value", "limit"}}`` in the limits' order; a number not
    measured is None and fails."""
    return {k: {"value": numbers.get(k), "limit": lim}
            for k, lim in limits.items()}


def passed(chk: Dict[str, Dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in chk.values())
