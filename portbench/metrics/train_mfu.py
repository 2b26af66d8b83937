"""The training window's model operations (``yardstick.flops``: 6 N D
plus causal attention, no recomputation) over its wall seconds, as a
share of the card's bf16 peak (989 TFLOP/s)."""

from portbench.yardstick.peaks import BF16_FLOP_PER_S

UNIT = "%"


def read(ctx):
    if ctx.get("driver") != "train" or not ctx["window"]["steps"]:
        return None
    w = ctx["window"]
    return 100.0 * ctx["step_flops"] * w["steps"] / w["seconds"] / BF16_FLOP_PER_S
