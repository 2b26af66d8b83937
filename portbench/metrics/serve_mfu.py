"""The serving window's model operations (``yardstick.flops.
serve_batch_flops``: each batch's prefill with its head at the last
position, and its decode steps over the cache) over its wall seconds, as
a share of the card's bf16 peak (989 TFLOP/s)."""

from portbench.yardstick.peaks import BF16_FLOP_PER_S

UNIT = "%"


def read(ctx):
    if ctx.get("driver") != "serve":
        return None
    w = ctx["window"]
    return 100.0 * w["flops"] / w["seconds"] / BF16_FLOP_PER_S
