"""The share of the traced serving batches' window in which no kernel ran
on the card, in %."""

UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "serve" or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
