"""Arithmetic shared by the readers of the traced training steps."""


def class_ms_a_step(ctx, cls):
    t = ctx.get("trace")
    if ctx.get("driver") != "train" or not t or not t["count"].get(cls):
        return None
    return 1e3 * t["by_class"][cls] / t["steps"]


def roofline(ctx, cls, launches, bound):
    """``launches`` calls' least time over their kernels' time, in %."""
    t = ctx.get("trace")
    if ctx.get("driver") != "train" or not t or not t["count"].get(cls):
        return None
    n = t["launches"].get(launches, 0)
    if not n:
        return None
    least_ms, _by = bound(ctx["attention_shape"], 2)
    return 100.0 * least_ms * n / (1e3 * t["by_class"][cls])
