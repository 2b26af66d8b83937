"""K5's forward (``flash_attention``) in the traced prefills: the least
time of a layer's call at each traced batch's shape (``yardstick.flops``)
over the card time of its kernels, in %."""

from portbench.yardstick.flops import attention_fwd_bound

UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "serve" or not t or not t["count"].get("k5_fwd"):
        return None
    c, b = ctx["config"], ctx["traffic"]["batch"]
    least = sum(c["n_layers"] * attention_fwd_bound(
        (b, c["n_heads"], c["n_kv_heads"], n, n, c["head_dim"]), 2)[0]
        for n, _new in t["lengths"])
    return 100.0 * least / (1e3 * t["by_class"]["k5_fwd"])
