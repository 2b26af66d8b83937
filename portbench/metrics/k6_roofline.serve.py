"""K6 (``decode_attention``) in the traced decode steps: the least time of
each call (step ``i`` of a batch of prompt ``L`` reads ``L + i + 1`` cache
rows; ``yardstick.flops``) over the card time of its kernels, in %."""

from portbench.yardstick.flops import decode_attention_bound

UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "serve" or not t or not t["count"].get("k6"):
        return None
    c, tr = ctx["config"], ctx["traffic"]
    shape = (tr["batch"], c["n_heads"], c["n_kv_heads"], c["head_dim"])
    least = sum(c["n_layers"] * decode_attention_bound(shape, n + i + 1, 2)[0]
                for n, new in t["lengths"] for i in range(new - 1))
    return 100.0 * least / (1e3 * t["by_class"]["k6"])
