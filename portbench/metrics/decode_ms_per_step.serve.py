"""Host milliseconds of a decode step in the serving window: each batch's
time from the end of its prefill to the end of ``generate`` over its
``max_new - 1`` steps, all batches pooled."""

UNIT = "ms"


def read(ctx):
    if ctx.get("driver") != "serve":
        return None
    bs = ctx["window"]["batches"]
    steps = sum(b["new"] - 1 for b in bs)
    return 1e3 * sum(b["decode_s"] for b in bs) / steps if steps else None
