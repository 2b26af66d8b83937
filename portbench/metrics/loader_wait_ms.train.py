"""The mean host milliseconds of a ``next()`` on the program's
``PackedLoader.batches()`` over the training window (a span the
benchmark takes around the call)."""

UNIT = "ms"


def read(ctx):
    if ctx.get("driver") != "train":
        return None
    spans = ctx["spans"]["loader_next_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
