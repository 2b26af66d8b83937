"""Host milliseconds a batch spends in the writer (``ParallelWriter``):
each batch's fill of its generations into the one file, and the file's
final close, over the window's batches."""

UNIT = "ms"


def read(ctx):
    if ctx.get("driver") != "serve":
        return None
    w = ctx["window"]
    return 1e3 * w["write_s"] / len(w["batches"])
