"""Card milliseconds of the optimizer a traced training step: the
program's ``train.optimizer`` spans (AdamW, the clip's norm included)
summed over its ``train.step`` spans.  The card milliseconds come from
the program's CUDA events (``repro_torch.obs``), recorded on the stream
at each span's start and end: stream time, the card's idle inside the
span included."""

UNIT = "ms"


def read(ctx):
    if ctx.get("driver") != "train" or not ctx.get("trace"):
        return None
    try:
        from repro_torch import obs
    except ImportError:     # a program without spans
        return None
    s = obs.summary()
    part, step = s.get("train.optimizer"), s.get("train.step")
    if not part or not step or part["card_ms"] is None:
        return None
    return part["card_ms"] / step["count"]
