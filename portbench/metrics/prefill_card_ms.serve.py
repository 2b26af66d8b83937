"""Card milliseconds of a traced batch's prefill: the program's
``serve.prefill`` spans (the bundle's prefill and the first token's
pick) summed over its ``serve.generate`` spans.  The card milliseconds
come from the program's CUDA events (``repro_torch.obs``), recorded on the
stream at each span's start and end: stream time, the card's idle inside
the span included."""

UNIT = "ms"


def read(ctx):
    if ctx.get("driver") != "serve" or not ctx.get("trace"):
        return None
    try:
        from repro_torch import obs
    except ImportError:     # a program without spans
        return None
    s = obs.summary()
    part, batch = s.get("serve.prefill"), s.get("serve.generate")
    if not part or not batch or part["card_ms"] is None:
        return None
    return part["card_ms"] / batch["count"]
