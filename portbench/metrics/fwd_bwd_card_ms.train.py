"""Card milliseconds of the model's forward and backward a traced
training step: the program's ``train.forward_backward`` spans (the loss
and its gradients by autograd) summed over its ``train.step`` spans.  The
card milliseconds come from the program's CUDA events
(``repro_torch.obs``), recorded on the stream at each span's start and
end: stream time, the card's idle inside the span included."""

UNIT = "ms"


def read(ctx):
    if ctx.get("driver") != "train" or not ctx.get("trace"):
        return None
    try:
        from repro_torch import obs
    except ImportError:     # a program without spans
        return None
    s = obs.summary()
    part, step = s.get("train.forward_backward"), s.get("train.step")
    if not part or not step or part["card_ms"] is None:
        return None
    return part["card_ms"] / step["count"]
