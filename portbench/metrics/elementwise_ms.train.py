"""Card milliseconds a traced training step in PyTorch's elementwise,
reduction and indexing kernels (casts, norms, routing, AdamW;
``yardstick.kernel_classes``)."""

from portbench.yardstick import share as _share

UNIT = "ms"


def read(ctx):
    return _share.class_ms_a_step(ctx, "elementwise")
