"""K5's backward (``flash_attention_bwd``: the dQ and the dK/dV kernels)
in the traced training steps: the least time of its calls at the cell's
shape (``yardstick.flops``) over the card time of its kernels, in %."""

from portbench.yardstick.flops import attention_bwd_bound
from portbench.yardstick import share as _share

UNIT = "%"


def read(ctx):
    return _share.roofline(ctx, "k5_bwd", "flash_attention_bwd", attention_bwd_bound)
