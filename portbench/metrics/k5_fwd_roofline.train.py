"""K5's forward (``flash_attention``) in the traced training steps: the
least time of its calls at the cell's shape (``yardstick.flops``) over
the card time of its kernels, in %."""

from portbench.yardstick.flops import attention_fwd_bound
from portbench.yardstick import share as _share

UNIT = "%"


def read(ctx):
    return _share.roofline(ctx, "k5_fwd", "flash_attention", attention_fwd_bound)
