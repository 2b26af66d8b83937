"""Card milliseconds a traced training step in matrix-product kernels
(cuBLAS, CUTLASS; ``yardstick.kernel_classes``)."""

from portbench.yardstick import share as _share

UNIT = "ms"


def read(ctx):
    return _share.class_ms_a_step(ctx, "gemm")
