"""Hopper kernels of the port, with their dispatch.

``ops`` is the kernel API, the twin of ``repro.kernels.ops``: nine op
entries that follow their inputs' device (the Hopper kernel on a card,
the plain version on the CPU), plus the write path's dispatch and the
launch counts.  ``offsets_scan`` (K1) and ``byteshuffle`` (K2) serve the
writer's fill and seal; ``decode_pages`` (K3, K4 and the drivers) serves
the reader's device read-back; ``flash_attention`` (K5) and
``decode_attention`` (K6) serve the models' prefill and decode, and
``flash_attention`` also holds K5's backward for the train step;
``rwkv6_scan`` (K7) and ``mamba2_ssd`` (K8) the recurrent families'
prefill; ``byteshuffle`` (K9, the single-buffer split) and
``delta_zigzag`` (K10) serve the op entries of the same names.  ``ref``
holds the plain PyTorch versions, ``_build`` the nvcc build.  Every
module imports without ``nvcc`` or a card: the CUDA libraries build and
load inside the first launch.
"""

from . import (byteshuffle, decode_attention, decode_pages, delta_zigzag,
               flash_attention, mamba2_ssd, offsets_scan, ops, ref,
               rwkv6_scan)

__all__ = ["byteshuffle", "decode_attention", "decode_pages", "delta_zigzag",
           "flash_attention", "mamba2_ssd", "offsets_scan", "ops", "ref",
           "rwkv6_scan"]
