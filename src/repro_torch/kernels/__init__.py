"""Hopper kernels of the port, with their dispatch.

``offsets_scan`` (K1) and ``byteshuffle`` (K2) serve the writer's fill
and seal; ``decode_pages`` (K3, K4 and the drivers) serves the reader's
device read-back; ``flash_attention`` (K5) and ``decode_attention`` (K6)
serve the models' prefill and decode; ``rwkv6_scan`` (K7) and
``mamba2_ssd`` (K8) the recurrent families' prefill.  ``ops`` holds the
dispatch and the launch counts, ``ref`` the plain PyTorch versions,
``_build`` the nvcc build.  Every module imports without ``nvcc`` or a card: the CUDA
libraries build and load inside the first launch.
"""

from . import (byteshuffle, decode_attention, decode_pages, flash_attention,
               mamba2_ssd, offsets_scan, ops, ref, rwkv6_scan)

__all__ = ["byteshuffle", "decode_attention", "decode_pages",
           "flash_attention", "mamba2_ssd", "offsets_scan", "ops", "ref",
           "rwkv6_scan"]
