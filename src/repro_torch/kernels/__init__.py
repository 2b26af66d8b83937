"""Hopper kernels of the write -> read path, with their dispatch.

``offsets_scan`` (K1) and ``byteshuffle`` (K2) serve the writer's fill
and seal; ``decode_pages`` (K3, K4 and the drivers) serves the reader's
device read-back.  ``ops`` holds the dispatch and the launch counts,
``ref`` the plain PyTorch versions, ``_build`` the nvcc build.  Every
module imports without ``nvcc`` or a card: the CUDA libraries build and
load inside the first launch.
"""

from . import byteshuffle, decode_pages, offsets_scan, ops, ref

__all__ = ["byteshuffle", "decode_pages", "offsets_scan", "ops", "ref"]
