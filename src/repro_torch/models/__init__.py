"""Models of the port: the dense family (GQA/MQA, gated MLP), rwkv6 and
the zamba2 hybrid on one backbone, twins of ``repro.models`` with the
reference's parameter trees (``weights`` carries them across)."""

from .registry import ModelBundle, build, make_batch

__all__ = ["ModelBundle", "build", "make_batch"]
