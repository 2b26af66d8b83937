"""Models of the port: every architecture of the registry (attention
blocks with GQA or MLA and an MLP or MoE, rwkv6, the zamba2 hybrid) on one
backbone, twins of ``repro.models`` with the reference's parameter trees
(``weights`` carries them across)."""

from .registry import ModelBundle, build, make_batch

__all__ = ["ModelBundle", "build", "make_batch"]
