"""Architecture configuration model.

One frozen dataclass describes every assigned architecture; the model
code in ``repro_torch.models`` consumes it.  Exact literature values
live in the per-arch files in this package.  The port's own copy of the
JAX package's ``configs/base.py`` with two differences: the parameter
count builds the port's modules on the ``meta`` device (which allocates
nothing), and ``scale_embeddings`` is a field of the config where the
reference tests the model's name for gemma's embedding scaling.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0                 # shared (always-on) experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    q_rank: int          # low-rank query compression
    kv_rank: int         # low-rank kv compression (this is what decode caches)
    d_nope: int          # per-head non-rotary q/k dim
    d_rope: int          # shared rotary dim
    d_v: int             # per-head value dim


@dataclass(frozen=True)
class SSMConfig:
    kind: str            # "rwkv6" | "mamba2"
    d_state: int = 64    # mamba2 N; rwkv6 uses head_dim
    head_dim: int = 64   # P (mamba2) / Dk=Dv (rwkv6)
    expand: int = 2      # d_inner = expand * d_model (mamba2)
    conv_kernel: int = 4
    chunk: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    mlp: str = "swiglu"               # swiglu | geglu
    attention: str = "gqa"            # gqa | mla | none
    window: Optional[int] = None      # sliding-window attention
    qk_norm: bool = False             # chameleon-style qk layernorm
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0        # zamba2: shared attn block period
    n_codebooks: int = 1              # musicgen: 4 EnCodec codebooks
    tie_embeddings: bool = False
    scale_embeddings: bool = False    # gemma: embeddings * sqrt(d_model)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True                # activation checkpointing over layers
    scan_layers: bool = True          # False: python-unrolled (cost probes)
    attn_impl: str = "ref"            # "ref" | "chunked" (§Perf variant)
    # source provenance for the config values
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded memory?"""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True  # shared-attn blocks run windowed at long context
        return self.window is not None

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    # -- parameter counting (for 6·N·D roofline bookkeeping) -------------------

    def param_count(self) -> int:
        """Parameters of the port's model, counted from its parameter
        tree built on the ``meta`` device (shapes only, no memory).
        Raises ``NotImplementedError`` for a family the port has no
        model for yet."""
        from repro_torch.models.registry import build  # lazy, avoids cycle

        params = build(self).init(None, "meta")
        return sum(t.numel() for t in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
