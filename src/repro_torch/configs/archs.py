"""The ten assigned architectures — registry.

Exact literature configs live in one module per architecture
(``gemma_2b.py`` ... ``musicgen_large.py``) per the deliverable layout;
this module aggregates them and derives reduced smoke variants.
"""

from __future__ import annotations

from typing import Dict

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from .gemma_2b import CONFIG as GEMMA_2B
from .minicpm3_4b import CONFIG as MINICPM3_4B
from .deepseek_67b import CONFIG as DEEPSEEK_67B
from .smollm_360m import CONFIG as SMOLLM_360M
from .rwkv6_7b import CONFIG as RWKV6_7B
from .chameleon_34b import CONFIG as CHAMELEON_34B
from .mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from .deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from .zamba2_2_7b import CONFIG as ZAMBA2_2_7B
from .musicgen_large import CONFIG as MUSICGEN_LARGE

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        GEMMA_2B, MINICPM3_4B, DEEPSEEK_67B, SMOLLM_360M, RWKV6_7B,
        CHAMELEON_34B, MIXTRAL_8X22B, DEEPSEEK_MOE_16B, ZAMBA2_2_7B,
        MUSICGEN_LARGE,
    )
}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}") from None


def smoke_config(name: str) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests.

    Shrinks layers/width/experts/vocab but keeps every structural feature
    (GQA ratios, MLA ranks, MoE topology, shared-attn period, codebooks).
    """
    c = get_arch(name)
    kw = dict(
        n_layers=min(c.n_layers, 4 if c.shared_attn_every == 0 else 4),
        d_model=128, d_ff=256, vocab_size=512,
        n_heads=4, n_kv_heads=max(1, 4 * c.n_kv_heads // c.n_heads),
        head_dim=32, remat=False,
    )
    if c.shared_attn_every:
        kw["n_layers"] = 4
        kw["shared_attn_every"] = 2
    if c.mla is not None:
        kw["mla"] = MLAConfig(q_rank=64, kv_rank=32, d_nope=16, d_rope=8, d_v=16)
        kw["n_kv_heads"] = kw["n_heads"]
    if c.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=min(c.moe.n_experts, 8),
            top_k=min(c.moe.top_k, 2),
            n_shared=min(c.moe.n_shared, 1),
        )
    if c.ssm is not None:
        kw["ssm"] = SSMConfig(
            kind=c.ssm.kind, d_state=16, head_dim=16,
            expand=c.ssm.expand, conv_kernel=c.ssm.conv_kernel, chunk=16,
        )
        if c.ssm.kind == "rwkv6":
            kw["n_heads"] = kw["n_kv_heads"] = 128 // 16  # d_model / head_dim
    return c.with_(**kw)
