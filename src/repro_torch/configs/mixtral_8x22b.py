"""Mixtral 8X22B — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32_768, window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
    source="arXiv:2401.04088 (8 experts top-2, SWA)",
)

MIXTRAL_8X22B = CONFIG
