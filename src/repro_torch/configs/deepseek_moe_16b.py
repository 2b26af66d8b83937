"""Deepseek Moe 16B — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102_400,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2),
    source="arXiv:2401.06066 (2 shared + 64 routed top-6, fine-grained; "
           "NOTE: paper's dense first layer folded into MoE stack for "
           "scan homogeneity, see DESIGN.md)",
)

DEEPSEEK_MOE_16B = CONFIG
