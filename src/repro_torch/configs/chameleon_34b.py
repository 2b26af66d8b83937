"""Chameleon 34B — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65_536, qk_norm=True,
    source="arXiv:2405.09818 (early-fusion, VQ image tokens in vocab)",
)

CHAMELEON_34B = CONFIG
