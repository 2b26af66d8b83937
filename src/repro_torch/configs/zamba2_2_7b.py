"""Zamba2 2 7B — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32_000, shared_attn_every=6,
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2, chunk=64),
    source="arXiv:2411.15242 (Mamba2 backbone + shared attn blocks)",
)

ZAMBA2_2_7B = CONFIG
