"""Rwkv6 7B — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab_size=65_536, attention="none",
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=32),
    source="arXiv:2404.05892 (Finch, data-dependent decay)",
)

RWKV6_7B = CONFIG
