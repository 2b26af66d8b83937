"""Deepseek 67B — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102_400,
    source="arXiv:2401.02954 (llama-arch GQA)",
)

DEEPSEEK_67B = CONFIG
