"""Smollm 360M — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49_152,
    source="hf:HuggingFaceTB/SmolLM-360M",
)

SMOLLM_360M = CONFIG
