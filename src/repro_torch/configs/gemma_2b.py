"""Gemma 2B — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256_000, mlp="geglu", tie_embeddings=True,
    scale_embeddings=True,
    source="arXiv:2403.08295 (GeGLU, head_dim=256, MQA)",
)

GEMMA_2B = CONFIG
