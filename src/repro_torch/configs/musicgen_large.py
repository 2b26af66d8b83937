"""Musicgen Large — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, n_codebooks=4, mlp="gelu",
    source="arXiv:2306.05284 (decoder-only over EnCodec tokens, 4 codebooks)",
)

MUSICGEN_LARGE = CONFIG
