"""Minicpm3 4B — exact literature config (see base.ArchConfig)."""

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73_448, attention="mla",
    mla=MLAConfig(q_rank=768, kv_rank=256, d_nope=64, d_rope=32, d_v=64),
    source="hf:openbmb/MiniCPM3-4B (MLA)",
)

MINICPM3_4B = CONFIG
