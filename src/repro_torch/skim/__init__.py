"""Dataset skimming application (paper §6.2, AGC-style), the twin of
``repro.skim``."""

from .engine import (
    EVENT_SCHEMA, Cuts, make_agc_dataset, skim_file, skim_partitions,
    STRATEGIES,
)

__all__ = ["EVENT_SCHEMA", "Cuts", "make_agc_dataset", "skim_file",
           "skim_partitions", "STRATEGIES"]
