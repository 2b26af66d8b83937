"""The port's configurations (its own copies; nothing imported from repro):
the ten architectures with their input-shape cells, and the paper's
writer configuration (``rntj_writer``)."""

from .archs import ARCHS, get_arch, smoke_config
from .base import (
    ArchConfig, MLAConfig, MoEConfig, SSMConfig, ShapeCell, SHAPES,
    SHAPES_BY_NAME,
)

__all__ = [
    "ARCHS", "get_arch", "smoke_config", "ArchConfig", "MLAConfig",
    "MoEConfig", "SSMConfig", "ShapeCell", "SHAPES", "SHAPES_BY_NAME",
]
