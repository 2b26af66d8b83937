"""Distribution substrate: sharding rules, collectives, pipeline parallel,
elastic replanning — the twin of ``repro.distributed`` on torch device
meshes (``torch.distributed``: NCCL on cards, gloo on the CPU)."""

from .sharding import (
    AxisRules, axis_rules, auto_param_sharding, current_rules, replicated,
    shard, DEFAULT_RULES, NamedSharding, place, to_placements,
)

__all__ = [
    "AxisRules", "axis_rules", "auto_param_sharding", "current_rules",
    "replicated", "shard", "DEFAULT_RULES", "NamedSharding", "place",
    "to_placements",
]
