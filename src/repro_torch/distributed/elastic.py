"""Elastic scaling: restart a run on a different mesh shape, the twin of
``repro.distributed.elastic``.

The pieces that make this work are deliberately boring:
  * checkpoints are mesh-agnostic (single self-describing file of full
    leaves; the training loop's rank 0 writes it and every rank places
    what it reads on its current mesh),
  * the loader cursor is logical (entry index), not host-indexed,
  * param shardings are derived from (shape, mesh) at load time by
    ``auto_param_sharding``, never stored.

``replan`` computes the new mesh + shardings after a resize and reports
what changes (per-device memory, dp degree).  It takes a live mesh or a
``MeshShape``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

from repro_torch.launch.mesh import mesh_shape

from .sharding import auto_param_sharding


@dataclass
class ElasticPlan:
    mesh: object
    param_shardings: object
    dp_degree: int
    per_device_param_bytes: int

    def describe(self) -> str:
        return (f"mesh={mesh_shape(self.mesh).shape} dp={self.dp_degree} "
                f"params/device={self.per_device_param_bytes/2**20:.1f} MiB")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def replan(param_shapes, mesh) -> ElasticPlan:
    shardings = auto_param_sharding(param_shapes, mesh)
    total = sum(math.prod(l.shape) * l.element_size()
                for l in _leaves(param_shapes))
    ms = mesh_shape(mesh)
    n_dev = ms.size
    dp = math.prod(ms.shape[a] for a in ("pod", "data") if a in ms.axis_names)
    return ElasticPlan(mesh, shardings, dp, total // max(n_dev, 1))


def validate_batch_divisibility(global_batch: int, plan: ElasticPlan) -> Tuple[bool, str]:
    if global_batch % plan.dp_degree:
        return False, (f"global_batch {global_batch} not divisible by new "
                       f"dp degree {plan.dp_degree}; adjust accumulation")
    return True, ""
