"""Logical-axis sharding rules (MaxText-style) + FSDP auto param sharding,
the twin of ``repro.distributed.sharding`` on torch device meshes.

Code annotates tensors with *logical* axes via :func:`shard`:

    x = shard(x, "dp", "sp", None)        # (batch, seq, d_model)

An :class:`AxisRules` context maps logical names to mesh axes.  The mapping
is *divisibility-checked per tensor*: if a dimension is not divisible by
the mapped mesh-axis size the constraint silently degrades to replication
for that dim.  That single rule places every assigned architecture on the
production mesh (e.g. gemma's 8 heads or smollm's 15 heads cannot shard
over model=16 and fall back to replicated attention, while their
MLP/vocab dims still shard).

Parameters are sharded by :func:`auto_param_sharding` — ZeRO-3/FSDP style:
for each >=2-D weight, the largest dim shards over the fsdp axes and the
next largest over the tensor-parallel axis, both divisibility-guarded.
Stacked layer params skip their leading layer dim.

A spec is the reference's ``PartitionSpec`` as a tuple: per tensor dim
``None``, a mesh axis name, or a tuple of names (major to minor).
:func:`to_placements` turns it into DTensor placements, one ``Shard(d)``
or ``Replicate()`` per mesh dim.  Rules and specs take a live
``DeviceMesh`` or a :class:`~repro_torch.launch.mesh.MeshShape`; placing a
tensor (:func:`shard`, :func:`place`) needs a live mesh.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import MeshShape, mesh_shape

_state = threading.local()

AxisName = Union[str, None, Tuple[str, ...]]
Spec = Tuple[AxisName, ...]

# default logical -> mesh mapping for the production mesh
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "dp": ("pod", "data"),      # batch
    "fsdp": ("pod", "data"),    # parameter sharding
    "sp": ("model",),           # sequence (activations between blocks)
    "tp": ("model",),           # heads / d_ff / vocab / experts
    "tp_kv": ("model",),        # kv heads (falls back per-tensor)
    "sp_kv": ("model",),        # kv-cache sequence: shards iff tp_kv fell back
    "ep": ("model",),           # experts
    "ep2": ("model",),          # MoE capacity dim: shards iff ep fell back
    "sp_attn": ("model",),      # attention q-sequence: iff heads fell back
}


def _size(shape: MeshShape, axes: Sequence[str]) -> int:
    return math.prod(shape.shape[a] for a in axes)


class AxisRules:
    def __init__(self, mesh, mapping: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        mapping = dict(mapping or DEFAULT_RULES)
        # drop mesh axes that don't exist (e.g. "pod" on the single-pod mesh)
        self.mapping = {
            k: tuple(a for a in v if a in self.shape.axis_names)
            for k, v in mapping.items()
        }

    def axis_size(self, logical: str) -> int:
        return _size(self.shape, self.mapping.get(logical, ()))

    def spec(self, logical_axes: Sequence[AxisName], shape: Sequence[int]) -> Spec:
        parts: List[AxisName] = []
        used: set = set()
        for dim, name in zip(shape, logical_axes):
            if name is None:
                parts.append(None)
                continue
            names = (name,) if isinstance(name, str) else name
            mesh_axes: Tuple[str, ...] = ()
            for n in names:
                mesh_axes += self.mapping.get(n, ())
            mesh_axes = tuple(a for a in mesh_axes if a not in used)
            size = _size(self.shape, mesh_axes)
            if size > 1 and dim % size == 0:
                parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
                used.update(mesh_axes)
            else:
                parts.append(None)  # divisibility fallback -> replicate
        return tuple(parts)


def current_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


@contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def _axes(part: AxisName) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def to_placements(spec: Sequence[AxisName], mesh) -> list:
    """A spec -> DTensor placements, one per mesh dim: ``Shard(d)`` where
    tensor dim ``d`` names the mesh axis, ``Replicate()`` elsewhere.  A dim
    over several axes must name them in mesh order (DTensor shards a dim
    over its mesh dims left to right, as a spec names them major to
    minor)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_shape(mesh).axis_names
    owner = {}
    for d, part in enumerate(spec):
        axes = _axes(part)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {tuple(spec)}: axes {axes} are not in "
                             f"mesh order {names}")
        for a in axes:
            if a not in names or a in owner:
                raise ValueError(f"spec {tuple(spec)}: axis {a!r} unknown or "
                                 "used twice")
            owner[a] = d
    return [Shard(owner[a]) if a in owner else Replicate() for a in names]


def local_shape(spec: Sequence[AxisName], shape: Sequence[int],
                mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``
    (every sharded dim divides: the rules only shard those)."""
    sizes = mesh_shape(mesh).shape
    out = list(shape)
    for d, part in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes(part))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {_axes(part)}")
        out[d] //= n
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s twin)."""
    mesh: object
    spec: Spec

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return local_shape(self.spec, shape, self.mesh)


def place(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the same global value on every rank, or a DTensor) as a
    DTensor with ``sharding``'s placements on its live mesh; a plain tensor
    gives its local chunk without communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = sharding.mesh
    if isinstance(mesh, MeshShape):
        raise TypeError("placing a tensor needs a live DeviceMesh, not a "
                        "MeshShape")
    placements = sharding.placements
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    d = distribute_tensor(x, mesh, placements, src_data_rank=None)
    local = d.to_local()
    if local.numel() == x.numel():
        return d
    # a chunk is a view of ``x``: copy it, so that ``x`` can be freed
    return DTensor.from_local(local.clone(), mesh, placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def shard(x: torch.Tensor, *logical_axes: AxisName) -> torch.Tensor:
    """Apply a logical sharding constraint (no-op outside an AxisRules ctx).

    If every requested axis degrades to None (divisibility fallback), the
    constraint is SKIPPED entirely and ``x`` comes back as it was.  Inside
    rules on a live mesh a plain tensor becomes a DTensor and a DTensor is
    redistributed; rules on a :class:`MeshShape` have no devices to place
    on and leave ``x`` as it is.
    """
    rules = current_rules()
    if rules is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"shard(): {len(logical_axes)} axes for rank-{x.ndim} array"
        )
    spec = rules.spec(logical_axes, x.shape)
    if all(p is None for p in spec) or isinstance(rules.mesh, MeshShape):
        return x
    return place(x, NamedSharding(rules.mesh, spec))


# ---------------------------------------------------------------------------
# FSDP auto sharding of parameter trees


def _leaf_spec(
    shape: Tuple[int, ...],
    mesh,
    fsdp_axes: Tuple[str, ...],
    tp_axis: Optional[str],
    stacked: bool,
) -> Spec:
    ms = mesh_shape(mesh)
    parts: list = [None] * len(shape)
    dims = list(range(len(shape)))
    if stacked and len(shape) >= 3:
        dims = dims[1:]  # never shard the scan/layer dim
    if not dims or len(shape) < 2:
        return tuple(parts)
    fsdp_size = _size(ms, fsdp_axes)
    tp_size = (int(ms.shape[tp_axis]) if tp_axis and tp_axis in ms.axis_names
               else 1)
    order = sorted(dims, key=lambda d: -shape[d])
    # largest shardable dim -> fsdp
    fsdp_dim = next((d for d in order if fsdp_size > 1 and shape[d] % fsdp_size == 0), None)
    if fsdp_dim is not None:
        parts[fsdp_dim] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    # next largest shardable dim -> tp
    tp_dim = next(
        (d for d in order
         if d != fsdp_dim and tp_size > 1 and shape[d] % tp_size == 0),
        None,
    )
    if tp_dim is not None:
        parts[tp_dim] = tp_axis
    return tuple(parts)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts; ``path`` is the tuple of keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def auto_param_sharding(
    params_shapes,
    mesh,
    fsdp_axes: Optional[Tuple[str, ...]] = None,
    tp_axis: str = "model",
):
    """NamedSharding tree for a parameter tree (of tensors, ``meta`` ones
    included: only shapes are read)."""
    names = mesh_shape(mesh).axis_names
    if fsdp_axes is None:
        fsdp_axes = tuple(a for a in ("pod", "data") if a in names)

    def one(path, leaf):
        stacked = any(k in ("layers", "groups") for k in path)
        spec = _leaf_spec(tuple(leaf.shape), mesh, tuple(fsdp_axes), tp_axis,
                          stacked)
        return NamedSharding(mesh, spec)

    return tree_map_with_path(one, params_shapes)


def replicated(tree, mesh):
    return tree_map_with_path(lambda _p, _l: NamedSharding(mesh, ()), tree)
