"""Production mesh definitions, the twin of ``repro.launch.mesh``.

Single pod: 256 ranks as (data=16, model=16).
Multi-pod:  2 pods x 256 ranks as (pod=2, data=16, model=16); the "pod"
axis carries inter-pod data parallelism (gradient all-reduce crosses the
pod boundary; everything bandwidth-heavy stays intra-pod).

A live mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
world ``torch.distributed`` was started with: NCCL on the card (one rank
a card), gloo when the caller asks for ``device="cpu"``.  A
:class:`MeshShape` is a mesh's axis names and sizes without devices or
ranks: the sharding rules, ``elastic.replan`` and the dry-run reason about
the 256- and 512-rank production meshes from one process with it, as the
reference does with fake host devices.

Functions, not module constants: importing this module never touches the
process group.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.ops import resolve_device

#: the production meshes' (axis names, sizes)
PRODUCTION = {False: (("data", "model"), (16, 16)),
              True: (("pod", "data", "model"), (2, 16, 16))}


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} against sizes {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, in mesh order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (or of a MeshShape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    return MeshShape(*PRODUCTION[multi_pod])


def _device_type(device) -> str:
    dev = torch.device(device)
    return "cpu" if dev.type == "cpu" else resolve_device(dev).type


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(device="cuda") -> None:
    """Start a one-rank group (NCCL on the card, gloo on the CPU) on a free
    ``localhost`` port unless ``torch.distributed`` is already started."""
    if dist.is_initialized():
        return
    kind = _device_type(device)
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo",
        init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (data=16, model=16) mesh, or (pod=2, data=16, model=16); the
    world must hold exactly that many ranks (``RuntimeError`` otherwise,
    as ``jax.make_mesh`` refuses too few devices)."""
    from torch.distributed.device_mesh import init_device_mesh

    names, sizes = PRODUCTION[multi_pod]
    need = production_mesh_shape(multi_pod).size
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(f"the production mesh needs {need} ranks, this "
                           f"world has {have}")
    return init_device_mesh(_device_type(device), sizes, mesh_dim_names=names)


def make_local_mesh(model: int = 1, device="cuda"):
    """A (data, model) mesh over the world ``torch.distributed`` was started
    with; a one-rank group is started when there is none (NCCL on the
    card, gloo for ``device="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    ensure_process_group(device)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide the world of {n}")
    return init_device_mesh(_device_type(device), (n // model, model),
                            mesh_dim_names=("data", "model"))


def describe(mesh) -> str:
    shape = mesh_shape(mesh).shape
    return " x ".join(f"{a}={n}" for a, n in shape.items())
