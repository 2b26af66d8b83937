"""Collective helpers over a device mesh's process groups, the twin of
``repro.distributed.collectives``, and the batch reductions of the
meshed train step.

The reference's helpers run inside ``shard_map`` and name mesh axes; here
each takes the live ``DeviceMesh`` and the axis names, and issues the
collective on that axis's process group.  They encode the multi-pod
hierarchy: reduce-scatter inside the pod (cheap links), all-reduce across
pods only on the already-reduced shard (the pod axis carries 1/|data| of
the bytes).

:func:`sum_over` is what keeps a data-parallel loss the reference's
global math: the meshed step sums the model's counts over the ranks that
hold other rows of the batch with it (cross-entropy's token count, the
MoE balance loss's picks and token count).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

def _group(mesh, axis: str):
    return mesh.get_group(axis)


def hierarchical_psum(x: torch.Tensor, mesh, pod_axis: str = "pod",
                      data_axis: str = "data") -> torch.Tensor:
    """Sum over (pod, data) as scatter(data) -> all-reduce(pod) ->
    gather(data) along dim 0 (which ``|data|`` must divide).

    Equal to an all-reduce over both axes, but the cross-pod hop moves
    1/|data| of the bytes: the standard hierarchical trick for gradient
    reduction at multi-pod scale.
    """
    g_data, g_pod = _group(mesh, data_axis), _group(mesh, pod_axis)
    n_data = dist.get_world_size(g_data)
    x = x.contiguous()
    part = x.new_empty((x.shape[0] // n_data,) + tuple(x.shape[1:]))
    dist.reduce_scatter_single(part, x, group=g_data)
    dist.all_reduce(part, group=g_pod)
    out = torch.empty_like(x)
    dist.all_gather_single(out, part, group=g_data)
    return out


def reduce_scatter_grads(tree, mesh, axis: str):
    """ZeRO-style: every rank ends with its dim-0 shard of the summed
    gradient; a tensor whose dim 0 ``|axis|`` does not divide (or a
    scalar) is all-reduced whole."""
    g = _group(mesh, axis)
    n = dist.get_world_size(g)

    def one(t):
        t = t.contiguous()
        if t.dim() and t.shape[0] % n == 0:
            out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
            dist.reduce_scatter_single(out, t, group=g)
            return out
        out = t.clone()
        dist.all_reduce(out, group=g)
        return out

    if isinstance(tree, dict):
        return {k: reduce_scatter_grads(v, mesh, axis) for k, v in tree.items()}
    return one(tree)


def ring_permute(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Rank ``i`` of ``axis`` sends ``x`` to rank ``i + shift`` and returns
    what rank ``i - shift`` sent (``lax.ppermute`` over the ring)."""
    g = _group(mesh, axis)
    n = dist.get_world_size(g)
    me = dist.get_group_rank(g, dist.get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    if n == 1 or shift % n == 0:
        return out.copy_(x)
    dst = dist.get_global_rank(g, (me + shift) % n)
    src = dist.get_global_rank(g, (me - shift) % n)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group=g),
                                     dist.P2POp(dist.irecv, out, src, group=g)]):
        w.wait()
    return out


# ---------------------------------------------------------------------------
# the meshed step's sums over the batch's rows


def sum_over(mesh, axes: Sequence[str]) -> Callable:
    """-> ``total(t)``: ``t`` summed over the mesh ``axes`` (those of size 1
    left out; with none left, ``t`` itself), a new tensor outside autograd
    (counts and normalisers, never a value to differentiate).  The meshed
    train step sums the loss's counts over the ranks holding the batch's
    rows with it."""
    groups = [mesh.get_group(a) for a in axes
              if mesh.size(list(mesh.mesh_dim_names).index(a)) > 1]

    def total(t: torch.Tensor) -> torch.Tensor:
        if not groups:
            return t
        out = t.detach().clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    return total
