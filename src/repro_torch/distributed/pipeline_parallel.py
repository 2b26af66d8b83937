"""Pipeline parallelism: GPipe-style microbatching over a mesh axis, the
twin of ``repro.distributed.pipeline_parallel``.

``pipelined`` runs a homogeneous layer stack as P pipeline stages over the
``stage`` mesh axis: every stage holds n_layers/P layers; microbatches
stream through with ring hand-offs between neighbouring stages
(``collectives.ring_permute``: ``send``/``recv`` pairs in one
``batch_isend_irecv``).  The classic rotation runs stages for (M + P - 1)
ticks, each rank computing on the microbatch currently resident — bubble
fraction (P-1)/(M+P-1).  A stage skips the layers on the ticks where it
holds no microbatch (the reference computes them and discards the
result).

The production configs default to FSDP+TP (every assigned model fits), but
this module carries the multi-pod story where a model would NOT fit one
pod's memory: stage the layer stack across pods ("pod" becomes the stage
axis) so each pod holds 1/P of the parameters, trading bubble for memory.
The hand-offs are collectives outside autograd: ``apply`` is a forward
pass (the port's train step does not pipeline, as the reference's does
not either).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .collectives import ring_permute


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipelined(
    layer_fn: Callable,       # (layer_params, x) -> x
    mesh,
    stage_axis: str,
    n_microbatches: int,
):
    """Build a pipelined stack applier.

    Returns ``apply(stacked_params, x)`` where ``stacked_params`` leaves
    have leading dim n_layers (n_layers % n_stages == 0) and ``x`` is
    (batch, ...) with batch % n_microbatches == 0; both the same on every
    rank.  Every rank returns the last stage's output.
    """
    group = mesh.get_group(stage_axis)
    n_stages = dist.get_world_size(group)
    my_stage = dist.get_group_rank(group, dist.get_rank())
    last = dist.get_global_rank(group, n_stages - 1)

    def apply(stacked_params, x):
        m = n_microbatches
        mb = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        lead = {}

        def mine(t):
            n = t.shape[0]
            if n % n_stages:
                raise ValueError(f"{n} layers over {n_stages} stages")
            per = n // n_stages
            lead["per"] = per
            return t[my_stage * per:(my_stage + 1) * per]

        params_stage = _tree_map(mine, stacked_params)

        def run_layers(h):
            for i in range(lead["per"]):
                h = layer_fn(_tree_map(lambda t: t[i], params_stage), h)
            return h

        outputs = torch.zeros_like(mb)
        buf = torch.zeros_like(mb[0])
        for t in range(m + n_stages - 1):
            x_in = mb[t if t < m else 0] if my_stage == 0 else buf
            active = 0 <= t - my_stage < m
            y = run_layers(x_in) if active else x_in
            # pass to next stage; last stage's output wraps to 0 (ignored)
            buf = ring_permute(y, mesh, stage_axis)
            if my_stage == n_stages - 1 and t >= n_stages - 1:
                outputs[t - (n_stages - 1)] = y
        dist.broadcast(outputs, src=last, group=group)
        return outputs.reshape(x.shape)

    return apply
