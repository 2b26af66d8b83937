"""Mixture-of-Experts FFN: top-k routing with capacity-factor dispatch.

The twin of ``repro.models.moe``: GShard/Switch-style dispatch in which
each sequence is a routing group, tokens go into per-expert capacity
buckets through one-hot dispatch tensors ``(B, T, E, C)``, and every
expert product is a dense ``torch.einsum`` over the expert axis (the
reference computes them outside any Pallas kernel too).  A token whose
bucket is full is dropped: its routed output is 0 (the shared experts
still see it), so drops are part of the result, and the capacity is
``C = k T cf / E`` rounded up to a multiple of 4 (at least 4).

Mixtral (8 experts, top-2) and DeepSeekMoE (64 fine-grained experts,
top-6, plus 2 shared experts every token uses) take the same code.  The
reference's ``shard(...)`` annotations are dropped (the meshed train step
computes on gathered parameters).  ``moe_route_sums`` returns the layer's
routing sums over its (B, T) and ``balance_loss`` forms the Switch loss
from them, so that a caller holding rows of a larger batch can sum them
over its ranks first (the meshed train step).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from .layers import _normal, cdtype, dense_init, pdtype


def moe_init(gen, cfg: ArchConfig, device) -> Dict:
    """The router (D, E), the routed experts' bank and, where the config
    has them, the shared experts' bank: ``w_gate`` / ``w_up`` (n, D, F),
    ``w_down`` (n, F, D)."""
    m = cfg.moe
    d, f, dt = cfg.d_model, cfg.d_ff, pdtype(cfg)

    def expert_bank(n):
        return {
            "w_gate": (_normal(gen, (n, d, f), device) / math.sqrt(d)).to(dt),
            "w_up": (_normal(gen, (n, d, f), device) / math.sqrt(d)).to(dt),
            "w_down": (_normal(gen, (n, f, d), device) / math.sqrt(f)).to(dt),
        }

    p = {"router": dense_init(gen, d, m.n_experts, dt, device),
         "experts": expert_bank(m.n_experts)}
    if m.n_shared:
        p["shared"] = expert_bank(m.n_shared)
    return p


def _capacity(group_tokens: int, cfg: ArchConfig) -> int:
    """Bucket slots per expert for a routing group of ``group_tokens``."""
    m = cfg.moe
    cap = int(math.ceil(m.top_k * group_tokens * m.capacity_factor
                        / m.n_experts))
    return max(4, ((cap + 3) // 4) * 4)  # pad to a multiple of 4


def balance_loss(probs: torch.Tensor, picks: torch.Tensor,
                 tokens) -> torch.Tensor:
    """The Switch load-balancing loss, E * sum_e mean prob_e * mean
    picks_e, from ``moe_route_sums``' sums over ``tokens`` routed tokens
    (``probs`` and ``picks`` (..., E); a leading layer axis is summed
    over)."""
    e = probs.shape[-1]
    return (e * torch.sum((probs / tokens) * (picks / tokens))).float()


def moe_apply(params: Dict, x: torch.Tensor,
              cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (y (B, T, D), the Switch balance loss, fp32)."""
    y, probs, picks = moe_route_sums(params, x, cfg)
    return y, balance_loss(probs, picks, x.shape[0] * x.shape[1])


def moe_route_sums(params: Dict, x: torch.Tensor, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (y (B, T, D), the router's probabilities summed
    over (B, T) (E,), fp32, the top-k picks of each expert summed over
    (B, T) (E,), fp32)."""
    m = cfg.moe
    dt = cdtype(cfg)
    b, t, _ = x.shape
    e, k = m.n_experts, m.top_k
    xt = x.to(dt)

    # routing: logits in the compute dtype, softmax in fp32, top-k renormed
    probs = torch.softmax((xt @ params["router"].to(dt)).float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)            # (B, T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # each (token, k)'s place in its expert's bucket, t-major then k
    cap = _capacity(t, cfg)
    onehot = F.one_hot(gate_idx, e).float()                       # (B,T,K,E)
    pos_in_expert = torch.cumsum(onehot.reshape(b, t * k, e), dim=1) - 1.0
    pos = (pos_in_expert.reshape(b, t, k, e) * onehot).sum(-1)    # (B, T, K)
    keep = pos < cap                                              # the drop
    gate_vals = gate_vals * keep.float()
    # a dropped place maps to the extra column ``cap``, cut off (the
    # reference's one_hot of an index past its classes is all zeros)
    pos_oh = F.one_hot(pos.long().clamp(max=cap), cap + 1)[..., :cap].float()
    dispatch = torch.einsum("btke,btkc->btec",
                            onehot * keep[..., None].float(), pos_oh)
    combine = torch.einsum("btke,btkc->btec", onehot * gate_vals[..., None],
                           pos_oh)
    dispatch, combine = dispatch.to(dt), combine.to(dt)

    # the experts: dense products over their buckets
    we = params["experts"]
    xe = torch.einsum("btec,btd->ebcd", dispatch, xt)             # (E,B,C,D)
    g = F.silu(torch.einsum("ebcd,edf->ebcf", xe, we["w_gate"].to(dt)))
    u = torch.einsum("ebcd,edf->ebcf", xe, we["w_up"].to(dt))
    ye = torch.einsum("ebcf,efd->ebcd", g * u, we["w_down"].to(dt))
    y = torch.einsum("btec,ebcd->btd", combine, ye)

    # the shared experts see every token
    if m.n_shared:
        ws = params["shared"]
        gs = F.silu(torch.einsum("btd,sdf->btsf", xt, ws["w_gate"].to(dt)))
        us = torch.einsum("btd,sdf->btsf", xt, ws["w_up"].to(dt))
        y = y + torch.einsum("btsf,sfd->btd", gs * us, ws["w_down"].to(dt))

    # the balance loss's sums (``balance_loss``)
    return y, probs.sum(dim=(0, 1)), onehot.sum(dim=2).sum(dim=(0, 1))
