"""Operations and bytes, worked out from a configuration's sizes alone.

Frozen copies, each from its source line:

* ``train_step_flops`` and ``serve_batch_flops`` follow
  ``launch/dryrun.model_flops`` (``src/repro_torch/launch/dryrun.py:99``):
  6 N D for training, 2 N D for a forward, MoE counting ``top_k`` of
  ``n_experts`` routed experts.
  Here N leaves out the embedding table (a gather, no product) and keeps
  the output head, and causal attention's products are added (forward 4
  D a visible pair and head, backward twice that); no recomputation is
  counted.
* ``attention_fwd_bound`` and ``decode_attention_bound`` are
  ``chip_smoke.attention_bound`` (``chip_smoke.py:562``) for K5 and K6;
  ``attention_bwd_bound`` is ``chip_smoke.attention_bwd_bound``
  (``chip_smoke.py:2363``).

Parameters are counted from the sizes, not from the program's model, so
that the count stays what these formulas say.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def layer_params(cfg: Dict, active: bool = False) -> int:
    """Parameters of one attention block: GQA attention (qk-norm gains
    where set), two norms, and a SwiGLU MLP or a MoE layer (router, routed
    experts, shared experts).  ``active``: the routed experts count
    ``top_k`` of them."""
    d, h, g, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    n = d * h * hd + 2 * d * g * hd + h * hd * d + 2 * d
    if cfg.get("qk_norm"):
        n += 2 * hd
    moe = cfg.get("moe")
    if moe:
        expert = 3 * d * cfg["d_ff"]
        routed = moe["top_k"] if active else moe["n_experts"]
        n += d * moe["n_experts"] + (routed + moe.get("n_shared", 0)) * expert
    else:
        n += 3 * d * cfg["d_ff"]
    return n


def param_count(cfg: Dict) -> int:
    """Every parameter: the embedding, the layers, the final norm and the
    output head (untied)."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    return v * d + cfg["n_layers"] * layer_params(cfg) + d + d * v


def active_params(cfg: Dict) -> int:
    """N of 6 N D: the layers with ``top_k`` routed experts, the final
    norm and the output head; not the embedding table."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    return cfg["n_layers"] * layer_params(cfg, active=True) + d + d * v


def causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a causal mask leaves, query ``i`` at position
    ``i + sk - sq``."""
    off = sk - sq
    return sum(max(0, min(sk, i + off + 1)) for i in range(sq))


def attention_fwd_flops(cfg: Dict, batch: int, seq: int) -> float:
    """QK^T and PV over the visible pairs of every layer's heads."""
    hd = head_dim(cfg)
    return (2.0 * batch * cfg["n_heads"] * 2 * hd * causal_pairs(seq, seq)
            * cfg["n_layers"])


def train_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model operations of one training step on (batch, seq) tokens."""
    return (6.0 * active_params(cfg) * batch * seq
            + 3.0 * attention_fwd_flops(cfg, batch, seq))


def serve_batch_flops(cfg: Dict, batch: int, prompt: int, new: int) -> float:
    """Model operations of one greedy batch: a prefill of the prompt whose
    head runs at the last position only, then ``new - 1`` one-token decode
    steps attending to the cache (``prompt + i + 1`` rows at step ``i``)."""
    d, v, hd = cfg["d_model"], cfg["vocab_size"], head_dim(cfg)
    layers = active_params(cfg) - d * v - d
    prefill = (2.0 * layers * batch * prompt + attention_fwd_flops(cfg, batch, prompt)
               + 2.0 * d * v * batch)
    decode = sum(2.0 * (layers + d * v) * batch
                 + 4.0 * batch * cfg["n_heads"] * hd * (prompt + i + 1) * cfg["n_layers"]
                 for i in range(new - 1))
    return prefill + decode


def _larger(nbytes: float, ops: float) -> Tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_fwd_bound(shape, itemsize: int) -> Tuple[float, str]:
    """(least ms, what bounds it) of one K5 forward call, ``shape`` (b, h,
    g, sq, sk, d[, dv]): q, k, v read once and o written once; ``2 (d +
    dv)`` operations a visible pair and head."""
    b, h, g, sq, sk, d = shape[:6]
    dv = shape[6] if len(shape) > 6 else d
    ops = 2 * b * h * (d + dv) * causal_pairs(sq, sk)
    nbytes = itemsize * (b * h * sq * (d + dv) + b * g * sk * (d + dv))
    return _larger(nbytes, ops)


def decode_attention_bound(shape, length: int, itemsize: int) -> Tuple[float, str]:
    """(least ms, what bounds it) of one K6 call, ``shape`` (b, h, g, d),
    ``length`` cache rows: the rows' k and v and q, o read or written once;
    4 d operations a row and head (``chip_smoke.attention_bound``)."""
    b, h, g, d = shape
    ops = 4 * b * h * length * d
    nbytes = itemsize * (2 * b * g * length * d + 2 * b * h * d)
    return _larger(nbytes, ops)


def attention_bwd_bound(shape, itemsize: int) -> Tuple[float, str]:
    """(least ms, what bounds it) of one K5 backward call: q, k, v, o and
    dO read once, dq, dk, dv written once; five products a visible pair
    and head, three of ``2 d`` operations and two of ``2 dv``."""
    b, h, g, sq, sk, d = shape[:6]
    dv = shape[6] if len(shape) > 6 else d
    ops = 2 * b * h * causal_pairs(sq, sk) * (3 * d + 2 * dv)
    nbytes = itemsize * (b * h * sq + b * g * sk) * (2 * d + 2 * dv)
    return _larger(nbytes, ops)
