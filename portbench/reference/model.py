"""Plain float32 reference of the benchmark's decoder models and their
training step.

A decoder of attention blocks as the configuration file states it:
token embedding; per layer an RMS norm, GQA attention (query and key RMS
norms per head where ``qk_norm`` is set, split-half rotary embedding,
causal softmax), a residual, an RMS norm and a SwiGLU MLP or a
mixture of experts, a residual; a final RMS norm and an untied output
head; next-token cross-entropy plus ``aux_loss_alpha`` times the Switch
balance loss summed over the MoE layers.

The mixture of experts routes each sequence as one group (softmax over
the router's logits, top-k, renormalised where ``norm_topk_prob`` is
set), with per-expert buckets of ``C = ceil(k T cf / E)`` slots rounded up to a multiple of 4 (at least
4), filled in (token, choice) order; a choice whose bucket is full is
dropped (the shared experts still see its token).  This follows
GShard's capacity rule as the configuration states it.  The experts run
on the tokens routed to them (a gather and an indexed add), not on
one-hot dispatch tensors.

The optimizer is AdamW as the configuration's traffic states it: the
gradient clipped by its global norm, bias-corrected moments, decoupled
weight decay on leaves of two or more dimensions as the parameter spec
stacks them, a linear warm-up into a cosine schedule.

The layer equations are the configuration file's: where it lists
``departures`` from the published model (Chameleon-34B's qk-norm form
and its Swin-style norm order), the reference follows the file.

``mm`` is every matrix product; the control of the correctness check
passes :func:`fp8_mm`, which rounds both operands to float8 e4m3 (a
scale per tensor) and accumulates in float32.

Memory: parameters are stacked leaves ``(L, ...)`` as the spec gives
them; each layer's slice is its own autograd leaf (a view of the stack),
each layer is recomputed in the backward pass, attention a kv group at a
time (each group recomputed again), and the whole state (parameters,
gradients, two moments) is 16 bytes a parameter.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.compare import sample_stride
from portbench.yardstick.weights import draw_leaf, walk

FP8_MAX = 448.0


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t.detach())  # rounded forward, identity gradient


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fp8(a) @ _fp8(b)


@contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the block's duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# parameters


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def param_spec(cfg: Dict) -> Dict[str, tuple]:
    """``{path: (shape, std)}`` of every leaf, stacked over the layers;
    std 0 is a norm's gain of ones."""
    d, v, L = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    h, g, hd, f = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg), cfg["d_ff"]

    def mat(*shape):
        return (shape, 1.0 / math.sqrt(shape[-2]))

    spec = {
        "embedding.embed": ((v, d), 0.02),
        "embedding.lm_head": mat(d, v),
        "embedding.final_norm": ((d,), 0.0),
        "layers.norm1": ((L, d), 0.0),
        "layers.norm2": ((L, d), 0.0),
        "layers.attn.wq": mat(L, d, h * hd),
        "layers.attn.wk": mat(L, d, g * hd),
        "layers.attn.wv": mat(L, d, g * hd),
        "layers.attn.wo": mat(L, h * hd, d),
    }
    if cfg.get("qk_norm"):
        spec["layers.attn.q_norm"] = ((L, hd), 0.0)
        spec["layers.attn.k_norm"] = ((L, hd), 0.0)
    moe = cfg.get("moe")
    if moe:
        e, s = moe["n_experts"], moe.get("n_shared", 0)
        spec["layers.moe.router"] = mat(L, d, e)
        banks = [("experts", e)] + ([("shared", s)] if s else [])
        for bank, n in banks:
            spec[f"layers.moe.{bank}.w_gate"] = mat(L, n, d, f)
            spec[f"layers.moe.{bank}.w_up"] = mat(L, n, d, f)
            spec[f"layers.moe.{bank}.w_down"] = mat(L, n, f, d)
    else:
        spec["layers.mlp.w_gate"] = mat(L, d, f)
        spec["layers.mlp.w_up"] = mat(L, d, f)
        spec["layers.mlp.w_down"] = mat(L, f, d)
    return spec


class Params:
    """The stacked leaves, drawn from ``seed`` (``yardstick.weights``), and
    each layer's slices as autograd leaves."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.spec = param_spec(cfg)
        self.seed = seed
        self.stacked: Dict[str, torch.Tensor] = {}
        for i, path, shape, std in walk(self.spec):
            self.stacked[path] = draw_leaf(shape, std, seed, i, device)
        self.leaves: Dict[str, List[torch.Tensor]] = {
            p: ([t.detach().requires_grad_(True)] if p.startswith("embedding")
                else [x.detach().requires_grad_(True) for x in t.unbind(0)])
            for p, t in self.stacked.items()}

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        return {p[len("layers."):]: ts[i] for p, ts in self.leaves.items()
                if p.startswith("layers.")}

    def flat(self) -> List[torch.Tensor]:
        return [t for ts in self.leaves.values() for t in ts]

    def change_norms(self) -> Dict[str, float]:
        """Each stacked leaf's distance from its drawn start."""
        out = {}
        for i, path, shape, std in walk(self.spec):
            cur = self.stacked[path]
            start = draw_leaf(shape, std, self.seed, i, cur.device)
            out[path] = float(torch.linalg.vector_norm(cur - start))
            del start
        return out


# ---------------------------------------------------------------------------
# the model


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * gain


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd): split-half rotation at positions 0 .. T - 1."""
    t, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x: torch.Tensor, w: Dict, cfg: Dict, mm: Callable) -> torch.Tensor:
    b, t, d = x.shape
    h, g, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    eps = cfg["norm_eps"]
    q = mm(x, w["attn.wq"]).view(b, t, h, hd)
    k = mm(x, w["attn.wk"]).view(b, t, g, hd)
    v = mm(x, w["attn.wv"]).view(b, t, g, hd)
    if cfg.get("qk_norm"):
        q = rms_norm(q, w["attn.q_norm"], eps)
        k = rms_norm(k, w["attn.k_norm"], eps)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    rep = h // g
    q = q.permute(0, 2, 1, 3).reshape(b, g, rep, t, hd)
    k = k.permute(0, 2, 1, 3)[:, :, None]                 # (B, G, 1, T, hd)
    v = v.permute(0, 2, 1, 3)[:, :, None]
    # a kv group at a time, each recomputed in the backward pass, so that
    # one group's (B, rep, T, T) scores are held at once
    ys = [checkpoint(group_attention, q[:, i], k[:, i], v[:, i], mm,
                     use_reentrant=False) if torch.is_grad_enabled()
          else group_attention(q[:, i], k[:, i], v[:, i], mm)
          for i in range(g)]
    y = torch.stack(ys, dim=1)                             # (B, G, rep, T, hd)
    y = y.reshape(b, h, t, hd).permute(0, 2, 1, 3).reshape(b, t, h * hd)
    return mm(y, w["attn.wo"])


def group_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mm: Callable) -> torch.Tensor:
    """Causal softmax attention of one kv group: q (B, rep, T, hd), k and
    v (B, 1, T, hd) -> (B, rep, T, hd)."""
    t, hd = q.shape[-2], q.shape[-1]
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)         # (B, rep, T, T)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return mm(p, v)


def swiglu(x, wg, wu, wd, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def capacity(group_tokens: int, moe: Dict) -> int:
    cap = math.ceil(moe["top_k"] * group_tokens * moe["capacity_factor"]
                    / moe["n_experts"])
    return max(4, ((cap + 3) // 4) * 4)


def moe(x: torch.Tensor, w: Dict, cfg: Dict, mm: Callable):
    """-> (y, router probabilities summed over tokens (E,), top-k picks
    counted over tokens (E,))."""
    m = cfg["moe"]
    b, t, d = x.shape
    e, k = m["n_experts"], m["top_k"]
    probs = torch.softmax(mm(x, w["moe.router"]), dim=-1)          # (B, T, E)
    top_p, top_i = probs.topk(k, dim=-1)
    gates = (top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
             if m["norm_topk_prob"] else top_p)
    # each (token, choice)'s slot in its expert's bucket, (token, choice) order
    flat = top_i.reshape(b, t * k)
    order = torch.argsort(flat, dim=1, stable=True)
    ranked = torch.gather(flat, 1, order)
    first = torch.searchsorted(ranked, ranked)
    slot = torch.empty_like(flat)
    slot.scatter_(1, order, torch.arange(t * k, device=x.device)[None] - first)
    keep = slot < capacity(t, m)
    xf = x.reshape(b * t, d)
    token = (torch.arange(b, device=x.device)[:, None] * t
             + torch.arange(t * k, device=x.device)[None] // k)
    gate = gates.reshape(b, t * k)
    y = torch.zeros_like(xf)
    wg, wu, wd = (w[f"moe.experts.{n}"].unbind(0) for n in ("w_gate", "w_up", "w_down"))
    for ex in range(e):
        sel = (flat == ex) & keep
        tok = token[sel]
        if tok.numel() == 0:
            continue
        out = swiglu(xf[tok], wg[ex], wu[ex], wd[ex], mm) * gate[sel][:, None]
        y = y.index_add(0, tok, out)
    if m.get("n_shared"):
        sg, su, sd = (w[f"moe.shared.{n}"].unbind(0) for n in ("w_gate", "w_up", "w_down"))
        for s in range(m["n_shared"]):
            y = y + swiglu(xf, sg[s], su[s], sd[s], mm)
    picks = torch.bincount(top_i.reshape(-1), minlength=e).float()
    return y.view(b, t, d), probs.sum(dim=(0, 1)), picks


def block(x: torch.Tensor, w: Dict, cfg: Dict, mm: Callable):
    eps = cfg["norm_eps"]
    x = x + attention(rms_norm(x, w["norm1"], eps), w, cfg, mm)
    xn = rms_norm(x, w["norm2"], eps)
    if cfg.get("moe"):
        y, probs, picks = moe(xn, w, cfg, mm)
        return x + y, probs, picks
    return x + swiglu(xn, w["mlp.w_gate"], w["mlp.w_up"], w["mlp.w_down"], mm), None, None


def hidden(params: Params, tokens: torch.Tensor, cfg: Dict,
           mm: Callable = plain_mm, remat: bool = True):
    """tokens (B, T) -> (the final norm's output (B, T, d), ``aux_loss_alpha``
    times the balance loss summed over the MoE layers)."""
    emb = params.leaves["embedding.embed"][0]
    x = emb[tokens.long()]
    n_tok = float(tokens.numel())
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["n_layers"]):
        w = params.layer(i)
        if remat:
            x, probs, picks = checkpoint(block, x, w, cfg, mm, use_reentrant=False)
        else:
            x, probs, picks = block(x, w, cfg, mm)
        if probs is not None:
            e = probs.shape[0]
            aux = aux + (cfg["moe"]["aux_loss_alpha"] * e
                         * torch.sum((probs / n_tok) * (picks / n_tok)))
    return rms_norm(x, params.leaves["embedding.final_norm"][0], cfg["norm_eps"]), aux


def loss(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: Dict, mm: Callable = plain_mm) -> torch.Tensor:
    """Cross-entropy (mean over the tokens) plus ``aux_loss_alpha`` times
    the balance loss summed over the MoE layers."""
    x, aux = hidden(params, tokens, cfg, mm)
    logits = mm(x, params.leaves["embedding.lm_head"][0])
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold) + aux


def served_gaps(cfg: Dict, seed: int, requests, device,
                control: Optional[Callable] = None) -> Dict[str, list]:
    """Each request ``(prompt, served)`` (int arrays) run once, teacher
    forced, over its prompt and served tokens -> {"served": [each request's
    widest gap by which a served token's logit lies below the best],
    "control": with ``control`` (a product), the same gap of the token
    the control's logits put first}."""
    out: Dict[str, list] = {"served": [], "control": []}
    with no_tf32(), torch.no_grad():
        params = Params(cfg, seed, device)
        head = params.leaves["embedding.lm_head"][0]
        for prompt, served in requests:
            seq = torch.as_tensor(list(prompt) + list(served[:-1]),
                                  device=device)[None]
            at = torch.arange(len(prompt) - 1, seq.shape[1], device=device)
            want = torch.as_tensor(served, device=device).long()
            x, _ = hidden(params, seq, cfg, remat=False)
            ref = plain_mm(x[0, at], head)
            best = ref.max(dim=-1).values
            out["served"].append(float((best - ref.gather(
                1, want[:, None])[:, 0]).max()))
            if control is not None:
                x, _ = hidden(params, seq, cfg, control, remat=False)
                pick = control(x[0, at], head).argmax(dim=-1)
                out["control"].append(float((best - ref.gather(
                    1, pick[:, None])[:, 0]).max()))
            del x, ref
    return out


# ---------------------------------------------------------------------------
# the optimizer


def cosine_lr(step: int, peak: float, warmup: int, total: int,
              floor: float = 0.1) -> float:
    if step < warmup:
        return peak * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    def __init__(self, params: Params, opt: Dict):
        self.p = params
        self.o = opt
        self.step = 0
        self.m = {k: torch.zeros_like(t) for k, t in params.stacked.items()}
        self.v = {k: torch.zeros_like(t) for k, t in params.stacked.items()}

    def update(self, grads: Dict[str, List[torch.Tensor]],
               against: Optional[Dict[str, torch.Tensor]] = None,
               keep: Optional[Dict[str, torch.Tensor]] = None,
               against_scale: float = 1.0) -> Dict[str, float]:
        """One step; -> each stacked leaf's clipped gradient norm, and with
        ``against`` (each stacked leaf's sample, ``compare.sample_stride``,
        of another gradient on the host, to be multiplied by
        ``against_scale``) the norm of each leaf's difference from it as
        ``"<leaf>.diff"``: the difference's share of the reference's norm
        on the sample times the leaf's norm.  ``keep`` (a dict) receives
        the clipped gradient's samples.  ``grads`` is consumed."""
        o = self.o
        self.step += 1
        s = self.step
        sq = {k: sum(float(torch.sum(g * g)) for g in gs) for k, gs in grads.items()}
        gnorm = math.sqrt(sum(sq.values()))
        scale = min(1.0, o["clip_norm"] / (gnorm + 1e-9))
        bc1, bc2 = 1 - o["b1"] ** s, 1 - o["b2"] ** s
        lr = cosine_lr(s, o["peak_lr"], o["warmup"], o["total_steps"])
        diff: Dict[str, float] = {}
        for path, gs in grads.items():
            decay = len(self.p.spec[path][0]) >= 2
            if against is not None or keep is not None:
                mine = stacked_sample(gs) * scale
                if keep is not None:
                    keep[path] = mine.cpu()
                if against is not None:
                    other = against[path].to(mine.device) * against_scale
                    share = float(torch.linalg.vector_norm(mine - other)
                                  / torch.linalg.vector_norm(mine).clamp(min=1e-30))
                    diff[f"{path}.diff"] = share * math.sqrt(sq[path]) * scale
            stacked = [self.p.stacked[path]] if path.startswith("embedding") \
                else self.p.stacked[path].unbind(0)
            ms = [self.m[path]] if path.startswith("embedding") else self.m[path].unbind(0)
            vs = [self.v[path]] if path.startswith("embedding") else self.v[path].unbind(0)
            for p, g, mm_, vv in zip(stacked, gs, ms, vs):
                g = g * scale
                mm_.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                vv.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
                step_dir = (mm_ / bc1) / ((vv / bc2).sqrt() + o["eps"])
                if decay and o["weight_decay"]:
                    step_dir = step_dir + o["weight_decay"] * p
                with torch.no_grad():
                    p.sub_(lr * step_dir)
            gs.clear()
        return {**{k: math.sqrt(v) * scale for k, v in sq.items()}, **diff}


def stacked_sample(gs: List[torch.Tensor]) -> torch.Tensor:
    """Every k-th element (``compare.sample_stride``) of the leaf that the
    layers' slices ``gs`` stack into, in the stacked order."""
    per = gs[0].numel()
    k = sample_stride(per * len(gs))
    idx = torch.arange(0, per * len(gs), k, device=gs[0].device)
    return torch.cat([g.reshape(-1)[idx[(idx >= i * per) & (idx < (i + 1) * per)] - i * per]
                      for i, g in enumerate(gs)])


def train_readings(cfg: Dict, opt: Dict, seed: int,
                   batches: Sequence[Dict[str, torch.Tensor]], device,
                   mm: Callable = plain_mm,
                   first_grad: Optional[Dict[str, torch.Tensor]] = None,
                   keep_first: bool = False, first_scale: float = 1.0) -> Dict:
    """Follow the training run from the drawn start over ``batches``:
    -> {"loss": [each step's loss], "grad": {leaf: the first step's clipped
    gradient norm}, "change": {leaf: the distance from the start after the
    last step}}; with ``first_grad`` (each stacked leaf's sample,
    ``compare.sample_stride``, on the host, which times ``first_scale`` is
    the program's first clipped gradient's) also "grad_diff": {leaf: the
    norm of its difference from the reference's}; with ``keep_first``
    also "first_grad": this run's own samples of it."""
    with no_tf32():
        params = Params(cfg, seed, device)
        adam = AdamW(params, opt)
        losses, first = [], None
        kept: Dict[str, torch.Tensor] = {}
        for batch in batches:
            tok = batch["tokens"].to(device)
            lab = batch["labels"].to(device)
            value = loss(params, tok, lab, cfg, mm)
            flat = params.flat()
            gl = list(torch.autograd.grad(value, flat))
            losses.append(float(value.detach()))
            del value
            grads, it = {}, iter(gl)
            for path, ts in params.leaves.items():
                grads[path] = [next(it) for _ in ts]
            del gl, it
            norms = adam.update(grads, first_grad if first is None else None,
                                kept if keep_first and first is None else None,
                                first_scale)
            if first is None:
                first = norms
        del adam
        change = params.change_norms()
    out = {"loss": losses, "change": change,
           "grad": {k: v for k, v in first.items() if not k.endswith(".diff")}}
    if keep_first:
        out["first_grad"] = kept
    if first_grad is not None:
        out["grad_diff"] = {k[: -len(".diff")]: v for k, v in first.items()
                            if k.endswith(".diff")}
    return out
