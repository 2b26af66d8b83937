"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes (bit for bit for
the codec kernels K1-K4, K9 and K10; up to the order of the sums, and to
the bf16 rounding of the products, for the attention kernels K5 and K6
and the scans K7 and K8), with PyTorch ops on whatever device its input
lies on.  The wrappers run them for tensors on the CPU; ``chip_smoke.py``
holds every kernel against them on the card.  They are oracles, not
yardsticks of speed.  ``flash_attention_chunked`` and the one-token
``*_decode_ref`` steps have no kernel of their own: they are the twins of
the reference's oracles of the same names.  ``flash_attention_lse_ref``
is the rows' log-sum-exp K5's forward hands to its backward, and
``flash_attention_bwd_ref`` is K5's backward written out; ``rwkv6_bwd_ref``
and ``mamba2_bwd_ref`` are K7's and K8's, reverse recurrences.  The
reference has no backward kernel (its training differentiates the jnp
oracles), and the tests hold these against ``jax.vjp`` of those oracles.
"""

from __future__ import annotations

import math

import torch


def offsets_scan_ref(sizes: torch.Tensor) -> torch.Tensor:
    """(N,) int64 collection sizes -> (N,) int64 inclusive scan."""
    return torch.cumsum(sizes, dim=0)


def byteshuffle_ref(planes: torch.Tensor) -> torch.Tensor:
    """(N, nb) uint8 -> (nb, N) byte planes."""
    return planes.t().contiguous()


#: the unsigned view of each signed dtype delta + zigzag takes
ZIGZAG_DTYPES = {torch.int32: torch.uint32, torch.int64: torch.uint64}


def delta_zigzag_ref(x: torch.Tensor) -> torch.Tensor:
    """(N,) int32 -> uint32, int64 -> uint64: ``zigzag(x[i] - x[i-1])``
    with the first element absolute.

    Computed in the signed dtype, where PyTorch's subtraction and left
    shift wrap as the reference's do, then viewed as unsigned (PyTorch
    has few ops on uint32/uint64 tensors)."""
    d = torch.cat([x[:1], x[1:] - x[:-1]])
    bits = x.element_size() * 8 - 1
    return ((d << 1) ^ (d >> bits)).view(ZIGZAG_DTYPES[x.dtype])


def byteshuffle_pages_ref(pages: torch.Tensor) -> torch.Tensor:
    """(P, per, nb) uint8 -> (P, nb, per): page-wise byte planes."""
    return pages.transpose(1, 2).contiguous()


def unsplit_pages_ref(planes: torch.Tensor) -> torch.Tensor:
    """(P, nb, per) uint8 -> (P, per, nb): inverse page-wise byteshuffle."""
    return planes.transpose(1, 2).contiguous()


def low_u32(b0, b1, b2, b3) -> torch.Tensor:
    """The low 4 little-endian bytes of stored uint64s, as int64 lanes
    (uint32 has few ops on the CPU; int64 holds every uint32 exactly)."""
    return (b0.to(torch.int64) | (b1.to(torch.int64) << 8)
            | (b2.to(torch.int64) << 16) | (b3.to(torch.int64) << 24))


def unzigzag_ref(z: torch.Tensor) -> torch.Tensor:
    """Zigzag inverse of uint32 values held in int64 -> int32.

    ``(z >> 1) ^ -(z & 1)`` lies in [-2**31, 2**31) for every uint32, so
    the cast is exact.
    """
    return ((z >> 1) ^ -(z & 1)).to(torch.int32)


def decode_offset_pages_ref(planes: torch.Tensor) -> torch.Tensor:
    """(P, 8, per) uint8 split zigzag deltas -> (P, per) int32 end offsets.

    Only the low four byte planes are read (the reader routes an offset
    column here only when its offsets fit int32, so planes 4..7 are zero);
    each page integrates from 0 (per-page delta restart).
    """
    d = unzigzag_ref(low_u32(planes[:, 0], planes[:, 1], planes[:, 2],
                             planes[:, 3]))
    return torch.cumsum(d, dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# attention (K5, its backward, and K6): twins of the jnp oracles, with
# the same GQA expansion, masks and fp32 softmax; the products run in the
# inputs' dtype, as there


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, G, S, D) -> (B, H, S, D) by repeating each kv head H//G times."""
    g = k.shape[1]
    if g == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // g, dim=1)


def attention_mask(sq: int, sk: int, causal: bool, window,
                   device) -> torch.Tensor:
    """(Sq, Sk) bool: which keys query row ``i`` (at position
    ``i + Sk - Sq``) sees."""
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window=None,
                        scale=None) -> torch.Tensor:
    """q (B, H, Sq, D), k (B, G, Sk, D), v (B, G, Sk, Dv) -> (B, H, Sq, Dv).

    Query row ``i`` sits at position ``i + Sk - Sq`` (the ends align, as
    in prefill); ``causal`` keeps keys at or before it, ``window`` the
    last ``window`` of those.  A row with no visible key is NaN, as in
    the reference oracle (the kernel writes 0 there)."""
    h, sq, d = q.shape[1], q.shape[2], q.shape[3]
    sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk, vv = _expand_kv(k, h), _expand_kv(v, h)
    logits = torch.einsum("bhqd,bhkd->bhqk", q * scale, kk)
    mask = attention_mask(sq, sk, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(vv.dtype), vv)


def flash_attention_with_lse_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, causal: bool = True,
                                 window=None, scale=None):
    """``(flash_attention_ref(...), flash_attention_lse_ref(...))``, what
    K5's CPU route records for its backward, the same values bit for bit.
    fp32 inputs take both from one pass of scores ``(scale q) k^T``.
    Narrower inputs round their scores to their dtype for the output, so
    their LSE, fp32 from the inputs' values, takes a pass of its own."""
    if q.dtype != torch.float32:
        return (flash_attention_ref(q, k, v, causal, window, scale),
                flash_attention_lse_ref(q, k, causal, window, scale))
    h, sq, d = q.shape[1], q.shape[2], q.shape[3]
    sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q * scale, _expand_kv(k, h))
    logits = logits.masked_fill(
        ~attention_mask(sq, sk, causal, window, q.device), float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1),
                       _expand_kv(v, h))
    return out, torch.logsumexp(logits, dim=-1)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            causal: bool = True, window=None,
                            scale=None) -> torch.Tensor:
    """(B, H, Sq) fp32: each query row's log-sum-exp (natural log) of its
    scaled, masked scores ``(scale q) k^T``, in fp32 from the inputs'
    values; ``-inf`` for a row that sees no key.  K5's forward writes this
    for its backward."""
    h, sq, d = q.shape[1], q.shape[2], q.shape[3]
    sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # q scaled first, as flash_attention_ref does: for fp32 inputs the
    # scores are that function's, bit for bit
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale,
                     _expand_kv(k, h).float())
    s = s.masked_fill(~attention_mask(sq, sk, causal, window, q.device),
                      float("-inf"))
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, window=None, scale=None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_ref` at
    ``dout``, written out (no autograd), in fp32 from the inputs' values;
    results in the inputs' dtype.  ``out`` and ``lse`` are the forward's
    output and rows' log-sum-exp (:func:`flash_attention_lse_ref`): as in
    the kernel, ``P = exp(scale * q k^T - lse)`` and ``Delta =
    rowsum(dout * out)`` (after ``out``'s rounding, for bf16).  dk and dv
    sum the ``H // G`` query heads of each kv group.  v (and so out, dout
    and dv) may be narrower than q/k, as in MLA.  A row with no
    visible key is NaN, as in the forward."""
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), _expand_kv(k, h).float(), _expand_kv(v, h).float()
    do = dout.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    s = s.masked_fill(~attention_mask(sq, sk, causal, window, q.device),
                      float("-inf"))
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(b, g, h // g, sk, d).sum(dim=2)
    dv = dv.reshape(b, g, h // g, sk, v.shape[3]).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window=None, scale=None,
                            block: int = 1024) -> torch.Tensor:
    """:func:`flash_attention_ref` as an online-softmax scan over kv blocks
    of ``block`` rows: the (Sq, Sk) scores never exist at once.  v's head
    dim may differ from q's (MLA).  A row with no visible key is 0, not
    NaN (the reference's ``flash_attention_chunked``)."""
    b, h, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    block = max(1, min(block, sk))
    kk, vv = _expand_kv(k, h), _expand_kv(v, h)
    q32 = (q * scale).float()
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    m = torch.full((b, h, sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, block):
        kb = kk[:, :, k0:k0 + block].float()
        vb = vv[:, :, k0:k0 + block].float()
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kb)
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
        mask = torch.ones((sq, kb.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length=None, window=None, scale=None) -> torch.Tensor:
    """One new token per sequence: q (B, H, D), k/v (B, G, S, D) cache,
    ``length`` (B,) valid cache lengths (all S when None) -> (B, H, D).
    ``window`` keeps positions ``>= length - window``."""
    b, h, d = q.shape
    s = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk, vv = _expand_kv(k, h), _expand_kv(v, h)
    logits = torch.einsum("bhd,bhkd->bhk", q * scale, kk)
    pos = torch.arange(s, device=q.device)[None, :]
    valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    if length is not None:
        last = length.to(q.device)[:, None]
        valid &= pos < last
    else:
        last = torch.full((b, 1), s, device=q.device)
    if window is not None:
        valid &= pos >= last - window
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p.to(vv.dtype), vv)


# ---------------------------------------------------------------------------
# the recurrent scans (the serve path's K7 and K8): twins of the jnp
# oracles, step by step over T with an fp32 state


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, initial_state=None):
    """RWKV-6 wkv: r/k/w (B, H, T, Dk), v (B, H, T, Dv), u (H, Dk),
    ``initial_state`` (B, H, Dk, Dv) -> (out (B, H, T, Dv) in v's dtype,
    final state (B, H, Dk, Dv) fp32)::

        o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
        S_t = diag(w_t) S_{t-1} + k_t^T v_t
    """
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r_, k_, v_, w_ = (x.float() for x in (r, k, v, w))
    u_ = u.float()[None, :, :, None]
    s = (initial_state.float().clone() if initial_state is not None else
         torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device))
    out = torch.empty((b, h, t, dv), dtype=torch.float32, device=r.device)
    for i in range(t):
        kv = k_[:, :, i, :, None] * v_[:, :, i, None, :]
        out[:, :, i] = torch.einsum("bhk,bhkv->bhv", r_[:, :, i], s + u_ * kv)
        s = w_[:, :, i, :, None] * s + kv
    return out.to(v.dtype), s


def mamba2_ref(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, initial_state=None):
    """Mamba-2 SSD without the D skip: x (B, H, T, P), log_a (B, H, T),
    Bm/Cm (B, T, N) shared across heads, ``initial_state`` (B, H, N, P)
    -> (y (B, H, T, P) in x's dtype, final state (B, H, N, P) fp32)::

        H_t = exp(a_t) H_{t-1} + B_t^T x_t
        y_t = C_t H_t

    The reference's ``mamba2_ref`` with ``D = 0``, as ``ops.mamba2``
    calls it and as the kernel computes."""
    b, h, t, p = x.shape
    n = Bm.shape[-1]
    x_, la, B_, C_ = (a.float() for a in (x, log_a, Bm, Cm))
    s = (initial_state.float().clone() if initial_state is not None else
         torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device))
    y = torch.empty((b, h, t, p), dtype=torch.float32, device=x.device)
    for i in range(t):
        s = (torch.exp(la[:, :, i])[..., None, None] * s
             + torch.einsum("bn,bhp->bhnp", B_[:, i], x_[:, :, i]))
        y[:, :, i] = torch.einsum("bn,bhnp->bhp", C_[:, i], s)
    return y.to(x.dtype), s


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or in fp64 where it is fp64 (a reference for the
    kernels' fp32 sums)."""
    return x if x.dtype == torch.float64 else x.float()


#: steps whose gradient terms the plain backwards take in one product
_BWD_SPAN = 64


def rwkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, dout, dstate=None):
    """The gradients ``(dr, dk, dv, dw, du)`` of :func:`rwkv6_ref` (from a
    zero state) at the cotangents ``dout`` of its output and ``dstate`` of
    its final state (zero when None), written out in fp32 from the inputs'
    values (fp64 for fp64 inputs); each in its input's dtype.  The
    forward's states ``S_{t-1}`` are kept, then with ``G_t = dL/dS_t``
    (``G_{T-1} = dstate``), per (b, h) and from the last step back::

        dr_t = S_{t-1} do_t + (u o k_t)(v_t . do_t)
        dk_t = G_t v_t + (r_t o u)(v_t . do_t)
        dv_t = k_t^T G_t + (sum r_t o u o k_t) do_t
        dw_t = rowsum(G_t o S_{t-1})
        du   = sum over b and t of r_t o k_t (v_t . do_t)
        G_{t-1} = diag(w_t) G_t + r_t^T do_t

    Only the two recurrences walk the steps; the terms are products over
    ``_BWD_SPAN`` steps at a time.  Nothing divides by w: a decay of
    exactly 0 gives finite gradients."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r_, k_, v_, w_ = (_wide(x) for x in (r, k, v, w))
    u_ = _wide(u)[None, :, None]                                  # (1, H, 1, Dk)
    f = r_.dtype
    do = (_wide(dout) if dout is not None else
          torch.zeros((b, h, t, dv), dtype=f, device=r.device))
    s = torch.zeros((b, h, dk, dv), dtype=f, device=r.device)
    prev = []  # S_{t-1} of each step
    for i in range(t):
        prev.append(s)
        s = w_[:, :, i, :, None] * s + k_[:, :, i, :, None] * v_[:, :, i, None, :]
    vdo = (v_ * do).sum(-1, keepdim=True)                         # (B, H, T, 1)
    d_r = u_ * k_ * vdo
    d_k = r_ * u_ * vdo
    d_v = (r_ * u_ * k_).sum(-1, keepdim=True) * do
    d_w = torch.empty_like(r_)
    du = (r_ * k_ * vdo).sum((0, 2))
    g = (dstate.to(f).clone() if dstate is not None else torch.zeros_like(s))
    for c in reversed(range(0, t, _BWD_SPAN)):
        e = min(c + _BWD_SPAN, t)
        gs = []
        for i in reversed(range(c, e)):
            gs.append(g)
            g = (w_[:, :, i, :, None] * g
                 + r_[:, :, i, :, None] * do[:, :, i, None, :])
        gg = torch.stack(gs[::-1], 2)                             # G_t
        sp = torch.stack(prev[c:e], 2)                            # S_{t-1}
        span = slice(c, e)
        d_r[:, :, span] += torch.einsum("bhtkv,bhtv->bhtk", sp, do[:, :, span])
        d_k[:, :, span] += torch.einsum("bhtkv,bhtv->bhtk", gg, v_[:, :, span])
        d_v[:, :, span] += torch.einsum("bhtk,bhtkv->bhtv", k_[:, :, span], gg)
        d_w[:, :, span] = (gg * sp).sum(-1)
    return (d_r.to(r.dtype), d_k.to(k.dtype), d_v.to(v.dtype),
            d_w.to(w.dtype), du.to(u.dtype))


def mamba2_bwd_ref(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, dy, dstate=None):
    """The gradients ``(dx, dlog_a, dBm, dCm)`` of :func:`mamba2_ref` (from
    a zero state) at the cotangents ``dy`` of its output and ``dstate`` of
    its final state (zero when None), written out in fp32 from the inputs'
    values (fp64 for fp64 inputs); each in its input's dtype.  With ``a_t =
    exp(log_a_t)`` and
    ``G_t = dL/dH_t``, per (b, h) and from the last step back::

        G_t = C_t^T dy_t + a_{t+1} G_{t+1}     (a_T G_T: dstate)
        dx_t = B_t G_t
        dB_t = sum_h G_t x_t^T,  dC_t = sum_h H_t dy_t^T   (B, C shared by
                                                            the heads)
        dlog_a_t = a_t sum(G_t o H_{t-1})

    Only the two recurrences walk the steps; the terms are products over
    ``_BWD_SPAN`` steps at a time.  Nothing divides by ``a``: ``log_a =
    -inf`` gives finite gradients."""
    b, h, t, p = x.shape
    n = Bm.shape[-1]
    x_, la, B_, C_ = (_wide(a) for a in (x, log_a, Bm, Cm))
    f = x_.dtype
    a = torch.exp(la)
    dy_ = (_wide(dy) if dy is not None else
           torch.zeros((b, h, t, p), dtype=f, device=x.device))
    s = torch.zeros((b, h, n, p), dtype=f, device=x.device)
    states = [s]  # H_{-1}, H_0, ..., H_{T-1}
    for i in range(t):
        s = (a[:, :, i, None, None] * s
             + torch.einsum("bn,bhp->bhnp", B_[:, i], x_[:, :, i]))
        states.append(s)
    g = (dstate.to(f).clone() if dstate is not None else torch.zeros_like(s))
    dx = torch.empty((b, h, t, p), dtype=f, device=x.device)
    dla = torch.empty((b, h, t), dtype=f, device=x.device)
    dB = torch.empty((b, t, n), dtype=f, device=x.device)
    dC = torch.empty((b, t, n), dtype=f, device=x.device)
    for c in reversed(range(0, t, _BWD_SPAN)):
        e = min(c + _BWD_SPAN, t)
        gs = []
        for i in reversed(range(c, e)):
            g = g + torch.einsum("bn,bhp->bhnp", C_[:, i], dy_[:, :, i])
            gs.append(g)
            g = a[:, :, i, None, None] * g
        gg = torch.stack(gs[::-1], 2)                             # G_t
        span = slice(c, e)
        dx[:, :, span] = torch.einsum("btn,bhtnp->bhtp", B_[:, span], gg)
        dB[:, span] = torch.einsum("bhtnp,bhtp->btn", gg, x_[:, :, span])
        dC[:, span] = torch.einsum("bhtnp,bhtp->btn",
                                   torch.stack(states[c + 1:e + 1], 2),
                                   dy_[:, :, span])
        dla[:, :, span] = a[:, :, span] * (
            gg * torch.stack(states[c:e], 2)).sum((-2, -1))
    return (dx.to(x.dtype), dla.to(log_a.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype))


def rwkv6_decode_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """One-token RWKV-6 step: r/k/w (B, H, Dk), v (B, H, Dv), u (H, Dk),
    ``state`` (B, H, Dk, Dv) -> (out (B, H, Dv) in v's dtype, new state
    fp32); ``state`` is left as it is."""
    out, new_state = rwkv6_ref(r[:, :, None], k[:, :, None], v[:, :, None],
                               w[:, :, None], u, state)
    return out[:, :, 0], new_state


def mamba2_decode_ref(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
                      Cm: torch.Tensor, D: torch.Tensor, state: torch.Tensor):
    """One-token Mamba-2 step with the D skip: x (B, H, P), log_a (B, H),
    Bm/Cm (B, N), D (H,), ``state`` (B, H, N, P) -> (y (B, H, P) in x's
    dtype, new state fp32); ``state`` is left as it is.  As the
    reference's, the skip is added in fp32 before the cast."""
    y, new_state = mamba2_ref(x.float()[:, :, None], log_a[:, :, None],
                              Bm[:, None], Cm[:, None], state)
    y = y[:, :, 0] + D.float()[None, :, None] * x.float()
    return y.to(x.dtype), new_state
