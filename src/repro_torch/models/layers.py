"""Core layers: RMSNorm (and its per-head form), RoPE, the depthwise causal
conv, SwiGLU MLP and GQA attention (full, or sliding-window over a
ring-buffer cache) in train, prefill and decode mode. Functions on tensors;
params are dict trees matching the ``*_specs`` functions, with
``[in, out]`` weights as in the JAX package.

Attention runs through :mod:`repro_torch.kernels.ops`: the CUDA kernels
for tensors on the card, their plain versions for tensors on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.params import ParamSpec


def acc_dtype(x):
    """The type the norms, rope and the head compute in: float32, or float64
    for a float64 model (a precision yardstick)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def rmsnorm(x, w, eps=1e-5):
    xf = x.to(acc_dtype(x))
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * w.to(xf.dtype)).to(x.dtype)


def rms_groupnorm(x, w, groups, eps=1e-5):
    """Per-head RMS norm over the trailing dim split into ``groups`` heads."""
    *lead, d = x.shape
    xf = x.to(acc_dtype(x)).reshape(*lead, groups, d // groups)
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y.reshape(*lead, d) * w.to(xf.dtype)).to(x.dtype)


def causal_conv1d(x, w):
    """Depthwise causal conv via shifted adds. x: [B,S,C]; w: [W,C]."""
    W, S = w.shape[0], x.shape[1]
    out = x * w[W - 1]
    for i in range(W - 1):
        shift = W - 1 - i
        out = out + F.pad(x, (0, 0, shift, 0))[:, :S] * w[i]
    return out


def causal_conv1d_step(x, state, w):
    """Single decode step. x: [B,C]; state: [B,W-1,C] (oldest first).
    Returns (out [B,C], new state [B,W-1,C])."""
    W = w.shape[0]
    out = x * w[W - 1] + torch.einsum("bwc,wc->bc", state, w[: W - 1])
    return out, torch.cat([state[:, 1:], x[:, None]], dim=1)


def ring_slot_positions(pos, W):
    """Global positions held by each ring-buffer slot after writing token
    ``pos`` (negative: the slot holds no token yet)."""
    return pos - torch.remainder(pos - torch.arange(W), W)


def rope(x, positions, theta):
    """x: [..., S, H, D] (or [..., H, D] with per-row positions). Rotates the
    two halves of each head; angles in float32 (float64 for float64 x)."""
    half = x.shape[-1] // 2
    dt = acc_dtype(x)
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=dt, device=x.device) / half)
    ang = positions[..., None].to(dt) * freqs          # [..., S, half]
    cos = torch.cos(ang).unsqueeze(-2)                 # broadcast over heads
    sin = torch.sin(ang).unsqueeze(-2)
    x1, x2 = x[..., :half].to(dt), x[..., half:].to(dt)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attn_specs(cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    sp = {
        "wq": ParamSpec((d, H * hd), ("embed", "heads")),
        "wk": ParamSpec((d, K * hd), ("embed", "kv")),
        "wv": ParamSpec((d, K * hd), ("embed", "kv")),
        "wo": ParamSpec((H * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((H * hd,), ("heads",), init="zeros")
        sp["bk"] = ParamSpec((K * hd,), ("kv",), init="zeros")
        sp["bv"] = ParamSpec((K * hd,), ("kv",), init="zeros")
    return sp


def _qkv(cfg, p, x):
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def attn_apply(cfg, p, x, *, mode, cache, window=None, pos=None, force=None):
    """GQA attention block; ``window`` (sliding-window attention) keeps the
    layer's K/V in a ring-buffer cache, as the reference does.

    train: x [B,S,d]; the prefill's attention with no cache (``cache`` is
    None and comes back None). Under autograd the kernel route carries its
    own backward (``ops.flash_attention``).
    prefill: x [B,S,d]. Full attention writes the K/V rows of positions
    ``0..S-1`` into ``cache`` ({'k','v'}: [B,S_max,K*hd], S_max >= S). A
    window layer's cache is a ring [B,W_ring,K*hd]: the last
    ``min(S, W_ring)`` rows go to slots ``pos % W_ring``.
    decode: x [B,d]; ``pos`` (int) is the index of the incoming token. Its
    K/V row is written into ``cache`` at ``pos`` (a ring: slot
    ``pos % W_ring``) in place, before attention, which then covers
    positions ``< pos + 1`` (a window: the last ``min(window, W_ring,
    pos + 1)`` of them).
    paged_decode: one lane, x [1,d], over a page pool: ``cache`` holds this
    layer's pages ``'k'``, ``'v'`` ([P, page, K, hd], the pool's strided
    view), the lane's ``'table'`` [1, n] and ``'lengths'`` [1] (``pos + 1``)
    int32 tensors, and ``'slot'``, the (page, offset) of ``pos``. The new
    K/V row goes straight into that slot, then attention reads the pages
    through the table: no dense copy of the cache is made.
    Returns (out, cache).
    """
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    theta = cfg.rope_theta

    if mode in ("train", "prefill"):
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)
        q, k, v = _qkv(cfg, p, x)
        q = rope(q.view(B, S, H, hd), positions, theta)
        k = rope(k.view(B, S, K, hd), positions, theta)
        v = v.view(B, S, K, hd)
        # [B,S,H,D] -> [B,H,S,D] as views: the kernel takes strides
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), window=window, force=force)
        out = o.transpose(1, 2).reshape(B, S, H * hd) @ p["wo"]
        if mode == "train":
            return out, None
        kc, vc = cache["k"], cache["v"]
        if window is not None:
            # each slot takes the position it holds after the prompt (on
            # the host: no device sync)
            kpos = ring_slot_positions(S - 1, kc.shape[1])
            slots = torch.nonzero(kpos >= 0).flatten()
            rows = kpos[slots].to(x.device)
            slots = slots.to(x.device)
            kc[:, slots] = k.reshape(B, S, K * hd)[:, rows]
            vc[:, slots] = v.reshape(B, S, K * hd)[:, rows]
        else:
            kc[:, :S] = k.reshape(B, S, K * hd)
            vc[:, :S] = v.reshape(B, S, K * hd)
        return out, cache

    if mode not in ("decode", "paged_decode"):
        raise ValueError(f"mode {mode!r}; expected 'train', 'prefill', 'decode' "
                         "or 'paged_decode'")
    kc, vc = cache["k"], cache["v"]
    B, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    posv = torch.full((B,), pos, device=x.device)
    q = rope(q.view(B, H, hd), posv, theta)
    k = rope(k.view(B, K, hd), posv, theta).reshape(B, K * hd)
    # in place, where the JAX package returns an updated copy of the cache
    if mode == "paged_decode":
        if B != 1:
            raise ValueError(f"paged_decode takes one lane; got {B} rows")
        page, off = cache["slot"]
        kc[page, off] = k.view(K, hd)
        vc[page, off] = v.view(K, hd)
        o = ops.paged_decode_attention(q, kc, vc, cache["table"], cache["lengths"],
                                       window=window, force=force)
    elif window is not None:
        W_ring = kc.shape[1]
        kc[:, pos % W_ring] = k
        vc[:, pos % W_ring] = v
        o = ops.window_decode_attention(q, kc.view(B, W_ring, K, hd),
                                        vc.view(B, W_ring, K, hd), pos, window=window,
                                        force=force)
    else:
        kc[:, pos] = k
        vc[:, pos] = v
        S_max = kc.shape[1]
        o = ops.decode_attention(q, kc.view(B, S_max, K, hd),
                                 vc.view(B, S_max, K, hd), pos + 1, window=window,
                                 force=force)
    out = o.reshape(B, H * hd) @ p["wo"]
    return out, cache


def mla_specs(cfg):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "lora")),
        "q_ln": ParamSpec((m.q_lora_rank,), ("lora",), init="ones"),
        "wq_b": ParamSpec((m.q_lora_rank, H * (m.qk_nope_dim + m.qk_rope_dim)),
                          ("lora", "heads")),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_dim), ("embed", "lora")),
        "kv_ln": ParamSpec((m.kv_lora_rank,), ("lora",), init="ones"),
        "wkv_b": ParamSpec((m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim)),
                           ("lora", "heads")),
        "wo": ParamSpec((H * m.v_head_dim, d), ("heads", "embed")),
    }


def mla_scale(cfg):
    """MLA's score scale, 1/sqrt(qk_nope + qk_rope): its prefill's and its
    decode's. (The reference's absorbed decode scales by the latent row's
    width, 1/sqrt(kv_lora + qk_rope), which differs from its own prefill
    wherever kv_lora != qk_nope: ROADMAP queue 3, part C.)"""
    return 1.0 / math.sqrt(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)


def mla_apply(cfg, p, x, *, mode, cache, pos=None, force=None):
    """Multi-head latent attention (minicpm3-4b), the reference's
    ``mla_apply``: queries through a low-rank ``wq_a``/``wq_b``, keys and
    values from one normed latent ``c`` of ``kv_lora_rank`` columns (through
    ``wkv_b``) plus one rope key shared by the heads.

    train / prefill: x [B,S,d]. K is [k_nope ‖ k_rope] per head, and K1
    takes V at its own ``v_head_dim`` beside q's and k's qk head dim
    (qk_nope + qk_rope; the reference zero-pads V to it and slices O back,
    the same function), so O comes back ``[B,S,H,v_head_dim]``. The
    prefill writes each position's latent row [c ‖ k_rope] (kv_lora + rope
    columns) into ``cache['lat']`` [B,S_max,kv_lora+rope].
    decode: x [B,d]; the absorbed form: ``wkv_b``'s key half is folded into
    q (q_eff = [q_nope wk_b ‖ q_rope]), the row of ``pos`` goes into the
    cache in place, and every head attends to the latent rows below
    ``pos + 1`` (its value their first kv_lora columns,
    ``ops.latent_decode_attention``); ``wkv_b``'s value half and ``wo``
    follow. paged_decode: one lane over the page pool, ``cache['lat']`` the
    layer's pages [P, page, 1, kv_lora+rope] beside the lane's ``table``,
    ``lengths`` and ``slot`` (as ``attn_apply`` takes them).
    Returns (out, cache)."""
    m = cfg.mla
    H = cfg.n_heads
    nope, rd, vd, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
    theta = cfg.rope_theta
    wkv_b = p["wkv_b"].view(r, H, nope + vd)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]

    if mode in ("train", "prefill"):
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)
        cq = rmsnorm(x @ p["wq_a"], p["q_ln"])
        q = (cq @ p["wq_b"]).view(B, S, H, nope + rd)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], positions, theta)], dim=-1)
        ckv = x @ p["wkv_a"]
        c = rmsnorm(ckv[..., :r], p["kv_ln"])
        k_rope = rope(ckv[..., None, r:], positions, theta)             # [B,S,1,rd]
        k_nope = torch.einsum("bsr,rhn->bshn", c, wk_b)
        v = torch.einsum("bsr,rhv->bshv", c, wv_b)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], dim=-1)
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                force=force)
        o = o.transpose(1, 2).reshape(B, S, H * vd)
        out = o @ p["wo"]
        if mode == "prefill":
            cache["lat"][:, :S] = torch.cat([c, k_rope[:, :, 0]], dim=-1)
        return out, cache

    if mode not in ("decode", "paged_decode"):
        raise ValueError(f"mode {mode!r}; expected 'train', 'prefill', 'decode' "
                         "or 'paged_decode'")
    B, _ = x.shape
    posv = torch.full((B,), pos, device=x.device)
    cq = rmsnorm(x @ p["wq_a"], p["q_ln"])
    q = (cq @ p["wq_b"]).view(B, H, nope + rd)
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :nope], wk_b)
    q_eff = torch.cat([q_lat, rope(q[..., nope:], posv, theta)], dim=-1)   # [B,H,r+rd]
    ckv = x @ p["wkv_a"]
    c = rmsnorm(ckv[..., :r], p["kv_ln"])
    row = torch.cat([c, rope(ckv[:, None, r:], posv, theta)[:, 0]], dim=-1)
    lat = cache["lat"]
    # in place, where the JAX package returns an updated copy of the cache
    if mode == "paged_decode":
        if B != 1:
            raise ValueError(f"paged_decode takes one lane; got {B} rows")
        pages = lat[:, :, 0]                                            # [P, page, r+rd]
        page, off = cache["slot"]
        pages[page, off] = row[0]
        o_lat = ops.paged_latent_decode_attention(q_eff, pages, cache["table"],
                                                  cache["lengths"], v_dim=r,
                                                  scale=mla_scale(cfg), force=force)
    else:
        lat[:, pos] = row
        o_lat = ops.latent_decode_attention(q_eff, lat, pos + 1, v_dim=r,
                                            scale=mla_scale(cfg), force=force)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wv_b).reshape(B, H * vd)
    return o @ p["wo"], cache


def mlp_specs(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "wg": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp_apply(p, x):
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]


def moe_specs(cfg):
    mo = cfg.moe
    d, f, E = cfg.d_model, mo.expert_d_ff, mo.n_experts
    sp = {
        "router": ParamSpec((d, E), ("embed", None)),
        "wi": ParamSpec((E, d, f), ("expert", "expert_in", "expert_mlp")),
        "wg": ParamSpec((E, d, f), ("expert", "expert_in", "expert_mlp")),
        "wo": ParamSpec((E, f, d), ("expert", "expert_mlp", "expert_in")),
    }
    if mo.dense_residual:
        sp["dense"] = mlp_specs(cfg)
    return sp


def _topk_dispatch(gates, k, C):
    """GShard's top-k slot assignment within each group, as the reference's
    ``_topk_dispatch`` builds its one-hot dispatch and combine tensors, but
    as indices. gates: [G,s,E] float32 softmax probabilities.

    Slot ``j`` takes each token's ``j``-th choice (the argmax of the gates
    not yet taken; the first maximum wins); its place in the expert's
    buffer is the number of the group's tokens that chose the expert in an
    earlier slot, or earlier in this slot; a place at or past ``C`` is
    dropped. Returns (dest [G,s,k] int64: ``expert * C + place``, kept
    [G,s,k] bool, weights [G,s,k]: each kept choice's gate over the kept
    gates' sum, differentiable in ``gates``; first [G,s,E]: the one-hot
    first choices)."""
    G, s, E = gates.shape
    g = gates.detach().clone()
    idx = []
    for _ in range(k):
        i = torch.argmax(g, dim=-1)                                  # [G,s]
        idx.append(i)
        g.masked_fill_(F.one_hot(i, E).bool(), 0.0)
    # the choices in slot-major order (slot 0's tokens, then slot 1's, ...):
    # a choice's place is the count of the same expert's choices before it
    flat = torch.stack(idx, 1).view(G, k * s)
    seen = torch.cumsum(F.one_hot(flat, E), dim=1)                   # [G,k*s,E] int64
    place = torch.gather(seen, -1, flat[..., None])[..., 0] - 1
    idx, place = (t.view(G, k, s).transpose(1, 2).contiguous() for t in (flat, place))
    kept = place < C
    # the chosen gates by a one-hot product (elementwise, and so is its
    # gradient: a gather's backward sums by index, which deterministic
    # mode sorts on the card)
    w = (gates[:, :, None, :] * F.one_hot(idx, E)).sum(-1) * kept
    weights = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    first = F.one_hot(idx[..., 0], E).to(gates.dtype)
    return idx * C + place, kept, weights, first


class _Route(torch.autograd.Function):
    """``out[g, j] = x[g, fwd[g, j]]``, a row index of ``x.shape[1]`` taking
    a zero row; the backward is a gather too: ``grad_x[g, i]`` sums the
    ``r`` rows ``grad_out[g, bwd[g, i*r : (i+1)*r]]`` (index
    ``out.shape[1]``: a zero row) in order. The MoE dispatch and combine
    move rows between tokens and expert slots, each row to at most ``r``
    places, so both directions are gathers: no sum by index, which the
    card's deterministic mode would sort."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, r):
        ctx.save_for_backward(bwd)
        ctx.r = r
        return _gather_rows(x, fwd)

    @staticmethod
    def backward(ctx, grad):
        bwd, = ctx.saved_tensors
        g = _gather_rows(grad, bwd)
        n, m, d = g.shape
        return g.view(n, m // ctx.r, ctx.r, d).sum(2), None, None, None


def _gather_rows(x, index):
    """x [n, m, d], index [n, j] in [0, m] (m: a zero row) -> [n, j, d]."""
    xpad = torch.cat([x, x.new_zeros(x.shape[0], 1, x.shape[2])], dim=1)
    return torch.gather(xpad, 1, index[..., None].expand(-1, -1, x.shape[2]))


def moe_apply(cfg, p, x, *, mode):
    """The reference's ``moe_apply``: GShard capacity dispatch over groups
    of the sequence (train, prefill) or the top-k experts of each row with
    their weights gathered (decode). x: [B,S,d] or [B,d]. Returns (out,
    aux): aux the router's load-balance and z losses averaged over the
    groups (float32 0-d), None in decode.

    The groups are independent, so they run as one batch ``[B*n, gs, d]``
    where the reference scans them. Dispatch and combine are gathers by the
    slots' indices (:class:`_Route`), not products with one-hot tensors:
    each buffer slot holds at most one token, so the gathered values are
    the products' (the combine sums each token's k weighted outputs in
    another order)."""
    mo = cfg.moe
    E, k = mo.n_experts, mo.top_k
    dt = x.dtype
    if mode in ("decode", "paged_decode"):
        gates = torch.softmax((x @ p["router"]).float(), dim=-1)
        top_w, top_i = torch.topk(gates, k, dim=-1)                  # [B,k]
        top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
        wi, wg, wo = p["wi"][top_i], p["wg"][top_i], p["wo"][top_i]  # [B,k,d,f], [B,k,f,d]
        xr = x[:, None, None, :]                                     # one row per (b, slot)
        h = F.silu(xr @ wg) * (xr @ wi)
        out = torch.einsum("bkd,bk->bd", (h @ wo)[:, :, 0], top_w.to(dt))
        if mo.dense_residual:
            out = out + mlp_apply(p["dense"], x)
        return out, None

    B, S, d = x.shape
    gs = math.gcd(min(mo.group_size, S), S)
    n = B * (S // gs)
    C = max(1, math.ceil(gs * k / E * mo.capacity_factor))
    xg = x.reshape(n, gs, d)
    logits = (xg @ p["router"]).float()
    gates = torch.softmax(logits, dim=-1)
    dest, kept, weights, first = _topk_dispatch(gates, k, C)
    # each kept choice's buffer slot (a dropped one's: E*C, a zero row), and
    # each buffer slot's choice (token * k + slot; gs*k: none)
    choice = torch.where(kept, dest, E * C).view(n, gs * k)
    spill = E * C + torch.arange(gs * k, device=x.device)
    owner = torch.full((n, E * C + gs * k), gs * k, dtype=torch.int64, device=x.device)
    owner.scatter_(1, torch.where(kept.view(n, -1), choice, spill),
                   torch.arange(gs * k, device=x.device).expand(n, -1))
    owner = owner[:, :E * C]
    xe = _Route.apply(xg, owner // k, choice, k)                     # [n, E*C, d]
    xe = xe.view(n, E, C, d).transpose(0, 1).reshape(E, n * C, d)
    h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wi"])
    ye = torch.bmm(h, p["wo"]).view(E, n, C, d).transpose(0, 1).reshape(n, E * C, d)
    picked = _Route.apply(ye, choice, owner, 1)                      # [n, gs*k, d]
    y = torch.bmm(weights.to(dt).view(n * gs, 1, k), picked.view(n * gs, k, d))
    y = y.view(B, S, d)
    # Switch-style load balance and the router z-loss, each group's then
    # their mean
    lb = E * (first.mean(1) * gates.mean(1)).sum(-1).mean()
    zl = torch.logsumexp(logits, dim=-1).pow(2).mean()
    aux = mo.load_balance_loss * lb + mo.router_z_loss * zl
    if mo.dense_residual:
        y = y + mlp_apply(p["dense"], x)
    return y, aux
