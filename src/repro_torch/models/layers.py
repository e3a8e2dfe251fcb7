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
