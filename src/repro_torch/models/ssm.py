"""The SSD mixer (Mamba-2 scalar-decay form): Hymba's parallel SSM heads;
and the stabilized mLSTM recurrence (xLSTM's matrix-memory block).

A copy of the JAX package's ``models/ssm.py``. The SSD prefill's and training's chunked gated linear
attention runs through :func:`repro_torch.kernels.ops.gla`: the CUDA
kernels (K4, or K5 under ``schedule='parallel'``; in training K4 and its
backward kernel) for tensors on the card, their plain versions on the
CPU. The decode's one-token update, :func:`gla_step`, is
plain torch, as the reference leaves it to XLA.

The cache is ``{'state': [B,H,N,P] float32, 'conv': [B,W-1,C]}`` in the
compute dtype, ``W = d_conv`` and ``C = H*P + 2N``: the recurrent state and
the last ``W - 1`` pre-conv rows. It is written in place.

The mLSTM's :func:`chunked_mlstm` (prefill) and :func:`mlstm_step`
(decode) are plain torch, as the reference leaves them to XLA: a loop over
a handful of 256-position chunks of large products, and one update a
step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import chunk_len
from repro_torch.models.layers import acc_dtype, causal_conv1d, causal_conv1d_step, rms_groupnorm
from repro_torch.models.params import ParamSpec


def gla_step(q, k, v, lg, state):
    """Single-token GLA update. q,k: [B,H,N]; v: [B,H,P]; lg: [B,H]; state:
    [B,H,N,P] float32. Returns (y [B,H,P] in v's dtype, new state)."""
    sf = state * torch.exp(lg.float())[..., None, None]
    sf = sf + torch.einsum("bhn,bhp->bhnp", k.float(), v.float())
    y = torch.einsum("bhn,bhnp->bhp", q.float(), sf)
    return y.to(v.dtype), sf


def chunked_mlstm(q, k, v, ig, fg, chunk=256):
    """The stabilized chunked mLSTM (exp input gates, a normalizer and a
    max-state). q,k: [B,S,H,N]; v: [B,S,H,P]; ig/fg: [B,S,H] raw gate
    pre-activations: fg through log-sigmoid, ig kept in log space. Runs the
    reference's chunks in order (its chunk rule, ``kernels.ref.chunk_len``),
    in float32 (float64 for float64 inputs) from ``m = -1e30``. Returns (h
    [B,S,H,P] in v's dtype, (C [B,H,N,P], n [B,H,N], m [B,H]))."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    c = chunk_len(S, chunk)
    nc = S // c
    f = acc_dtype(q)
    scale = 1.0 / math.sqrt(N)
    qf = (q.to(f) * scale).reshape(B, nc, c, H, N)
    kf = k.to(f).reshape(B, nc, c, H, N)
    vf = v.to(f).reshape(B, nc, c, H, P)
    igf = ig.to(f).reshape(B, nc, c, H)
    lf = F.logsigmoid(fg.to(f)).reshape(B, nc, c, H)
    cum = torch.cumsum(lf, dim=2)
    total = cum[:, :, -1]
    C = torch.zeros((B, H, N, P), dtype=f, device=q.device)
    n = torch.zeros((B, H, N), dtype=f, device=q.device)
    m = torch.full((B, H), -1e30, dtype=f, device=q.device)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    hs = []
    for z in range(nc):
        qc, kc, vc, totc = qf[:, z], kf[:, z], vf[:, z], total[:, z]
        cumh = cum[:, z].transpose(1, 2)                     # [B,H,c]
        igh = igf[:, z].transpose(1, 2)
        # intra log-weights a_ij = cum_i - cum_j + ig_j (j <= i)
        a = cumh[..., :, None] - cumh[..., None, :] + igh[..., None, :]
        a = a.masked_fill(~mask, -math.inf)
        # per-row stabilizer: the max over the intra weights and the inter path
        b_inter = cumh + m[..., None]
        m_row = torch.clamp_min(torch.maximum(a.amax(-1), b_inter), -1e30)
        w = torch.exp(a - m_row[..., None])
        inter_w = torch.exp(b_inter - m_row)
        s = torch.einsum("bihn,bjhn->bhij", qc, kc)
        qh = qc.transpose(1, 2)                              # [B,H,c,N]
        num = torch.einsum("bhij,bjhp->bhip", w * s, vc) \
            + inter_w[..., None] * torch.einsum("bhin,bhnp->bhip", qh, C)
        den = torch.einsum("bhij,bhij->bhi", w, s) \
            + inter_w * torch.einsum("bhin,bhn->bhi", qh, n)
        h = num / torch.maximum(den.abs(), torch.exp(-m_row))[..., None]
        # the state update with its own stabilizer
        kdec = totc[..., None] - cumh + igh                  # [B,H,c]
        m_new = torch.maximum(totc + m, kdec.amax(-1))
        kw = torch.exp(kdec - m_new[..., None])
        carry = torch.exp(totc + m - m_new)
        kcs = kc.transpose(1, 2) * kw[..., None]             # [B,H,c,N]
        C = carry[..., None, None] * C + torch.einsum("bhjn,bjhp->bhnp", kcs, vc)
        n = carry[..., None] * n + kcs.sum(2)
        m = m_new
        hs.append(h.transpose(1, 2))                         # [B,c,H,P]
    h = torch.stack(hs, dim=1).reshape(B, S, H, P)
    return h.to(v.dtype), (C, n, m)


def mlstm_step(q, k, v, ig, fg, state):
    """One token of the stabilized mLSTM. q,k: [B,H,N]; v: [B,H,P]; ig/fg:
    [B,H]; state (C, n, m). Returns (h [B,H,P] in v's dtype, new state)."""
    C, n, m = state
    f = C.dtype
    qf = q.to(f) / math.sqrt(q.shape[-1])
    lf = F.logsigmoid(fg.to(f))
    igf = ig.to(f)
    m_new = torch.maximum(lf + m, igf)
    fscale = torch.exp(lf + m - m_new)
    iscale = torch.exp(igf - m_new)
    kf = k.to(f) * iscale[..., None]
    C_new = fscale[..., None, None] * C + torch.einsum("bhn,bhp->bhnp", kf, v.to(f))
    n_new = fscale[..., None] * n + kf
    num = torch.einsum("bhn,bhnp->bhp", qf, C_new)
    den = torch.einsum("bhn,bhn->bh", qf, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(v.dtype), (C_new, n_new, m_new)


def ssd_specs(cfg):
    s = cfg.ssm
    d = cfg.d_model
    dss = s.n_ssm_heads * s.head_dim
    return {
        "w_in": ParamSpec((d, 2 * dss + 2 * s.d_state), ("embed", "inner")),
        "conv": ParamSpec((s.d_conv, dss + 2 * s.d_state), ("conv", "inner"), init="normal",
                          scale=0.5),
        "w_dt": ParamSpec((d, s.n_ssm_heads), ("embed", None)),
        "dt_bias": ParamSpec((s.n_ssm_heads,), (None,), init="zeros"),
        "a_log": ParamSpec((s.n_ssm_heads,), (None,), init="zeros"),
        "d_skip": ParamSpec((s.n_ssm_heads,), (None,), init="ones"),
        "norm": ParamSpec((dss,), ("inner",), init="ones"),
        "wo": ParamSpec((dss, d), ("inner", "embed")),
    }


def cache_shapes(cfg):
    """(shape of one row, dtype name) of each SSD cache leaf."""
    s = cfg.ssm
    C = s.n_ssm_heads * s.head_dim + 2 * s.d_state
    return {"state": ((s.n_ssm_heads, s.d_state, s.head_dim), "float32"),
            "conv": ((s.d_conv - 1, C), cfg.compute_dtype)}


def _gates(p, x):
    """dt = softplus(x w_dt + dt_bias) and the log decay lg = -exp(a_log) dt."""
    dt = F.softplus(x @ p["w_dt"] + p["dt_bias"])
    return dt, -torch.exp(p["a_log"]) * dt


def ssd_apply(cfg, p, x, *, mode, cache=None, force=None, schedule="chunk"):
    """x: [B,S,d] (train, prefill) or [B,d] (decode); ``cache`` is updated
    in place (train: None). Returns (out, cache). Train mode is the
    prefill's math with no cache, differentiable (``ops.gla`` under the
    chunk schedule). ``schedule`` picks the prefill's GLA kernel
    (:data:`repro_torch.kernels.ops.GLA_SCHEDULES`)."""
    s = cfg.ssm
    Hs, Pd, N, W = s.n_ssm_heads, s.head_dim, s.d_state, s.d_conv
    dss = Hs * Pd

    if mode in ("train", "prefill"):
        B, S, _ = x.shape
        if mode == "prefill" and S < W - 1:
            # the reference keeps pre_conv[:, S - (W - 1):], which is short
            # of W - 1 rows here, and its next decode step fails
            raise ValueError(f"SSD prefill of {S} positions: needs at least "
                             f"d_conv - 1 = {W - 1}")
        proj = x @ p["w_in"]
        pre_conv, z = proj[..., : dss + 2 * N], proj[..., dss + 2 * N:]
        u_bc = F.silu(causal_conv1d(pre_conv, p["conv"]))
        u, Bt, Ct = u_bc[..., :dss], u_bc[..., dss:dss + N], u_bc[..., dss + N:]
        dt, lg = _gates(p, x)                                   # [B,S,H]
        uh = u.reshape(B, S, Hs, Pd)
        v = uh * dt[..., None]
        # the heads share C_t and B_t: ops.gla takes the rows as they are (the
        # kernels read them as head-stride-0 views, nothing copied, and the
        # backward kernel returns their gradients as rows)
        y, state = ops.gla(Ct, Bt, v, lg, chunk=s.chunk, schedule=schedule, force=force)
        y = y + uh * p["d_skip"][None, None, :, None]
        y = rms_groupnorm(y.reshape(B, S, dss), p["norm"], Hs)
        out = (y * F.silu(z)) @ p["wo"]
        if mode == "train":
            return out, None
        cache["state"].copy_(state)
        cache["conv"].copy_(pre_conv[:, S - (W - 1):])
        return out, cache

    if mode != "decode":
        raise ValueError(f"mode {mode!r}; the SSD mixer takes 'train', 'prefill' or "
                         "'decode'")
    B, _ = x.shape
    proj = x @ p["w_in"]
    pre_conv, z = proj[..., : dss + 2 * N], proj[..., dss + 2 * N:]
    u_bc, conv_state = causal_conv1d_step(pre_conv, cache["conv"], p["conv"])
    u_bc = F.silu(u_bc)
    u, Bt, Ct = u_bc[..., :dss], u_bc[..., dss:dss + N], u_bc[..., dss + N:]
    dt, lg = _gates(p, x)                                   # [B,H]
    uh = u.reshape(B, Hs, Pd)
    v = uh * dt[..., None]
    q = Ct[:, None].expand(B, Hs, N)
    k = Bt[:, None].expand(B, Hs, N)
    y, state = gla_step(q, k, v, lg, cache["state"])
    y = y + uh * p["d_skip"][None, :, None]
    y = rms_groupnorm(y.reshape(B, dss), p["norm"], Hs)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_state)
    return (y * F.silu(z)) @ p["wo"], cache
