"""xLSTM blocks [arXiv:2405.04517]: the mLSTM (matrix memory, chunked
parallel, stabilized exp gating) and the sLSTM (scalar memory, a sequential
recurrence with block-diagonal recurrent weights). xlstm-350m interleaves
them 1:1.

A copy of the JAX package's ``models/xlstm.py``: the same leaf names,
``[in, out]`` layouts and inits. The mLSTM runs plain torch
(``models/ssm.chunked_mlstm`` in the prefill, ``mlstm_step`` in decode), as
the reference leaves it to XLA. The sLSTM's recurrence runs through
:func:`repro_torch.kernels.ops.slstm_scan`: the CUDA kernel for tensors on
the card (one launch a layer for the prefill's whole scan, and one a
decode step at S = 1 from the cached state), its plain version on the
CPU.

Modes: ``train`` (x [B,S,d], from the prefill's start state, no cache;
differentiable: the sLSTM through ``ops.slstm_scan``'s training forward and
backward kernel on the card, the mLSTM by autograd through the plain
``chunked_mlstm``, as the reference differentiates its plain XLA),
``prefill`` (x [B,S,d], writes the cache) and ``decode`` (x [B,d], updates
it). The caches, written in place:

- mLSTM ``{"C": [B,H,N,P], "n": [B,H,N], "m": [B,H]}`` float32 and
  ``"conv": [B,W-1,di]`` (the last pre-conv rows) in the compute dtype;
- sLSTM ``{"c", "n", "m", "h": [B,H,dh]}`` float32 and ``"conv":
  [B,W-1,d]`` in the compute dtype.

None grows with the sequence.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import slstm_state0
from repro_torch.models.layers import causal_conv1d, causal_conv1d_step, rms_groupnorm
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import chunked_mlstm, mlstm_step


def _check_prefill(cfg, S):
    W = cfg.xlstm.d_conv
    if S < W - 1:
        # the reference keeps x[:, S - (W - 1):], short of W - 1 rows here,
        # and its next decode step fails
        raise ValueError(f"xLSTM prefill of {S} positions: needs at least "
                         f"d_conv - 1 = {W - 1}")


def _mode(mode):
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"xLSTM mode {mode!r}; the blocks take train, prefill "
                                  "and decode")


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_dims(cfg):
    """(inner width di, heads H, head width N = di / H)."""
    x = cfg.xlstm
    di = int(cfg.d_model * x.m_proj_factor)
    return di, x.n_heads, di // x.n_heads


def mlstm_specs(cfg):
    x = cfg.xlstm
    d = cfg.d_model
    di, H, _ = mlstm_dims(cfg)
    return {
        "w_up": ParamSpec((d, 2 * di), ("embed", "inner")),
        "conv": ParamSpec((x.d_conv, di), ("conv", "inner"), scale=0.5),
        "wq": ParamSpec((di, di), ("inner_in", "inner")),
        "wk": ParamSpec((di, di), ("inner_in", "inner")),
        "wv": ParamSpec((di, di), ("inner_in", "inner")),
        "w_ig": ParamSpec((di, H), ("inner", None), scale=0.01),
        "b_ig": ParamSpec((H,), (None,), init="zeros"),
        "w_fg": ParamSpec((di, H), ("inner", None), scale=0.01),
        "b_fg": ParamSpec((H,), (None,), init="ones"),  # bias > 0: remember by default
        "norm": ParamSpec((di,), ("inner",), init="ones"),
        "w_down": ParamSpec((di, d), ("inner", "embed")),
    }


def mlstm_apply(cfg, p, x, *, mode, cache):
    """x: [B,S,d] (train, prefill) or [B,d] (decode); ``cache`` updated in
    place (train: None, and None is returned). Returns (out, cache)."""
    _mode(mode)
    xc = cfg.xlstm
    di, H, N = mlstm_dims(cfg)
    W = xc.d_conv
    lead = x.shape[:-1]
    up = x @ p["w_up"]
    x_in, z = up[..., :di], up[..., di:]
    if mode != "decode":
        _check_prefill(cfg, x.shape[1])
        x_conv = F.silu(causal_conv1d(x_in, p["conv"]))
    else:
        x_conv, conv_state = causal_conv1d_step(x_in, cache["conv"], p["conv"])
        x_conv = F.silu(x_conv)
    q = (x_conv @ p["wq"]).reshape(*lead, H, N)
    k = (x_conv @ p["wk"]).reshape(*lead, H, N)
    v = (x_in @ p["wv"]).reshape(*lead, H, N)
    ig = x_conv @ p["w_ig"] + p["b_ig"]
    fg = x_conv @ p["w_fg"] + p["b_fg"]
    if mode != "decode":
        S = x.shape[1]
        h, (C, n, m) = chunked_mlstm(q, k, v, ig, fg, chunk=xc.chunk)
        conv_state = x_in[:, S - (W - 1):]
    else:
        h, (C, n, m) = mlstm_step(q, k, v, ig, fg, (cache["C"], cache["n"], cache["m"]))
    h = rms_groupnorm(h.reshape(*lead, di), p["norm"], H)
    out = (h * F.silu(z)) @ p["w_down"]
    if mode == "train":
        return out, None
    for name, t in (("C", C), ("n", n), ("m", m), ("conv", conv_state)):
        cache[name].copy_(t)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def _slstm_ff(cfg):
    """The sLSTM FFN width, padded to 128 (the reference pads for its TP
    shardings)."""
    ff = int(cfg.d_model * cfg.xlstm.s_ff_factor)
    return max(128, ((ff + 127) // 128) * 128)


def slstm_specs(cfg):
    x = cfg.xlstm
    d = cfg.d_model
    H = x.n_heads
    dh = d // H
    ff = _slstm_ff(cfg)
    return {
        "conv": ParamSpec((x.d_conv, d), ("conv", "embed"), scale=0.5),
        "w_gates": ParamSpec((d, 4 * d), ("embed", "inner")),
        "r_gates": ParamSpec((H, dh, 4 * dh), (None, "inner_in", "inner"), scale=0.02),
        "b_gates": ParamSpec((4 * d,), ("inner",), init="zeros"),
        "norm": ParamSpec((d,), ("embed",), init="ones"),
        "ff_w1": ParamSpec((d, ff), ("embed", "mlp")),
        "ff_wg": ParamSpec((d, ff), ("embed", "mlp")),
        "ff_w2": ParamSpec((ff, d), ("mlp", "embed")),
    }


def slstm_apply(cfg, p, x, *, mode, cache, force=None):
    """x: [B,S,d] (train, prefill) or [B,d] (decode); ``cache`` updated in
    place (train: None, and None is returned). The gates' input projection
    is hoisted out of the recurrence (one product over every position),
    then ``ops.slstm_scan`` runs it: from the reference's ``state0`` in
    train and prefill, from the cache at S = 1 in decode. Returns (out,
    cache)."""
    _mode(mode)
    xc = cfg.xlstm
    d = cfg.d_model
    H = xc.n_heads
    W = xc.d_conv
    if mode != "decode":
        B, S, _ = x.shape
        _check_prefill(cfg, S)
        x_conv = F.silu(causal_conv1d(x, p["conv"]))
        state = slstm_state0(B, H, d // H, x.device)
        conv_state = x[:, S - (W - 1):]
    else:
        B = x.shape[0]
        x_conv, conv_state = causal_conv1d_step(x, cache["conv"], p["conv"])
        x_conv = F.silu(x_conv)[:, None]
        state = tuple(cache[k] for k in ("c", "n", "m", "h"))
    wx = x_conv @ p["w_gates"] + p["b_gates"]              # [B,S,4d]
    hs, (c, n, m, hh) = ops.slstm_scan(wx, p["r_gates"], state, force=force)
    h = rms_groupnorm(hs.reshape(*x.shape), p["norm"], H)
    h = h + x  # the residual inside the block, after the recurrence
    y = (F.silu(h @ p["ff_wg"]) * (h @ p["ff_w1"])) @ p["ff_w2"]
    if mode == "train":
        return y, None
    for name, t in (("c", c), ("n", n), ("m", m), ("h", hh), ("conv", conv_state)):
        cache[name].copy_(t)
    return y, cache


def cache_shapes(cfg):
    """(shape of one row, dtype name) of each xLSTM cache leaf, by block."""
    xc = cfg.xlstm
    di, H, N = mlstm_dims(cfg)
    d, Hs = cfg.d_model, xc.n_heads
    W = xc.d_conv
    return {"mlstm": {"C": ((H, N, N), "float32"), "n": ((H, N), "float32"),
                      "m": ((H,), "float32"), "conv": ((W - 1, di), cfg.compute_dtype)},
            "slstm": {**{k: ((Hs, d // Hs), "float32") for k in ("c", "n", "m", "h")},
                      "conv": ((W - 1, d), cfg.compute_dtype)}}
