"""Decoder-stack assembly: segment planning (stacked homogeneous runs and
unstacked exceptional layers), block specs/apply, embeddings, head, and
the loop over a segment's layers.

Three blocks are here: ``attn`` (GQA attention, with or without q/k/v
biases, full or sliding-window, or MLA (multi-head latent attention,
minicpm3-4b), then a SwiGLU MLP or a mixture of experts: the dense
families granite-3-2b, minicpm-2b, qwen2.5-14b and minicpm3-4b,
llava-next-34b's backbone, granite-moe-3b-a800m and arctic-480b),
``hymba`` (attention and the SSD mixer in parallel on the same normed
input, then the MLP) and ``xlstm_pair`` (xlstm-350m: an mLSTM block, then
an sLSTM block, each a residual half; ``models/xlstm.py``). llava's vision
prefix enters through :func:`embed_tokens`. The multi-codebook frontend
comes with its own slice and raises until then. Params and caches keep
the JAX package's layout: a list with one entry per segment; a stacked
(scanned) segment's leaves carry a leading ``[n_layers]`` axis, an
unstacked one's (hymba's global-attention layers) do not. Cache leaves: attention ``{"k", "v"}`` ``[B, S_max, K*hd]`` (a
window layer's ring ``[B, W_ring, K*hd]``), MLA's one latent leaf
``{"lat"}`` ``[B, S_max, kv_lora + rope]``, in ``cache_dtype``; hymba's
``"ssd"`` ``{"state", "conv"}`` (``models/ssm.py``); xLSTM's ``"mlstm"``
and ``"slstm"`` recurrent states and conv rows (``models/xlstm.py``),
none of which grows with the sequence.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X
from repro_torch.models.params import ParamSpec, stack_spec, tree_map

VISION_DIM = 1024  # the stubbed llava frontend's output width


@dataclass(frozen=True)
class Segment:
    kind: str            # 'attn' | 'hymba' | 'xlstm_pair'
    n: int               # number of block repetitions in this segment
    scanned: bool        # leaves stacked [n, ...] (the reference's lax.scan)
    window: Optional[int]  # None = full attention


def _check_supported(cfg):
    if cfg.block not in ("attn", "hymba", "xlstm") or cfg.n_codebooks > 1 \
            or (cfg.block == "hymba" and (cfg.ssm is None or cfg.mla is not None)) \
            or (cfg.block == "xlstm" and (cfg.xlstm is None or cfg.n_layers % 2)):
        raise NotImplementedError(
            f"{cfg.name}: only the attention decoders (dense, MLA, MoE, llava's "
            "backbone), hymba and xLSTM are ported so far")


def check_trainable(cfg):
    """Training is ported for every block the port serves: the attention
    decoders (K1's backward, MLA's at its qk head dim; the MoE layer and
    llava's projection under autograd), hymba (also the GLA backward) and
    xLSTM (the sLSTM recurrence's backward kernel; the mLSTM under
    autograd)."""
    _check_supported(cfg)


def plan_segments(cfg):
    _check_supported(cfg)
    if cfg.block == "xlstm":
        return [Segment("xlstm_pair", cfg.n_layers // 2, True, None)]
    if cfg.block == "hymba":
        segs, prev = [], 0
        for g in sorted(cfg.global_layers):
            if g > prev:
                segs.append(Segment("hymba", g - prev, True, cfg.window))
            segs.append(Segment("hymba", 1, False, None))   # global-attention layer
            prev = g + 1
        if prev < cfg.n_layers:
            segs.append(Segment("hymba", cfg.n_layers - prev, True, cfg.window))
        return segs
    return [Segment("attn", cfg.n_layers, True, cfg.window)]


def block_specs(cfg, kind):
    d = cfg.d_model
    if kind == "xlstm_pair":
        return {"m_norm": ParamSpec((d,), ("embed",), init="ones"),
                "mlstm": X.mlstm_specs(cfg),
                "s_norm": ParamSpec((d,), ("embed",), init="ones"),
                "slstm": X.slstm_specs(cfg)}
    sp = {"ln1": ParamSpec((d,), ("embed",), init="ones"),
          "attn": L.mla_specs(cfg) if cfg.mla is not None else L.attn_specs(cfg)}
    if kind == "hymba":
        sp["ssd"] = SSM.ssd_specs(cfg)
    if cfg.moe is not None or cfg.d_ff:
        sp["ln2"] = ParamSpec((d,), ("embed",), init="ones")
        sp["ffn"] = L.moe_specs(cfg) if cfg.moe is not None else L.mlp_specs(cfg)
    return sp


def block_apply(cfg, kind, p, x, *, mode, window, cache, pos=None, force=None,
                schedule="chunk"):
    """Returns (x_out, cache, aux): aux the MoE layer's router losses
    (float32 0-d), None without experts or in decode. Block norms use
    rmsnorm's default eps, as the JAX package does; only the final norm
    takes ``cfg.norm_eps``. In train mode ``cache`` is None."""
    if kind == "xlstm_pair":
        h, _ = X.mlstm_apply(cfg, p["mlstm"], L.rmsnorm(x, p["m_norm"]), mode=mode,
                             cache=None if cache is None else cache["mlstm"])
        x = x + h
        h, _ = X.slstm_apply(cfg, p["slstm"], L.rmsnorm(x, p["s_norm"]), mode=mode,
                             cache=None if cache is None else cache["slstm"], force=force)
        return x + h, cache, None
    xn = L.rmsnorm(x, p["ln1"])
    a_cache = None if cache is None else cache["attn"]
    if cfg.mla is not None:
        a_out, _ = L.mla_apply(cfg, p["attn"], xn, mode=mode, cache=a_cache, pos=pos,
                               force=force)
    else:
        a_out, _ = L.attn_apply(cfg, p["attn"], xn, mode=mode, cache=a_cache,
                                window=window, pos=pos, force=force)
    if kind == "hymba":
        s_out, _ = SSM.ssd_apply(cfg, p["ssd"], xn, mode=mode,
                                 cache=None if cache is None else cache["ssd"],
                                 force=force, schedule=schedule)
        x = x + 0.5 * (a_out + s_out)
    else:
        x = x + a_out
    aux = None
    if "ffn" in p:
        xn2 = L.rmsnorm(x, p["ln2"])
        if cfg.moe is not None:
            f_out, aux = L.moe_apply(cfg, p["ffn"], xn2, mode=mode)
        else:
            f_out = L.mlp_apply(p["ffn"], xn2)
        x = x + f_out
    return x, cache, aux


def model_specs(cfg):
    d, Vp = cfg.d_model, cfg.padded_vocab
    sp = {"embed": ParamSpec((Vp, d), ("vocab", "embed"), init="embed"),
          "segments": []}
    if cfg.img_tokens:
        sp["mm_proj"] = ParamSpec((VISION_DIM, d), (None, "embed"))
    for seg in plan_segments(cfg):
        bs = block_specs(cfg, seg.kind)
        sp["segments"].append(stack_spec(bs, seg.n) if seg.scanned else bs)
    sp["final_norm"] = ParamSpec((d,), ("embed",), init="ones")
    sp["head"] = ParamSpec((d, Vp), ("embed", "vocab"))
    return sp


def embed_tokens(cfg, params, tokens, patch_embeds=None):
    """tokens [B,S] (or [B] in decode) -> [B,S,d] in the compute dtype.
    With ``patch_embeds`` [B, img_tokens, VISION_DIM] (llava), their
    projection by ``mm_proj`` takes the first ``img_tokens`` positions, in
    the table's dtype as the reference computes it. A prompt shorter than
    the image raises ``ValueError``: the reference's splice would make the
    sequence longer than the prompt (ROADMAP queue 3, part C)."""
    h = params["embed"][tokens]
    if cfg.img_tokens and patch_embeds is not None and h.dim() == 3:
        n = cfg.img_tokens
        if tuple(patch_embeds.shape) != (h.shape[0], n, VISION_DIM):
            raise ValueError(f"patch_embeds {tuple(patch_embeds.shape)}; expected "
                             f"{(h.shape[0], n, VISION_DIM)}")
        if h.shape[1] < n:
            raise ValueError(f"{cfg.name}: a prompt of {h.shape[1]} positions is shorter "
                             f"than its image's {n}")
        vis = patch_embeds.to(h.dtype) @ params["mm_proj"]
        h = torch.cat([vis, h[:, n:]], dim=1)
    return h.to(getattr(torch, cfg.compute_dtype))


def lm_head(cfg, params, h):
    """h: [..., d] -> logits [..., padded_vocab] (float32; float64 for a
    float64 model)."""
    return (h @ params["head"]).to(L.acc_dtype(h))


def ring_width(window, prompt_len, max_len):
    """A window layer's ring after a prefill of ``prompt_len`` into caches
    at ``max_len``, as the JAX ``Server`` leaves it: the window when the
    prompt is longer, else the prompt's rows grown to ``max_len``."""
    return window if prompt_len > window else max_len


def alloc_caches(cfg, batch_size, max_len, device, prompt_len=None):
    """Zeroed decode caches at ``max_len`` for a prompt of ``prompt_len``
    (default ``max_len``) positions, which the prefill writes."""
    prompt_len = max_len if prompt_len is None else prompt_len
    kv_dtype = getattr(torch, cfg.cache_dtype)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    caches = []
    for seg in plan_segments(cfg):
        lead = (seg.n, batch_size) if seg.scanned else (batch_size,)
        if seg.kind == "xlstm_pair":
            caches.append({blk: {k: zeros((*lead, *shape), getattr(torch, dt))
                                 for k, (shape, dt) in leaves.items()}
                           for blk, leaves in X.cache_shapes(cfg).items()})
            continue
        rows = max_len if seg.window is None else ring_width(seg.window, prompt_len, max_len)
        names = ("lat",) if cfg.mla is not None else ("k", "v")
        c = {"attn": {k: zeros((*lead, rows, cfg.kv_cache_width), kv_dtype)
                      for k in names}}
        if seg.kind == "hymba":
            c["ssd"] = {k: zeros((*lead, *shape), getattr(torch, dt))
                        for k, (shape, dt) in SSM.cache_shapes(cfg).items()}
        caches.append(c)
    return caches


def cache_capacity(caches):
    """Positions a cache tree holds: the rows of its widest attention leaf
    (a full-attention layer's ``max_len``); None when no leaf grows with the
    sequence (xLSTM), which has no capacity to run out of."""
    rows = [next(iter(c["attn"].values())).shape[-2] for c in caches if "attn" in c]
    return max(rows) if rows else None


def run_segments(cfg, params, h, *, mode, caches, pos=None, force=None, lane=None,
                 schedule="chunk"):
    """Runs all segments; a Python loop over a stacked segment's layer
    leaves takes the place of ``lax.scan``. Layer ``i`` reads and writes
    its cache (``caches[si]`` at index ``i``, or the whole entry of an
    unstacked segment) in place. Returns (h, caches, aux): aux the sum of
    the MoE layers' router losses (float32 0-d; None without experts or in
    decode), which the train step adds to the loss and the serving paths
    drop.

    ``mode='paged_decode'``: ``caches[si]`` is ``{"attn": {"k", "v"}}`` of
    the page pool's ``[P, page, n_layers, K, hd]`` views (MLA's ``{"lat"}``
    ``[P, page, n_layers, 1, kv_lora + rope]``) and ``lane`` the lane's
    ``table`` / ``lengths`` / ``slot`` (see ``layers.attn_apply``); layer
    ``i`` takes the strided view ``[:, :, i]``, nothing is copied.

    ``mode='train'``: no caches (``caches`` is None); with ``cfg.remat``
    each layer runs under ``torch.utils.checkpoint`` (non-reentrant), which
    keeps only the layer's input and recomputes the layer in the backward,
    as the reference wraps each scanned layer in ``jax.checkpoint`` with
    ``nothing_saveable``; ``ops.remat_context`` marks the two passes, so
    that the first, whose saved tensors are discarded, runs the sLSTM's
    serving kernel and only the recompute its training forward."""
    aux = None
    if mode == "train":
        check_trainable(cfg)
        for si, seg in enumerate(plan_segments(cfg)):
            p = params["segments"][si]
            # a stacked leaf is unbound once: its gradient is then one stack
            # of the layers' gradients, where indexing it per layer would
            # give each layer's gradient as a zero-filled stacked-size
            # tensor to add into the sum
            layers = tree_map(lambda t: t.unbind(0), p) if seg.scanned else None
            fn = _train_layer(cfg, seg, force)
            for i in range(seg.n):
                pi = tree_map(lambda t: t[i], layers) if seg.scanned else p
                h, a = (checkpoint(fn, pi, h, use_reentrant=False, context_fn=ops.remat_context)
                        if cfg.remat else fn(pi, h))
                aux = _add(aux, a)
        return h, caches, aux
    for si, seg in enumerate(plan_segments(cfg)):
        p, c = params["segments"][si], caches[si]
        for i in range(seg.n):
            if mode == "paged_decode":
                ci = {"attn": {**{k: t[:, :, i] for k, t in c["attn"].items()}, **lane}}
            else:
                ci = tree_map(lambda t: t[i], c) if seg.scanned else c
            pi = tree_map(lambda t: t[i], p) if seg.scanned else p
            h, _, a = block_apply(cfg, seg.kind, pi, h, mode=mode, window=seg.window,
                                  cache=ci, pos=pos, force=force, schedule=schedule)
            aux = _add(aux, a)
    return h, caches, aux


def _add(total, a):
    """A running sum that stays None until a layer reports a loss."""
    return a if total is None else total if a is None else total + a


def _train_layer(cfg, seg, force):
    def fn(p, x):
        x, _, aux = block_apply(cfg, seg.kind, p, x, mode="train", window=seg.window,
                                cache=None, force=force)
        return x, aux
    return fn
