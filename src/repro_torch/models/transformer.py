"""Decoder-stack assembly for the dense attention family: segment planning,
block specs/apply, embeddings, head, and the loop over stacked layers.

Only the ``attn`` block with full attention is here; ring/window caches,
MLA, MoE, hymba and xLSTM come with their own slices and raise until then.
Caches keep the JAX package's layout: a list with one entry per segment,
``{"attn": {"k", "v"}}`` with ``[n_layers, B, S_max, K*hd]`` leaves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec, stack_spec, tree_map


@dataclass(frozen=True)
class Segment:
    kind: str            # 'attn'
    n: int               # number of stacked block repetitions in this segment
    window: Optional[int]  # None = full attention


def _check_supported(cfg):
    if cfg.block != "attn" or cfg.window is not None or cfg.mla is not None \
            or cfg.moe is not None or cfg.n_codebooks > 1 or cfg.img_tokens:
        raise NotImplementedError(
            f"{cfg.name}: only dense full-attention decoders are ported so far")


def plan_segments(cfg):
    _check_supported(cfg)
    return [Segment("attn", cfg.n_layers, cfg.window)]


def block_specs(cfg, kind):
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    d = cfg.d_model
    sp = {"ln1": ParamSpec((d,), ("embed",), init="ones"),
          "attn": L.attn_specs(cfg)}
    if cfg.d_ff:
        sp["ln2"] = ParamSpec((d,), ("embed",), init="ones")
        sp["ffn"] = L.mlp_specs(cfg)
    return sp


def block_apply(cfg, kind, p, x, *, mode, window, cache, pos=None, force=None):
    """Returns (x_out, cache). Block norms use rmsnorm's default eps, as the
    JAX package does; only the final norm takes ``cfg.norm_eps``."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    a_out, a_cache = L.attn_apply(cfg, p["attn"], L.rmsnorm(x, p["ln1"]),
                                  mode=mode, cache=cache["attn"], window=window,
                                  pos=pos, force=force)
    x = x + a_out
    if "ffn" in p:
        x = x + L.mlp_apply(p["ffn"], L.rmsnorm(x, p["ln2"]))
    return x, {"attn": a_cache}


def model_specs(cfg):
    d, Vp = cfg.d_model, cfg.padded_vocab
    sp = {"embed": ParamSpec((Vp, d), ("vocab", "embed"), init="embed"),
          "segments": []}
    for seg in plan_segments(cfg):
        sp["segments"].append(stack_spec(block_specs(cfg, seg.kind), seg.n))
    sp["final_norm"] = ParamSpec((d,), ("embed",), init="ones")
    sp["head"] = ParamSpec((d, Vp), ("embed", "vocab"))
    return sp


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens].to(getattr(torch, cfg.compute_dtype))


def lm_head(cfg, params, h):
    """h: [..., d] -> logits [..., padded_vocab] (float32)."""
    return (h @ params["head"]).float()


def alloc_caches(cfg, batch_size, max_len, device):
    """Zeroed decode caches at ``max_len`` (the prefill writes its rows)."""
    shape = (batch_size, max_len, cfg.kv_cache_width)
    dtype = getattr(torch, cfg.cache_dtype)
    return [{"attn": {k: torch.zeros((seg.n, *shape), dtype=dtype, device=device)
                      for k in ("k", "v")}}
            for seg in plan_segments(cfg)]


def run_segments(cfg, params, h, *, mode, caches, pos=None, force=None, lane=None):
    """Runs all segments; a Python loop over a segment's stacked layer
    leaves takes the place of ``lax.scan``. Layer ``i`` reads and writes
    ``caches[si]`` at index ``i`` in place. Returns (h, caches).

    ``mode='paged_decode'``: ``caches[si]`` is ``{"attn": {"k", "v"}}`` of
    the page pool's ``[P, page, n_layers, K, hd]`` views and ``lane`` the
    lane's ``table`` / ``lengths`` / ``slot`` (see ``layers.attn_apply``);
    layer ``i`` takes the strided view ``[:, :, i]``, nothing is copied."""
    for si, seg in enumerate(plan_segments(cfg)):
        p, c = params["segments"][si], caches[si]
        for i in range(seg.n):
            if mode == "paged_decode":
                ci = {"attn": {"k": c["attn"]["k"][:, :, i],
                               "v": c["attn"]["v"][:, :, i], **lane}}
            else:
                ci = tree_map(lambda t: t[i], c)
            h, _ = block_apply(cfg, seg.kind, tree_map(lambda t: t[i], p), h,
                               mode=mode, window=seg.window, cache=ci, pos=pos,
                               force=force)
    return h, caches
