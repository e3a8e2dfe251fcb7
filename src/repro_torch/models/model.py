"""Model facade: build once from a ModelConfig, expose init/train/prefill/decode."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import init_params


@dataclass(frozen=True)
class Model:
    cfg: object
    #: kernel path for every layer: None | 'kernel' | 'ref' (kernels/ops.py)
    force: Optional[str] = None
    #: the SSD prefill's GLA schedule: 'chunk' | 'parallel' (kernels/ops.py)
    gla_schedule: str = "chunk"

    def specs(self):
        return T.model_specs(self.cfg)

    def init(self, seed: int, device):
        return init_params(self.specs(), getattr(torch, self.cfg.param_dtype),
                           seed=seed, device=device)

    def alloc_caches(self, batch_size: int, max_len: int, device, prompt_len=None):
        return T.alloc_caches(self.cfg, batch_size, max_len, device, prompt_len)

    def train_logits(self, params, batch):
        """batch: ``{"tokens": [B,S] int64, ...}`` on the params' device,
        with ``"patch_embeds"`` [B, img_tokens, 1024] for llava. -> (logits
        [B,S,Vp] float32, aux loss float32 0-d: the MoE layers' router
        losses, 0 without experts). Differentiable: every layer runs in
        train mode (``T.run_segments``, under ``torch.utils.checkpoint``
        when ``cfg.remat``)."""
        cfg = self.cfg
        h = T.embed_tokens(cfg, params, batch["tokens"], batch.get("patch_embeds"))
        h, _, aux = T.run_segments(cfg, params, h, mode="train", caches=None,
                                   force=self.force)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return T.lm_head(cfg, params, h), aux

    def prefill(self, params, tokens, *, max_len: Optional[int] = None, patch_embeds=None):
        """tokens: [B,S] int64; ``patch_embeds`` [B, img_tokens, 1024] for
        llava's image (``T.embed_tokens``). -> (last-position logits [B, Vp]
        float32, caches allocated at ``max_len`` (default S) holding the
        prompt's rows; a window layer's ring is ``T.ring_width`` rows)."""
        cfg = self.cfg
        B, S = tokens.shape
        caches = self.alloc_caches(B, max_len or S, tokens.device, prompt_len=S)
        h = T.embed_tokens(cfg, params, tokens, patch_embeds)
        h, caches, _ = T.run_segments(cfg, params, h, mode="prefill", caches=caches,
                                      force=self.force, schedule=self.gla_schedule)
        h_last = rmsnorm(h[:, -1], params["final_norm"], cfg.norm_eps)
        return T.lm_head(cfg, params, h_last), caches

    def decode_step(self, params, token, pos: int, caches):
        """token: [B] int64; pos: index of the token. Updates ``caches`` in
        place. -> (logits [B, Vp] float32, caches)."""
        cfg = self.cfg
        h = T.embed_tokens(cfg, params, token)
        h, caches, _ = T.run_segments(cfg, params, h, mode="decode", caches=caches,
                                      pos=pos, force=self.force)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return T.lm_head(cfg, params, h), caches

    def decode_step_paged(self, params, token, pos: int, pool_views, pages):
        """One lane over the serving page pool. token: [1] int64; pos: index
        of the token; pool_views: per segment ``{"attn": {"k", "v"}}`` views
        ``[P, page, n_layers, K, hd]`` of the pool's stores (MLA's
        ``{"lat"}``, K = 1 and hd the latent row)
        (``PagePool.layer_view``); pages: the lane's page list (host ints),
        which must already cover ``pos``. Each layer's K/V row is written
        into the page slot of ``pos`` in place, and attention covers
        positions ``< pos + 1`` through the page table.
        -> logits [1, Vp] float32."""
        cfg = self.cfg
        page_size = next(iter(pool_views[0]["attn"].values())).shape[1]
        # the table and the length in one host-to-device copy
        meta = torch.tensor([*pages, pos + 1], dtype=torch.int32, device=token.device)
        lane = {"table": meta[:-1].view(1, -1), "lengths": meta[-1:],
                "slot": (pages[pos // page_size], pos % page_size)}
        h = T.embed_tokens(cfg, params, token)
        h, _, _ = T.run_segments(cfg, params, h, mode="paged_decode", caches=pool_views,
                                 pos=pos, force=self.force, lane=lane)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return T.lm_head(cfg, params, h)
