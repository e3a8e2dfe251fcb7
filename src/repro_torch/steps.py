"""Step functions: what the serving engine calls per request."""
from __future__ import annotations

from repro_torch.models import Model


def make_prefill_step(model: Model):
    def prefill_step(params, tokens, max_len=None):
        return model.prefill(params, tokens, max_len=max_len)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, token, pos, caches):
        return model.decode_step(params, token, pos, caches)
    return decode_step


def make_paged_decode_step(model: Model):
    def paged_decode_step(params, token, pos, pool_views, pages):
        return model.decode_step_paged(params, token, pos, pool_views, pages)
    return paged_decode_step
