"""The single-stream ``Server``: one batched sequence, prefilled once and
decoded greedily token by token.

The counterpart of the JAX package's ``serving/engine.Server`` without its
checkpoint/restart plane (cluster, runtime-state registry, snapshots),
which comes with a later slice of the port.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import steps as ST
from repro_torch.models import Model


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no silent CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """Single-stream serving (one batched sequence).

    ``params`` defaults to the seeded init on ``device``; tests hand in the
    JAX package's params through ``models.params.from_jax_params``.
    """

    def __init__(self, cfg, *, seed=0, params=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.params = params if params is not None \
            else self.model.init(seed, self.device)
        self.prefill_fn = ST.make_prefill_step(self.model)
        self.decode_fn = ST.make_decode_step(self.model)
        self.caches = None
        self.pos = 0
        self._tok = None

    def _tokens(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        if t.numel() and (int(t.min()) < 0 or int(t.max()) >= self.cfg.padded_vocab):
            raise ValueError(f"token ids must lie in [0, {self.cfg.padded_vocab})")
        return t.to(self.device)

    def prefill(self, tokens, pad_to=None):
        """tokens: [B,S]. Caches are allocated at ``max(pad_to, S)`` and hold
        the prompt's rows. Returns the last position's logits [B, Vp]."""
        t = self._tokens(tokens)
        S = t.shape[-1]
        logits, self.caches = self.prefill_fn(self.params, t,
                                              max_len=max(pad_to or S, S))
        self.pos = S
        return logits

    def start_decode(self, first_token):
        """Seed the decode loop (``step_once`` consumes it)."""
        self._tok = self._tokens(first_token)

    def step_once(self):
        """Decode ONE token from the internal seed; returns it as numpy [B]."""
        if self.pos >= self.caches[0]["attn"]["k"].shape[2]:
            raise RuntimeError(f"cache full at {self.pos} positions")
        logits, self.caches = self.decode_fn(self.params, self._tok, self.pos,
                                             self.caches)
        self._tok = torch.argmax(logits[..., : self.cfg.vocab_size], dim=-1)
        self.pos += 1
        return self._tok.to(torch.int32).cpu().numpy()

    def decode(self, n_tokens, first_token):
        """Greedy decode of ``n_tokens``; returns (tokens, seconds)."""
        self.start_decode(first_token)
        _sync(self.device)
        t0 = time.perf_counter()
        out = [self.step_once() for _ in range(n_tokens)]
        _sync(self.device)
        return out, time.perf_counter() - t0
