"""Dispatch between the CUDA kernels and their plain PyTorch versions.

``force`` selects a path: ``None`` takes the kernel for CUDA tensors and the
plain version for CPU tensors; ``'kernel'`` takes the kernel and raises for
tensors that are not on a CUDA device; ``'ref'`` takes the plain version
(tests and ``chip_smoke.py`` use it to hold the kernels to it). A CUDA
tensor never falls back to the plain version: a kernel that does not build
or launch raises; the same holds for the backward kernels.
"""
from __future__ import annotations

import contextvars

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gla_chunk as _gla
from repro_torch.kernels import latent_decode_attention as _latent
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import slstm_scan as _slstm

FORCES = (None, "kernel", "ref")
#: which pass of a layer under ``torch.utils.checkpoint`` runs: None
#: outside one, "forward" in its first pass (whose saved tensors the
#: checkpoint discards), "recompute" in the backward's recompute
_REMAT = contextvars.ContextVar("remat_pass", default=None)
#: GLA schedules: 'chunk' (K4, the reference's ``ops.gla`` target) or
#: 'parallel' (K5, the chunk-parallel phases)
GLA_SCHEDULES = ("chunk", "parallel")


def _use_kernel(x, force) -> bool:
    if force not in FORCES:
        raise ValueError(f"force={force!r}; expected one of {FORCES}")
    if force == "ref":
        return False
    if x.device.type == "cuda":
        return True
    if force == "kernel":
        raise RuntimeError(f"force='kernel' needs CUDA tensors; got {x.device}")
    if x.device.type != "cpu":
        raise RuntimeError(f"no kernel path for device {x.device}")
    return False


def flash_attention(q, k, v, *, window=None, force=None):
    """Causal attention. q: [B,H,S,D]; k: [B,K,S,D]; v: [B,K,S,Dv], as wide
    as q or at MLA's (96, 64) (the scale 1/sqrt(D)); returns [B,H,S,Dv].
    Differentiable on
    both routes: on the kernel route, when an input requires a gradient,
    through :class:`~repro_torch.kernels.flash_attention.FlashAttention`
    (the forward writes its logsumexp and the gradient is the backward
    kernels'); on the plain route through autograd of the plain version."""
    if _use_kernel(q, force):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _flash.FlashAttention.apply(q, k, v, window)
        return _flash.flash_attention(q, k, v, window=window)
    return ref.naive_attention(q, k, v, window=window)


def decode_attention(q, k, v, length, *, window=None, force=None):
    """One-token attention. q: [B,H,D]; k,v: [B,S,K,D]; positions < length."""
    if _use_kernel(q, force):
        return _decode.decode_attention(q, k, v, length, window=window)
    return ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                      length, window=window)


def window_decode_attention(q, k_ring, v_ring, pos, *, window, force=None):
    """One-token attention over a sliding-window layer's ring-buffer cache.
    q: [B,H,D]; k_ring, v_ring: [B,W,K,D] with position ``p`` in slot
    ``p % W``; ``pos``: index of the newest token (its row written)."""
    if _use_kernel(q, force):
        return _decode.ring_decode_attention(q, k_ring, v_ring, pos, window=window)
    return ref.naive_ring_decode_attention(q, k_ring, v_ring, pos, window=window)


def gla(q, k, v, lg, *, chunk, schedule="chunk", force=None):
    """Chunked gated linear attention. q,k: [B,S,H,N], or [B,S,N], one row
    shared by every head (the SSD mixer's C_t and B_t); v: [B,S,H,P]; lg:
    [B,S,H]. Returns (y [B,S,H,P], final state [B,H,N,P] float32).
    Differentiable on both routes under the chunk schedule: on the kernel
    route, when an input requires a gradient, through
    :class:`~repro_torch.kernels.gla_chunk.GLAChunk` (K4 and its backward
    kernel, which returns a shared row's gradient as such a row; the final
    state takes no gradient); on the plain route through autograd of the
    plain version (shared rows expanded inside, so autograd sums the heads).
    Training takes the chunk schedule, as the reference differentiates the
    sequential ``chunked_gla``: the parallel one raises when a gradient is
    asked for."""
    if schedule not in GLA_SCHEDULES:
        raise ValueError(f"schedule={schedule!r}; expected one of {GLA_SCHEDULES}")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, lg))
    if grad and schedule != "chunk":
        raise ValueError(f"schedule={schedule!r} takes no gradient; training takes the "
                         "chunk schedule")
    if _use_kernel(q, force) and grad:
        return _gla.GLAChunk.apply(q, k, v, lg, chunk)
    q, k = ref.expand_heads(q, v.shape[2]), ref.expand_heads(k, v.shape[2])
    if _use_kernel(q, force):
        if schedule == "parallel":
            return _gla.gla_chunk_parallel(q, k, v, lg, chunk=chunk)
        return _gla.gla_chunk(q, k, v, lg, chunk=chunk)
    fn = ref.chunked_gla if schedule == "chunk" else ref.gla_chunk_parallel
    return fn(q, k, v, lg, chunk=chunk)


class _RematMark:
    """Marks the pass it guards (a ``with`` block) as ``name``."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.token = _REMAT.set(self.name)

    def __exit__(self, *exc):
        _REMAT.reset(self.token)


def remat_context():
    """The ``context_fn`` of a layer's non-reentrant ``checkpoint``
    (``models/transformer.run_segments``): marks its first pass "forward"
    and its recompute "recompute", so that a differentiable kernel saves
    for its backward only where the backward reads it
    (:func:`slstm_scan`)."""
    return _RematMark("forward"), _RematMark("recompute")


def remat_pass():
    """The pass :func:`remat_context` marked (None outside a checkpoint)."""
    return _REMAT.get()


def slstm_scan(wx, r, state, *, force=None):
    """The sLSTM recurrence over wx's S positions from ``state`` = (c, n,
    m, h), each [B,H,dh] float32. wx: [B,S,4d] the hoisted input gates
    (head-major [H,4,dh]); r: [H,dh,4dh] in wx's dtype. Returns (hs
    [B,S,H,dh] in wx's dtype, the final state). The prefill runs it from
    ``ref.slstm_state0``, a decode step at S = 1 from the cached state.
    Differentiable on both routes: on the kernel route, when wx or r
    requires a gradient, through
    :class:`~repro_torch.kernels.slstm_scan.SLSTMScan` (the training
    forward, then the backward kernel and the dR product; the final state
    takes no gradient), and in a checkpoint's first pass, whose saved
    tensors the recompute replaces, through the serving forward; on the
    plain route through autograd of the plain version."""
    if _use_kernel(wx, force):
        if torch.is_grad_enabled() and (wx.requires_grad or r.requires_grad):
            save = remat_pass() != "forward"
            hs, *final = _slstm.SLSTMScan.apply(wx, r, *state, save)
            return hs, tuple(final)
        return _slstm.slstm_scan(wx, r, state)
    return ref.slstm_scan(wx, r, state)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *, window=None,
                           force=None):
    """One-token attention over a page pool. q: [B,H,D]; k/v pages: [P, page,
    K, D]; page_table: [B, n] int32; lengths: [B] int32."""
    if _use_kernel(q, force):
        return _paged.paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                                             window=window)
    return ref.naive_paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                                            window=window)


def paged_attention_pool_view(q, view, *, window=None, force=None):
    """:func:`paged_decode_attention` straight off a serving-pool view:
    ``view`` is the ``(k_pages, v_pages, page_table, lengths)`` tuple of
    :meth:`repro_torch.serving.kv_pool.PagePool.kernel_view`, the pool's
    stores seen as ``[P, page, K, D]`` with no gather and no copy."""
    k_pages, v_pages, page_table, lengths = view
    return paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                                  window=window, force=force)


def latent_decode_attention(q, lat, length, *, v_dim, scale, force=None):
    """MLA's absorbed decode: one latent row a position is each query head's
    key, and its first ``v_dim`` columns the value. q: [B,H,Dk]; lat:
    [B,S,Dk]; positions < length; scores scaled by ``scale``."""
    if _use_kernel(q, force):
        return _latent.latent_decode_attention(q, lat, length, v_dim=v_dim, scale=scale)
    return ref.naive_latent_decode_attention(q, lat, length, v_dim=v_dim, scale=scale)


def paged_latent_decode_attention(q, lat_pages, page_table, lengths, *, v_dim, scale,
                                  force=None):
    """:func:`latent_decode_attention` over a page pool. q: [B,H,Dk];
    lat_pages: [P, page, Dk]; page_table: [B, n] int32; lengths: [B] int32."""
    if _use_kernel(q, force):
        return _latent.paged_latent_decode_attention(q, lat_pages, page_table, lengths,
                                                     v_dim=v_dim, scale=scale)
    return ref.naive_paged_latent_decode_attention(q, lat_pages, page_table, lengths,
                                                   v_dim=v_dim, scale=scale)
