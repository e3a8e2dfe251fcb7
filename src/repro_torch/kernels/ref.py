"""Plain PyTorch versions of the attention kernels: deliberately naive (full
materialization, repeated KV heads), the ground truth the CUDA kernels are
held against and the path taken for tensors on the CPU."""
from __future__ import annotations

import math

import torch


def naive_attention(q, k, v, *, causal=True, window=None):
    """q: [B,H,S,D]; k,v: [B,K,S,D] with H % K == 0. Returns [B,H,S,D]."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kr = k.repeat_interleave(G, dim=1)
    vr = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) / math.sqrt(D)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= (qpos - kpos) < window
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.float()).to(q.dtype)


def naive_decode_attention(q, k, v, length, *, window=None):
    """q: [B,H,D]; k,v: [B,K,S,D]; attend to positions < length."""
    B, H, D = q.shape
    G = H // k.shape[1]
    kr = k.repeat_interleave(G, dim=1)
    vr = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kr.float()) / math.sqrt(D)
    kpos = torch.arange(k.shape[2], device=q.device)
    valid = kpos < length
    if window is not None:
        valid &= kpos >= length - window
    s = s.masked_fill(~valid, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vr.float()).to(q.dtype)


def naive_paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                                 window=None):
    """q: [B,H,D]; k_pages, v_pages: [P, page, K, D] (any strides); page_table:
    [B, n] int; lengths: [B] int. Each row's pages are gathered into a
    contiguous cache and attended to below that row's length, as
    :func:`naive_decode_attention` does; a length of 0 gives zeros, as the
    kernels do. Tensor ops only (no host sync), so it can run in a CUDA graph."""
    B, n = page_table.shape
    _, page, K, D = k_pages.shape
    out = []
    for b in range(B):
        rows = page_table[b].long()
        kc = k_pages[rows].reshape(1, n * page, K, D).transpose(1, 2)   # [1,K,S,D]
        vc = v_pages[rows].reshape(1, n * page, K, D).transpose(1, 2)
        length = lengths[b]
        o = naive_decode_attention(q[b : b + 1], kc, vc, length, window=window)
        out.append(torch.where(length > 0, o, torch.zeros_like(o)))
    return torch.cat(out)
