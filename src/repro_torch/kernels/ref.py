"""Plain PyTorch versions of the kernels: deliberately naive (full
materialization, repeated KV heads, step-by-step recurrences), the ground
truth the CUDA kernels are held against and the path taken for tensors on
the CPU."""
from __future__ import annotations

import math

import torch


def _acc(x):
    """x in the type the plain versions compute in: float32, or float64 for
    float64 inputs (the gradient checks)."""
    return x if x.dtype == torch.float64 else x.float()


def _scores(q, k, causal, window):
    """Scaled scores [B,H,S,S] of q against k's heads repeated to H, with
    the causal mask (and the window) as -inf."""
    B, H, S, D = q.shape
    kr = k.repeat_interleave(H // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(kr)) / math.sqrt(D)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= (qpos - kpos) < window
        s = s.masked_fill(~mask, -math.inf)
    return s


def naive_attention(q, k, v, *, causal=True, window=None):
    """q: [B,H,S,D]; k,v: [B,K,S,D] with H % K == 0. Returns [B,H,S,D]."""
    G = q.shape[1] // k.shape[1]
    vr = v.repeat_interleave(G, dim=1)
    p = torch.softmax(_scores(q, k, causal, window), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, _acc(vr)).to(q.dtype)


def naive_attention_lse(q, k, *, window=None):
    """The logsumexp over the keys of each row's scaled, causally masked
    scores, the statistic the flash forward writes: [B,H,S] float32
    (float64 for float64 inputs)."""
    return torch.logsumexp(_scores(q, k, True, window), dim=-1)


def attention_bwd_delta(o, do):
    """The backward's row sums Dr = rowsum(dO o) [B,H,S] in float32 (the dQ
    kernel writes them for the dK/dV kernel)."""
    return (_acc(do) * _acc(o)).sum(-1)


def _bwd_p(q, k, lse, window):
    """P = exp(s - lse) [B,H,S,S], recomputed from q, k and the logsumexp."""
    return torch.exp(_scores(q, k, True, window) - _acc(lse)[..., None])


def attention_bwd_dkdv(q, k, v, lse, do, delta, *, window=None):
    """dK, dV of the causal attention (the dK/dV kernel's function): dV =
    P^T dO, dK = (P (dO V^T - Dr))^T Q / sqrt(D), each summed over its KV
    head's query heads. Returns (dk, dv) in k's and v's types."""
    B, H, S, D = q.shape
    K = k.shape[1]
    G = H // K
    p = _bwd_p(q, k, lse, window)
    vr = _acc(v.repeat_interleave(G, dim=1))
    dof = _acc(do)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - _acc(delta)[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _acc(q)) / math.sqrt(D)
    return (dk.view(B, K, G, S, D).sum(2).to(k.dtype),
            dv.view(B, K, G, S, D).sum(2).to(v.dtype))


def attention_bwd_dq(q, k, v, lse, do, delta, *, window=None):
    """dQ of the causal attention (the dQ kernel's function): dQ =
    (P (dO V^T - Dr)) K / sqrt(D), in q's type."""
    D = q.shape[-1]
    G = q.shape[1] // k.shape[1]
    kr, vr = (_acc(x.repeat_interleave(G, dim=1)) for x in (k, v))
    p = _bwd_p(q, k, lse, window)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", _acc(do), vr) - _acc(delta)[..., None])
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kr) / math.sqrt(D)).to(q.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, *, window=None):
    """The causal attention's gradient, as the backward kernels compute it
    from the forward's output ``o`` and logsumexp ``lse`` [B,H,S] and the
    output's gradient ``do`` (q, o, do: [B,H,S,D]; k, v: [B,K,S,D]):
    P = exp(s - lse), dV = P^T dO, dP = dO V^T, Dr = rowsum(dO o),
    dS = P (dP - Dr), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D); dK and dV
    summed over each KV head's query heads. Returns (dq, dk, dv) in the
    inputs' types."""
    delta = attention_bwd_delta(o, do)
    dk, dv = attention_bwd_dkdv(q, k, v, lse, do, delta, window=window)
    return attention_bwd_dq(q, k, v, lse, do, delta, window=window), dk, dv


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


def naive_ring_decode_attention(q, k, v, pos, *, window):
    """One-token attention over a ring-buffer window cache, a copy of the
    reference's ``layers.window_decode_attention``. q: [B,H,D]; k,v:
    [B,W,K,D] with position ``p`` in slot ``p % W``; ``pos`` is the index of
    the newest token. Attends to the slots whose position is >= 0 and
    within ``window`` of ``pos``."""
    B, H, D = q.shape
    W, K = k.shape[1], k.shape[2]
    slots = torch.arange(W, device=q.device)
    kpos = pos - torch.remainder(pos - slots, W)       # position held by each slot
    valid = (kpos >= 0) & (kpos >= pos + 1 - window)
    G = H // K
    kr = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vr = v.transpose(1, 2).repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kr.float()) / math.sqrt(D)
    s = s.masked_fill(~valid, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vr.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# gated linear attention: h_t = exp(lg_t) h_{t-1} + k_t v_t^T ; y_t = q_t . h_t
# q, k: [B,S,H,N]; v: [B,S,H,P]; lg: [B,S,H] log decays (<= 0). Sums float32.
# ---------------------------------------------------------------------------

def chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk rule: ``min(chunk, S)``, halved until it
    divides S."""
    c = min(chunk, S)
    while S % c:
        c //= 2
    return c


def naive_gla(q, k, v, lg):
    """The step-by-step recurrence (the reference's ``ref.naive_gla``).
    Returns (y [B,S,H,P] in v's dtype, final state [B,H,N,P] float32)."""
    B, S, H, N = q.shape
    h = torch.zeros((B, H, N, v.shape[-1]), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(lg[:, t].float())[..., None, None]
        h = h + torch.einsum("bhn,bhp->bhnp", k[:, t].float(), v[:, t].float())
        ys.append(torch.einsum("bhn,bhnp->bhp", q[:, t].float(), h))
    return torch.stack(ys, dim=1).to(v.dtype), h


def _by_chunk(q, k, v, lg, chunk):
    """float32 [B,nc,c,H,*] views of q, k, v and the within-chunk inclusive
    cumsum of lg [B,nc,c,H]."""
    B, S, H, N = q.shape
    c = chunk_len(S, chunk)
    nc = S // c
    cum = lg.float().reshape(B, nc, c, H).cumsum(2)
    return tuple(None if x is None else x.float().reshape(B, nc, c, H, x.shape[-1])
                 for x in (q, k, v)) + (cum,)


def _intra_and_delta(qf, kf, vf, cum):
    """The per-chunk math both schedules share (the reference's
    ``mlstm_chunk._intra_and_delta``), over every chunk at once. Returns
    (y_intra [B,nc,c,H,P], state delta [B,H,nc,N,P], total [B,nc,H])."""
    c = cum.shape[2]
    s = torch.einsum("bzihn,bzjhn->bzhij", qf, kf)
    ch = cum.transpose(2, 3)                                   # [B,nc,H,c]
    mask = torch.ones((c, c), dtype=torch.bool, device=cum.device).tril()
    w = torch.where(mask, torch.exp(ch[..., :, None] - ch[..., None, :]), 0.0)
    y = torch.einsum("bzhij,bzjhp->bzihp", s * w, vf)
    total = cum[:, :, -1]
    kdec = torch.exp(total[:, :, None] - cum)                  # [B,nc,c,H]
    d = torch.einsum("bzjhn,bzjhp->bhznp", kf * kdec[..., None], vf)
    return y, d, total


def chunked_gla(q, k, v, lg, chunk=256):
    """A copy of the reference's ``ssm.chunked_gla`` (the plain version of
    K4): the chunks in order, carrying the state. Returns (y [B,S,H,P] in
    q's dtype, final state [B,H,N,P] float32)."""
    B, S, H, _ = q.shape
    qf, kf, vf, cum = _by_chunk(q, k, v, lg, chunk)
    y_intra, d, total = _intra_and_delta(qf, kf, vf, cum)
    state = torch.zeros_like(d[:, :, 0])
    ys = []
    for z in range(cum.shape[1]):
        qdec = qf[:, z] * torch.exp(cum[:, z])[..., None]
        ys.append(y_intra[:, z] + torch.einsum("bihn,bhnp->bihp", qdec, state))
        state = state * torch.exp(total[:, z])[..., None, None] + d[:, :, z]
    return torch.stack(ys, dim=1).reshape(B, S, H, -1).to(q.dtype), state


def gla_phase_a(q, k, v, lg, *, chunk):
    """Phase A of the chunk-parallel schedule (the plain version of K5's
    first kernel): per chunk, the intra output, g = exp(total) and the
    state delta. Returns (y_intra [B,S,H,P] in v's dtype, g [B,H,nc],
    delta [B,H,nc,N,P]), both float32."""
    B, S, H, _ = q.shape
    y, d, total = _intra_and_delta(*_by_chunk(q, k, v, lg, chunk))
    return (y.reshape(B, S, H, -1).to(v.dtype), torch.exp(total).transpose(1, 2).contiguous(),
            d)


def gla_scan(g, d):
    """The scan between the phases, in chunk order: state_j = g_j *
    state_{j-1} + d_j. g: [B,H,nc]; d: [B,H,nc,N,P]. Returns (each chunk's
    start state [B,H,nc,N,P], zeros for chunk 0; the final state
    [B,H,N,P])."""
    start = torch.empty_like(d)
    state = torch.zeros_like(d[:, :, 0])
    for j in range(d.shape[2]):
        start[:, :, j] = state
        state = state * g[:, :, j, None, None] + d[:, :, j]
    return start, state


def gla_phase_b(q, lg, start, y_intra, *, chunk):
    """Phase B (the plain version of K5's second kernel): y = y_intra +
    (q exp(cum)) . start, per chunk. Returns y [B,S,H,P] in y_intra's
    dtype."""
    B, S, H, _ = q.shape
    qf, _, _, cum = _by_chunk(q, None, None, lg, chunk)
    inter = torch.einsum("bzihn,bhznp->bzihp", qf * torch.exp(cum)[..., None], start)
    y = y_intra.float().reshape(inter.shape) + inter
    return y.reshape(B, S, H, -1).to(y_intra.dtype)


def gla_chunk_parallel(q, k, v, lg, *, chunk):
    """The chunk-parallel schedule (plain version of K5): phase A, the scan,
    phase B. Returns (y [B,S,H,P] in v's dtype, final state)."""
    y_intra, g, d = gla_phase_a(q, k, v, lg, chunk=chunk)
    start, final = gla_scan(g, d)
    return gla_phase_b(q, lg, start, y_intra, chunk=chunk), final
