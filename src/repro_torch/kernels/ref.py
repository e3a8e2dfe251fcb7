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
    """q: [B,H,S,D]; k: [B,K,S,D], v: [B,K,S,Dv] with H % K == 0 (Dv may
    differ from D, MLA's 64 beside 96; the scale is 1/sqrt(D)). Returns
    [B,H,S,Dv]."""
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
    head's query heads (dV at v's width Dv, dO [B,H,S,Dv]). Returns (dk, dv)
    in k's and v's types."""
    B, H, S, D = q.shape
    K, Dv = k.shape[1], v.shape[-1]
    G = H // K
    p = _bwd_p(q, k, lse, window)
    vr = _acc(v.repeat_interleave(G, dim=1))
    dof = _acc(do)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - _acc(delta)[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _acc(q)) / math.sqrt(D)
    return (dk.view(B, K, G, S, D).sum(2).to(k.dtype),
            dv.view(B, K, G, S, Dv).sum(2).to(v.dtype))


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
    output's gradient ``do`` (q: [B,H,S,D]; o, do: [B,H,S,Dv]; k: [B,K,S,D];
    v: [B,K,S,Dv]):
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


def naive_latent_decode_attention(q, lat, length, *, v_dim, scale):
    """MLA's absorbed decode: every query head attends to one latent row a
    position, which is both its key and (its first ``v_dim`` columns) its
    value. q: [B,H,Dk]; lat: [B,S,Dk]; attend to positions < length with
    the scores scaled by ``scale``. Returns [B,H,v_dim] in q's type."""
    s = torch.einsum("bhd,bsd->bhs", _acc(q), _acc(lat)) * scale
    valid = torch.arange(lat.shape[1], device=q.device) < length
    p = torch.softmax(s.masked_fill(~valid, -math.inf), dim=-1)
    return torch.einsum("bhs,bsv->bhv", p, _acc(lat[..., :v_dim])).to(q.dtype)


def naive_paged_latent_decode_attention(q, lat_pages, page_table, lengths, *, v_dim,
                                        scale):
    """:func:`naive_latent_decode_attention` through a page table. q:
    [B,H,Dk]; lat_pages: [P, page, Dk] (any strides); page_table: [B, n]
    int; lengths: [B] int. Each row's pages are gathered into a contiguous
    cache; a length of 0 gives zeros, as the kernel does. Tensor ops only
    (no host sync)."""
    B, n = page_table.shape
    _, page, Dk = lat_pages.shape
    out = []
    for b in range(B):
        lat = lat_pages[page_table[b].long()].reshape(1, n * page, Dk)
        o = naive_latent_decode_attention(q[b : b + 1], lat, lengths[b], v_dim=v_dim,
                                          scale=scale)
        out.append(torch.where(lengths[b] > 0, o, torch.zeros_like(o)))
    return torch.cat(out)


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
    """float32 (float64 for float64 inputs) [B,nc,c,H,*] views of q, k, v
    and the within-chunk inclusive cumsum of lg [B,nc,c,H]."""
    B, S, H, N = q.shape
    c = chunk_len(S, chunk)
    nc = S // c
    cum = _acc(lg).reshape(B, nc, c, H).cumsum(2)
    return tuple(None if x is None else _acc(x).reshape(B, nc, c, H, x.shape[-1])
                 for x in (q, k, v)) + (cum,)


def _intra_and_delta(qf, kf, vf, cum):
    """The per-chunk math both schedules share (the reference's
    ``mlstm_chunk._intra_and_delta``), over every chunk at once. Returns
    (y_intra [B,nc,c,H,P], state delta [B,H,nc,N,P], total [B,nc,H])."""
    c = cum.shape[2]
    s = torch.einsum("bzihn,bzjhn->bzhij", qf, kf)
    ch = cum.transpose(2, 3)                                   # [B,nc,H,c]
    mask = torch.ones((c, c), dtype=torch.bool, device=cum.device).tril()
    # the exponent is masked before the exp as well as after: above the
    # diagonal cum_i - cum_j > 0 can overflow to inf, and the gradient
    # through a where of inf is 0 * inf = nan (the reference's
    # ``chunked_gla`` masks only after, so its lg gradient is nan once a
    # chunk's decays pass exp's range); the values are the same bits
    dec = torch.where(mask, ch[..., :, None] - ch[..., None, :], 0.0)
    w = torch.where(mask, torch.exp(dec), 0.0)
    y = torch.einsum("bzhij,bzjhp->bzihp", s * w, vf)
    total = cum[:, :, -1]
    kdec = torch.exp(total[:, :, None] - cum)                  # [B,nc,c,H]
    d = torch.einsum("bzjhn,bzjhp->bhznp", kf * kdec[..., None], vf)
    return y, d, total


def chunked_gla(q, k, v, lg, chunk=256, *, starts=False):
    """A copy of the reference's ``ssm.chunked_gla`` (the plain version of
    K4): the chunks in order, carrying the state. Returns (y [B,S,H,P] in
    q's dtype, final state [B,H,N,P] float32); with ``starts`` also the
    state entering each chunk [B,H,nc,N,P] (zeros for chunk 0), K4's
    output for training (the plain version of ``gla_chunk(...,
    starts=True)``). Differentiable by autograd: the plain route's
    training path."""
    B, S, H, _ = q.shape
    qf, kf, vf, cum = _by_chunk(q, k, v, lg, chunk)
    y_intra, d, total = _intra_and_delta(qf, kf, vf, cum)
    state = torch.zeros_like(d[:, :, 0])
    ys, entering = [], []
    for z in range(cum.shape[1]):
        entering.append(state)
        qdec = qf[:, z] * torch.exp(cum[:, z])[..., None]
        ys.append(y_intra[:, z] + torch.einsum("bihn,bhnp->bihp", qdec, state))
        state = state * torch.exp(total[:, z])[..., None, None] + d[:, :, z]
    y = torch.stack(ys, dim=1).reshape(B, S, H, -1).to(q.dtype)
    return (y, state, torch.stack(entering, dim=2)) if starts else (y, state)


def expand_heads(x, H):
    """A [B,S,N] row shared by the heads as a [B,S,H,N] view (head stride
    0); a [B,S,H,N] tensor as it is."""
    return x[:, :, None].expand(x.shape[0], x.shape[1], H, x.shape[-1]) if x.dim() == 3 else x


def gla_bwd_states(q, lg, dy, *, chunk, dfinal=None):
    """The reversed state pass of the GLA backward (the plain version of
    its first launch): dS_z, the gradient of the state leaving chunk z, for
    every z, from the last: dS_{nc-1} = ``dfinal`` (zeros if None) and
    dS_{z-1} = exp(tot_z) dS_z + sum_{i in z} exp(cum_i) q_i dy_i^T, with
    cum the chunk's inclusive cumsum of lg and tot its last value. q
    [B,S,H,N] or [B,S,N] (shared by the heads), dy [B,S,H,P], lg [B,S,H].
    Returns [B,H,nc,N,P] float32 (float64 for float64 inputs)."""
    B, S, H, P = dy.shape
    qf, _, _, cum = _by_chunk(expand_heads(q, H), None, None, lg, chunk)
    nc, c, N = cum.shape[1], cum.shape[2], qf.shape[-1]
    dyf = _acc(dy).reshape(B, nc, c, H, P)
    dS = (torch.zeros((B, H, N, P), dtype=qf.dtype, device=qf.device) if dfinal is None
          else dfinal.to(qf.dtype))
    out = torch.empty((B, H, nc, N, P), dtype=qf.dtype, device=qf.device)
    for z in reversed(range(nc)):
        out[:, :, z] = dS
        ch = cum[:, z].transpose(1, 2)                               # [B,H,c]
        dS = dS * torch.exp(ch[..., -1])[..., None, None] + torch.einsum(
            "bhi,bihn,bihp->bhnp", torch.exp(ch), qf[:, z], dyf[:, z])
    return out


def gla_bwd(q, k, v, lg, dy, starts, *, chunk, dfinal=None):
    """The gradient of :func:`chunked_gla` (the plain version of the GLA
    backward kernel), as the kernel computes it: with dS_z the gradient of
    the state leaving chunk z (:func:`gla_bwd_states`; ``dfinal``
    [B,H,N,P] for the last, else zeros) and, within chunk z, cum the
    inclusive cumsum of lg, tot its last value, S_z = ``starts[:, :, z]``
    the state entering it and W_ij = exp(cum_i - cum_j) for j <= i:

        dq_i = sum_{j<=i} W_ij (dy_i . v_j) k_j + exp(cum_i) S_z dy_i
        dk_j = sum_{i>=j} W_ij (dy_i . v_j) q_i + exp(tot - cum_j) dS_z v_j
        dv_j = sum_{i>=j} W_ij (q_i . k_j) dy_i + exp(tot - cum_j) dS_z^T k_j

    and dlg by the scalar-decay identity dlg_t = sum_{s>=t} (q_s . dq_s -
    k_s . dk_s) per head, plus <final, dfinal> at every position (the
    final state's decay runs through every lg). q, k [B,S,H,N] (any
    strides; head-stride-0 views take per-head gradients) or [B,S,N], one
    row shared by every head (their gradients are then the sum over the
    heads, [B,S,N]); v, dy [B,S,H,P], lg [B,S,H], starts [B,H,nc,N,P].
    Returns (dq, dk and dlg float32 (float64 for float64 inputs); dv in
    v's dtype)."""
    B, S, H, P = v.shape
    shared = q.dim() == 3
    q, k = expand_heads(q, H), expand_heads(k, H)
    N = q.shape[-1]
    qf, kf, vf, cum = _by_chunk(q, k, v, lg, chunk)
    nc, c = cum.shape[1], cum.shape[2]
    dyf = _acc(dy).reshape(B, nc, c, H, P)
    st = starts.to(qf.dtype)
    dst = gla_bwd_states(q, lg, dy, chunk=chunk, dfinal=dfinal)
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    for z in reversed(range(nc)):
        qc, kc, vc, dyc = qf[:, z], kf[:, z], vf[:, z], dyf[:, z]     # [B,c,H,*]
        ch = cum[:, z].transpose(1, 2)                               # [B,H,c]
        tot = ch[..., -1]                                            # [B,H]
        dS = dst[:, :, z]
        w = torch.where(mask, torch.exp(torch.where(mask, ch[..., :, None] - ch[..., None, :],
                                                    0.0)), 0.0)
        m = w * torch.einsum("bihp,bjhp->bhij", dyc, vc)
        m2 = w * torch.einsum("bihn,bjhn->bhij", qc, kc)
        eq, ek = torch.exp(ch), torch.exp(tot[..., None] - ch)       # [B,H,c]
        dq[:, z] = (torch.einsum("bhij,bjhn->bihn", m, kc)
                    + torch.einsum("bhi,bihp,bhnp->bihn", eq, dyc, st[:, :, z]))
        dk[:, z] = (torch.einsum("bhij,bihn->bjhn", m, qc)
                    + torch.einsum("bhj,bjhp,bhnp->bjhn", ek, vc, dS))
        dv[:, z] = (torch.einsum("bhij,bihp->bjhp", m2, dyc)
                    + torch.einsum("bhj,bjhn,bhnp->bjhp", ek, kc, dS))
    dq, dk = dq.reshape(B, S, H, N), dk.reshape(B, S, H, N)
    r = (qf.reshape(B, S, H, N) * dq).sum(-1) - (kf.reshape(B, S, H, N) * dk).sum(-1)
    dlg = r.flip(1).cumsum(1).flip(1)
    if dfinal is not None:
        # the final state, from the last chunk's entering one
        ch = cum[:, -1].transpose(1, 2)
        delta = torch.einsum("bhj,bjhn,bjhp->bhnp", torch.exp(ch[..., -1:] - ch),
                             kf[:, -1], vf[:, -1])
        final = st[:, :, -1] * torch.exp(ch[..., -1])[..., None, None] + delta
        dlg = dlg + (final * dfinal.to(qf.dtype)).sum((-2, -1))[:, None]
    if shared:
        dq, dk = dq.sum(2), dk.sum(2)
    return dq, dk, dv.reshape(B, S, H, P).to(v.dtype), dlg


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


# ---------------------------------------------------------------------------
# the sLSTM recurrence (xLSTM's scalar-memory block): stabilized exp gating
# over gates head-major [H,4,dh] (i, f, z, o); the state (c, n, m, h)
# [B,H,dh] float32
# ---------------------------------------------------------------------------

def slstm_state0(B: int, H: int, dh: int, device):
    """The prefill's start state, the reference's ``state0``: c = 0, n =
    1e-6, m = -1e30, h = 0, each [B,H,dh] float32."""
    z = torch.zeros((B, H, dh), dtype=torch.float32, device=device)
    return z, z + 1e-6, torch.full_like(z, -1e30), z.clone()


def slstm_cell(gates, state, H, dh):
    """One step of the cell (the reference's ``xlstm._slstm_cell``). gates:
    [B,4d] head-major [H,4,dh]; state (c, n, m, h). Returns the new state,
    computed in float32 (float64 for float64 gates)."""
    B = gates.shape[0]
    g = _acc(gates.reshape(B, H, 4, dh))
    i_raw, f_raw, z_raw, o_raw = g.unbind(2)
    c, n, m, _ = state
    lf = torch.nn.functional.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m, i_raw)
    fs = torch.exp(lf + m - m_new)
    is_ = torch.exp(i_raw - m_new)
    c_new = fs * c + is_ * torch.tanh(z_raw)
    n_new = fs * n + is_
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, m_new, h_new


def slstm_scan(wx, r, state, *, states=False):
    """The plain version of the sLSTM scan kernel, the reference's
    ``run_scan`` body position by position with its rounding: h_{t-1} cast
    to wx's dtype, the product ``rh`` in that dtype, ``wx + rh`` added in
    it, the cell in float32. wx: [B,S,4d] (head-major [H,4,dh]); r:
    [H,dh,4dh]; state (c, n, m, h) [B,H,dh]. Returns (hs [B,S,H,dh] in wx's
    dtype, the final state); with ``states`` also what the backward reads,
    ``(gates [B,S,4d] in wx's dtype, c, n, m [B,S,H,dh])``: each position's
    gates as the cell took them and its state after it (float32, float64
    for float64 inputs)."""
    B, S, _ = wx.shape
    H, dh = r.shape[:2]
    hs, saved = [], []
    for t in range(S):
        rh = torch.einsum("bhj,hjg->bhg", state[3].to(wx.dtype), r).reshape(B, 4 * H * dh)
        gates = wx[:, t] + rh
        state = slstm_cell(gates, state, H, dh)
        hs.append(state[3])
        if states:
            saved.append((gates, *state[:3]))
    out = torch.stack(hs, dim=1).to(wx.dtype), state
    if not states:
        return out
    return (*out, tuple(torch.stack(x, dim=1) for x in zip(*saved)))


def slstm_dr(h0, hs, dwx):
    """The recurrent weights' gradient, one product after the scan: dR_h =
    sum over rows and positions of h_{t-1}^T dgates_t, h_{-1} the start
    state's h, each h as the product took it (in hs's dtype). h0: [B,H,dh];
    hs: [B,S,H,dh]; dwx: [B,S,4d] head-major. Returns [H,dh,4dh] in hs's
    dtype."""
    B, S, H, dh = hs.shape
    prev = torch.cat([h0.to(hs.dtype)[:, None], hs[:, :-1]], dim=1)
    return torch.einsum("bshj,bshg->hjg", prev, dwx.reshape(B, S, H, 4 * dh))


def slstm_scan_bwd(r, state, hs, saved, dhs, *, dstate=False):
    """The plain version of the sLSTM scan's backward kernel: the analytic
    reverse recurrence, not autograd. ``state`` is the scan's start state,
    ``hs`` its output and ``saved`` what :func:`slstm_scan` returned with
    ``states=True``; dhs: [B,S,H,dh], the gradient of hs. Returns (dwx
    [B,S,4d] in the gates' dtype, dR [H,dh,4dh] in r's dtype, and with
    ``dstate`` the start state's gradient (dc, dn, dm, dh), else None).

    The stabilizer m takes no gradient: c and n are the unstabilized values
    times e^{-m_t}, so h = o c / max(n, 1e-6) does not depend on the m
    trajectory (n >= 1 from the first step on, as m_t is i_t, then is = 1,
    or lf + m_{t-1}, then fs = 1), and holding m constant gives the exact
    gradient. Carried per (row, head, unit): dc, dn, and dh = dhs_t +
    (dgates_{t+1} as T) @ R_h^T, rounded to T as the reference's product
    is. Per step, with fs, is, z = tanh(z_raw), o = sigmoid(o_raw):
    d o_raw = dh (c/n) o(1-o); dc += dh o/n; dn -= dh o c/n^2; d z_raw = dc
    is (1-z^2); d i_raw = (dc z + dn) is; d f_raw = (dc c_{t-1} + dn
    n_{t-1}) fs sigmoid(-f_raw); then dc fs and dn fs carry to t-1. The
    start state's dm = dc c_0 + dn n_0 (it scales the unstabilized c and
    n). dR is one product after the scan (:func:`slstm_dr`)."""
    gates, cs, ns, ms = saved
    B, S, _ = gates.shape
    H, dh = r.shape[:2]
    T = gates.dtype
    g = _acc(gates).reshape(B, S, H, 4, dh)
    f = g.dtype
    c0, n0, m0, h0 = (_acc(x) for x in state)
    dc = torch.zeros((B, H, dh), dtype=f, device=gates.device)
    dn = torch.zeros_like(dc)
    dh_rec = torch.zeros_like(dc)
    dwx = torch.empty((B, S, H, 4, dh), dtype=T, device=gates.device)
    for t in reversed(range(S)):
        i_raw, f_raw, z_raw, o_raw = g[:, t].unbind(2)
        c, n, m = cs[:, t], ns[:, t], ms[:, t]
        cp, np_, mp = (cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t else (c0, n0, m0)
        fs = torch.exp(torch.nn.functional.logsigmoid(f_raw) + mp - m)
        is_ = torch.exp(i_raw - m)
        z, o = torch.tanh(z_raw), torch.sigmoid(o_raw)
        d_h = _acc(dhs[:, t]) + dh_rec
        nn = torch.clamp_min(n, 1e-6)
        do = d_h * (c / nn) * o * (1 - o)
        dc = dc + d_h * o / nn
        dn = dn - torch.where(n > 1e-6, d_h * o * c / nn ** 2, 0)
        dz = dc * is_ * (1 - z * z)
        di = (dc * z + dn) * is_
        df = (dc * cp + dn * np_) * fs * torch.sigmoid(-f_raw)
        dg = torch.stack([di, df, dz, do], dim=2).to(T)        # [B,H,4,dh]
        dwx[:, t] = dg
        dh_rec = _acc(torch.einsum("bhg,hjg->bhj", dg.reshape(B, H, 4 * dh), r))
        dc, dn = dc * fs, dn * fs
    dwx = dwx.reshape(B, S, 4 * H * dh)
    dr = slstm_dr(state[3], hs, dwx).to(r.dtype)
    if not dstate:
        return dwx, dr, None
    return dwx, dr, (dc, dn, dc * c0 + dn * n0, dh_rec)
