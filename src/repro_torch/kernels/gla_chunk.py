"""Chunked gated linear attention (GLA) as hand-written CUDA: both schedules.

The Hopper twins of the JAX package's Pallas kernels in
``kernels/mlstm_chunk.py``; the kernels and their design notes are in
``csrc/gla_chunk.cu``.

* :func:`gla_chunk` (K4, the twin of ``_kernel``): walks the chunks in
  order carrying the ``[N,P]`` state, and also writes the final state,
  which the model's prefill cache needs. In bf16 one block per (row, head,
  32-column slice of P) runs the intra-chunk products on the tensor cores;
  in float32 one block per (row, head) keeps exact scalar products. Its
  plain version is :func:`repro_torch.kernels.ref.chunked_gla`.
* :func:`gla_chunk_parallel` (K5, the twins of ``_phase_a_kernel`` and
  ``_phase_b_kernel``): :func:`gla_phase_a` and :func:`gla_phase_b` (in
  bf16 persistent blocks walking (row, head, chunk, slice) items; in
  float32 one block per (row, head, chunk)), with the scan over chunks
  between them in plain torch (:func:`scan_chunks`, chunk order). The plain versions of the phases and the scan are
  ``ref.gla_phase_a``, ``ref.gla_phase_b`` and ``ref.gla_scan``.
* :func:`gla_chunk_bwd` (K4b, the port's own kernel: the reference
  differentiates the plain-XLA ``ssm.chunked_gla``): dq, dk, dv and dlg of
  K4's function from the state entering each chunk, which K4 writes with
  ``starts=True``. In bf16 four launches, each deterministic (no
  atomics): the reversed state pass (the gradient of the state leaving
  each chunk: every chunk's increment at once, walked over the chunks by
  the first blocks of the next launch), dq and dk/dv (chunk-parallel tiles
  of 64 rows on wgmma fed by TMA, a group of heads a block) and the finish
  (the head groups' sums, dlg's suffix sums); in float32 one exact scalar
  kernel. With q and k given as
  the rows the heads share (``[B,S,N]``), dq and dk come back so, the
  heads' sum. Its plain versions are :func:`repro_torch.kernels.ref.gla_bwd`
  and, for the state pass, :func:`repro_torch.kernels.ref.gla_bwd_states`.
  :class:`GLAChunk` joins K4 and K4b for ``torch.autograd``; both schedules
  compute one function, and training takes the chunk schedule.

Layout: q, k ``[B,S,H,N]`` and v ``[B,S,H,P]`` with any strides whose last
dim is contiguous (the model's head-broadcast q and k are ``expand`` views
with head stride 0; nothing is copied), lg ``[B,S,H]`` log decays (<= 0,
cast to float32). :class:`GLAChunk` and :func:`gla_chunk_bwd` also take q
and k as ``[B,S,N]``, one row shared by every head. y comes back
``[B,S,H,P]`` contiguous in v's dtype; states are float32. The chunk
follows the JAX rule (:func:`chunk_len`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

#: launches of K4 since the count was last set to 0
launches = 0
#: launches of K5's phase A, likewise
launches_a = 0
#: launches of K5's phase B, likewise
launches_b = 0
#: launches of K4b's kernels, the backward, likewise: a bf16 call launches
#: :data:`BWD_LAUNCHES` (the state pass, dq, dk/dv, the finish), a float32
#: call one
bwd_launches = 0
#: the shared library whose C entries (``repro_gla_*``) the wrappers launch:
#: None for the one built from ``csrc/gla_chunk.cu``; the path of another
#: build of a source with the same entries (a diagnostic build of
#: ``tools/gla_breakdown.py``) runs that build on the same calls
library = None

#: the (N, P) pairs built: hymba-1.5b's SSD heads at full width and smoke size
SHAPES = ((16, 64), (8, 32))
MAX_SMEM = 232448        # a block's shared memory on sm_90, bytes
#: the kernels as ``repro_gla_smem_bytes`` numbers them
KERNELS = ("chunk", "phase_a", "phase_b", "bwd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
#: pointer arguments of each C entry (csrc/gla_chunk.cu)
_N_PTRS = {"repro_gla_chunk": 6, "repro_gla_chunk_starts": 7, "repro_gla_phase_a": 7,
           "repro_gla_phase_b": 5, "repro_gla_chunk_bwd": 18}
#: int arguments of each C entry after the pointers (B, S, H, N, P, c, and
#: the backward's heads a block)
_N_INTS = {"repro_gla_chunk_bwd": 7}
#: blocks of K4b's dq and dk/dv launches the head groups aim at: about four
#: an SM of an H100 (132 SMs), so that each fills the card more than twice
BWD_BLOCKS = 528
BWD_TILE = 64            # rows of K4b's dq and dk/dv tiles
BWD_LAUNCHES = 4         # kernels a bf16 call of K4b launches, each once
_SCRATCH = ("cl", "fwd", "bwd", "dstate", "rq", "rk", "dqp", "dkp")


@functools.cache
def _bind(entry, path=None):
    lib = build.load("gla_chunk") if path is None else ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    if entry == "repro_gla_smem_bytes":
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_longlong
        return fn
    fn.argtypes = ([_P] * _N_PTRS[entry] + [ctypes.c_int] * _N_INTS.get(entry, 6)
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, _P])
    fn.restype = ctypes.c_int
    return fn


def chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk rule: ``min(chunk, S)``, halved until it
    divides S."""
    c = min(chunk, S)
    while S % c:
        c //= 2
    return c


def scan_chunks(g, d):
    """K5's scan between the phases, in chunk order: state_j = g_j *
    state_{j-1} + d_j. g: [B,H,nc]; d: [B,H,nc,N,P] float32. Returns (each
    chunk's start state [B,H,nc,N,P], zeros for chunk 0; the final state
    [B,H,N,P])."""
    start = torch.empty_like(d)
    state = torch.zeros_like(d[:, :, 0])
    for j in range(d.shape[2]):
        start[:, :, j] = state
        state = state * g[:, :, j, None, None] + d[:, :, j]
    return start, state


def smem_bytes(c: int, N: int, P: int, kernel: str = "chunk",
               dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block of ``kernel`` (one of
    :data:`KERNELS`) at chunk ``c``, as the library computes it for its
    launch (csrc/gla_chunk.cu: float32 stages the chunk as float32, bf16
    two chunks' rows at a time)."""
    return _bind("repro_gla_smem_bytes", library)(KERNELS.index(kernel), c, N, P,
                                                  _DTYPES[dtype])


def _check(q, k, v, lg, chunk, what):
    """Device, dtype, shape and layout checks; returns the dims and the
    chunk length."""
    tensors = [t for t in (q, k, v, lg) if t is not None]
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"{what} kernel: all tensors must lie on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v) if t is not None):
        raise TypeError(f"{what} kernel: q/k/v dtypes must be all float32 or all "
                        f"bfloat16; got {[str(t.dtype) for t in (q, k, v) if t is not None]}")
    B, S, H, N = q.shape
    P = v.shape[-1] if v is not None else None
    if lg.shape != (B, S, H) or (k is not None and k.shape != q.shape) \
            or (v is not None and v.shape[:3] != (B, S, H)):
        raise ValueError(f"{what} kernel: shapes q{tuple(q.shape)} lg{tuple(lg.shape)}"
                         + "".join(f" {n}{tuple(t.shape)}" for n, t in (("k", k), ("v", v))
                                   if t is not None))
    if S < 1:
        raise ValueError(f"{what} kernel: no positions")
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"{what} kernel: {n}'s last dim must be contiguous")
    return B, S, H, N, P, chunk_len(S, chunk)


def _check_np(N, P, c, what, kernel, dtype):
    if (N, P) not in SHAPES:
        raise ValueError(f"{what} kernel: (N, P) = ({N}, {P}) not in {SHAPES}")
    need = smem_bytes(c, N, P, kernel, dtype)
    if need > MAX_SMEM:
        raise ValueError(f"{what} kernel: chunk {c} needs {need} bytes of shared memory")


def _rows_ok(t):
    """bf16: each [B,S,H,*] row starts on 16 bytes (the kernels copy rows
    16 bytes at a time); float32 rows may start anywhere."""
    return t.dtype != torch.bfloat16 or (t.data_ptr() % 16 == 0 and not any(
        st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def _check_rows(what, *ts):
    for t in ts:
        if not _rows_ok(t):
            raise ValueError(f"{what} kernel: bf16 rows must start on 16 bytes; got data "
                             f"pointer % 16 = {t.data_ptr() % 16}, strides {t.stride()}")


def _strides(*ts):
    """(batch, position, head) element strides of each [B,S,H,...] tensor."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _call(entry, ptrs, dims, strides, dtype, device):
    fn = _bind(entry, library)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, *dims, strides, _DTYPES[dtype], stream)
    build.check(rc, entry)


def gla_chunk(q, k, v, lg, *, chunk, starts=False):
    """K4. q,k: [B,S,H,N]; v: [B,S,H,P]; lg: [B,S,H]. Returns (y
    [B,S,H,P] in v's dtype, final state [B,H,N,P] float32); with
    ``starts`` also the state entering each chunk [B,H,nc,N,P] float32
    (zeros for chunk 0), which :func:`gla_chunk_bwd` reads (y and the final
    state are the same bits either way)."""
    global launches
    B, S, H, N, P, c = _check(q, k, v, lg, chunk, "gla_chunk")
    _check_np(N, P, c, "gla_chunk", "chunk", q.dtype)
    _check_rows("gla_chunk", q, k, v)
    lgf = lg.float()
    y = torch.empty((B, S, H, P), dtype=v.dtype, device=q.device)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), lgf.data_ptr(), y.data_ptr(),
            state.data_ptr()]
    entry = "repro_gla_chunk"
    if starts:
        st = torch.empty((B, H, S // c, N, P), dtype=torch.float32, device=q.device)
        ptrs.append(st.data_ptr())
        entry = "repro_gla_chunk_starts"
    _call(entry, ptrs, (B, S, H, N, P, c), _strides(q, k, v, lgf), q.dtype, q.device)
    launches += 1
    return (y, state, st) if starts else (y, state)


def head_group(B: int, S: int, H: int, c: int) -> int:
    """Heads a block of K4b's dq and dk/dv launches walks, in order, when q
    and k are rows the heads share: equal groups, the fewest that give each
    launch :data:`BWD_BLOCKS` blocks (one a 64-row tile of a chunk a group),
    so that their partial sums stay few. hymba's training shape: 5 heads a
    block, 480 blocks (groups sized by the tile's weight, and groups of 1-3
    or 8, were slower on an H100: PERF.md)."""
    blocks = B * (S // c) * -(-c // BWD_TILE)
    ng = min(H, max(1, -(-BWD_BLOCKS // blocks)))
    return -(-H // ng)


def _bwd(q, k, v, lg, dy, starts, *, chunk):
    """K4b's launches, counted in :data:`bwd_launches`; returns (dq, dk,
    dv, dlg, the bf16 launches' scratch by name (:data:`_SCRATCH`: each
    chunk's cum log2(e) and its 64-row tiles' decays, the dS states, each
    head's q.dq and k.dk rows, the head groups' dq and dk); empty in
    float32). :func:`gla_chunk_bwd` is the public call; the scratch lets
    tests and ``chip_smoke.py`` hold each launch to its plain part."""
    global bwd_launches
    shared = q.dim() == 3
    if shared != (k.dim() == 3):
        raise ValueError("gla_chunk_bwd kernel: q and k must both be [B,S,N] shared rows or "
                         f"both [B,S,H,N]; got {tuple(q.shape)} and {tuple(k.shape)}")
    H = v.shape[2] if v.dim() == 4 else 0
    qe, ke = ref.expand_heads(q, H), ref.expand_heads(k, H)
    B, S, H, N, P, c = _check(qe, ke, v, lg, chunk, "gla_chunk_bwd")
    _check_np(N, P, c, "gla_chunk_bwd", "bwd", q.dtype)
    if dy.shape != v.shape or dy.dtype != v.dtype or dy.device != q.device \
            or dy.stride(-1) != 1:
        raise ValueError(f"gla_chunk_bwd kernel: dy {tuple(dy.shape)} {dy.dtype} needs "
                         f"v's shape and dtype {tuple(v.shape)} {v.dtype}, rows contiguous")
    nc = S // c
    if starts.shape != (B, H, nc, N, P) or starts.dtype != torch.float32 \
            or not starts.is_contiguous() or starts.device != q.device \
            or starts.data_ptr() % 16:
        raise ValueError(f"gla_chunk_bwd kernel: starts {tuple(starts.shape)} "
                         f"{starts.dtype}; needs ({B}, {H}, {nc}, {N}, {P}) float32, "
                         "contiguous, on 16 bytes")
    _check_rows("gla_chunk_bwd", qe, ke, v, dy)
    lgf = lg.float()
    dev, f32 = q.device, torch.float32
    dv = torch.empty((B, S, H, P), dtype=v.dtype, device=dev)
    dlg = torch.empty((B, S, H), dtype=f32, device=dev)
    scratch, hg = {}, 0
    if q.dtype == torch.bfloat16:
        hg = head_group(B, S, H, c) if shared else 0
        ng = -(-H // hg) if shared else H
        rows = {n: (B, H, S) for n in ("cl", "fwd", "bwd", "rq", "rk")}
        rows.update(dstate=(B, H, nc, N, P), dqp=(ng, B, S, N), dkp=(ng, B, S, N))
        scratch = {n: torch.empty(rows[n], dtype=f32, device=dev) for n in _SCRATCH}
        dq = torch.empty((B, S, N) if shared else (B, S, H, N), dtype=q.dtype, device=dev)
    else:
        dq = torch.empty((B, S, H, N), dtype=f32, device=dev)
    dk = torch.empty_like(dq)
    work = [scratch[n].data_ptr() if scratch else None for n in _SCRATCH]
    _call("repro_gla_chunk_bwd",
          [x.data_ptr() for x in (qe, ke, v, lgf, dy, starts, dq, dk, dv, dlg)] + work,
          (B, S, H, N, P, c, hg), _strides(qe, ke, v, lgf, dy), q.dtype, q.device)
    bwd_launches += BWD_LAUNCHES if scratch else 1
    if shared and not scratch:   # float32: each head's rows, summed in head order
        dq, dk = (functools.reduce(torch.add, x.unbind(2)) for x in (dq, dk))
    return dq, dk, dv, dlg, scratch


def gla_chunk_bwd(q, k, v, lg, dy, starts, *, chunk):
    """K4b: the gradient of :func:`gla_chunk`'s y at (q, k, v, lg) given
    ``dy`` [B,S,H,P] (v's dtype, any strides whose rows are contiguous) and
    K4's ``starts`` [B,H,nc,N,P] float32. q and k: [B,S,H,N] (any strides,
    head stride 0 included), or [B,S,N], one row shared by every head.
    Returns (dq, dk in q's dtype: [B,S,N] for shared rows, the sum over the
    heads; else per head [B,S,H,N] (float32 in float32); dv [B,S,H,P] in
    v's dtype; dlg [B,S,H] float32), all contiguous. Deterministic: equal
    inputs give equal bits."""
    return _bwd(q, k, v, lg, dy, starts, chunk=chunk)[:4]


class GLAChunk(torch.autograd.Function):
    """:func:`gla_chunk` with its gradient from :func:`gla_chunk_bwd`: the
    forward runs K4 with the chunk start states and saves them with q, k, v
    and lg; the backward runs K4b. q and k may be [B,S,N] rows shared by
    every head (the SSD mixer's C_t and B_t): K4 reads them as head-stride-0
    views, and K4b returns their gradients as such rows, the heads' sum, in
    their dtype (no per-head copy, no cast or sum pass after it). The final
    state takes no gradient (training discards it; it is marked
    non-differentiable), and neither does ``chunk``; dlg comes back in lg's
    dtype."""

    @staticmethod
    def forward(ctx, q, k, v, lg, chunk):
        H = v.shape[2]
        y, state, starts = gla_chunk(ref.expand_heads(q, H), ref.expand_heads(k, H), v, lg,
                                     chunk=chunk, starts=True)
        ctx.save_for_backward(q, k, v, lg, starts)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(state)
        ctx.set_materialize_grads(False)  # no zeros filled for the state's gradient
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        if dy is None:  # y took no gradient
            return None, None, None, None, None
        q, k, v, lg, starts = ctx.saved_tensors
        if dy.stride(-1) != 1 or not _rows_ok(dy):
            dy = dy.contiguous()
        dq, dk, dv, dlg = gla_chunk_bwd(q, k, v, lg, dy, starts, chunk=ctx.chunk)
        return dq.to(q.dtype), dk.to(k.dtype), dv, dlg.to(lg.dtype), None


def gla_phase_a(q, k, v, lg, *, chunk):
    """K5 phase A. Returns (y_intra [B,S,H,P] in v's dtype, g = exp(total)
    [B,H,nc] float32, state delta [B,H,nc,N,P] float32), per chunk."""
    global launches_a
    B, S, H, N, P, c = _check(q, k, v, lg, chunk, "gla_phase_a")
    _check_np(N, P, c, "gla_phase_a", "phase_a", q.dtype)
    _check_rows("gla_phase_a", q, k, v)
    nc = S // c
    lgf = lg.float()
    y = torch.empty((B, S, H, P), dtype=v.dtype, device=q.device)
    g = torch.empty((B, H, nc), dtype=torch.float32, device=q.device)
    d = torch.empty((B, H, nc, N, P), dtype=torch.float32, device=q.device)
    _call("repro_gla_phase_a",
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), lgf.data_ptr(), y.data_ptr(),
           g.data_ptr(), d.data_ptr()),
          (B, S, H, N, P, c), _strides(q, k, v, lgf), q.dtype, q.device)
    launches_a += 1
    return y, g, d


def gla_phase_b(q, lg, start, y_intra, *, chunk):
    """K5 phase B: y = y_intra + (q exp(cum)) . start per chunk. start:
    [B,H,nc,N,P] float32, each chunk's start state; y_intra: [B,S,H,P] in
    q's dtype. Returns y [B,S,H,P]."""
    global launches_b
    B, S, H, N, _, c = _check(q, None, None, lg, chunk, "gla_phase_b")
    P = y_intra.shape[-1]
    _check_np(N, P, c, "gla_phase_b", "phase_b", q.dtype)
    _check_rows("gla_phase_b", q, y_intra)
    nc = S // c
    if start.shape != (B, H, nc, N, P) or start.dtype != torch.float32 \
            or not start.is_contiguous() or start.device != q.device:
        raise ValueError(f"gla_phase_b kernel: start {tuple(start.shape)} "
                         f"{start.dtype}; needs ({B}, {H}, {nc}, {N}, {P}) float32, "
                         "contiguous")
    if q.dtype == torch.bfloat16 and start.data_ptr() % 16:
        raise ValueError("gla_phase_b kernel: bf16 start must start on 16 bytes (copied 16 "
                         f"bytes at a time); got data pointer % 16 = {start.data_ptr() % 16}")
    if y_intra.shape != (B, S, H, P) or y_intra.dtype != q.dtype \
            or not y_intra.is_contiguous() or y_intra.device != q.device:
        raise ValueError(f"gla_phase_b kernel: y_intra {tuple(y_intra.shape)} "
                         f"{y_intra.dtype}; needs ({B}, {S}, {H}, {P}) {q.dtype}, contiguous")
    lgf = lg.float()
    y = torch.empty_like(y_intra)
    # the entry reads only q's and lg's strides; k's and v's slots repeat q's
    _call("repro_gla_phase_b",
          (q.data_ptr(), lgf.data_ptr(), start.data_ptr(), y_intra.data_ptr(),
           y.data_ptr()),
          (B, S, H, N, P, c), _strides(q, q, q, lgf), q.dtype, q.device)
    launches_b += 1
    return y


def gla_chunk_parallel(q, k, v, lg, *, chunk):
    """K5: phase A, the plain scan over chunks in order, phase B. Returns
    (y [B,S,H,P] in v's dtype, final state [B,H,N,P] float32)."""
    y_intra, g, d = gla_phase_a(q, k, v, lg, chunk=chunk)
    start, final = scan_chunks(g, d)
    return gla_phase_b(q, lg, start, y_intra, chunk=chunk), final
