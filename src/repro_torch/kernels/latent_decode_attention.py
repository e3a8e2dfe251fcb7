"""MLA's absorbed decode (one query token per row, every query head over one
latent head) as a hand-written CUDA kernel.

The Hopper twin of the JAX package's Pallas ``decode_attention._kernel`` at
the shape MLA's decode gives it (``models/layers.py`` ``mla_apply``: K = 1,
G = the model's 40 heads, the latent row of r + rope = 288 columns as the
key and its first r = 256 as the value), and of ``_paged_kernel`` through
the fleet's page table. The kernel and its design notes are in
``csrc/latent_decode_attention.cu``; its plain versions are
:func:`repro_torch.kernels.ref.naive_latent_decode_attention` and
:func:`~repro_torch.kernels.ref.naive_paged_latent_decode_attention`.

Layout: q ``[B,H,Dk]`` contiguous; the latent cache ``[B,S,Dk]``
contiguous (the decode cache as it lies), or pages ``[P, page, Dk]`` with
any strides whose rows are contiguous and start on 16 bytes (a layer's
strided view of the fleet's stacked store); the output ``[B,H,Dv]``. A
block takes ``SPAN`` positions of a row, whatever B, the length or the
addressing, and writes an unnormalised partial; the last block of the row
to finish (a ticket from :func:`decode_attention.counters`, shared with the
split-KV decode) combines them in block order. So the paged form over
in-order pages gives the contiguous form's bits, and a B = 1 lane a batched
row's.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import counters

#: launches of the kernel over a contiguous cache since the count was last
#: set to 0
launches = 0
#: launches of the kernel through a page table, likewise
paged_launches = 0

DK, DV = 288, 256    # the built shape: minicpm3-4b's r + rope and r
MAX_H = 48           # query heads a launch takes (three m16 tiles)
SPAN = 64            # positions a block takes (``SPAN`` in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_longlong


@functools.cache
def _bind(entry):
    fn = getattr(build.load("latent_decode_attention"), entry)
    if entry.startswith("repro_paged"):
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [_I64] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def n_blocks(positions: int) -> int:
    """Blocks (and partials) of a row over ``positions`` cache positions."""
    return -(-positions // SPAN)


def partials(B: int, H: int, n_p: int, device):
    """The float32 scratch of a launch with ``n_p`` blocks a row: the
    unnormalised outputs ``[B,n_p,H,DV]`` and each block's (m, l)
    ``[2,B,n_p,H]``."""
    return (torch.empty((B, n_p, H, DV), dtype=torch.float32, device=device),
            torch.empty((2, B, n_p, H), dtype=torch.float32, device=device))


def _check(q, lat, v_dim, what):
    if not (q.is_cuda and lat.device == q.device):
        raise ValueError(f"{what} kernel: q and the latent cache must lie on one CUDA device")
    if q.dtype not in _DTYPES or lat.dtype != q.dtype:
        raise TypeError(f"{what} kernel: dtypes {q.dtype}/{lat.dtype}; needs both float32 "
                        "or both bfloat16")
    B, H, D = q.shape
    if D != DK or lat.shape[-1] != DK or v_dim != DV:
        raise ValueError(f"{what} kernel: built for Dk {DK} and Dv {DV}; got q{tuple(q.shape)} "
                         f"latent{tuple(lat.shape)} v_dim {v_dim}")
    if not 1 <= H <= MAX_H:
        raise ValueError(f"{what} kernel: {H} query heads; at most {MAX_H}")
    if not q.is_contiguous() or q.data_ptr() % 16 or lat.data_ptr() % 16:
        raise ValueError(f"{what} kernel: q must be contiguous, q and the cache 16-byte "
                         "aligned")
    return B, H


def _launch(entry, q, lat, n_p, *args):
    B, H = q.shape[:2]
    o = q.new_empty((B, H, DV))
    part_o, part_ml = partials(B, H, n_p, q.device)
    cnt = counters(q.device, B)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind(entry)(q.data_ptr(), lat.data_ptr(), o.data_ptr(), part_o.data_ptr(),
                          part_ml.data_ptr(), cnt.data_ptr(), *args,
                          _DTYPES[q.dtype], stream)
    build.check(rc, entry)
    return o


def latent_decode_attention(q, lat, length, *, v_dim, scale):
    """Launch the kernel. q: [B,H,Dk]; lat: [B,S,Dk] contiguous, on one CUDA
    device, both float32 or both bfloat16, Dk = ``DK``, ``v_dim`` = ``DV``,
    H at most ``MAX_H``; attend to positions ``< length`` with the scores
    scaled by ``scale``. Returns [B,H,v_dim]."""
    global launches
    B, H = _check(q, lat, v_dim, "latent_decode_attention")
    if not lat.is_contiguous():
        raise ValueError("latent_decode_attention kernel: the cache must be contiguous")
    S = lat.shape[1]
    length = int(length)
    if lat.shape != (B, S, DK) or not 1 <= length <= S:
        raise ValueError(f"latent_decode_attention kernel: cache {tuple(lat.shape)}, length "
                         f"{length}")
    o = _launch("repro_latent_decode_attention", q, lat, n_blocks(S), B, H, S, length, DK,
                DV, float(scale))
    launches += 1
    return o


def paged_latent_decode_attention(q, lat_pages, page_table, lengths, *, v_dim, scale):
    """Launch the kernel through a page table. q: [B,H,Dk] contiguous;
    lat_pages: [P, page, Dk] with contiguous rows on 16 bytes; page_table:
    [B, n] int32, its entries past a row's length valid pool indices (0),
    never read; lengths: [B] int32 (clamped to the table's positions; 0
    gives a zero row). Returns [B,H,v_dim]."""
    global paged_launches
    B, H = _check(q, lat_pages, v_dim, "paged_latent_decode_attention")
    dev = q.device
    if page_table.device != dev or lengths.device != dev:
        raise ValueError("paged_latent_decode_attention kernel: all tensors must lie on one "
                         "CUDA device")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_latent_decode_attention kernel: page_table and lengths must "
                        "be int32")
    if (lat_pages.dim() != 3 or page_table.dim() != 2 or page_table.shape[0] != B
            or lengths.shape != (B,)):
        raise ValueError(f"paged_latent_decode_attention kernel: pages "
                         f"{tuple(lat_pages.shape)} table {tuple(page_table.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if not (page_table.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("paged_latent_decode_attention kernel: page_table and lengths must "
                         "be contiguous")
    vec = 16 // q.element_size()
    page_stride, row_stride, col = lat_pages.stride()
    if col != 1 or page_stride % vec or row_stride % vec:
        raise ValueError("paged_latent_decode_attention kernel: rows must be contiguous "
                         "and 16-byte aligned")
    n_tab, page = page_table.shape[1], lat_pages.shape[1]
    o = _launch("repro_paged_latent_decode_attention", q, lat_pages, n_blocks(n_tab * page),
                page_table.data_ptr(), lengths.data_ptr(), B, H, n_tab, page, page_stride,
                row_stride, DK, DV, float(scale))
    paged_launches += 1
    return o
