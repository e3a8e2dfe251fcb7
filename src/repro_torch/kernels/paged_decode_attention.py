"""Split-KV flash-decoding over a paged KV pool as hand-written CUDA.

The Hopper twin of the JAX package's Pallas ``decode_attention._paged_kernel``;
the entry point is in ``csrc/paged_decode_attention.cu`` and shares its
one-launch split-KV kernel (the last split block of each row and KV head
combines the splits) and the ticket counters with the contiguous decode
(``csrc/decode_split.cuh``, :func:`decode_attention.counters`). Its plain
version is :func:`repro_torch.kernels.ref.naive_paged_decode_attention`.

Layout: q ``[B,H,D]``; k/v pages ``[n_pool_pages, page_size, K, D]`` with any
strides whose last dim is contiguous, so the serving pool's per-layer
strided view of a stacked ``[n_pages, page_size, n_layers*K*D]`` store goes
in as it lies; ``page_table [B, n]`` int32, whose entries past a row's length
must be valid pool indices (0) and are never read; ``lengths [B]`` int32,
one per row. A row's length is clamped to the table's ``n * page_size``
positions on the card; a length of 0 gives a zero output row.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (HEAD_DIMS, MAX_G, counters, partials,
                                                   slots, split_len)

#: launches of the CUDA kernel since the count was last set to 0
launches = 0
#: the shared library whose C entry the wrapper launches: None for the one
#: built from ``csrc/paged_decode_attention.cu``; the path of another build
#: of it runs that one (``tools/decode_tail.py --define``)
library = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_longlong


@functools.cache
def _bind(path):
    lib = build.load("paged_decode_attention") if path is None else ctypes.CDLL(str(path))
    fn = lib.repro_paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [_I64] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def n_splits(n_table: int, page_size: int, D: int) -> int:
    """Split blocks over a table's ``n_table * page_size`` positions at head
    dim ``D``: the contiguous decode's over as many positions."""
    return -(-(n_table * page_size) // split_len(D))


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *, window=None):
    """Launch the kernel. q: [B,H,D] contiguous; k_pages, v_pages: [P, page,
    K, D] with equal strides and a contiguous last dim; page_table: [B, n]
    int32; lengths: [B] int32; all on one CUDA device; q and the pages all
    float32 or all bfloat16, D in ``HEAD_DIMS``, H/K at most ``MAX_G``."""
    global launches
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k_pages, v_pages, page_table,
                                                         lengths))):
        raise ValueError("paged_decode_attention kernel: all tensors must lie on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention kernel: dtypes {q.dtype}/"
                        f"{k_pages.dtype}/{v_pages.dtype}; needs all float32 or all "
                        "bfloat16")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention kernel: page_table and lengths must "
                        "be int32")
    B, H, D = q.shape
    P, page, K = k_pages.shape[:3]
    if (k_pages.shape != (P, page, K, D) or v_pages.shape != k_pages.shape or H % K
            or page_table.dim() != 2 or page_table.shape[0] != B
            or lengths.shape != (B,)):
        raise ValueError(f"paged_decode_attention kernel: shapes q{tuple(q.shape)} "
                         f"pages{tuple(k_pages.shape)}/{tuple(v_pages.shape)} table"
                         f"{tuple(page_table.shape)} lengths{tuple(lengths.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if H // K > MAX_G:
        raise ValueError(f"paged_decode_attention kernel: {H // K} query heads per "
                         f"KV head; at most {MAX_G}")
    if window is not None and window < 1:
        raise ValueError(f"paged_decode_attention kernel: window {window} < 1")
    if not (q.is_contiguous() and page_table.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("paged_decode_attention kernel: q, page_table and lengths "
                         "must be contiguous")
    vec = 16 // q.element_size()
    strides = k_pages.stride()
    if v_pages.stride() != strides or strides[3] != 1:
        raise ValueError("paged_decode_attention kernel: k and v pages need equal "
                         "strides and a contiguous last dim")
    if any(s % vec for s in strides[:3]) or any(
            x.data_ptr() % 16 for x in (q, k_pages, v_pages)):
        raise ValueError("paged_decode_attention kernel: rows must be 16-byte aligned")
    n_tab = page_table.shape[1]
    o = torch.empty_like(q)
    sl = slots(q.dtype, D, H // K, n_splits(n_tab, page, D))
    part_o, part_ml = partials(B, H, K, D, sl, dev)
    cnt = counters(dev, B * K)
    fn = _bind(library)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
                part_o.data_ptr(), part_ml.data_ptr(), cnt.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), B, H, K, D, n_tab, page,
                *strides[:3],
                window or 0, _DTYPES[q.dtype], split_len(D), stream)
    build.check(rc, "paged_decode_attention")
    launches += 1
    return o
