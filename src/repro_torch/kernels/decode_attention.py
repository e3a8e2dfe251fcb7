"""Split-KV flash-decoding (one query token per row) as hand-written CUDA.

The Hopper twin of the JAX package's Pallas ``decode_attention._kernel``;
the kernels and their design notes are in ``csrc/decode_attention.cu``.
Its plain version is :func:`repro_torch.kernels.ref.naive_decode_attention`
(which takes k/v as ``[B,K,S,D]``).

Layout: q ``[B,H,D]``; k/v ``[B,S,K,D]``, which is the decode cache
``[B, S_max, K*D]`` viewed without a copy. The cache is cut into splits of
``SPLIT`` positions; one block per (row, KV head, split) reads its K/V
rows once for the KV head's ``G = H/K`` query heads (at most ``MAX_G``) and
writes an unnormalised partial to a scratch buffer, and a second kernel
combines the partials in a fixed order, so the result is deterministic.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel pair since the count was last set to 0
launches = 0

HEAD_DIMS = (32, 64)
SPLIT = 128          # cache positions per split block (one per thread)
MAX_G = 16           # query heads per KV head (GMAX in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _bind():
    lib = build.load("decode_attention")
    fn = lib.repro_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def n_splits(S: int) -> int:
    return -(-S // SPLIT)


def decode_attention(q, k, v, length, *, window=None):
    """Launch the kernels. q: [B,H,D]; k,v: [B,S,K,D] contiguous on one CUDA
    device, all float32 or all bfloat16, D in ``HEAD_DIMS``, H/K at most
    ``MAX_G``; attend to cache positions ``< length`` (and
    ``>= length - window``)."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("decode_attention kernel: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; needs all float32 or all bfloat16")
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"decode_attention kernel: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head dim {D} not in {HEAD_DIMS}")
    if H // K > MAX_G:
        raise ValueError(f"decode_attention kernel: {H // K} query heads per KV "
                         f"head; at most {MAX_G}")
    length = int(length)
    if not 1 <= length <= S:
        raise ValueError(f"decode_attention kernel: length {length} not in [1, {S}]")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention kernel: window {window} < 1")
    for x, n in ((q, "q"), (k, "k"), (v, "v")):
        if not x.is_contiguous():
            raise ValueError(f"decode_attention kernel: {n} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"decode_attention kernel: {n} must be 16-byte aligned")
    G = H // K
    ns = n_splits(S)
    o = torch.empty_like(q)
    part_o = torch.empty((B, K, ns, G, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, B, K, ns, G), dtype=torch.float32, device=q.device)
    fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                part_o.data_ptr(), part_ml.data_ptr(), B, H, K, S, D, length,
                window or 0, _DTYPES[q.dtype], SPLIT, stream)
    build.check(rc, "decode_attention")
    launches += 1
    return o
