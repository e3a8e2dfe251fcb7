"""Causal GQA flash attention (prefill) as a hand-written CUDA kernel.

The Hopper twin of the JAX package's Pallas ``flash_attention._kernel``;
the kernel and its design notes are in ``csrc/flash_attention.cu``. Its
plain version is :func:`repro_torch.kernels.ref.naive_attention`.

Layout: q ``[B,H,S,D]``, k/v ``[B,K,S,D]`` as in the Pallas kernel, but any
strides with a contiguous last dim are taken, so the model passes its
``[B,S,H,D]`` projections as transposed views and nothing is copied. The
output has q's strides.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel since the count was last set to 0
launches = 0
#: the shared library whose C entry ``repro_flash_attention`` the wrapper
#: launches: None for the one built from ``csrc/flash_attention.cu``; the
#: path of another build of a source with the same C entry compares an
#: earlier or altered version on the same calls (``tools/k1_witness.py``)
library = None

HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_longlong


@functools.cache
def _bind(path):
    lib = build.load("flash_attention") if path is None else ctypes.CDLL(str(path))
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [_I64] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_rows(x, name):
    """Each row of D elements must start on 16 bytes (vector loads)."""
    vec = 16 // x.element_size()
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous")
    if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:-1]):
        raise ValueError(f"{name}: rows must be 16-byte aligned")


def flash_attention(q, k, v, *, window=None):
    """Launch the kernel. q: [B,H,S,D]; k,v: [B,K,S,D] on one CUDA device,
    all float32 or all bfloat16, D in ``HEAD_DIMS``. Returns [B,H,S,D]."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; needs all float32 or all bfloat16")
    B, H, S, D = q.shape
    K = k.shape[1]
    if k.shape != (B, K, S, D) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_attention kernel: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention kernel: window {window} < 1")
    for x, n in ((q, "q"), (k, "k"), (v, "v")):
        _check_rows(x, n)
    o = torch.empty_like(q)
    if S == 0 or B == 0:
        return o
    fn = _bind(library)
    strides = [s for x in (q, k, v, o) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B, H, K, S, D, *strides, window or 0, _DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention")
    launches += 1
    return o
