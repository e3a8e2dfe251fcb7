"""Causal GQA flash attention (prefill and training) as hand-written CUDA
kernels.

The forward is the Hopper twin of the JAX package's Pallas
``flash_attention._kernel`` (``csrc/flash_attention.cu``); its plain
version is :func:`repro_torch.kernels.ref.naive_attention`. Asked for it,
the forward also writes each row's logsumexp (float32 ``[B,H,S]``, plain
version :func:`~repro_torch.kernels.ref.naive_attention_lse`), from which
the backward (``csrc/flash_attention_bwd.cu``: a dQ kernel that also writes
the row sums rowsum(dO o), then a dK/dV kernel; deterministic, no atomics)
recomputes the probabilities; its plain version is
:func:`~repro_torch.kernels.ref.flash_attention_bwd`. :class:`FlashAttention`
joins the two for ``torch.autograd``.

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

#: launches of the forward kernel since the count was last set to 0
launches = 0
#: launches of the backward's kernels, likewise: the dQ kernel (which also
#: writes the row sums) and the dK/dV kernel
bwd_dq_launches = 0
bwd_dkdv_launches = 0
#: the shared library whose C entry ``repro_flash_attention`` the wrapper
#: launches: None for the one built from ``csrc/flash_attention.cu``; the
#: path of another build of a source with the same C entry compares an
#: earlier or altered version on the same calls (``tools/k1_witness.py``)
library = None

HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_longlong


@functools.cache
def _bind(path, entry="repro_flash_attention"):
    """The forward's C entry: ``repro_flash_attention``, or with a logsumexp
    buffer after ``o`` ``repro_flash_attention_lse`` (``library`` may name
    an earlier build, which has only the first)."""
    lib = build.load("flash_attention") if path is None else ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    n_ptr = 5 if entry.endswith("_lse") else 4
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [_I64] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bind_bwd():
    """The backward's C entry (kernel 1: dQ and the row sums; 2: dK/dV)."""
    fn = build.load("flash_attention_bwd").repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(_I64), ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _rows_ok(x):
    """Each row of D elements is contiguous and starts on 16 bytes (the
    kernels' vector and TMA loads)."""
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and not any(s % vec for s in x.stride()[:-1]))


def _check_rows(x, name):
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous")
    if not _rows_ok(x):
        raise ValueError(f"{name}: rows must be 16-byte aligned")


def _check_args(q, k, v, window, what):
    """The kernels' shared checks; returns (B, H, K, S, D)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what} kernel: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; needs all float32 or all bfloat16")
    B, H, S, D = q.shape
    K = k.shape[1]
    if k.shape != (B, K, S, D) or v.shape != k.shape or H % K:
        raise ValueError(f"{what} kernel: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what} kernel: head dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{what} kernel: window {window} < 1")
    for x, n in ((q, "q"), (k, "k"), (v, "v")):
        _check_rows(x, n)
    return B, H, K, S, D


def flash_attention(q, k, v, *, window=None, lse=False):
    """Launch the kernel. q: [B,H,S,D]; k,v: [B,K,S,D] on one CUDA device,
    all float32 or all bfloat16, D in ``HEAD_DIMS``. Returns o [B,H,S,D],
    or with ``lse`` (o, logsumexp float32 [B,H,S])."""
    global launches
    B, H, K, S, D = _check_args(q, k, v, window, "flash_attention")
    o = torch.empty_like(q)
    m = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if lse else None
    if S == 0 or B == 0:
        return (o, m) if lse else o
    strides = [s for x in (q, k, v, o) for s in x.stride()[:3]]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
    if lse:
        fn = _bind(library, "repro_flash_attention_lse")
        ptrs.append(m.data_ptr())
    else:
        fn = _bind(library)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, B, H, K, S, D, *strides, window or 0, _DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention")
    launches += 1
    return (o, m) if lse else o


def _bwd(q, k, v, o, lse, do, *, window=None):
    """Launch the backward's two kernels on the current stream, the dQ
    kernel first (it also writes each row's Dr = rowsum(do * o), float32
    ``[B,H,S]`` contiguous, which the dK/dV kernel reads). Returns (dq, dk,
    dv, Dr); :func:`flash_attention_bwd` is the public entry."""
    global bwd_dkdv_launches, bwd_dq_launches
    B, H, K, S, D = _check_args(q, k, v, window, "flash_attention_bwd")
    for x, n in ((o, "o"), (do, "do")):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd kernel: {n} {tuple(x.shape)} "
                             f"{x.dtype} does not match q {tuple(q.shape)} {q.dtype}")
        _check_rows(x, n)
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd kernel: lse must be contiguous float32 "
                         f"{(B, H, S)} on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0 or B == 0:
        return dq, dk, dv, delta
    strides = (_I64 * 24)(*[s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]])
    fn = _bind_bwd()
    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, delta, dq, dk, dv)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(1, *ptrs, B, H, K, S, D, strides, window or 0, _DTYPES[q.dtype], stream)
        build.check(rc, "flash_attention_bwd dq")
        bwd_dq_launches += 1
        rc = fn(2, *ptrs, B, H, K, S, D, strides, window or 0, _DTYPES[q.dtype], stream)
        build.check(rc, "flash_attention_bwd dkdv")
        bwd_dkdv_launches += 1
    return dq, dk, dv, delta


def flash_attention_bwd(q, k, v, o, lse, do, *, window=None):
    """Launch the backward's kernels: dq, dk, dv of :func:`flash_attention`
    at (q, k, v) given its output ``o``, its logsumexp ``lse`` (float32
    [B,H,S]) and the output's gradient ``do`` (any strides whose rows are
    contiguous and start on 16 bytes). Each gradient is laid out as
    ``torch.empty_like`` lays out its input (a dense view keeps its
    strides). Deterministic: equal inputs give equal bits."""
    return _bwd(q, k, v, o, lse, do, window=window)[:3]


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its gradient from :func:`flash_attention_bwd`.
    The forward saves q, k, v, o and the logsumexp; the backward takes dO
    with the strides autograd hands over (in training the transposed view
    of the output projection's gradient) and copies it only when its rows
    are not contiguous on 16 bytes. ``window`` takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = flash_attention(q, k, v, window=window, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if not _rows_ok(do) or 0 in do.stride():   # a broadcast dO is copied too
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, window=ctx.window)
        return dq, dk, dv, None
