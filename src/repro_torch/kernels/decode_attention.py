"""Split-KV flash-decoding (one query token per row) as hand-written CUDA.

The Hopper twin of the JAX package's Pallas ``decode_attention._kernel``;
the kernel and its design notes are in ``csrc/decode_split.cuh`` (entry
points in ``csrc/decode_attention.cu``). Its plain version is
:func:`repro_torch.kernels.ref.naive_decode_attention` (which takes k/v as
``[B,K,S,D]``).

Layout: q ``[B,H,D]``; k/v ``[B,S,K,D]``, which is the decode cache
``[B, S_max, K*D]`` viewed without a copy. The cache is cut into splits of
``split_len(D)`` positions (64 at head dim 128, else 128); each (row, KV
head, split) is read once for the KV head's ``G = H/K`` query heads (at
most ``MAX_G``), by a block of its own (or, in bf16 at G = 1, by one of a
one-wave grid's blocks walking such splits), into an unnormalised partial.
Which kernel runs is a rule on (dtype, D, G), :func:`kernel`; a block of
the tensor-core kernel (bf16 at D = 128, and at D = 64 for G > 1) takes
``MMA_SPAN`` positions, two splits at D = 128, so a launch writes
:func:`slots` partials a row and KV head into a scratch buffer. In the
same launch the last block of each (row, KV head) to finish, elected by a
ticket counter, combines them in split order, so the result is
deterministic. The
counters are this module's, one zeroed int32 buffer per device that every
launch leaves at zero (so a captured CUDA graph replays correctly); two
launches that may run at once on different streams must not share it. A
buffer is never freed, since a captured graph keeps its address, and none is
allocated during a capture: launch once at the largest size, outside the
capture, first.

:func:`ring_decode_attention` runs the same kernel over a sliding-window
layer's ring-buffer cache ``[B, W, K, D]`` (position ``p`` in slot
``p % W``); its plain version is
:func:`repro_torch.kernels.ref.naive_ring_decode_attention`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel over a contiguous cache since the count was
#: last set to 0
launches = 0
#: launches of the kernel over a ring-buffer cache, likewise
ring_launches = 0
#: the shared library whose C entries the wrappers launch: None for the one
#: built from ``csrc/decode_attention.cu``; the path of another build of it
#: (with diagnostic macros, ``tools/decode_tail.py --define``) runs that one
library = None

HEAD_DIMS = (32, 64, 128)
MAX_G = 16           # query heads per KV head (GMAX in the source)
#: cache positions a block of decode_mma_kernel takes (``tc::L<D>::SPAN``
#: in the source): one split at head dim 64, two at 128
MMA_SPAN = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_counter_bufs: dict[torch.device, torch.Tensor] = {}
# buffers a larger launch outgrew, kept alive: a graph that captured a
# launch with one of them goes on counting in it on every replay
_outgrown: list[torch.Tensor] = []


@functools.cache
def _bind(path, entry):
    lib = build.load("decode_attention") if path is None else ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def counters(device, n: int) -> torch.Tensor:
    """The device's ticket counters, at least ``n`` int32 (one per row and
    KV head), zeroed when allocated; the kernels leave them at zero."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    buf = _counter_bufs.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # a buffer made here would be zeroed only when the graph replays
            raise RuntimeError(f"decode kernels: {n} ticket counters are needed during a "
                               "CUDA graph capture; launch once at this size before it")
        if buf is not None:
            _outgrown.append(buf)
        size = max(n, 2 * buf.numel() if buf is not None else 4096)
        buf = _counter_bufs[device] = torch.zeros(size, dtype=torch.int32, device=device)
    return buf


def split_len(D: int) -> int:
    """Cache positions a split block takes at head dim ``D``
    (``split_len`` in the source): 64 at D = 128, whose bf16 kernel puts a
    KV head's query heads on the tensor cores, else 128. It depends on the
    head dim alone, so the contiguous, ring and paged decodes cut a row
    alike."""
    return 64 if D > 64 else 128


def n_splits(S: int, D: int) -> int:
    """Split blocks over ``S`` cache positions at head dim ``D``."""
    return -(-S // split_len(D))


def kernel(dtype, D: int, G: int) -> str:
    """The kernel a CUDA call launches at head dim ``D`` with ``G`` query
    heads a KV head, whatever B, the length or the addressing (K2, K2 over a
    ring and K3 alike): ``decode_mma_kernel`` (the heads on the tensor
    cores) in bf16 at D = 128 and at D = 64 for G > 1, ``decode_g1_kernel``
    in bf16 at G = 1 and D <= 64, else ``decode_kernel``. It mirrors the
    source's ``mma_route`` and dispatch (``tests/test_torch_split.py``
    holds it to them)."""
    if dtype == torch.bfloat16:
        if D == 128 or (D == 64 and G > 1):
            return "decode_mma_kernel"
        if G == 1:
            return "decode_g1_kernel"
    return "decode_kernel"


def slots(dtype, D: int, G: int, ns: int) -> int:
    """Partials a launch over ``ns`` splits writes per (row, KV head): on
    ``decode_mma_kernel`` one a block, which takes ``MMA_SPAN`` positions
    (the source's grid), else one a split (the G = 1 kernel walks them on a
    one-wave grid)."""
    if kernel(dtype, D, G) != "decode_mma_kernel":
        return ns
    return -(-ns // (MMA_SPAN // split_len(D)))


def partials(B: int, H: int, K: int, D: int, ns: int, device):
    """The float32 scratch a launch with ``ns`` partial slots a (row, KV
    head) writes (:func:`slots`): the unnormalised outputs ``[B,K,ns,G,D]``
    and each slot's (m, l) ``[2,B,K,ns,G]``."""
    G = H // K
    return (torch.empty((B, K, ns, G, D), dtype=torch.float32, device=device),
            torch.empty((2, B, K, ns, G), dtype=torch.float32, device=device))


def _check(q, k, v, what):
    """Device, dtype, shape and layout checks shared by both entries;
    returns (B, H, K, S, D)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what} kernel: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; needs all float32 or all bfloat16")
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"{what} kernel: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what} kernel: head dim {D} not in {HEAD_DIMS}")
    if H // K > MAX_G:
        raise ValueError(f"{what} kernel: {H // K} query heads per KV "
                         f"head; at most {MAX_G}")
    for x, n in ((q, "q"), (k, "k"), (v, "v")):
        if not x.is_contiguous():
            raise ValueError(f"{what} kernel: {n} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{what} kernel: {n} must be 16-byte aligned")
    return B, H, K, S, D


def _launch(entry, q, k, v, ns, *ints):
    """Allocate the output and the partials for ``ns`` splits and launch
    ``entry`` with the C entry's int arguments ``ints``."""
    B, H, D = q.shape
    K = k.shape[2]
    o = torch.empty_like(q)
    sl = slots(q.dtype, D, H // K, ns)
    part_o, part_ml = partials(B, H, K, D, sl, q.device)
    cnt = counters(q.device, B * K)
    fn = _bind(library, entry)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                part_o.data_ptr(), part_ml.data_ptr(), cnt.data_ptr(), *ints,
                _DTYPES[q.dtype], split_len(D), stream)
    build.check(rc, entry)
    return o


def decode_attention(q, k, v, length, *, window=None):
    """Launch the kernel. q: [B,H,D]; k,v: [B,S,K,D] contiguous on one CUDA
    device, all float32 or all bfloat16, D in ``HEAD_DIMS``, H/K at most
    ``MAX_G``; attend to cache positions ``< length`` (and
    ``>= length - window``)."""
    global launches
    B, H, K, S, D = _check(q, k, v, "decode_attention")
    length = int(length)
    if not 1 <= length <= S:
        raise ValueError(f"decode_attention kernel: length {length} not in [1, {S}]")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention kernel: window {window} < 1")
    o = _launch("repro_decode_attention", q, k, v, n_splits(S, D),
                B, H, K, S, D, length, window or 0)
    launches += 1
    return o


def ring_decode_attention(q, k, v, pos, *, window):
    """Launch the kernel over a ring-buffer cache. q: [B,H,D]; k,v:
    [B,W,K,D] as :func:`decode_attention` takes them, position ``p`` in slot
    ``p % W``; ``pos`` is the index of the newest token, whose row is
    written. Attends to the last ``min(window, W, pos + 1)`` positions, as
    the reference's ``layers.window_decode_attention`` does."""
    global ring_launches
    B, H, K, W, D = _check(q, k, v, "ring_decode_attention")
    pos = int(pos)
    if pos < 0 or window is None or window < 1:
        raise ValueError(f"ring_decode_attention kernel: pos {pos}, window {window}")
    n = min(window, W, pos + 1)
    o = _launch("repro_ring_decode_attention", q, k, v, n_splits(n, D),
                B, H, K, W, D, pos, window)
    ring_launches += 1
    return o
