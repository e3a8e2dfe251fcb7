"""The sLSTM recurrence (xLSTM's scalar-memory block) as a hand-written CUDA
kernel: one launch runs a layer's whole scan.

The JAX package has no Pallas kernel here: its ``models/xlstm.py``
``slstm_apply`` runs the recurrence as a ``jax.lax.scan``, one compiled
loop. Stepped from Python the port would launch some 20 kernels a position
and layer; this kernel runs the loop on the card, for the prefill from the
start state :func:`~repro_torch.kernels.ref.slstm_state0` and for each
decode step at S = 1 from the
cached state. The kernels and their design notes are in
``csrc/slstm_scan.cu``: a cluster of 8 blocks per head and group of up to 8
rows, the new h exchanged through distributed shared memory, one cluster
barrier a step; in bf16 the product on the tensor cores with each warp's R
fragments in registers for the whole scan (``slstm_mma_kernel``), in
float32 exact FMA products over R's columns in shared memory
(``slstm_f32_kernel``). Its plain version is
:func:`repro_torch.kernels.ref.slstm_scan`.

Layout: wx ``[B,S,4d]`` contiguous (the hoisted ``x_conv @ w_gates +
b_gates``, head-major ``[H,4,dh]``: i, f, z, o), r ``[H,dh,4dh]``
contiguous in wx's dtype (bfloat16 or float32), the state ``(c, n, m, h)``
each ``[B,H,dh]`` float32. Returns hs ``[B,S,H,dh]`` in wx's dtype and the
final state, new tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of the kernel since the count was last set to 0
launches = 0
#: the shared library the wrapper launches: None for the one built from
#: ``csrc/slstm_scan.cu``, or the path of another build of it
library = None

CLUSTER = 8     # blocks a (head, row group) (``CLUSTER`` in the source)
ROWS = 8        # rows a group at most (``ROWS``)
MAX_DH = 256    # the widest head (the float32 kernel's shared memory holds dh x dh / 2 of R)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p


@functools.cache
def _bind(path, entry):
    lib = build.load("slstm_scan") if path is None else ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    if entry == "repro_slstm_barrier":
        fn.argtypes = [ctypes.c_int] * 4 + [_P]
    else:
        fn.argtypes = [_P] * 11 + [ctypes.c_int] * 5 + [_P]
    fn.restype = ctypes.c_int
    return fn


def kernel(dtype) -> str:
    """The name of the kernel a launch in ``dtype`` runs."""
    return "slstm_mma_kernel" if dtype == torch.bfloat16 else "slstm_f32_kernel"


def _check(wx, r, state):
    if not (wx.is_cuda and r.device == wx.device
            and all(t.device == wx.device for t in state)):
        raise ValueError("slstm_scan kernel: wx, r and the state must lie on one CUDA device")
    if wx.dtype not in _DTYPES or r.dtype != wx.dtype:
        raise TypeError(f"slstm_scan kernel: dtypes {wx.dtype}/{r.dtype}; needs both float32 "
                        "or both bfloat16")
    if wx.dim() != 3 or r.dim() != 3:
        raise ValueError(f"slstm_scan kernel: wx {tuple(wx.shape)}, r {tuple(r.shape)}")
    B, S, G = wx.shape
    H, dh = r.shape[:2]
    if tuple(r.shape) != (H, dh, 4 * dh) or G != 4 * H * dh:
        raise ValueError(f"slstm_scan kernel: wx {tuple(wx.shape)} and r {tuple(r.shape)}; "
                         "needs r [H,dh,4dh] and wx [B,S,4 H dh]")
    if dh % 32 or dh > MAX_DH or S < 1 or B < 1:
        raise ValueError(f"slstm_scan kernel: head width {dh} (a multiple of 32 up to "
                         f"{MAX_DH}), S {S}, B {B}")
    for t in state:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, dh) or not t.is_contiguous():
            raise ValueError(f"slstm_scan kernel: a state leaf {t.dtype} {tuple(t.shape)}; "
                             f"needs contiguous float32 {(B, H, dh)}")
    if not (wx.is_contiguous() and r.is_contiguous()):
        raise ValueError("slstm_scan kernel: wx and r must be contiguous")
    return B, S, H, dh


def slstm_scan(wx, r, state):
    """Launch the kernel over wx's S positions from ``state`` = (c, n, m,
    h). Returns (hs [B,S,H,dh] in wx's dtype, (c, n, m, h) after the last
    position)."""
    global launches
    B, S, H, dh = _check(wx, r, state)
    hs = wx.new_empty((B, S, H, dh))
    out = tuple(torch.empty_like(t) for t in state)
    with torch.cuda.device(wx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind(library, "repro_slstm_scan")(
            wx.data_ptr(), r.data_ptr(), *(t.data_ptr() for t in state), hs.data_ptr(),
            *(t.data_ptr() for t in out), B, S, H, dh, _DTYPES[wx.dtype], stream)
    build.check(rc, "repro_slstm_scan")
    launches += 1
    return hs, out


def barrier(B: int, S: int, H: int, dh: int, device=None) -> None:
    """Launch S + 1 cluster barriers on the scan's grid (nothing else): the
    latency floor of an S-step scan, which ``chip_smoke.py`` times beside
    the kernel. Not a launch of the kernel: no count."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind(library, "repro_slstm_barrier")(B, S, H, dh, stream)
    build.check(rc, "repro_slstm_barrier")
