"""The sLSTM recurrence (xLSTM's scalar-memory block) as hand-written CUDA
kernels: one launch runs a layer's whole scan, forward or backward.

The JAX package has no Pallas kernel here: its ``models/xlstm.py``
``slstm_apply`` runs the recurrence as a ``jax.lax.scan``, one compiled
loop, and differentiates it by XLA's autodiff. Stepped from Python the
port would launch some 20 kernels a position and layer; these kernels run
the loop on the card, for the prefill from the start state
:func:`~repro_torch.kernels.ref.slstm_state0` and for each decode step at
S = 1 from the cached state, and in training its reverse. The forward
kernels and their design notes are in ``csrc/slstm_scan.cu``: a cluster of
8 blocks per head and group of up to 8 rows, the new h exchanged through
distributed shared memory; in bf16 the product on the tensor cores with
each warp's R fragments in registers for the whole scan
(``slstm_mma_kernel``), in float32 exact FMA products over R's columns in
shared memory (``slstm_f32_kernel``). ``states=True`` launches their
training variant, which also writes what the backward reads. The backward
(``csrc/slstm_scan_bwd.cu``, ``slstm_bwd_mma_kernel`` and
``slstm_bwd_f32_kernel``) is the forward's design run in reverse, its
product's partials reduce-scattered among the cluster. Their plain
versions are :func:`repro_torch.kernels.ref.slstm_scan` and
:func:`~repro_torch.kernels.ref.slstm_scan_bwd`; :class:`SLSTMScan` is the
differentiable scan.

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

from repro_torch.kernels import build, ref

#: launches of the serving forward, of the training forward
#: (``states=True``) and of the backward since each count was last set to 0
launches = 0
train_launches = 0
bwd_launches = 0
#: the shared library the forward wrapper launches: None for the one built
#: from ``csrc/slstm_scan.cu``, or the path of another build of it; and the
#: backward's (``csrc/slstm_scan_bwd.cu``)
library = None
bwd_library = None

CLUSTER = 8     # blocks a (head, row group) (``CLUSTER`` in the source)
ROWS = 8        # rows a group at most (``ROWS``)
MAX_DH = 256    # the widest head (the float32 kernel's shared memory holds dh x dh / 2 of R)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p


#: each C entry's source and its number of pointer arguments before the
#: ints (B, S, H, dh, dtype) and the stream
_ENTRIES = {"repro_slstm_scan": ("slstm_scan", 11),
            "repro_slstm_scan_states": ("slstm_scan", 15),
            "repro_slstm_scan_bwd": ("slstm_scan_bwd", 13)}


@functools.cache
def _bind(path, entry):
    if entry == "repro_slstm_barrier":
        lib = build.load("slstm_scan") if path is None else ctypes.CDLL(str(path))
        fn = lib.repro_slstm_barrier
        fn.argtypes = [ctypes.c_int] * 4 + [_P]
    else:
        src, n_ptr = _ENTRIES[entry]
        lib = build.load(src) if path is None else ctypes.CDLL(str(path))
        fn = getattr(lib, entry)
        fn.argtypes = [_P] * n_ptr + [ctypes.c_int] * 5 + [_P]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry, ptrs, B, S, H, dh, dtype, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind(bwd_library if entry == "repro_slstm_scan_bwd" else library, entry)(
            *ptrs, B, S, H, dh, _DTYPES[dtype], stream)
    build.check(rc, entry)


def kernel(dtype, bwd=False) -> str:
    """The name of the kernel a launch in ``dtype`` runs (the forward's, or
    with ``bwd`` the backward's)."""
    name = "mma" if dtype == torch.bfloat16 else "f32"
    return f"slstm_bwd_{name}_kernel" if bwd else f"slstm_{name}_kernel"


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


def slstm_scan(wx, r, state, *, states=False):
    """Launch the kernel over wx's S positions from ``state`` = (c, n, m,
    h). Returns (hs [B,S,H,dh] in wx's dtype, (c, n, m, h) after the last
    position); with ``states`` the training variant, which also returns what
    the backward reads, ``(gates [B,S,4d] in wx's dtype, c, n, m
    [B,S,H,dh] float32)`` (hs and the final state are the same bits)."""
    global launches, train_launches
    B, S, H, dh = _check(wx, r, state)
    hs = wx.new_empty((B, S, H, dh))
    out = tuple(torch.empty_like(t) for t in state)
    ptrs = [wx.data_ptr(), r.data_ptr(), *(t.data_ptr() for t in state), hs.data_ptr(),
            *(t.data_ptr() for t in out)]
    if not states:
        _launch("repro_slstm_scan", ptrs, B, S, H, dh, wx.dtype, wx.device)
        launches += 1
        return hs, out
    saved = (torch.empty_like(wx),
             *(torch.empty((B, S, H, dh), dtype=torch.float32, device=wx.device)
               for _ in range(3)))
    _launch("repro_slstm_scan_states", ptrs + [t.data_ptr() for t in saved], B, S, H, dh,
            wx.dtype, wx.device)
    train_launches += 1
    return hs, out, saved


def _bwd(r, state, hs, saved, dhs):
    """The backward kernel alone: (dwx [B,S,4d] in the gates' dtype, and the
    start state's dc, dn, dh [B,H,dh] float32)."""
    global bwd_launches
    gates, cs, ns, ms = saved
    B, S, H, dh = _check(gates, r, state)
    for name, t, dtype in (("c", cs, torch.float32), ("n", ns, torch.float32),
                           ("m", ms, torch.float32), ("hs", hs, gates.dtype),
                           ("dhs", dhs, gates.dtype)):
        if t.dtype != dtype or tuple(t.shape) != (B, S, H, dh) or not t.is_contiguous() \
                or t.device != gates.device:
            raise ValueError(f"slstm_scan_bwd kernel: {name} {t.dtype} {tuple(t.shape)}; "
                             f"needs contiguous {dtype} {(B, S, H, dh)} on {gates.device}")
    dwx = torch.empty_like(gates)
    dc0, dn0, dh0 = (torch.empty_like(state[0]) for _ in range(3))
    _launch("repro_slstm_scan_bwd",
            [r.data_ptr(), *(t.data_ptr() for t in state[:3]), gates.data_ptr(),
             cs.data_ptr(), ns.data_ptr(), ms.data_ptr(), dhs.data_ptr(), dwx.data_ptr(),
             dc0.data_ptr(), dn0.data_ptr(), dh0.data_ptr()], B, S, H, dh, gates.dtype,
            gates.device)
    bwd_launches += 1
    return dwx, dc0, dn0, dh0


def slstm_scan_bwd(r, state, hs, saved, dhs, *, dstate=False):
    """The backward kernel, then dR as one product after the scan
    (``ref.slstm_dr``, a plain large matmul, as the reference leaves it to
    XLA). ``state``: the scan's start state; ``hs``: its output; ``saved``:
    what :func:`slstm_scan` returned with ``states=True``; dhs [B,S,H,dh]:
    hs's gradient, in its dtype. Returns (dwx [B,S,4d] in wx's dtype, dR
    [H,dh,4dh] in r's dtype, and with ``dstate`` the start state's
    gradient (dc, dn, dm, dh) float32, else None), as
    :func:`repro_torch.kernels.ref.slstm_scan_bwd`. Deterministic: equal
    inputs give equal bits."""
    dwx, dc0, dn0, dh0 = _bwd(r, state, hs, saved, dhs)
    dr = ref.slstm_dr(state[3], hs, dwx)
    if not dstate:
        return dwx, dr, None
    return dwx, dr, (dc0, dn0, dc0 * state[0] + dn0 * state[1], dh0)


class SLSTMScan(torch.autograd.Function):
    """:func:`slstm_scan` with its gradient from :func:`slstm_scan_bwd`: the
    forward launches the training variant and saves what it wrote with r,
    the start state and hs; the backward launches the backward kernel, then
    the dR product. With ``save`` False (a checkpoint's first pass, whose
    saved tensors the recompute replaces) the forward launches the serving
    kernel and saves placeholders of the same shapes and dtypes, one
    element each (the checkpoint compares their metadata with the
    recompute's). The final state takes no gradient (training discards it;
    it is marked non-differentiable); the start state takes one only when
    it requires it (the prefill's ``slstm_state0`` does not)."""

    @staticmethod
    def forward(ctx, wx, r, c, n, m, h, save=True):
        if save:
            hs, final, saved = slstm_scan(wx, r, (c, n, m, h), states=True)
        else:
            hs, final = slstm_scan(wx, r, (c, n, m, h))
            B, S, _ = wx.shape
            saved = (wx.new_empty(()).expand(wx.shape),
                     *(c.new_empty(()).expand(B, S, *c.shape[1:]) for _ in range(3)))
        ctx.save_for_backward(r, c, n, m, h, hs, *saved)
        ctx.mark_non_differentiable(*final)
        ctx.set_materialize_grads(False)  # no zeros filled for the final state's gradient
        return (hs, *final)

    @staticmethod
    def backward(ctx, dhs, *_dfinal):
        if dhs is None:  # hs took no gradient
            return (None,) * 7
        r, c, n, m, h, hs, *saved = ctx.saved_tensors
        dwx, dr, dst = slstm_scan_bwd(r, (c, n, m, h), hs, tuple(saved), dhs.contiguous(),
                                      dstate=any(ctx.needs_input_grad[2:6]))
        return (dwx, dr, *(dst or (None,) * 4), None)


def barrier(B: int, S: int, H: int, dh: int, device=None) -> None:
    """Launch S + 1 cluster barriers on the scan's grid (nothing else): the
    latency floor of an S-step scan, which ``chip_smoke.py`` times beside
    the kernel. Not a launch of the kernel: no count."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind(library, "repro_slstm_barrier")(B, S, H, dh, stream)
    build.check(rc, "repro_slstm_barrier")
