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
strided view of the fleet's stacked store); the output ``[B,H,Dv]``.

The bf16 kernel's plan is mirrored here (:func:`row_plan`,
:func:`launch_plan`; ``tests/test_torch_latent_route.py`` holds it to the
source's constants and checks its properties): a row of length L is cut
into :func:`n_spans` spans of whole ``CHUNK``\\ s and its heads into tiles of
``TILE``; an item is a (row, span, head tile) and writes an unnormalised
partial, and once a (row, tile) has all of its spans' partials (a ticket
counter from :func:`decode_attention.counters`, shared with the split-KV
decode) each item's block combines its own slice of the tile's outputs in
span order. The plan depends on L alone, so the paged form over in-order
pages gives the contiguous form's bits, a B = 1 lane a batched row's, and
a cache or table wider than the length the exact fit's. The float32
kernel keeps one block a (row, CHUNK) and the last block's combine.
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
#: the shared library whose C entries the wrappers launch: None for the one
#: built from ``csrc/latent_decode_attention.cu``; the path of another build
#: of it (``tools/latent_breakdown.py``: diagnostic macros, another tree's
#: source) runs that one
library = None

DK, DV = 288, 256    # the built shape: minicpm3-4b's r + rope and r
MAX_H = 48           # query heads a launch takes (``HMAX`` in the source)
CHUNK = 64           # positions a block stages at once; spans are whole chunks
NSMAX = 32           # spans a row is cut into at most
TILE = 16            # query heads an item takes (``HT``)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_longlong


@functools.cache
def _bind(path, entry):
    lib = build.load("latent_decode_attention") if path is None else ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    if entry == "repro_latent_wave":
        fn.argtypes = [ctypes.c_int]
    elif entry.startswith("repro_paged"):
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [_I64] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# -- the plan (the source's n_chunks, span_chunks, n_spans, span_slots) -------

def n_chunks(positions: int) -> int:
    """Chunks of ``CHUNK`` positions over ``positions``."""
    return -(-positions // CHUNK)


def span_chunks(L: int) -> int:
    """Chunks a span of a row of length L takes: as few as keep the spans
    at most ``NSMAX``."""
    return -(-n_chunks(L) // NSMAX) if n_chunks(L) > NSMAX else 1


def n_spans(L: int) -> int:
    """Spans of a row of length L; a row of no position is one span, which
    writes zeros."""
    return 1 if L < 1 else -(-n_chunks(L) // span_chunks(L))


def span_slots(positions: int) -> int:
    """Partial slots a (row, head tile) keeps over ``positions`` cache
    positions: at least :func:`n_spans` of every length up to them."""
    return min(max(n_chunks(positions), 1), NSMAX)


def n_tiles(H: int) -> int:
    """Head tiles of ``TILE`` over H query heads."""
    return -(-H // TILE)


def row_plan(L: int, H: int) -> list[dict]:
    """The items of a row of length L at H heads, in span order then tile
    order: each its span ``s`` and tile ``t``, the positions ``[j0, j1)`` it
    stages and computes, whether it writes the output ``direct``\\ ly (one
    span), and the (head, 4-column piece) slice ``[pc0, pc1)`` of its tile's
    outputs it combines (``None`` when direct), where piece ``pc`` is head
    ``pc // (DV // 4)`` of the tile, columns ``4 (pc % (DV // 4))`` on."""
    ns, span = n_spans(L), span_chunks(L) * CHUNK
    items = []
    for s in range(ns):
        for t in range(n_tiles(H)):
            pieces = min(TILE, H - TILE * t) * (DV // 4)
            items.append({"s": s, "t": t, "j0": min(s * span, L), "j1": min((s + 1) * span, L),
                          "direct": ns == 1,
                          "slice": None if ns == 1 else (s * pieces // ns, (s + 1) * pieces // ns)})
    return items


def launch_plan(lengths, H: int, n_slot: int, wave: int) -> dict:
    """A launch's grid and each block's walk as the kernel runs them: items
    ``i = ((b n_slot) + s) n_tiles + t`` for each row b of ``lengths`` and
    span slot s < ``n_slot``, a grid of ``min(items, wave)`` blocks, block k
    taking items k, k + grid, ...: first each live item's products
    (``compute``, in walk order), then each live item's combine
    (``combine``, items of rows of more than one span). Returns ``grid``,
    ``compute`` and ``combine`` (a list a block of (b, s, t))."""
    n_t = n_tiles(H)
    n_items = len(lengths) * n_slot * n_t
    grid = min(n_items, wave)
    compute = [[] for _ in range(grid)]
    combine = [[] for _ in range(grid)]
    for k in range(grid):
        for i in range(k, n_items, grid):
            b, s, t = i // (n_slot * n_t), i // n_t % n_slot, i % n_t
            ns = n_spans(int(lengths[b]))
            if s < ns:
                compute[k].append((b, s, t))
                if ns > 1:
                    combine[k].append((b, s, t))
    return {"grid": grid, "compute": compute, "combine": combine}


def scratch_sizes(dtype, B: int, H: int, positions: int, exact: bool) -> tuple[int, int, int]:
    """Float32 elements of a launch's partial outputs and (m, l), and its
    int32 ticket counters, over ``positions`` cache positions: each row's
    length when ``exact`` (the contiguous form), else a capacity (the
    paged one). bf16: ``[B, n_tiles, slots, TILE, DV]`` and ``[2, B,
    n_tiles, slots, TILE]``, slots :func:`n_spans` (exact) or
    :func:`span_slots`, a counter a (row, tile); float32: ``[B, n, H, DV]``
    and ``[2, B, n, H]``, n :func:`n_chunks`, a counter a row."""
    if dtype == torch.bfloat16:
        n = B * n_tiles(H) * (n_spans(positions) if exact else span_slots(positions)) * TILE
        return n * DV, 2 * n, B * n_tiles(H)
    n = B * n_chunks(positions) * H
    return n * DV, 2 * n, B


def wave(device=None, paged: bool = False) -> int:
    """Blocks of the bf16 kernel the card holds at once (its resident
    blocks an SM times the SMs): the most a launch's grid takes."""
    with torch.cuda.device(device):
        n = _bind(library, "repro_latent_wave")(int(paged))
    build.check(-n if n < 0 else 0, "repro_latent_wave")
    return n


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


def _launch(entry, q, lat, positions, exact, *args):
    B, H = q.shape[:2]
    o = q.new_empty((B, H, DV))
    n_o, n_ml, n_cnt = scratch_sizes(q.dtype, B, H, positions, exact)
    part_o = torch.empty(n_o, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(n_ml, dtype=torch.float32, device=q.device)
    cnt = counters(q.device, n_cnt)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind(library, entry)(q.data_ptr(), lat.data_ptr(), o.data_ptr(), part_o.data_ptr(),
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
    o = _launch("repro_latent_decode_attention", q, lat, length, True, B, H, S, length, DK,
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
    o = _launch("repro_paged_latent_decode_attention", q, lat_pages, n_tab * page, False,
                page_table.data_ptr(), lengths.data_ptr(), B, H, n_tab, page, page_stride,
                row_stride, DK, DV, float(scale))
    paged_launches += 1
    return o
