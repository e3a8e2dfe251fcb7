"""Pipelined device->host snapshot engine.

The paper's users feel the BLOCKING window of a checkpoint — the time ranks
are quiesced and images captured — not the background write (MANA, arXiv
1904.12595; NERSC follow-up, arXiv 2103.08546).  This module owns the
blocking half and keeps it short:

  * ``plan_snapshot`` enumerates every leaf in ONE pass over the tree as
    lightweight work items — no host copies yet.  The port runs on one
    device, so every leaf is one rank-0 shard, as a meshless run of the JAX
    package plans it;
  * items are grouped into RANK-ALIGNED batches of ``batch_bytes`` raw
    bytes (``snapshot_batch_mb`` knob);
  * on the card, a side stream first waits on the current stream, then
    issues one ``non_blocking`` copy per leaf into pinned host memory and
    records a CUDA event per batch; every copy is in flight before the
    first batch is waited on.  CPU tensors and numpy leaves are copied
    synchronously into the same arena;
  * each batch, once its event has completed, is handed STRAIGHT to the
    ``ckpt_io`` writer pool, which digests/compresses/writes it from the
    arena after the window closes;
  * the blocking window closes when the LAST batch's event has completed.

Why the copy must finish inside the window: the port's decode writes each
step's K/V row into the caches IN PLACE (``models/layers.py``), so a copy
still in flight when the next decode step starts would tear the snapshot.

Arena semantics: a pair of reusable host arenas, each holding a whole
snapshot.  A snapshot takes a free arena for itself and keeps it until its
last sink has read its bytes (the lock discipline of the JAX package's
pair: a buffer is never refilled while a writer still reads it).  If both
arenas are busy the snapshot lands in a transient buffer instead of
stalling the caller; spills are counted in the run stats.  Arenas grow to
the high-water snapshot size once and are then reused across checkpoints;
on the card they are pinned, so the copies are true asynchronous DMA.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import ckpt_io
from repro_torch.core.faults import failpoint
from repro_torch.models.params import tree_leaves

DEFAULT_BATCH_MB = 8.0
_MIN_BATCH_BYTES = 64 << 10
_ALIGN = 64                      # arena regions start on 64 bytes

_NP_OF_TORCH = {
    torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
    torch.float16: np.dtype(np.float16), torch.bfloat16: ckpt_io.BFLOAT16,
    torch.int8: np.dtype(np.int8), torch.uint8: np.dtype(np.uint8),
    torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.bool: np.dtype(np.bool_),
    torch.uint16: np.dtype(np.uint16), torch.uint32: np.dtype(np.uint32),
    torch.uint64: np.dtype(np.uint64),
}
_TORCH_OF_NAME = {ckpt_io.dtype_name(v): k for k, v in _NP_OF_TORCH.items()}


def host_dtype(leaf) -> np.dtype:
    """The numpy dtype a leaf lands in on the host (bfloat16 tensors as
    :data:`ckpt_io.BFLOAT16` bits)."""
    if isinstance(leaf, torch.Tensor):
        return _NP_OF_TORCH[leaf.dtype]
    return np.asarray(leaf).dtype


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype for a host dtype (:data:`ckpt_io.BFLOAT16` bits ->
    ``torch.bfloat16``)."""
    return _TORCH_OF_NAME[ckpt_io.dtype_name(np_dtype)]


@dataclass
class ShardItem:
    """One owned shard: where it belongs in the checkpoint + the (still
    device-resident) tensor or host array that backs it."""
    rank: int
    key: str                     # "<leaf_idx>.<shard_idx>"
    index: list                  # [[start, stop], ...] into the global leaf
    data: Any                    # torch.Tensor or np.ndarray
    nbytes: int
    leaf: int


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def plan_snapshot(tree):
    """Single planning pass over the tree (leaves in the JAX package's
    flatten order).

    Returns ``(leaves_meta, items)``: the manifest leaf descriptions (shard
    entries carry (rank, key, index); the writer fills in (step, file) once
    it knows where the bytes land) and the flat work-item list.  The port
    runs on one device: every leaf is one rank-0 shard."""
    leaves_meta: list[dict] = []
    items: list[ShardItem] = []
    dtype_name = ckpt_io.dtype_name       # hot loop: skip attribute lookups
    for li, leaf in enumerate(tree_leaves(tree)):
        shape = [int(s) for s in leaf.shape]
        key = f"{li}.0"
        index = [[0, s] for s in shape]
        leaves_meta.append({"shape": shape,
                            "dtype": dtype_name(host_dtype(leaf)),
                            "shards": [{"rank": 0, "key": key,
                                        "index": index}]})
        items.append(ShardItem(0, key, index, leaf, _nbytes(leaf), li))
    return leaves_meta, items


def batch_plan(items, batch_bytes: int):
    """Group work items into rank-aligned batches of ~``batch_bytes`` raw
    bytes.  Rank alignment lets each batch stream into exactly one rank's
    shard container; a single oversized shard still forms its own batch."""
    batch_bytes = max(int(batch_bytes), _MIN_BATCH_BYTES)
    by_rank: dict[int, list] = {}
    for it in items:
        by_rank.setdefault(it.rank, []).append(it)
    batches: list[tuple[int, list]] = []
    for rank, its in by_rank.items():
        cur, size = [], 0
        for it in its:
            cur.append(it)
            size += it.nbytes
            if size >= batch_bytes:
                batches.append((rank, cur))
                cur, size = [], 0
        if cur:
            batches.append((rank, cur))
    return batches


class HostArena:
    """One reusable host landing zone (half of the pair): a byte buffer that
    grows to the high-water snapshot size and is reused forever — pinned
    when the snapshot comes off the card.  Acquisition is lock-based and
    atomic (``try_acquire``); the holder releases it once every writer has
    read its bytes."""

    def __init__(self):
        self._buf = torch.empty(0, dtype=torch.uint8)
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        return self._lock.acquire(blocking=False)

    def reserve(self, nbytes: int, pinned: bool) -> torch.Tensor:
        if self._buf.numel() < nbytes or (pinned and not self._buf.is_pinned()):
            self._buf = _host_buffer(nbytes, pinned)
        return self._buf

    def release(self):
        self._lock.release()


def _host_buffer(nbytes: int, pinned: bool) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    """The copy stream of ``device``, made once.  It carries the snapshot's
    device-to-host copies and nothing else: no decode kernel is ever
    launched on it, because the decode kernels' ticket counters are one
    buffer per device (``kernels/decode_attention.py``) and two streams
    decoding at once would share them."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    s = _SIDE_STREAMS.get(idx)
    if s is None:
        s = _SIDE_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


def arena_layout(items):
    """Byte offset of each item in the arena (64-byte aligned) and the
    total size.  The restore stages into the same layout
    (``restore._place_tree``), so a snapshot of the tree it restored fits
    the arena."""
    offs, off = [], 0
    for it in items:
        offs.append(off)
        off += -(-it.nbytes // _ALIGN) * _ALIGN
    return offs, off


def _host_view(buf: torch.Tensor, off: int, it: ShardItem) -> np.ndarray:
    """The item's bytes in the arena as a numpy array of its host dtype and
    shape (0-d leaves stay 0-d)."""
    dt = host_dtype(it.data)
    return buf[off:off + it.nbytes].numpy().view(dt).reshape(
        tuple(int(s) for s in it.data.shape))


def _copy_in(buf: torch.Tensor, off: int, it: ShardItem) -> None:
    """Issue the copy of one item into its arena region.  A CUDA tensor's
    copy is ``non_blocking`` on the current (side) stream; anything on the
    host is copied now."""
    src = it.data
    if isinstance(src, torch.Tensor):
        dst = buf[off:off + it.nbytes].view(src.dtype).view(src.shape)
        dst.copy_(src.detach(), non_blocking=src.is_cuda)
    else:
        np.copyto(_host_view(buf, off, it), np.asarray(src))


class SnapshotPipeline:
    """Drives one pipelined snapshot over a writer pool.

    ``run(items, sink)`` copies rank-aligned batches into an arena (or a
    spill buffer) and submits ``sink(rank, batch_items, host_views)`` to
    the pool for each batch whose copies have completed; it returns once
    the last batch's copies are done and it is enqueued, with the futures
    plus a timing/stat breakdown and a ``release`` callable the caller MUST
    invoke once its blocking window closes (sinks hold until then; a 60 s
    backstop prevents a forgotten release from wedging the pool).  The sink
    is called on pool threads — it must be thread-safe across ranks."""

    def __init__(self, pool: ckpt_io.IOPool, *,
                 batch_bytes: int = int(DEFAULT_BATCH_MB * (1 << 20)),
                 arenas: tuple | None = None):
        self.pool = pool
        self.batch_bytes = batch_bytes
        self.arenas = arenas if arenas is not None else (HostArena(),
                                                         HostArena())

    def _take_arena(self):
        for cand in self.arenas:
            if cand.try_acquire():
                return cand
        return None

    def run(self, items, sink: Callable) -> dict:
        batches = batch_plan(items, self.batch_bytes)
        ordered = [it for _, its in batches for it in its]
        offs, total = arena_layout(ordered)
        off_of = {id(it): o for it, o in zip(ordered, offs)}
        dev = next((it.data.device for it in ordered
                    if isinstance(it.data, torch.Tensor) and it.data.is_cuda), None)
        counters = {"spills": 0}
        arena = self._take_arena()
        if arena is None:        # both arenas still read by writers: spill
            counters["spills"] += 1
            buf = _host_buffer(total, dev is not None)
        else:
            buf = arena.reserve(total, dev is not None)
        # sinks hold until the caller releases them: encode/digest/IO would
        # otherwise steal cycles from the still-open blocking window.
        window_closed = threading.Event()
        remaining = [len(batches)]
        rlock = threading.Lock()
        if not batches and arena is not None:
            arena.release()

        def _done_reading():
            with rlock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last and arena is not None:
                arena.release()

        side = _side_stream(dev) if dev is not None else None
        futures, events = [], []
        t_get = t_submit = 0.0
        try:
            t0 = time.perf_counter()
            if side is not None:
                # the copies read what the current stream last wrote
                side.wait_stream(torch.cuda.current_stream(dev))
            ctx = torch.cuda.stream(side) if side is not None \
                else contextlib.nullcontext()
            with ctx:
                for bi, (rank, its) in enumerate(batches):
                    # chaos-harness injection site: a raise here fails the
                    # checkpoint INSIDE its blocking window, mid-batch
                    failpoint("ckpt.snapshot_batch", rank=rank, batch=bi)
                    for it in its:
                        _copy_in(buf, off_of[id(it)], it)
                    if side is not None:
                        ev = torch.cuda.Event()
                        ev.record(side)
                        events.append(ev)
            t_get += time.perf_counter() - t0
            for bi, (rank, its) in enumerate(batches):
                t0 = time.perf_counter()
                if events:
                    events[bi].synchronize()
                views = [_host_view(buf, off_of[id(it)], it) for it in its]
                t_get += time.perf_counter() - t0

                def task(rank=rank, its=its, views=views):
                    window_closed.wait(timeout=60.0)
                    try:
                        sink(rank, its, views)
                    finally:
                        _done_reading()

                t0 = time.perf_counter()
                futures.append(self.pool.submit(task))
                t_submit += time.perf_counter() - t0
        except BaseException:
            # fail CLEAN: no copy may still be writing into the arena, the
            # already-enqueued sinks are drained so the caller can abort
            # its writers without racing in-flight appends, and the arena
            # goes back to the pair
            if side is not None:
                side.synchronize()
            window_closed.set()
            for f in futures:
                try:
                    f.result(timeout=35.0)
                except BaseException:  # noqa: BLE001 — best-effort drain
                    pass
            # a batch was never submitted, so no reader will release it
            if arena is not None and batches:
                arena.release()
            raise
        return {"futures": futures,
                "release": window_closed.set,
                "batches": len(batches),
                "bytes": sum(it.nbytes for it in ordered),
                "counters": counters,
                "snapshot_ms": round(t_get * 1e3, 3),
                "enqueue_ms": round(t_submit * 1e3, 3)}
