"""Checkpoint I/O engine: parallel, incremental, compressed shard files.

This subsystem is the data plane of the checkpoint writer/reader pair in
``ckpt.py`` / ``restore.py``.  The paper's Table 3 observation — "checkpoint
times follow image sizes" — means the only levers on checkpoint cost are
bytes written and write concurrency; this module provides both:

  * **shard container** — each rank persists one ``shards.bin`` (concatenated
    encoded chunks, streamed to disk chunk-by-chunk rather than materialising
    a monolithic ``npz`` in memory) plus one ``index.json`` describing every
    entry (dtype/shape/offset/chunks/codec/digest);
  * **codecs** — pluggable ``none`` / ``zlib`` / ``lz4`` byte codecs and an
    opt-in lossy ``int8`` codec (symmetric per-tensor quantization, meant
    for optimizer moments);
  * **digests** — cheap content hashes per shard, so an incremental
    checkpoint writes only dirty shards and points clean shards at the step
    that already holds their bytes (a flat delta chain);
  * **thread pools** — rank writes and shard reads fan out over a pool sized
    ``min(world_size, cpu)`` unless overridden.

Nothing here knows about torch or devices: inputs are ``{key: np.ndarray}``
dicts per rank, outputs are numpy arrays — which is exactly what keeps the
format topology-oblivious.  The on-disk format is the JAX package's byte for
byte, so either package restores the other's checkpoints.

**bfloat16 without ml_dtypes.**  A bfloat16 leaf travels as its ``uint16``
bits under :data:`BFLOAT16`, a ``uint16`` dtype whose metadata carries the
logical name.  :func:`dtype_name` reports ``"bfloat16"`` for it, so the entry's
``dtype`` / ``enc_dtype`` and the digest say ``bfloat16`` as the JAX
package's do, and the reader hands the bits back under the same tagged dtype
(the caller views them as ``torch.bfloat16``).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from repro_torch.core.faults import failpoint

FORMAT_VERSION = 2
DEFAULT_CHUNK_BYTES = 4 << 20        # 4 MiB raw per streamed chunk
BIN_NAME = "shards.bin"
INDEX_NAME = "index.json"


def atomic_write_text(path, text: str) -> None:
    """Crash-atomic text publish: write a sibling tmp file, fsync, then
    ``os.replace`` over the destination.  A kill mid-publish leaves either
    the old file or nothing — never a torn metadata file that makes a
    checkpoint LOOK complete (the failure class the chaos harness's
    corrupt/truncate faults exist to catch)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# dtype handling (bfloat16 travels as tagged uint16 bits)
# ---------------------------------------------------------------------------

#: bfloat16 as its bits: ``uint16`` with the logical name in the metadata.
#: numpy keeps the metadata through views, reshapes and copies; it compares
#: (and hashes) equal to plain ``uint16``, so the name is read from the
#: metadata, never through a dtype-keyed cache.
BFLOAT16 = np.dtype(np.uint16, metadata={"logical": "bfloat16"})
_LOGICAL = {"bfloat16": BFLOAT16}


def resolve_dtype(name: str) -> np.dtype:
    """``np.dtype(name)`` that also resolves ``"bfloat16"`` (to the tagged
    :data:`BFLOAT16` bits), which plain numpy rejects."""
    if name in _LOGICAL:
        return _LOGICAL[name]
    try:
        return np.dtype(name)
    except TypeError:
        raise TypeError(f"cannot resolve dtype name {name!r} "
                        f"(not a numpy dtype or bfloat16)") from None


_DTYPE_NAMES: dict = {}


def dtype_name(dt) -> str:
    """Stable round-trippable name for a dtype (``"bfloat16"`` for
    :data:`BFLOAT16`).  Cached: snapshot planning calls this once per leaf
    inside the checkpoint's blocking window, and a model has ~5 distinct
    dtypes."""
    md = getattr(dt, "metadata", None)
    if md and "logical" in md:
        return md["logical"]
    try:
        return _DTYPE_NAMES[dt]
    except (KeyError, TypeError):        # TypeError: unhashable dt
        name = str(np.dtype(dt))
        try:
            _DTYPE_NAMES[dt] = name
        except TypeError:
            pass
        return name


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits -> float32 values (exact)."""
    u = np.asarray(bits).view(np.uint16).astype(np.uint32) << 16
    return u.view(np.float32)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits under :data:`BFLOAT16`, rounding to nearest
    even and quieting NaNs (what ``astype(bfloat16)`` does in ml_dtypes)."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
    bits = np.where(np.isnan(x), (u >> 16) | np.uint32(0x40), rounded)
    return bits.astype(np.uint16).view(BFLOAT16).reshape(x.shape)


def is_float_dtype(dt) -> bool:
    """True for numpy floats AND bfloat16, whose bits are ``uint16``."""
    return "float" in dtype_name(dt)


def _digest_start(arr: np.ndarray):
    """sha256 over blake2b: OpenSSL rides SHA-NI at ~1.4 GB/s vs ~0.7 for
    blake2 — the digest pass is the incremental mode's per-checkpoint tax,
    so hash speed is write speed.  Dtype/shape-qualified so a reshape or
    cast never aliases."""
    h = hashlib.sha256()
    h.update(dtype_name(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    return h


def shard_digest(arr: np.ndarray) -> str:
    """Content digest of a host shard."""
    h = _digest_start(arr)
    h.update(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

class Codec:
    """Two-layer codec: an optional array transform (lossy codecs quantize
    here and record ``qmeta``) followed by a byte codec applied per chunk."""

    name = "none"
    lossy = False

    # -- array layer --------------------------------------------------------
    def transform(self, arr: np.ndarray):
        """arr -> (encoded_arr, qmeta|None). Lossless default: identity."""
        return arr, None

    def untransform(self, arr: np.ndarray, qmeta, dtype: np.dtype):
        return arr

    # -- byte layer ---------------------------------------------------------
    def encode_chunk(self, raw) -> bytes:
        return bytes(raw)

    def decode_chunk(self, enc: bytes, raw_len: int) -> bytes:
        return enc


class NoneCodec(Codec):
    name = "none"


class ZlibCodec(Codec):
    """Deflate with the Z_RLE strategy: on the data that actually passes the
    compressibility probe (zero-dominated optimizer moments, untouched
    embedding rows) RLE matches the default strategy's ratio at 3-4x the
    throughput (~150-200 MB/s vs ~50), which is what lets compression beat
    raw writes instead of trading CPU for bandwidth."""

    name = "zlib"

    def __init__(self, level: int = 1, strategy: int = zlib.Z_RLE):
        self.level = level
        self.strategy = strategy

    def encode_chunk(self, raw) -> bytes:
        co = zlib.compressobj(self.level, zlib.DEFLATED, 15, 9, self.strategy)
        # zlib takes buffer-protocol objects: no bytes() copy on the hot path
        return co.compress(raw) + co.flush()

    def decode_chunk(self, enc: bytes, raw_len: int) -> bytes:
        return zlib.decompress(enc)


class Lz4Codec(Codec):
    """lz4-frame byte codec; available only when the ``lz4`` package is
    importable (gated — never a hard dependency)."""

    name = "lz4"

    def __init__(self):
        try:
            import lz4.frame as _f
        except ImportError as e:
            raise ImportError(
                "codec 'lz4' requires the optional lz4 package; "
                "use 'zlib' or 'none' instead") from e
        self._f = _f

    def encode_chunk(self, raw) -> bytes:
        return self._f.compress(bytes(raw))

    def decode_chunk(self, enc: bytes, raw_len: int) -> bytes:
        return self._f.decompress(enc)


def quantize_int8_np(x):
    """Per-tensor symmetric int8 quantization on the host (the JAX package's
    ``optim.compress.quantize_int8_np``).  Returns (q, scale) with ``scale``
    a python float (json-able)."""
    xf = np.asarray(x, dtype=np.float32)
    scale = max(float(np.max(np.abs(xf))) if xf.size else 0.0, 1e-12) / 127.0
    q = np.clip(np.rint(xf / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8_np(q, scale):
    return np.asarray(q, dtype=np.float32) * scale


class Int8Codec(ZlibCodec):
    """Opt-in LOSSY codec for optimizer moments: per-tensor symmetric int8
    quantization + zlib over the int8 payload.  Non-float entries pass
    through lossless zlib untouched; bfloat16 bits are quantized by value."""

    name = "int8"
    lossy = True

    def transform(self, arr: np.ndarray):
        if arr.size == 0 or not is_float_dtype(arr.dtype):
            return arr, None     # integer / bool / empty entries stay lossless
        if dtype_name(arr.dtype) == "bfloat16":
            arr = bf16_bits_to_f32(arr)
        q, scale = quantize_int8_np(arr)
        return q, {"scale": scale}

    def untransform(self, arr: np.ndarray, qmeta, dtype: np.dtype):
        if qmeta is None:
            return arr
        x = dequantize_int8_np(arr, qmeta["scale"])
        if dtype_name(dtype) == "bfloat16":
            return f32_to_bf16_bits(x)
        return x.astype(dtype)


_CODECS = {
    "none": NoneCodec,
    "zlib": ZlibCodec,
    "lz4": Lz4Codec,
    "int8": Int8Codec,
}


def get_codec(name: str) -> Codec:
    if name not in _CODECS:
        raise KeyError(f"unknown checkpoint codec {name!r}; "
                       f"known: {sorted(_CODECS)}")
    return _CODECS[name]()


def register_codec(name: str, cls) -> None:
    _CODECS[name] = cls


# ---------------------------------------------------------------------------
# shard container: write
# ---------------------------------------------------------------------------

def _byte_view(arr: np.ndarray):
    arr = np.ascontiguousarray(arr)
    return arr.view(np.uint8).reshape(-1)


SAMPLE_BYTES = 16 << 10              # compressibility probe per entry
ENTROPY_THRESHOLD_BITS = 6.0         # byte entropy below this -> compress


def _worth_compressing(codec: Codec, view) -> bool:
    """Adaptive compression gate: raw float weights are mantissa noise on
    which zlib runs at ~20 MB/s for <10% savings, so compression must EARN
    its keep per entry.  A byte-entropy probe (~100us via bincount) decides:
    measured classes separate cleanly — zero pages / token ids sit at <=3.3
    bits/byte (zlib ratio 0.01-0.45 at 50-280 MB/s), float noise at >=7.1
    (ratio ~0.93 at 20 MB/s).  Entries that fail are stored raw (chunk flag
    1) — that is what keeps the 'compressed' engine strictly faster than the
    seed serial writer instead of trading write bandwidth for nothing."""
    if codec.name == "none":
        return False
    sample = view[:SAMPLE_BYTES]
    if sample.nbytes == 0:
        return False
    counts = np.bincount(sample, minlength=256)
    p = counts[counts > 0] / sample.size
    entropy_bits = float(-(p * np.log2(p)).sum())
    return entropy_bits < ENTROPY_THRESHOLD_BITS


class RankShardWriter:
    """Incremental writer for ONE rank's shard container.

    The pipelined snapshot path appends entries as D2H batches complete —
    from any pool thread, in any order (appends serialize on an internal
    lock and every entry records its own offset, so entry order in
    ``shards.bin`` is immaterial).  ``finish()`` publishes ``index.json``
    and returns the same stats dict as :func:`write_rank_shards`, which is
    now a one-shot convenience wrapper over this class.

    Each ``add`` encodes the entry chunk-by-chunk (transform -> probe ->
    encode-or-raw) outside the lock and appends under it, so memory
    high-water is one ENTRY's encoded chunks — a shard, never a rank
    image.  Chunk records are ``[enc_len, raw_len, stored_raw]``."""

    def __init__(self, rank_dir, codec: Codec,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        self.rank_dir = Path(rank_dir)
        self.rank_dir.mkdir(parents=True, exist_ok=True)
        self.codec = codec
        self.chunk_bytes = chunk_bytes
        self._f = open(self.rank_dir / BIN_NAME, "wb")
        self._lock = threading.Lock()
        self._offset = 0
        self.entries: dict[str, dict] = {}
        self.digests: dict[str, str] = {}
        self.raw_bytes = 0
        self.enc_bytes = 0

    def add(self, key: str, arr, digest: str | None = None,
            compute_digest: bool = False, kind: str = "array") -> str | None:
        """Append one entry.  ``digest`` records a known content digest;
        ``compute_digest`` hashes the entry inline while streaming — for
        lossless codecs the transform is the identity, so the chunk stream
        is the original bytes and the fused hash equals
        :func:`shard_digest` without a second memory pass.  (Callers must
        pre-compute digests for lossy codecs.)  ``kind`` tags non-parameter
        entries ("runtime": KV/recurrent caches, RNG streams) in the index;
        the default "array" is implicit and not stored, so legacy containers
        parse identically.  Returns the entry digest."""
        failpoint("ckpt_io.append", key=key, rank_dir=self.rank_dir)
        arr = np.asarray(arr)
        enc_arr, qmeta = self.codec.transform(arr)
        view = _byte_view(enc_arr)
        compress = _worth_compressing(self.codec, view)
        hasher = None
        if compute_digest and digest is None:
            if self.codec.lossy and qmeta is not None:
                raise ValueError("inline digests require a lossless "
                                 "stream; pre-compute for lossy codecs")
            hasher = _digest_start(arr)
        # hash + encode OUTSIDE the lock: pool threads appending different
        # batches to the same rank must not serialize on compression, only
        # on the file append itself.  Memory high-water becomes one ENTRY's
        # encoded chunks (a shard, not a rank image); uncompressed chunks
        # stay zero-copy views.
        chunks, enc_chunks = [], []
        for start in range(0, max(view.nbytes, 1), self.chunk_bytes):
            raw = view[start:start + self.chunk_bytes]
            if raw.nbytes == 0 and view.nbytes > 0:
                break
            if hasher is not None:
                hasher.update(raw)
            enc = self.codec.encode_chunk(raw) if compress else raw
            enc_chunks.append(enc)
            chunks.append([len(enc), raw.nbytes, 0 if compress else 1])
        if hasher is not None:
            digest = hasher.hexdigest()[:32]
        with self._lock:
            for enc in enc_chunks:
                self._f.write(enc)
                self.enc_bytes += len(enc)
            entry = {
                "dtype": dtype_name(arr.dtype),
                "shape": list(arr.shape),
                "enc_dtype": dtype_name(enc_arr.dtype),
                "offset": self._offset,
                "nbytes": int(view.nbytes),
                "chunks": chunks,
                "qmeta": qmeta,
                "digest": digest,
            }
            if kind != "array":
                entry["kind"] = kind
            self.entries[key] = entry
            self._offset += sum(c[0] for c in chunks)
            self.raw_bytes += arr.nbytes
            if digest is not None:
                self.digests[key] = digest
        return digest

    def finish(self) -> dict:
        with self._lock:
            if not self._f.closed:
                self._f.close()
        # tmp + os.replace: the index is the entry directory — published in
        # place, a kill mid-write leaves a container that parses as "no/few
        # entries" while shards.bin holds everything (silent data loss)
        atomic_write_text(self.rank_dir / INDEX_NAME, json.dumps({
            "format": FORMAT_VERSION, "codec": self.codec.name,
            "entries": self.entries}))
        return {"raw_bytes": self.raw_bytes, "enc_bytes": self.enc_bytes,
                "entries": self.entries, "digests": self.digests}

    def abort(self):
        """Release the file handle after a failed checkpoint (the half-
        written ``.tmp`` dir stays invisible to readers)."""
        with self._lock:
            if not self._f.closed:
                self._f.close()


def write_rank_shards(rank_dir, arrays: dict, codec: Codec,
                      chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                      digests: dict | None = None,
                      compute_digests: bool = False,
                      kinds: dict | None = None) -> dict:
    """Stream ``arrays`` ({key: np.ndarray}) into ``rank_dir/shards.bin`` +
    ``rank_dir/index.json`` in one shot (see :class:`RankShardWriter` for
    the streaming/digest semantics).  ``kinds`` optionally maps entry keys
    to a non-default kind tag (e.g. "runtime").  Returns {"raw_bytes",
    "enc_bytes", "entries", "digests"}."""
    digests = digests or {}
    kinds = kinds or {}
    w = RankShardWriter(rank_dir, codec, chunk_bytes)
    for key, arr in arrays.items():
        d = w.add(key, arr, digest=digests.get(key),
                  compute_digest=compute_digests,
                  kind=kinds.get(key, "array"))
        if d is not None:
            digests[key] = d
    st = w.finish()
    st["digests"] = digests
    return st


# ---------------------------------------------------------------------------
# shard container: read
# ---------------------------------------------------------------------------

def read_rank_index(rank_dir) -> dict:
    return json.loads((Path(rank_dir) / INDEX_NAME).read_text())


def _decode_entry(read_at, entry: dict, codec: Codec) -> np.ndarray:
    """Decode one entry given a positioned reader ``read_at(offset, n)``."""
    nbytes = entry["nbytes"]
    chunks = entry["chunks"]
    if len(chunks) == 1 and nbytes > 0:
        # single-chunk fast path: view the (pread/decompressed) bytes
        # directly — no staging buffer, no second memcpy.  The view is
        # read-only; every consumer either copies into a leaf slice or
        # hands it to device placement, which copies anyway.
        enc_len, raw_len = chunks[0][0], chunks[0][1]
        stored_raw = chunks[0][2] if len(chunks[0]) > 2 else 0
        enc = read_at(entry["offset"], enc_len)
        if len(enc) != enc_len:
            raise IOError(f"short read: wanted {enc_len} bytes, "
                          f"got {len(enc)}")
        raw = enc if stored_raw else codec.decode_chunk(enc, raw_len)
        buf = np.frombuffer(raw, np.uint8)
    else:
        buf = np.empty(nbytes, np.uint8)
        off = entry["offset"]
        pos = 0
        for chunk in chunks:
            enc_len, raw_len = chunk[0], chunk[1]
            stored_raw = chunk[2] if len(chunk) > 2 else 0
            enc = read_at(off, enc_len)
            if len(enc) != enc_len:
                raise IOError(f"short read: wanted {enc_len} bytes, "
                              f"got {len(enc)}")
            off += enc_len
            raw = enc if stored_raw else codec.decode_chunk(enc, raw_len)
            buf[pos:pos + raw_len] = np.frombuffer(raw, np.uint8)
            pos += raw_len
    enc_dtype = resolve_dtype(entry["enc_dtype"])
    arr = buf.view(enc_dtype).reshape(entry["shape"])
    dtype = resolve_dtype(entry["dtype"])
    arr = codec.untransform(arr, entry["qmeta"], dtype)
    if arr.dtype != dtype:
        arr = arr.astype(dtype)
    return arr.reshape(entry["shape"])


def read_entry(bin_file, entry: dict, codec: Codec) -> np.ndarray:
    """Decode one entry from an open ``shards.bin`` file object into an
    array of the entry's ORIGINAL dtype/shape.  The result may be a
    READ-ONLY view over the decoded bytes (single-chunk fast path) — copy
    before mutating in place."""
    def read_at(offset, n):
        bin_file.seek(offset)
        return bin_file.read(n)
    return _decode_entry(read_at, entry, codec)


class RankShardReader:
    """Thread-safe reader for ONE rank's shard container — the restore-side
    twin of :class:`RankShardWriter`.

    One file descriptor is shared by every pool worker: reads go through
    ``os.pread`` (positioned, no seek state), so the parallel restore engine
    can decode many entries of the same rank concurrently without per-task
    ``open()`` calls or fd-offset races.  Decompression (zlib) releases the
    GIL, which is where the parallel restore speedup comes from."""

    def __init__(self, rank_dir, codec: Codec | None = None):
        self.rank_dir = Path(rank_dir)
        self.index = read_rank_index(rank_dir)
        self.codec = codec or get_codec(self.index["codec"])
        self._fd = os.open(str(self.rank_dir / BIN_NAME), os.O_RDONLY)
        self._closed = False

    def entry(self, key: str) -> dict:
        return self.index["entries"][key]

    def read(self, key: str) -> np.ndarray:
        """Decode one entry (may return a read-only view — see
        :func:`read_entry`)."""
        return _decode_entry(lambda off, n: os.pread(self._fd, n, off),
                             self.entry(key), self.codec)

    def close(self):
        if not self._closed:
            self._closed = True
            os.close(self._fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MemoryShardReader:
    """:class:`RankShardReader`-compatible reader over an IN-MEMORY shard
    container (parsed ``index.json`` dict + raw ``shards.bin`` bytes) — the
    read side of the peer-replicated RAM checkpoint tier.

    The restore engine is oblivious to where a container lives: anything
    with ``index`` / ``entry`` / ``read`` / ``close`` duck-types as a rank
    reader, so the RAM tier plugs the SAME bytes a partner rank holds in
    memory straight into the parallel restore path with zero disk I/O.
    ``close()`` is a no-op — the tier owns the bytes' lifetime."""

    def __init__(self, index: dict, data, codec: Codec | None = None):
        self.index = index
        self.codec = codec or get_codec(index["codec"])
        self._data = memoryview(data)

    def entry(self, key: str) -> dict:
        return self.index["entries"][key]

    def read(self, key: str) -> np.ndarray:
        """Decode one entry (may return a read-only view — see
        :func:`read_entry`)."""
        return _decode_entry(lambda off, n: self._data[off:off + n],
                             self.entry(key), self.codec)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_rank_entries(rank_dir, keys, codec: Codec | None = None) -> dict:
    """Read a subset of entries from one rank dir; opens and closes the bin
    file exactly once. ``codec=None`` -> the codec recorded in the index.
    Arrays may be read-only views (see :func:`read_entry`)."""
    with RankShardReader(rank_dir, codec) as r:
        return {key: r.read(key) for key in keys}


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

def default_workers(world_size: int) -> int:
    return max(1, min(world_size, os.cpu_count() or 1))


class IOPool:
    """Tiny wrapper over ThreadPoolExecutor: maps a function over tasks and
    re-raises the first failure (checkpoint I/O must be all-or-nothing)."""

    def __init__(self, workers: int):
        self.workers = max(1, workers)
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="ckpt_io")

    def submit(self, fn, *args):
        """Single-task submit (the pipelined snapshot path enqueues batches
        one at a time as D2H completes); returns the future."""
        return self._pool.submit(fn, *args)

    def map(self, fn, items):
        futures = [self._pool.submit(fn, it) for it in items]
        results, first_error = [], None
        # drain EVERY future before raising: a failed checkpoint must not
        # leave straggler tasks still writing into a dir being torn down
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return results

    def close(self):
        self._pool.shutdown(wait=False)
