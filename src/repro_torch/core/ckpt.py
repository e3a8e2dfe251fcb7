"""Transparent checkpoint writer: per-rank images of the UPPER HALF only.

Image contents per rank (mirroring MANA's checkpoint image, but logical rather
than a raw memory dump — which is what buys topology-oblivious elastic
restart):
  * the rank's shards of every array leaf (params, optimizer state, caches),
  * the vid-table snapshot + record-replay log (from Mana.snapshot()),
  * drained in-flight messages,
  * data-iterator state, RNG key, step counter.

Writes are asynchronous and PIPELINED: the blocking window covers only the
batched device->host transfer (``ckpt_pipeline``: rank-aligned batches copied
on a side stream into a reusable pinned arena, each handed to the ``ckpt_io``
writer pool the moment its copies complete), and the caller resumes as soon
as the last batch is enqueued.  Digesting, compression, file I/O, manifest
assembly and the COMMIT marker all happen behind the trainer's back;
per-rank write durations are recorded for straggler analysis.  The pipelined
snapshot is the only one: nothing else may copy a cache after the window
closes, since the decode writes the caches in place.

Array trees are nested dicts/lists of torch tensors (or numpy arrays),
flattened in the JAX package's order, so both packages write the same
container for the same values.  The data plane (chunked shard container,
codecs, digests) lives in ``repro_torch.core.ckpt_io``; the blocking-path
plane (snapshot planning, batching, arenas) in
``repro_torch.core.ckpt_pipeline``; this module owns the control plane:
full-vs-delta policy, manifest assembly, atomic publish, and GC that never
deletes a step a live delta chain depends on (see docs/checkpoint_format.md)."""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

from repro_torch.core import ckpt_io, ckpt_pipeline
from repro_torch.models.params import tree_leaves


def runtime_leaf_indices(arrays) -> frozenset:
    """Flattened-leaf indices of the conventional top-level ``"runtime"``
    subtree (``repro_torch.core.runtime_state``).  These leaves are
    bit-for-bit ordinary array entries — same delta digests, codecs — but
    the container index and manifest tag them ``kind="runtime"`` so tooling
    can tell live state from params.  Dict keys flatten sorted, so the
    runtime leaves follow every leaf of the keys sorting before it."""
    if not isinstance(arrays, dict) or "runtime" not in arrays:
        return frozenset()
    start = sum(len(tree_leaves(arrays[k])) for k in arrays if k < "runtime")
    return frozenset(range(start, start + len(tree_leaves(arrays["runtime"]))))


class CheckpointRequest:
    """Async handle for an in-flight checkpoint (a REQUEST-kind object: the
    drain protocol completes it before the next snapshot).  ``timings``
    carries the stop-the-world breakdown in milliseconds — drain_ms /
    snapshot_ms / enqueue_ms / blocking_ms filled at call time (with
    device_copy_ms and host_copy_ms, which overlap within snapshot_ms),
    persist_ms once the background write commits."""

    def __init__(self, directory: Path):
        self.directory = directory
        self.done = threading.Event()
        self.error = None
        self.error_delivered = False  # wait() raised it to SOME caller
        self.write_stats: dict = {}
        self.timings: dict = {}
        self.release = lambda: None   # pipelined: opens the sink floodgates

    def wait(self, timeout=120.0):
        if not self.done.wait(timeout):
            raise TimeoutError(f"checkpoint {self.directory} did not complete")
        if self.error:
            self.error_delivered = True
            raise self.error
        return self.write_stats


class CheckpointWriter:
    """Pipelined async writer over the parallel/incremental/compressed
    ckpt_io engine.  At most one checkpoint is in flight; a new checkpoint()
    drains the previous one first.

    Args beyond the seed writer:
      codec             — "none" | "zlib" | "lz4" | "int8" (lossy, opt-in)
      incremental       — write only shards whose content digest changed,
                          with a full checkpoint every ``keep``-th
      io_workers        — writer/reader pool size; 0 -> min(world_size, cpu)
      chunk_bytes       — raw bytes per streamed chunk
      snapshot_batch_mb — raw MB per batch of device-to-host copies"""

    def __init__(self, base_dir, world_size: int, keep: int = 3, *,
                 codec: str = "none", incremental: bool = False,
                 io_workers: int = 0,
                 chunk_bytes: int = ckpt_io.DEFAULT_CHUNK_BYTES,
                 snapshot_batch_mb: float = ckpt_pipeline.DEFAULT_BATCH_MB):
        self.base = Path(base_dir)
        self.base.mkdir(parents=True, exist_ok=True)
        self.world_size = world_size
        self.keep = keep
        self.codec_name = codec
        self.codec = ckpt_io.get_codec(codec)
        self.incremental = incremental
        self.chunk_bytes = chunk_bytes
        self.io_workers = io_workers or ckpt_io.default_workers(world_size)
        self.snapshot_batch_bytes = int(snapshot_batch_mb * (1 << 20))
        # the double-buffered arena pair is shared across checkpoints (and
        # stages the restore's copies to the card, ``Cluster.restart``) so
        # the steady state never reallocates pinned host memory
        self.arenas = (ckpt_pipeline.HostArena(), ckpt_pipeline.HostArena())
        self._pool: ckpt_io.IOPool | None = None
        self._inflight: CheckpointRequest | None = None
        # (rank:key) -> {"digest", "step", "file"}: where each shard's bytes
        # currently live on disk.  Only mutated after a successful COMMIT, so
        # a failed write can never poison delta decisions.
        self._digest_table: dict[str, dict] = {}
        self._since_full = 0
        #: optional hook ``cb(committed_step_dir)`` invoked right after an
        #: image commits (rename + GC done) — the RAM replica tier latches
        #: onto this to learn which dirs to push.  Runs on the finalize
        #: thread; exceptions are swallowed (tier bookkeeping must never
        #: fail a committed checkpoint).
        self.on_commit = None

    def _get_pool(self) -> ckpt_io.IOPool:
        if self._pool is None:
            self._pool = ckpt_io.IOPool(self.io_workers)
        return self._pool

    def checkpoint(self, step: int, arrays, mesh, rank_states: dict,
                   extra_meta: dict | None = None, *,
                   defer_release: bool = False) -> CheckpointRequest:
        """arrays: tree of tensors / host arrays; ``mesh`` must be None (the
        port runs on one device; the argument keeps the JAX package's call
        shape); rank_states: {rank: json-able dict}
        (each rank's Mana.snapshot() + iterator/rng state).

        ``defer_release=True`` hands the sink floodgate to
        the caller as ``req.release`` so the last scrap of blocking-path
        bookkeeping above this layer can finish before background encode
        starts contending for the GIL; the caller MUST invoke it."""
        if mesh is not None:
            raise ValueError("the port runs on one device: pass mesh=None")
        if self._inflight is not None:
            self._inflight.wait()
        tdir = self.base / f"step_{step:08d}.tmp"
        fdir = self.base / f"step_{step:08d}"
        if tdir.exists():
            shutil.rmtree(tdir)
        full = (not self.incremental or not self._digest_table
                or self._since_full >= self.keep)
        req = CheckpointRequest(fdir)
        rt_leaves = runtime_leaf_indices(arrays)
        self._checkpoint_pipelined(step, arrays, rank_states, extra_meta,
                                   tdir, fdir, full, req, rt_leaves)
        if not defer_release:
            req.release()
        self._inflight = req
        return req

    # -- pipelined path ------------------------------------------------------
    def _checkpoint_pipelined(self, step, arrays, rank_states,
                              extra_meta, tdir, fdir, full, req,
                              rt_leaves=frozenset()):
        """Blocking work = plan + batched D2H + enqueue.  Everything else —
        digest/delta decisions, compression, file writes, manifest, COMMIT —
        runs on the pool + a finalize thread while training continues."""
        leaves_meta, items = ckpt_pipeline.plan_snapshot(arrays)
        for li in rt_leaves:
            leaves_meta[li]["kind"] = "runtime"
        pool = self._get_pool()
        lossy = self.codec.lossy
        writers: dict[int, ckpt_io.RankShardWriter] = {}
        wlock = threading.Lock()
        per_rank = {r: {"keys": [], "digests": {}, "fresh": set(),
                        "raw_bytes": 0, "seconds": 0.0,
                        "lock": threading.Lock()}
                    for r in range(self.world_size)}

        def _writer_for(rank):
            with wlock:
                w = writers.get(rank)
                if w is None:
                    w = writers[rank] = ckpt_io.RankShardWriter(
                        tdir / f"rank{rank:05d}", self.codec,
                        self.chunk_bytes)
                return w

        def sink(rank, its, views):
            """Consume one landed batch: per-shard delta decision + append
            into the rank's shard container.  Runs on pool threads."""
            t1 = time.perf_counter()
            w = _writer_for(rank)
            out = []
            for it, view in zip(its, views):
                digest, fresh = None, True
                if self.incremental:
                    if lossy or not full:
                        digest = ckpt_io.shard_digest(view)
                    if not full:
                        prev = self._digest_table.get(
                            f"{rank}:{it.key}", {}).get("digest")
                        fresh = prev != digest
                if fresh:
                    digest = w.add(it.key, view, digest=digest,
                                   compute_digest=self.incremental
                                   and not lossy,
                                   kind="runtime"
                                   if int(it.key.split(".", 1)[0]) in rt_leaves
                                   else "array")
                out.append((it, digest, fresh))
            pr = per_rank[rank]
            with pr["lock"]:
                for it, digest, fresh in out:
                    pr["keys"].append(it.key)
                    pr["raw_bytes"] += it.nbytes
                    if digest is not None:
                        pr["digests"][it.key] = digest
                    if fresh:
                        pr["fresh"].add(it.key)
                pr["seconds"] += time.perf_counter() - t1

        pipe = ckpt_pipeline.SnapshotPipeline(
            pool, batch_bytes=self.snapshot_batch_bytes, arenas=self.arenas)
        try:
            res = pipe.run(items, sink)
        except BaseException as e:       # noqa: BLE001 — incl. injected faults
            # a fault mid-snapshot (e.g. the ckpt.snapshot_batch failpoint)
            # must not leave the writer wedged: run() has already drained the
            # sinks it submitted, so the container handles can be released
            # and the request marked failed before the error propagates to
            # the supervisor
            for w in writers.values():
                w.abort()
            req.error = e
            req.done.set()
            raise
        req.timings["snapshot_ms"] = res["snapshot_ms"]
        req.timings["enqueue_ms"] = res["enqueue_ms"]
        # within snapshot_ms, overlapping: the device leaves' copies on the
        # side stream (CUDA events) and the host leaves' copies into the arena
        req.timings["device_copy_ms"] = res["device_copy_ms"]
        req.timings["host_copy_ms"] = res["host_copy_ms"]
        req.write_stats["device_to_host_s"] = round(
            res["snapshot_ms"] / 1e3, 4)
        req.write_stats["snapshot_batches"] = res["batches"]

        def _finalize():
            try:
                t_write = time.time()
                first_err = None
                for f in res["futures"]:
                    try:
                        f.result()
                    except BaseException as e:  # noqa: BLE001
                        if first_err is None:
                            first_err = e
                if first_err is not None:
                    raise first_err
                # stable once every sink future has resolved
                req.write_stats["arena_spills"] = res["counters"]["spills"]
                results = []
                for r in range(self.world_size):
                    st = _writer_for(r).finish()   # ranks w/o shards: empty
                    ckpt_io.atomic_write_text(
                        tdir / f"rank{r:05d}" / "state.json",
                        json.dumps(rank_states.get(r, {})))
                    pr = per_rank[r]
                    results.append({"rank": r, "keys": pr["keys"],
                                    "digests": pr["digests"],
                                    "fresh": pr["fresh"],
                                    "enc_bytes": st["enc_bytes"],
                                    "fresh_raw_bytes": st["raw_bytes"],
                                    "raw_bytes": pr["raw_bytes"],
                                    "seconds": round(pr["seconds"], 4)})
                self._publish(step, leaves_meta, results, full,
                              extra_meta, tdir, fdir, req, t_write)
            except Exception as e:  # noqa: BLE001
                req.error = e
                for w in writers.values():
                    w.abort()
            finally:
                req.done.set()

        # finalize rides the pool rather than a fresh thread (spawn is
        # blocking-window cost): sinks were submitted first, so FIFO order
        # guarantees they schedule before the finalize task that awaits them
        pool.submit(_finalize)
        req.release = res["release"]

    # -- publish tail -------------------------------------------------
    def _publish(self, step, leaves_meta, results, full, extra_meta,
                 tdir, fdir, req, t_write):
        """Resolve shard locations, assemble the manifest, COMMIT, atomically
        publish, roll the digest table forward, GC.  Runs on the background
        finalize thread."""
        new_table: dict[str, dict] = {}
        src: dict[tuple, dict] = {}
        for r in results:
            rank = r["rank"]
            rfile = f"rank{rank:05d}/{ckpt_io.BIN_NAME}"
            for k in r["keys"]:
                tk = f"{rank}:{k}"
                if k in r["fresh"]:
                    ent = {"digest": r["digests"].get(k),
                           "step": step, "file": rfile}
                else:
                    ent = dict(self._digest_table[tk])
                new_table[tk] = ent
                src[(rank, k)] = ent
        for meta in leaves_meta:
            for sh in meta["shards"]:
                ent = src[(sh["rank"], sh["key"])]
                sh["step"] = ent["step"]
                sh["file"] = ent["file"]
        base_steps = sorted({sh["step"] for meta in leaves_meta
                             for sh in meta["shards"]} - {step})
        total = sum(r["raw_bytes"] for r in results)
        written = sum(r["enc_bytes"] for r in results)
        fresh_shards = sum(len(r["fresh"]) for r in results)
        total_shards = sum(len(r["digests"]) for r in results)
        per_rank_s = {r["rank"]: r["seconds"] for r in results}
        manifest = {
            "format": ckpt_io.FORMAT_VERSION,
            "step": step,
            "world_size": self.world_size,
            "mesh": None,              # one device: no mesh to record
            "leaves": leaves_meta,
            "codec": self.codec_name,
            "incremental": self.incremental,
            "full": full,
            "base_steps": base_steps,
            "bytes_total": total,
            "bytes_written": written,
            "delta": {"fresh_shards": fresh_shards,
                      "total_shards": total_shards},
            "per_rank_write_s": per_rank_s,
            "straggler_rank": max(per_rank_s, key=per_rank_s.get)
            if per_rank_s else 0,
            **(extra_meta or {}),
        }
        ckpt_io.atomic_write_text(tdir / "manifest.json",
                                  json.dumps(manifest))
        ckpt_io.atomic_write_text(tdir / "COMMIT", "ok")
        if fdir.exists():
            shutil.rmtree(fdir)
        tdir.rename(fdir)       # atomic publish
        self._digest_table = new_table
        self._since_full = 1 if full else self._since_full + 1
        persist_s = time.time() - t_write
        req.timings["persist_ms"] = round(persist_s * 1e3, 3)
        req.write_stats.update(
            bytes_total=total, bytes_written=written, full=full,
            fresh_shards=fresh_shards, total_shards=total_shards,
            write_s=round(persist_s, 4),
            per_rank_write_s=per_rank_s)
        self._gc()
        cb = self.on_commit
        if cb is not None:
            try:
                cb(fdir)
            except Exception:  # noqa: BLE001
                pass

    # -- directory scanning / GC -------------------------------------------
    def _completed_steps(self) -> list[Path]:
        """Sorted committed step dirs (``.tmp`` and uncommitted dirs are
        invisible: half-written checkpoints can never be restored from).
        Shared with the restore side (``restore.completed_steps``) so writer
        and reader can never disagree on what counts as committed."""
        from repro_torch.core.restore import completed_steps
        return completed_steps(self.base)

    def _gc(self):
        """Delete all but the newest ``keep`` completed checkpoints — except
        any older step that a kept manifest's delta chain still references
        (``base_steps``); deleting those would orphan clean shards."""
        if self.keep <= 0:          # retain everything (seed semantics)
            return
        done = self._completed_steps()
        kept = done[-self.keep:]
        deps: set[int] = set()
        for d in kept:
            try:
                man = json.loads((d / "manifest.json").read_text())
            except (OSError, ValueError):
                continue
            deps.update(man.get("base_steps", []))
        protect = {d.name for d in kept} | {f"step_{s:08d}" for s in deps}
        for d in done[: -self.keep]:
            if d.name not in protect:
                shutil.rmtree(d)

    def latest(self):
        done = self._completed_steps()
        return done[-1] if done else None

    def resumable(self):
        """Newest committed checkpoint whose delta chain fully resolves
        (``restore.find_resumable``) — what resume-from-latest should load.
        Differs from ``latest()`` only when an operator has orphaned a delta
        chain (e.g. hand-deleted a base step)."""
        from repro_torch.core.restore import find_resumable
        return find_resumable(self.base)

    def force_full_next(self):
        """Make the next checkpoint a full one (operators: guaranteed
        self-contained snapshot before migrations; benchmarks: repeatable
        full-write measurements)."""
        self._digest_table = {}
        self._since_full = 0

    def wait_idle(self):
        req = self._inflight
        if req is None:
            return
        # a failure is delivered EXACTLY once: if some caller already saw it
        # via req.wait(), draining here (close(), Cluster.restart, the next
        # checkpoint) must not re-raise it — a supervisor recovering FROM
        # that failure would count the echo as a second incident
        already = req.error_delivered
        try:
            req.wait()
        except BaseException:
            if not already:
                raise
        finally:
            # the request IS finished (possibly failed): clearing it even
            # on error keeps later wait_idle/close calls from re-raising
            # the same failure forever
            self._inflight = None

    def close(self):
        try:
            self.wait_idle()
        finally:
            # the pool must die even if the last checkpoint failed
            if self._pool is not None:
                self._pool.close()
                self._pool = None
