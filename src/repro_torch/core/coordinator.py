"""Cluster coordinator: logical ranks, heartbeats, failure detection, and the
auto-restart policy. This is the fault-tolerance control plane that MANA-style
transparent checkpointing enables: any failure is handled by rebuilding the
lower half (possibly with a different backend flavor / world size / mesh) and
re-binding the saved upper half.

In-container, ranks are objects in one process beside one device; on a real
cluster each rank is a ``torch.distributed`` process and this class runs in
the job controller. Nothing in the checkpoint format depends on which."""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from repro_torch.core.backends.fabric import Fabric
from repro_torch.core.ckpt import CheckpointWriter
from repro_torch.core.drain import drain_world
from repro_torch.core.interpose import Mana


@dataclass
class RankState:
    mana: Mana
    alive: bool = True
    #: lower half unresponsive (crashed node): the rank cannot renew its
    #: heartbeat lease, but the coordinator has not yet DETECTED the death —
    #: that is the supervisor's job (lease expiry or active probe)
    halted: bool = False
    last_heartbeat: float = field(default_factory=time.time)


class Cluster:
    """World of logical ranks sharing one fabric + one process."""

    def __init__(self, world_size: int, backend_name: str = "mpich",
                 *, translation: str = "fast", ckpt_dir=None,
                 keep: int | None = None, ckpt_io=None):
        from repro_torch.configs import CkptIOConfig
        self.world_size = world_size
        self.backend_name = backend_name
        self.translation = translation
        if ckpt_io is not None and keep is not None and keep != ckpt_io.keep:
            raise ValueError(f"conflicting retention: keep={keep} but "
                             f"ckpt_io.keep={ckpt_io.keep}; set one")
        self.ckpt_io = ckpt_io or CkptIOConfig(
            keep=keep if keep is not None else 3)
        self.fabric = Fabric(world_size)
        self.ranks = [RankState(Mana(backend_name, self.fabric, r, world_size,
                                     translation=translation))
                      for r in range(world_size)]
        self.writer = CheckpointWriter(
            ckpt_dir, world_size, keep=self.ckpt_io.keep,
            codec=self.ckpt_io.codec, incremental=self.ckpt_io.incremental,
            io_workers=self.ckpt_io.io_workers,
            chunk_bytes=self.ckpt_io.chunk_bytes,
            snapshot_batch_mb=self.ckpt_io.snapshot_batch_mb) if ckpt_dir else None
        self.events: list = []
        self.restart_count = 0
        self._coll_pool = None          # lazy persistent collective executor
        self._coll_pool_size = 0
        # filled by restart(): phase timings mirroring checkpoint's
        # req.timings, per-rank rebind stats, optionally restored arrays
        self.restart_timings: dict = {}
        self.rebind_stats: list = []
        self.restored_arrays = None

    @property
    def manas(self):
        # halted (crashed-but-undetected) ranks are still in the world: a
        # drain that probes one fails with RankDeadError, which is exactly
        # how a checkpoint DISCOVERS an unreported death
        return [r.mana for r in self.ranks if r.alive]

    def mana(self, rank: int) -> Mana:
        return self.ranks[rank].mana

    def _coll_executor(self, workers: int):
        """Persistent executor for collective fan-out (grown, never
        shrunk): the training step drives one collective per step, so
        thread spawn must not be per-step cost."""
        from concurrent.futures import ThreadPoolExecutor
        pool = getattr(self, "_coll_pool", None)
        if pool is None or self._coll_pool_size < workers:
            if pool is not None:
                pool.shutdown(wait=False)
            self._coll_pool_size = max(workers, 2)
            pool = self._coll_pool = ThreadPoolExecutor(
                max_workers=self._coll_pool_size,
                thread_name_prefix="coll")
        return pool

    def _discard_coll_executor(self) -> None:
        """Drop the pool after a failed/timed-out collective: a worker
        still parked in a receive would otherwise starve the NEXT
        collective, which needs every rank entering concurrently."""
        pool = getattr(self, "_coll_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._coll_pool = None

    def run_collective_async(self, fn: Callable, *,
                             timeout: float = 30.0) -> "CollectiveHandle":
        """START ``fn(mana)`` on every live rank and return immediately with
        a :class:`CollectiveHandle`; ``handle.wait()`` blocks for the
        results.  This is the async-start/late-wait split that lets the
        training loop overlap the per-step metrics allreduce with device
        compute: the rank threads begin exchanging (or blocking on a value
        callable that forces a device transfer) while the caller keeps
        dispatching work, and the wait lands just before the result is
        needed (see docs/performance.md, "Async allreduce overlap").

        The handle must be waited before the next collective on this
        cluster is started — collectives need every rank entering
        concurrently, and an unwaited straggler would poison the pool."""
        import threading as _threading

        manas = self.manas
        out = [None] * len(manas)
        errs: list[BaseException] = []
        lock = _threading.Lock()
        done = _threading.Event()
        state = {"remaining": len(manas)}

        def run(i, m):
            try:
                r = fn(m)
            except BaseException as e:  # noqa: BLE001 — surface to caller
                with lock:
                    errs.append(e)
                done.set()
            else:
                out[i] = r
                with lock:
                    state["remaining"] -= 1
                    if state["remaining"] == 0:
                        done.set()

        pool = self._coll_executor(len(manas))
        for i, m in enumerate(manas):
            pool.submit(run, i, m)
        return CollectiveHandle(self, out, errs, done, state, timeout)

    def run_collective(self, fn: Callable, *, timeout: float = 30.0) -> list:
        """Execute ``fn(mana)`` concurrently on every live rank — the
        driver for collective wrappers, which every member must enter
        (``cluster.run_collective(lambda m: m.allreduce(...))``).

        Fail-fast: the first rank error (e.g. a ``RankDeadError`` from a
        crashed-but-undetected lower half) is raised IMMEDIATELY, without
        waiting for peers blocked on the dead rank's contribution (the
        poisoned pool is discarded; stragglers drain on their own).
        Dead-rank errors outrank secondary timeouts so the supervisor
        classifies the root cause."""
        return self.run_collective_async(fn, timeout=timeout).wait()

    # -- heartbeats / failure detection ------------------------------------
    def heartbeat(self, rank: int):
        # a halted rank's lease must EXPIRE: dead nodes don't heartbeat,
        # even when the driver loop dutifully pings every rank id
        if not self.ranks[rank].halted:
            self.ranks[rank].last_heartbeat = time.time()

    def detect_failures(self, timeout_s: float = 5.0) -> list:
        now = time.time()
        dead = [i for i, r in enumerate(self.ranks)
                if r.alive and now - r.last_heartbeat > timeout_s]
        for i in dead:
            self.ranks[i].alive = False
            self.events.append(("failure_detected", i, now))
        return dead

    def kill_rank(self, rank: int):
        """Fault injection: the rank's lower half dies (network/node failure)."""
        self.ranks[rank].alive = False
        self.ranks[rank].mana.backend.shutdown()
        self.events.append(("killed", rank, time.time()))

    def halt_rank(self, rank: int):
        """A rank's node crashes WITHOUT the coordinator being told: the
        lower half is swapped for a :class:`~repro_torch.core.faults.DeadLowerHalf`
        (any call raises ``RankDeadError``) and the rank stops renewing its
        lease.  Unlike :meth:`kill_rank` the rank stays ``alive=True`` until
        a failure detector actually notices — the honest failure model the
        supervisor is built against."""
        from repro_torch.core.faults import DeadLowerHalf
        r = self.ranks[rank]
        r.mana.backend.shutdown()
        r.mana.backend = DeadLowerHalf(rank, self.backend_name)
        r.halted = True
        self.events.append(("halted", rank, time.time()))

    def survivors(self) -> list:
        """Rank ids whose lower halves are still usable (not dead, not
        halted) — the world an elastic recovery restarts on."""
        return [i for i, r in enumerate(self.ranks)
                if r.alive and not r.halted]

    # -- live membership change (no restart; see repro_torch.core.elastic) -------
    def resize(self, new_world) -> dict:
        """Re-point every member's COMM_WORLD at ``new_world`` — a
        possibly-sparse ordered rank-id list — WITHOUT a restart.  Survivor
        rank ids are stable; departed slots simply leave the member list
        (they stay in ``self.ranks`` as dead slots so stats/images keyed by
        rank id never re-attach to the wrong rank).  Returns per-rank
        repoint stats keyed by rank id.

        This is the coordinator half of the live-rescale protocol: the
        drain/handoff choreography around it lives in
        :mod:`repro_torch.core.elastic`."""
        from repro_torch.core import restore
        members = list(new_world)
        stats = {}
        for i, r in enumerate(self.ranks):
            if i in members:
                if not (r.alive and not r.halted):
                    raise ValueError(f"rank {i} is dead but listed in the "
                                     f"new world {members}")
                stats[i] = restore.repoint_world(r.mana, members)
            elif r.alive and not r.halted:
                # leaving gracefully: slot becomes a dead slot
                r.alive = False
        self.events.append(("resized", tuple(members), time.time()))
        return stats

    def add_rank(self) -> Mana:
        """Grow the world by one slot: extend the fabric's address space,
        build a fresh ``Mana`` on the new rank id, and append its slot.
        The new rank is NOT yet a world member — membership changes only
        via :meth:`resize` (after the join handshake completes), so a
        joiner that stalls mid-handshake never poisons the running world."""
        new_rank = len(self.ranks)
        self.fabric.resize(new_rank + 1)
        self.world_size = new_rank + 1
        if self.writer is not None:
            self.writer.world_size = new_rank + 1
        m = Mana(self.backend_name, self.fabric, new_rank, new_rank + 1,
                 translation=self.translation)
        self.ranks.append(RankState(m))
        self.events.append(("rank_added", new_rank, time.time()))
        return m

    def remove_rank(self, rank: int):
        """Graceful departure: the slot is marked dead and its fabric inbox
        retired (later sends to it raise the typed ``DepartedRankError``)."""
        self.ranks[rank].alive = False
        self.fabric.retire(rank)
        self.events.append(("departed", rank, time.time()))

    # -- transparent checkpoint --------------------------------------------
    def checkpoint(self, step: int, arrays, mesh, extra_rank_state=None):
        """Drain -> barrier -> pipelined snapshot -> async write.  Returns
        the request; ``req.timings`` carries the stop-the-world breakdown
        {drain_ms, snapshot_ms, enqueue_ms, blocking_ms} in milliseconds
        (persist_ms lands once the background write commits)."""
        if self.writer is None:
            raise RuntimeError("no ckpt_dir configured")
        t0 = time.perf_counter()
        drain_stats = drain_world(self.manas,
                                  timeout=self.ckpt_io.drain_timeout,
                                  backoff=self.ckpt_io.drain_backoff)
        drain_ms = (time.perf_counter() - t0) * 1e3
        rank_states = {}
        for i, r in enumerate(self.ranks):
            if not r.alive:
                continue
            # drain stats are keyed by RANK ID — with dead ranks a positional
            # lookup would attach a survivor's stats to the wrong rank
            st = {"mana": r.mana.snapshot(),
                  "drain": drain_stats.get(r.mana.rank, {})}
            if extra_rank_state:
                st.update(extra_rank_state(i))
            rank_states[i] = st
        req = self.writer.checkpoint(step, arrays, mesh, rank_states,
                                     extra_meta={"backend": self.backend_name,
                                                 "members": self.survivors()},
                                     defer_release=True)
        try:
            req.timings["drain_ms"] = round(drain_ms, 3)
            req.timings["blocking_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
            self.events.append(("checkpoint", step, time.time()))
        finally:
            # the blocking window ends HERE: only now may the held encode/
            # digest/IO tasks start competing for the interpreter
            req.release()
        return req

    # -- restart ------------------------------------------------------------
    def restart(self, ckpt, *, new_world_size: Optional[int] = None,
                new_backend: Optional[str] = None, shardings=None,
                parallel: bool = True) -> "Cluster":
        """Build a NEW cluster (new lower halves) from a checkpoint. Elastic:
        the new world size and backend flavor may differ (paper §9), with
        per-pair capability translation resolving how each MPI object is
        rebuilt (``repro_torch.core.restore``).

        ``ckpt`` is a committed step dir or any checkpoint source
        (``restore.as_source``) — the restart engine is storage-oblivious,
        so the RAM tier's ``TierImage`` restores through the same path.

        ``shardings`` (a pytree matching the checkpointed arrays, leaves
        being the NEW shardings or ``None``) additionally restores the array
        state — leaf shard reads overlap descriptor re-binding on one worker
        pool, and the result lands in ``fresh.restored_arrays``.

        The returned cluster carries phase timings mirroring
        ``checkpoint``'s ``req.timings``: ``fresh.restart_timings`` =
        {manifest_ms, lower_half_ms, rebind_ms, arrays_ms, total_ms}, with
        ``place_ms`` (the part of arrays_ms that puts leaves on their
        device) when the arrays were restored in parallel, plus
        per-rank rebind stats in ``fresh.rebind_stats``.  ``parallel=False``
        selects the sequential seed-equivalent path.  The fresh writer takes
        over this cluster's pinned arena pair, which stages the restored
        leaves bound for the card and then the next snapshot."""
        from repro_torch.core import ckpt_io as ckpt_io_mod
        from repro_torch.core import restore
        t0 = time.perf_counter()
        source = restore.as_source(ckpt)
        manifest = source.manifest()
        old_ws = manifest["world_size"]
        ws = new_world_size or old_ws
        backend = new_backend or self.backend_name
        timings = {"manifest_ms": round((time.perf_counter() - t0) * 1e3, 3)}
        t1 = time.perf_counter()
        fresh = Cluster(ws, backend, translation=self.translation,
                        ckpt_dir=self.writer.base if self.writer else None,
                        ckpt_io=self.ckpt_io)
        timings["lower_half_ms"] = round((time.perf_counter() - t1) * 1e3, 3)
        if self.writer is not None:
            # release the abandoned writer's thread pool (close() drains the
            # in-flight write; the writer stays queryable via latest())
            self.writer.close()
            if fresh.writer is not None:
                fresh.writer.arenas = self.writer.arenas
        arenas = fresh.writer.arenas if fresh.writer is not None else ()
        fresh.restart_count = self.restart_count + 1
        # two pools: leaf reads can queue arbitrarily deep on the I/O pool,
        # so rebind DAGs get dedicated workers — otherwise FIFO order would
        # park every rebind node behind the whole read backlog and a large
        # checkpoint would look like a stalled rebind
        want_arrays = shardings is not None and parallel
        io_pool = ckpt_io_mod.IOPool(self.ckpt_io.io_workers
                                     or ckpt_io_mod.default_workers(ws)) \
            if want_arrays else None
        rebind_pool = ckpt_io_mod.IOPool(min(ws, 4)) if parallel else None
        try:
            # leaf-restore I/O first: reads/decompression start immediately
            # and overlap the rebind DAGs scheduled next
            arrays_job = None
            if want_arrays:
                arrays_job = restore.ArrayRestoreJob(
                    source, manifest, shardings, io_pool, arenas=arenas)
            # re-bind each new rank from an old rank image (elastic: wrap
            # around) — one dependency-ordered DAG per rank.  The source
            # caches image text; each new rank gets a fresh parse
            # (descriptor meta must never be shared between ranks — rebind
            # mutates it in place)
            t2 = time.perf_counter()
            pairs = []
            # post-rescale manifests carry the (possibly sparse) member
            # list: only member slots hold real images, so the wrap-around
            # maps into members, not range(world_size)
            members = manifest.get("members") or list(range(old_ws))
            for r in range(ws):
                snap = source.rank_state(members[r % len(members)])["mana"]
                m = Mana(backend, fresh.fabric, r, ws,
                         translation=snap["translation"])
                pairs.append((m, snap))
            fresh.rebind_stats = restore.rebind_world(pairs,
                                                      pool=rebind_pool)
            for r, (m, _) in enumerate(pairs):
                fresh.ranks[r].mana = m
            timings["rebind_ms"] = round(
                (time.perf_counter() - t2) * 1e3, 3)
            t3 = time.perf_counter()
            if arrays_job is not None:
                fresh.restored_arrays = arrays_job.result()
                timings["place_ms"] = arrays_job.place_ms
            elif shardings is not None:
                fresh.restored_arrays = restore.load_arrays(
                    source, shardings, parallel=False, arenas=arenas)
            timings["arrays_ms"] = round(
                (time.perf_counter() - t3) * 1e3, 3)
        finally:
            if arrays_job is not None:
                # idempotent after result(); REQUIRED if rebind raised
                # before result() ran, else the pread fds leak
                arrays_job.close()
            for p in (io_pool, rebind_pool):
                if p is not None:
                    p.close()
        timings["total_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        fresh.restart_timings = timings
        fresh.events.append(("restarted", manifest["step"], time.time()))
        return fresh


class CollectiveHandle:
    """Waitable result of :meth:`Cluster.run_collective_async`.

    ``wait()`` applies exactly the fail-fast policy of the synchronous
    path — timeout discards the poisoned pool, dead-rank errors outrank
    secondary timeouts — and is idempotent (subsequent waits return the
    cached result or re-raise the same error)."""

    def __init__(self, cluster, out, errs, done, state, timeout):
        self._cluster = cluster
        self._out = out
        self._errs = errs
        self._done = done
        self._state = state
        self._timeout = timeout
        self._result = None
        self._exc: BaseException | None = None
        self._finished = False

    @property
    def done(self) -> bool:
        """True once every rank finished (or any rank errored)."""
        return self._finished or self._done.is_set()

    def wait(self) -> list:
        from repro_torch.core.faults import RankDeadError
        if self._finished:
            if self._exc is not None:
                raise self._exc
            return self._result
        if not self._done.wait(self._timeout):
            self._cluster._discard_coll_executor()
            self._finished = True
            self._exc = TimeoutError(
                f"collective did not complete within {self._timeout}s "
                f"({self._state['remaining']} rank(s) pending)")
            raise self._exc
        if self._errs:
            self._cluster._discard_coll_executor()
            self._errs.sort(key=lambda e: not isinstance(e, RankDeadError))
            self._finished = True
            self._exc = self._errs[0]
            raise self._exc
        self._finished = True
        self._result = self._out
        return self._result
