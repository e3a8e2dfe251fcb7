"""Peer-replicated in-RAM checkpoint tier (multi-level C/R, level 1).

Multi-level checkpoint runtimes (SCR, the thread-based MPI C/R line of
work in PAPERS.md) collapse MTTR by keeping the NEWEST image somewhere
much faster than the parallel filesystem: each rank's encoded shards live
in its own memory plus one partner's, so any single rank loss still
leaves a complete copy in RAM and recovery never touches disk.  This
module is that tier for the in-process world:

  * after every committed snapshot (``CheckpointWriter.on_commit`` ->
    :meth:`ReplicaTier.note_commit`), the supervisor drains the commit
    queue and :meth:`ReplicaTier.replicate` pushes each rank's container
    bytes to its ring partner **over the interposed p2p plane** — a real
    ``backend.send``/``recv`` per pair under the internal ``replica`` tag
    (``callspec.TAG_BASES``), so replication exercises the same plumbing
    user traffic does and is visible in fabric stats;
  * at recovery time :meth:`ReplicaTier.image` reassembles the newest
    step from copies held by SURVIVING ranks only (a dead rank's RAM is
    gone), verifies every container against the checksum recorded at push
    time, and returns a :class:`TierImage` — a checkpoint *source* (see
    ``restore.as_source``) the restart engine consumes exactly like a
    committed step dir, decoding via ``ckpt_io.MemoryShardReader`` with
    zero disk I/O.

Verification is deliberately one flat checksum per container, not the
disk tier's deep per-entry decode+digest walk: the RAM tier's value is
restore latency, and a checksum mismatch (or any missing container)
simply escalates the supervisor's ladder to the disk tier.  Delta chains
work unchanged — retention keeps every base step the newest manifest
references, and ``TierImage.reader`` serves prior-step containers from
the same store.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from pathlib import Path

from repro_torch.core import ckpt_io
from repro_torch.core.callspec import TAG_BASES, coll_tag, handle_vid

__all__ = ["Container", "ReplicaTier", "TierImage", "TierVerifyError",
           "ring_partner", "container_sha"]

assert "replica" in TAG_BASES  # the tier owns this internal tag base


class TierVerifyError(RuntimeError):
    """A RAM-tier container failed its push-time checksum — the in-memory
    copy rotted (or a fault injector pretended it did) and the escalation
    ladder must fall back to the disk tier."""


def container_sha(data) -> str:
    return hashlib.sha256(data).hexdigest()[:32]


def ring_partner(rank: int, alive: list) -> int | None:
    """The next ALIVE rank after ``rank`` on the world ring (wrapping), or
    ``None`` when ``rank`` is alone — the buddy that holds its replica."""
    others = sorted(r for r in alive if r != rank)
    if not others:
        return None
    after = [r for r in others if r > rank]
    return (after or others)[0]


class Container:
    """One rank's shard container for one step, held in memory: the parsed
    ``index.json``, the raw ``shards.bin`` bytes, the ``state.json`` text
    (kept as TEXT — parsed state must never be shared, rebind mutates it in
    place), and the checksum recorded when the bytes were read off the
    freshly-committed image."""

    __slots__ = ("step", "rank", "index", "data", "state", "sha")

    def __init__(self, step, rank, index, data, state, sha):
        self.step = step
        self.rank = rank
        self.index = index
        self.data = data
        self.state = state
        self.sha = sha


class ReplicaTier:
    """The in-RAM tier: per-holder stores of :class:`Container` objects.

    ``stores[holder][(step, src_rank)]`` models WHOSE memory a copy lives
    in: each rank holds its own container (primary) plus its ring
    predecessor's (replica).  :meth:`image` only consults holders that are
    currently alive, which is what makes the tier's survivability claims
    honest — killing a rank really does lose every copy it held.

    Thread-safety: ``note_commit`` runs on the writer's finalize thread;
    everything else runs on the supervisor thread.  The lock covers the
    commit queue and store mutation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: list[Path] = []
        self._cluster = None
        self.stores: dict[int, dict] = {}
        self.manifests: dict[int, dict] = {}
        self.newest_step: int | None = None
        self.stats = {"replicated_steps": 0, "dropped_steps": 0,
                      "pushed_bytes": 0, "push_ms_total": 0.0}

    # -- commit intake ------------------------------------------------------
    def attach(self, cluster) -> None:
        """Bind the cluster whose p2p plane carries replica pushes.  Once
        attached, :meth:`note_commit` replicates INSIDE the commit (on the
        writer's finalize thread) — so ``writer.wait_idle()`` returning
        means the RAM tier is exactly as new as the newest disk commit,
        which is what lets the recovery ladder's freshness rule trust it.
        A rank that dies while its commit is still finalizing simply never
        pushes, and the incomplete RAM image escalates to disk — the honest
        partner-replication outcome."""
        with self._lock:
            self._cluster = cluster
        # membership may have changed since the held copies were pushed: a
        # survivor whose ring partner died would otherwise keep exactly one
        # alive copy of its container until the next commit
        try:
            self.repair(cluster)
        except Exception:  # noqa: BLE001 — repair is best-effort redundancy
            pass

    def note_commit(self, step_dir) -> None:
        """``CheckpointWriter.on_commit`` hook.  Attached: replicate now,
        riding the commit; detached: queue for :meth:`drain_commits`.
        Replication is best-effort either way — a failed push evicts the
        step and leaves the disk tier authoritative."""
        with self._lock:
            cluster = self._cluster
        if cluster is None:
            with self._lock:
                self._pending.append(Path(step_dir))
            return
        try:
            self.replicate(cluster, step_dir)
        except Exception:  # noqa: BLE001
            self._evict_step_of(Path(step_dir))
            self.stats["dropped_steps"] += 1

    def drain_commits(self, cluster) -> int:
        """Replicate every commit queued while detached; returns how many
        were pushed (attached tiers replicate inside :meth:`note_commit`,
        so this is usually a no-op)."""
        with self._lock:
            pending, self._pending = self._pending, []
        done = 0
        for d in pending:
            try:
                self.replicate(cluster, d)
                done += 1
            except Exception:  # noqa: BLE001
                self._evict_step_of(d)
                self.stats["dropped_steps"] += 1
        return done

    def _evict_step_of(self, step_dir: Path) -> None:
        try:
            step = int(step_dir.name[len("step_"):])
        except ValueError:
            return
        with self._lock:
            for store in self.stores.values():
                for key in [k for k in store if k[0] == step]:
                    del store[key]
            self.manifests.pop(step, None)
            if self.newest_step == step:
                self.newest_step = max(self.manifests, default=None)

    # -- replication --------------------------------------------------------
    def replicate(self, cluster, step_dir) -> None:
        """Load the committed image's per-rank containers and ring-push each
        over the interposed p2p layer, so after this returns every container
        exists in TWO ranks' memory (primary + partner replica)."""
        t0 = time.perf_counter()
        step_dir = Path(step_dir)
        manifest = json.loads((step_dir / "manifest.json").read_text())
        step = manifest["step"]
        ws = manifest["world_size"]
        alive = [r for r in cluster.survivors() if r < ws]
        owned: dict[int, Container] = {}
        for r in alive:
            rdir = step_dir / f"rank{r:05d}"
            data = (rdir / ckpt_io.BIN_NAME).read_bytes()
            owned[r] = Container(step, r, ckpt_io.read_rank_index(rdir),
                                 data, (rdir / "state.json").read_text(),
                                 container_sha(data))
        # dead-slot inheritance: after a live shrink the slot space still
        # contains departed ranks whose committed containers nobody's RAM
        # would otherwise hold — their ring successor reads them off the
        # fresh commit so the RAM image stays complete over range(ws)
        inherited: dict[int, list[Container]] = {}
        for r in range(ws):
            if r in alive:
                continue
            h = ring_partner(r, alive)
            rdir = step_dir / f"rank{r:05d}"
            if h is None or not rdir.is_dir():
                continue
            data = (rdir / ckpt_io.BIN_NAME).read_bytes()
            inherited.setdefault(h, []).append(
                Container(step, r, ckpt_io.read_rank_index(rdir), data,
                          (rdir / "state.json").read_text(),
                          container_sha(data)))
        # send first, then receive: fabric sends enqueue without blocking,
        # and consuming each push before returning keeps replica traffic
        # out of any later drain's in-flight accounting
        pushes = []
        if len(alive) > 1:
            for r in alive:
                p = ring_partner(r, alive)
                m = cluster.mana(r)
                c = owned[r]
                m.backend.send(p, coll_tag("replica",
                                           handle_vid(m.comm_world())),
                               {"step": c.step, "rank": c.rank,
                                "index": c.index, "data": c.data,
                                "state": c.state, "sha": c.sha})
                pushes.append((r, p))
        received: dict[int, Container] = {}
        for r, p in pushes:
            pm = cluster.mana(p)
            msg = pm._recv_any(r, coll_tag("replica",
                                           handle_vid(pm.comm_world())))
            received[p] = Container(msg["step"], msg["rank"], msg["index"],
                                    msg["data"], msg["state"], msg["sha"])
        with self._lock:
            for r, c in owned.items():
                self.stores.setdefault(r, {})[(step, r)] = c
            for p, c in received.items():
                self.stores.setdefault(p, {})[(step, c.rank)] = c
            for h, cs in inherited.items():
                for c in cs:
                    self.stores.setdefault(h, {})[(step, c.rank)] = c
            self.manifests[step] = manifest
            self.newest_step = step
            # retention: the newest step plus every base step its delta
            # chain references — older steps' copies are dead weight
            keep = {step, *manifest.get("base_steps", [])}
            for store in self.stores.values():
                for key in [k for k in store if k[0] not in keep]:
                    del store[key]
            self.manifests = {s: m for s, m in self.manifests.items()
                              if s in keep}
            self.stats["replicated_steps"] += 1
            self.stats["pushed_bytes"] += sum(len(c.data)
                                              for c in owned.values())
            self.stats["push_ms_total"] += round(
                (time.perf_counter() - t0) * 1e3, 3)

    # -- recovery-side assembly ---------------------------------------------
    def image(self, cluster) -> "TierImage | None":
        """Assemble the newest replicated step from copies held by ranks
        that are STILL ALIVE.  Returns ``None`` when the tier cannot serve
        (nothing replicated yet, or some needed container lost every
        surviving copy); raises :class:`TierVerifyError` when a surviving
        copy fails its push-time checksum — distinct outcomes because the
        ladder logs them differently, though both escalate to disk."""
        with self._lock:
            step = self.newest_step
            if step is None:
                return None
            manifest = self.manifests.get(step)
            if manifest is None:
                return None
            alive = set(cluster.survivors())
            holders = {r: dict(self.stores.get(r, {})) for r in alive}
        from repro_torch.core.restore import plan_leaf_reads
        needed = {(step, r) for r in range(manifest["world_size"])}
        needed |= set(plan_leaf_reads(manifest))
        picked: dict[tuple, Container] = {}
        for key in needed:
            # prefer the primary copy (the owner's own memory), else any
            # surviving replica
            c = holders.get(key[1], {}).get(key)
            if c is None:
                c = next((st[key] for st in holders.values() if key in st),
                         None)
            if c is None:
                return None
            picked[key] = c
        for (cstep, crank), c in picked.items():
            if container_sha(c.data) != c.sha:
                raise TierVerifyError(
                    f"RAM replica step {cstep} rank {crank}: checksum "
                    f"mismatch (in-memory copy corrupt)")
        return TierImage(step, manifest, picked)

    def repair(self, cluster) -> dict:
        """Re-pair the replica ring after a MEMBERSHIP CHANGE (satellite of
        the live-rescale engine): any held container that survives in only
        ONE alive rank's memory — because its old ring partner died or
        departed — is re-pushed to the holder's CURRENT ring partner over
        the interposed p2p plane, so every container is again redundant
        without waiting for the next commit.  Containers with zero alive
        copies are unrecoverable here (that is the disk tier's job).
        Returns ``{"repushed": n, "single_copy": m}``."""
        t0 = time.perf_counter()
        with self._lock:
            steps = sorted(self.manifests)
            alive = sorted(cluster.survivors())
            holders = {r: dict(self.stores.get(r, {})) for r in alive}
        repushed = single = 0
        if len(alive) < 2:
            return {"repushed": 0,
                    "single_copy": sum(len(s) for s in holders.values())}
        for step in steps:
            keys = sorted({k for st in holders.values()
                           for k in st if k[0] == step})
            for key in keys:
                copies = [h for h in alive if key in holders[h]]
                if len(copies) >= 2:
                    continue
                single += 1
                src = copies[0]
                dst = ring_partner(src, alive)
                c = holders[src][key]
                m, pm = cluster.mana(src), cluster.mana(dst)
                m.backend.send(dst, coll_tag("replica",
                                             handle_vid(m.comm_world())),
                               {"step": c.step, "rank": c.rank,
                                "index": c.index, "data": c.data,
                                "state": c.state, "sha": c.sha})
                msg = pm._recv_any(src, coll_tag("replica",
                                                 handle_vid(pm.comm_world())))
                rc = Container(msg["step"], msg["rank"], msg["index"],
                               msg["data"], msg["state"], msg["sha"])
                holders[dst][key] = rc
                with self._lock:
                    self.stores.setdefault(dst, {})[key] = rc
                self.stats["pushed_bytes"] += len(rc.data)
                repushed += 1
        self.stats["push_ms_total"] += round(
            (time.perf_counter() - t0) * 1e3, 3)
        return {"repushed": repushed, "single_copy": single}

    def reset(self) -> None:
        """Drop everything — called after a recovery: the restored world's
        rank numbering (and its fresh lower halves) invalidate every held
        copy, and the next commit repopulates the tier."""
        with self._lock:
            self.stores.clear()
            self.manifests.clear()
            self._pending.clear()
            self.newest_step = None
            self._cluster = None


class TierImage:
    """A complete in-memory checkpoint image — the RAM tier's counterpart
    of ``restore.DirCheckpointSource`` (same checkpoint-source protocol:
    ``name`` / ``manifest()`` / ``rank_state`` / ``reader``), so
    ``Cluster.restart`` and ``load_arrays`` consume it unchanged."""

    def __init__(self, step: int, manifest: dict, containers: dict):
        self.step = step
        self.containers = containers
        self._manifest_text = json.dumps(manifest)
        self.name = f"ram:step_{step:08d}"

    def manifest(self) -> dict:
        return json.loads(self._manifest_text)

    def rank_state(self, rank: int) -> dict:
        # fresh parse per call — rebind mutates descriptor meta in place
        return json.loads(self.containers[(self.step, rank)].state)

    def reader(self, step: int, rank: int) -> ckpt_io.MemoryShardReader:
        c = self.containers[(step, rank)]
        return ckpt_io.MemoryShardReader(c.index, c.data)

    @property
    def nbytes(self) -> int:
        return sum(len(c.data) for c in self.containers.values())
