"""Restore subsystem: rebuild the lower half under ANY backend flavor and
re-bind every virtual id (paper §4.2, §9) — fast.

This is the restart half of the checkpoint/restart pair (`ckpt.py` +
`ckpt_io` own the write path).  Three planes:

**Capability translation (the backend-pair restart matrix).**  A checkpoint
taken under flavor S must restart under every flavor D.  For each ordered
pair the :class:`PairPlan` resolves, per descriptor kind, how the object is
rebuilt:

  RECORD_REPLAY — replay the logged creation call against the new backend;
  SERIALIZE     — rebuild from the decoded description in the descriptor
                  (works across families: it is pure upper-half state);
  HYBRID        — replay when S and D share an implementation FAMILY
                  (Cray MPI is MPICH-derived) and D natively supports the
                  original call; otherwise deserialize.

Constants (COMM_WORLD, predefined datatypes/ops) always re-bind LAZILY on
first use (§4.3 — ExaMPI's addresses are not even known at startup), and
datatype envelopes are RE-ENCODED through the destination's aliasing
discipline (``Backend.alias_dtype``) so e.g. an MPI_INT8_T checkpointed
under MPICH lands on ExaMPI's shared INT8/CHAR pointer.

**Parallel streaming rebind.**  Descriptor re-binding overlaps `ckpt_io`'s
leaf restore: shard reads (I/O + GIL-releasing decompress) are submitted
to the I/O pool first, then every rank's rebind DAG runs on dedicated
workers — dependency-ordered (a replayed ``comm_split`` needs its parent's
physical handle first), ready-queue scheduled, backend calls serialized
per rank by a lock since lower halves are not thread-safe.  This replaces
the seed's single sorted loop; restart wall time approaches
max(slowest rank DAG, array I/O) instead of their sum.

**Elastic reshape.**  Array state is topology-oblivious: leaves are
reassembled from the per-rank shard entries recorded by the write-side
planner (``ckpt_pipeline.plan_snapshot``, or the JAX package's, whose
container this is byte for byte), so the world size may differ from
checkpoint time.  Rank images wrap around (new rank r restores image r mod
old_world).  The port runs on one device: a placement tree's leaf is the
``torch.device`` a leaf goes to (through the writer's pinned arena when it
is the card) or ``None`` for the host array itself.  Only the chunked
container (format 2) is read: neither package writes another.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import ckpt_io
from repro_torch.core.ckpt_pipeline import HostArena, arena_layout, torch_dtype
from repro_torch.core.backends import BACKENDS, backend_family
from repro_torch.core.faults import failpoint
from repro_torch.core.descriptors import Kind, Strategy
from repro_torch.core.vid import VidTable
from repro_torch.models.params import tree_leaves, tree_unflatten

_REBIND_TIMEOUT = 60.0


# ---------------------------------------------------------------------------
# capability translation: the backend-pair restart matrix
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PairPlan:
    """Resolved translation rules for one ordered (checkpoint, restart)
    backend pair."""
    src: str
    dst: str
    src_family: str
    dst_family: str
    same_family: bool            # HYBRID resolves to replay iff True
    native_split: bool           # dst implements comm_split natively
    dtype_aliases: dict          # dst aliasing table over predefined names
    reencode_envelopes: bool     # any alias differs -> envelopes re-encoded
    #: canonical-dtype re-encode rules for runtime-state leaves
    #: (``repro_torch.core.runtime_state``): StateLeaf transport dtypes pass
    #: through the same aliasing table as datatype envelopes.
    runtime: dict = field(default_factory=dict)

    @property
    def replay_comm_split(self) -> bool:
        """Split replays only when HYBRID resolves to replay AND the
        destination has the native call; otherwise comm_create serializes."""
        return self.same_family and self.native_split


def translation_plan(src: str, dst: str, dst_backend=None) -> PairPlan:
    """Build the capability-translation plan for restarting a checkpoint
    taken under ``src`` on a lower half of flavor ``dst``.  ``dst_backend``
    (a live instance) supplies capabilities/aliasing; without one a
    throwaway probe instance is constructed."""
    if dst_backend is None:
        from repro_torch.core.backends.fabric import Fabric
        dst_backend = BACKENDS[dst](Fabric(1), 0, 1)
    from repro_torch.core.backends.base import PREDEFINED_DTYPES
    aliases = {nm: dst_backend.alias_dtype(nm)
               for nm, _, _ in PREDEFINED_DTYPES}
    return PairPlan(
        src=src, dst=dst,
        src_family=backend_family(src),
        dst_family=dst_backend.family,
        same_family=backend_family(src) == dst_backend.family,
        native_split="comm_split" in dst_backend.capabilities(),
        dtype_aliases=aliases,
        reencode_envelopes=any(k != v for k, v in aliases.items()),
        runtime={"dtype_aliases": dict(aliases),
                 "reencode": any(k != v for k, v in aliases.items())},
    )


def restart_matrix() -> dict:
    """Every ordered (checkpoint_backend, restart_backend) pair with its
    resolved translation plan — the support matrix documented in
    docs/restart_matrix.md and exercised exhaustively by
    tests/test_restore_matrix.py."""
    return {(s, d): translation_plan(s, d)
            for s in BACKENDS for d in BACKENDS}


def reencode_envelope(env: dict, plan: PairPlan) -> dict:
    """Re-encode a datatype envelope through the destination's aliasing
    discipline: named leaves are mapped via ``alias_dtype`` (recursing into
    derived-type ``base`` envelopes) so the rebuilt handle always lands on
    the destination's canonical constant."""
    if not plan.reencode_envelopes:
        return env
    out = dict(env)
    if out.get("combiner") == "named":
        out["name"] = plan.dtype_aliases.get(out["name"], out["name"])
    base = out.get("base")
    if isinstance(base, dict):
        out["base"] = reencode_envelope(base, plan)
    return out


def resolve_strategy(d, plan: PairPlan) -> str:
    """Per-descriptor reconstruction mode under a pair plan:
    ``lazy`` (constants, §4.3) | ``replay`` | ``serialize``."""
    if d.kind == Kind.COMM and d.meta.get("axis_name") == "world":
        return "lazy"
    if d.kind == Kind.DATATYPE and d.meta.get("envelope", {}).get(
            "combiner") == "named":
        return "lazy"
    if d.kind == Kind.OP and d.meta.get("predefined"):
        return "lazy"
    if d.kind == Kind.COMM:
        use_replay = (d.strategy == Strategy.RECORD_REPLAY or
                      (d.strategy == Strategy.HYBRID and plan.same_family))
        if use_replay and d.meta.get("color") is not None \
                and plan.native_split:
            return "replay"
        return "serialize"
    if d.kind == Kind.OP:
        return "replay"
    if d.kind == Kind.REQUEST:
        return "request"
    return "serialize"          # GROUP, derived DATATYPE


# ---------------------------------------------------------------------------
# rebind engine: dependency-ordered, parallel across and within ranks
# ---------------------------------------------------------------------------

@dataclass
class _RebindPlan:
    """One rank's classified rebind work: descriptor jobs keyed by vid,
    replay dependencies (parent comm before child split), and the
    per-rank lock that serializes lower-half creation calls."""
    mana: object
    plan: PairPlan
    by_vid: dict
    modes: dict                  # vid -> lazy|replay|serialize|request
    deps: dict = field(default_factory=dict)   # vid -> parent vid
    stats: dict = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)


def _plan_rebind(mana, snap: dict) -> _RebindPlan:
    """Swap the snapshot's vid table into ``mana`` and classify every
    unbound descriptor under the pair plan.  No lower-half calls yet."""
    plan = translation_plan(snap["backend_name"], mana.backend_name,
                            mana.backend)
    table = VidTable.restore(snap["vids"])
    mana.vids = table
    mana.log = list(snap["log"])
    mana.pending_messages = [tuple(p) for p in snap["pending"]]
    _repoint_constants(mana, table)
    # rebuild the legacy shadow tables when running in slow-translation mode
    if mana.legacy is not None:
        from repro_torch.core.legacy_vid import LegacyVidTables
        mana.legacy = LegacyVidTables()
        mana._legacy_of = {}
    from repro_torch.core.callspec import COLL_TAG_MIN
    by_vid = {d.vid: d for d in table.all_descriptors()}
    rp = _RebindPlan(mana=mana, plan=plan, by_vid=by_vid, modes={},
                     stats={"replayed": 0, "serialized": 0, "lazy": 0,
                            "reencoded_envelopes": 0,
                            # drained traffic re-delivered via the buffered
                            # receive once the peers' calls resume —
                            # collective payloads replay like p2p
                            "pending_redelivery": len(mana.pending_messages),
                            "pending_collective": sum(
                                1 for _, t, _ in mana.pending_messages
                                if t >= COLL_TAG_MIN)})
    # two passes: classify EVERYTHING first, then register dependencies.
    # by_vid iterates in vid order, which for comms is ggid (hash) order —
    # a child split can hash below its parent, so a single fused pass would
    # silently drop the parent->child edge and let the parallel engine
    # replay the split against world_comm instead of its parent.
    for d in by_vid.values():
        if d.phys is not None:
            continue
        mode = resolve_strategy(d, plan)
        rp.modes[d.vid] = mode
        if mode == "lazy":
            rp.stats["lazy"] += 1
    for vid, mode in rp.modes.items():
        if mode != "replay":
            continue
        d = by_vid[vid]
        if d.kind != Kind.COMM:
            continue
        parent = d.meta.get("parent")
        # order only matters when the parent itself is being replayed/
        # serialized in this pass (constants bind lazily on first use)
        if parent in rp.modes and rp.modes[parent] in ("replay",
                                                       "serialize"):
            rp.deps[vid] = parent
    return rp


def _repoint_constants(mana, table: VidTable) -> None:
    """Re-aim the upper-half constant accessors (``comm_world()``,
    ``dtype_handles``, ``op_handles``) at the RESTORED table's descriptors.

    ``Mana.__init__`` registered fresh constants before the snapshot's
    table was swapped in; for datatypes/ops the per-kind counters make the
    vids coincide, but COMM vids are ggid hashes of the MEMBER RANKS — an
    elastic restart onto a different world size leaves ``world_handle``
    pointing at a vid the restored table never contained.  A post-recovery
    collective over ``comm_world()`` (the training step's allreduce hot
    path) would then die on a dangling vid."""
    from repro_torch.core.callspec import make_handle
    for d in table.all_descriptors():
        if d.kind == Kind.COMM and d.meta.get("axis_name") == "world":
            mana.world_handle = make_handle(d.vid)
        elif d.kind == Kind.DATATYPE:
            env = d.meta.get("envelope", {})
            if env.get("combiner") == "named":
                mana.dtype_handles[env["name"]] = make_handle(d.vid)
        elif d.kind == Kind.OP and d.meta.get("predefined"):
            mana.op_handles[d.meta["name"]] = make_handle(d.vid)


def repoint_world(mana, members) -> dict:
    """LIVE membership change (no restart): re-aim one rank's COMM_WORLD at
    ``members`` — a possibly-sparse, ordered rank-id list (survivors keep
    their ids; the world is a membership list, not a dense range).

    Three moves, all upper-half except the middle one:

      1. free the old world COMM descriptor (its ggid hashes the OLD member
         list, so it can never be confused with the new one);
      2. rebuild the lower half's world communicator over ``members``
         (``Backend.resize_world`` — works for every flavor);
      3. register a fresh world-axis COMM descriptor bound to the new
         physical handle and re-aim the constant accessors through the
         existing :func:`_repoint_constants`.

    Because the new vid is a ggid of the identical member list, every
    member computes the SAME world vid without coordination — the property
    live collectives rely on.  Buffered internal messages whose tag embeds
    the old world vid are purged (their collective round died with the old
    membership); buffered USER p2p traffic is untouched — redelivery of a
    departed rank's user traffic is the elastic layer's job, not this one's.
    """
    from repro_torch.core.callspec import COLL_TAG_MIN, handle_vid
    from repro_torch.core.descriptors import comm_desc
    members = list(members)
    old_vid = handle_vid(mana.world_handle)
    mana.vids.free(old_vid)
    # vid coherence across DIFFERENT insert histories: a joiner's init
    # world may already be this exact member tuple (bumping its probe
    # counter), so reset the counter and let slot-occupancy probing alone
    # pick the seq — a pure function of live table content, which is
    # symmetric across ranks under MPI's collective-creation discipline
    mana.vids._ggid_seq.pop((Kind.COMM, tuple(sorted(members))), None)
    phys = mana.backend.resize_world(members)
    mana.world_size = len(members)
    d = comm_desc(members, axis_name="world", strategy=Strategy.SERIALIZE)
    new_vid = mana._register(d, phys)
    _repoint_constants(mana, mana.vids)
    kept, purged = [], 0
    for s, t, payload in mana.pending_messages:
        if t >= COLL_TAG_MIN and (t & 0xFFFFFFFF) == old_vid:
            purged += 1
            continue
        kept.append((s, t, payload))
    mana.pending_messages = kept
    return {"old_vid": old_vid, "new_vid": new_vid,
            "members": members, "purged_internal": purged}


def _bind_one(rp: _RebindPlan, vid: int) -> None:
    """Bind one descriptor's physical handle.  Creation calls serialize on
    the rank's lock — lower halves are not thread-safe — but run
    concurrently ACROSS ranks and with leaf-restore I/O."""
    d = rp.by_vid[vid]
    mode = rp.modes[vid]
    backend = rp.mana.backend
    plan = rp.plan
    with rp.lock:
        if mode == "replay" and d.kind == Kind.COMM:
            parent = rp.by_vid.get(d.meta.get("parent"))
            pphys = parent.phys if parent and parent.phys is not None \
                else backend.world_comm()
            d.phys = backend.comm_split(
                pphys, d.meta["color"], d.meta["key"], d.meta["ranks"])
            rp.stats["replayed"] += 1
        elif d.kind == Kind.COMM:
            d.phys = backend.comm_create(d.meta["ranks"])
            rp.stats["serialized"] += 1
        elif d.kind == Kind.GROUP:
            d.phys = backend.comm_group(
                backend.comm_create(d.meta["ranks"]))
            rp.stats["serialized"] += 1
        elif d.kind == Kind.DATATYPE:
            env = reencode_envelope(d.meta["envelope"], plan)
            if env != d.meta["envelope"]:
                d.meta["envelope"] = env
                rp.stats["reencoded_envelopes"] += 1
            d.phys = backend.type_create(env)
            rp.stats["serialized"] += 1
        elif d.kind == Kind.OP:
            d.phys = backend.op_create(d.meta["name"],
                                       d.meta.get("commutative", True))
            rp.stats["replayed"] += 1
        elif d.kind == Kind.REQUEST:
            # completed during drain; re-materialize as a done request
            d.phys = backend.request_create(dict(d.meta))
            d.state["done"] = True


def _finalize_rebind(rp: _RebindPlan) -> None:
    """Post-bind bookkeeping that needs every handle in place (legacy
    shadow tables mirror physical handles)."""
    mana = rp.mana
    if mana.legacy is not None:
        from repro_torch.core.interpose import _KIND_NAME
        for d in mana.vids.all_descriptors():
            lvid = mana.legacy.insert(_KIND_NAME[d.kind], d.phys)
            mana._legacy_of[d.vid] = lvid


def _execute_rebind(plans: list, pool=None) -> None:
    """Run every rank's rebind DAG.  With a pool: one combined ready-queue —
    a job is submitted the moment its parent resolves, so independent
    descriptors of ALL ranks interleave with whatever else (leaf reads) the
    pool is chewing on.  Without: the seed-equivalent sequential walk in
    creation order (kept as the measured baseline and zero-thread path)."""
    if pool is None:
        for rp in plans:
            order = sorted((vid for vid, m in rp.modes.items() if m != "lazy"),
                           key=lambda v: rp.by_vid[v].meta.get("order", 0))
            for vid in order:
                _bind_one(rp, vid)
            _finalize_rebind(rp)
        return

    lock = threading.Lock()
    done = threading.Event()
    errors: list[BaseException] = []
    waiting: dict[tuple, list] = {}      # (plan_i, parent) -> [(plan_i, vid)]
    ready: list[tuple] = []
    pending = 0
    completed = 0
    for i, rp in enumerate(plans):
        for vid, mode in rp.modes.items():
            if mode == "lazy":
                continue
            pending += 1
            parent = rp.deps.get(vid)
            if parent is None:
                ready.append((i, vid))
            else:
                waiting.setdefault((i, parent), []).append((i, vid))
    if pending == 0:
        for rp in plans:
            _finalize_rebind(rp)
        return

    def run(node):
        nonlocal pending, completed
        i, vid = node
        try:
            _bind_one(plans[i], vid)
        except BaseException as e:  # noqa: BLE001
            with lock:
                errors.append(e)
        with lock:
            for child in waiting.pop((i, vid), ()):
                pool.submit(run, child)
            pending -= 1
            completed += 1
            if pending == 0:
                done.set()

    for node in ready:
        pool.submit(run, node)
    # progress-aware wait: raise only when a whole timeout slice passes
    # with ZERO descriptors resolved — a genuine wedge — rather than
    # capping total rebind time (a big world legitimately takes a while)
    last = 0
    while not done.wait(_REBIND_TIMEOUT):
        with lock:
            now, left = completed, pending
        if now == last:
            raise TimeoutError(f"rebind stalled: {left} descriptor(s) "
                               f"unresolved with no progress for "
                               f"{_REBIND_TIMEOUT}s")
        last = now
    if errors:
        raise errors[0]
    for rp in plans:
        _finalize_rebind(rp)


def rebind_objects(mana, snap: dict, *, pool=None) -> dict:
    """Replace ``mana``'s fresh vid table with the snapshot's and bind
    physical handles for every descriptor under the pair plan (checkpoint
    flavor -> ``mana``'s flavor).  ``pool`` (a ``ckpt_io.IOPool``) enables
    the dependency-ordered parallel engine; ``None`` is the sequential
    baseline.  Returns the rebind stats, including the resolved pair."""
    rp = _plan_rebind(mana, snap)
    _execute_rebind([rp], pool)
    rp.stats["pair"] = f"{rp.plan.src}->{rp.plan.dst}"
    return rp.stats


def rebind_world(pairs, *, pool=None) -> list:
    """Rebind MANY ranks' snapshots concurrently over one pool (the restart
    path: every rank's DAG plus the leaf-restore reads share the workers).
    ``pairs`` is [(mana, snap), ...]; returns per-rank stats in order."""
    failpoint("restore.rebind_world", ranks=len(pairs))
    plans = [_plan_rebind(m, s) for m, s in pairs]
    _execute_rebind(plans, pool)
    for rp in plans:
        rp.stats["pair"] = f"{rp.plan.src}->{rp.plan.dst}"
    return [rp.stats for rp in plans]


# ---------------------------------------------------------------------------
# array state: topology-oblivious load + elastic reshape
# ---------------------------------------------------------------------------

def plan_leaf_reads(manifest: dict) -> dict:
    """Group every shard entry by the (step, rank) container that physically
    holds its bytes — delta checkpoints point clean shards at a prior step —
    so each read task opens exactly one shard file.  The write-side planner
    (``ckpt_pipeline.plan_snapshot``) decided these locations; this is that
    plan read back in reverse."""
    groups: dict[tuple, list] = {}
    for li, meta in enumerate(manifest["leaves"]):
        for sh in meta["shards"]:
            step = sh.get("step", manifest["step"])
            groups.setdefault((step, sh["rank"]), []).append((li, sh))
    return groups


def _full_cover(sh: dict, shape: list) -> bool:
    """True when one shard entry spans the entire leaf — the common case
    (replicated or unsharded leaves), where the decoded bytes can BE the
    leaf instead of being copied into a preallocated buffer."""
    return sh["index"] == [[0, s] for s in shape]


class ArrayRestoreJob:
    """Leaf restore in flight on a shared pool.

    Constructing the job preallocates every leaf and immediately submits
    one task PER SHARD ENTRY — not per file — so a checkpoint whose bytes
    all live in one rank's container still fans out across every worker
    (entries of one file decode concurrently over a shared pread
    descriptor).  The file reads and GIL-releasing decompression overlap
    descriptor rebinding scheduled on the same pool; ``result()`` waits for
    the reads and performs the elastic reshape placement."""

    def __init__(self, source, manifest: dict, shardings, pool, *,
                 arenas=()):
        _require_chunked(manifest)
        self.source = as_source(source)
        self.manifest = manifest
        self._arenas = arenas
        self._meta = manifest["leaves"]
        flat_sh, self._tree = tree_leaves(shardings), shardings
        if len(flat_sh) != len(self._meta):
            raise ValueError(f"checkpoint has {len(self._meta)} leaves, "
                             f"target tree has {len(flat_sh)}")
        self._flat_sh = flat_sh
        self.place_ms = 0.0      # host->device placement, once result() ran
        # leaves allocate lazily: a full-cover shard's decoded bytes BECOME
        # the leaf (zero staging copy); only partially-sharded leaves get a
        # preallocated destination buffer
        self._leaves: list = [None] * len(self._meta)
        self._readers: dict[tuple, object] = {}
        self._rlock = threading.Lock()
        self._alloc_lock = threading.Lock()
        self._futures = [
            pool.submit(self._read_entry, step, rank, li, sh)
            for (step, rank), shards in plan_leaf_reads(manifest).items()
            for li, sh in shards]

    def _reader(self, step, rank):
        key = (step, rank)
        with self._rlock:
            r = self._readers.get(key)
            if r is None:
                r = self._readers[key] = self.source.reader(step, rank)
            return r

    def _dest(self, li: int) -> np.ndarray:
        arr = self._leaves[li]
        if arr is None:
            with self._alloc_lock:
                arr = self._leaves[li]
                if arr is None:
                    meta = self._meta[li]
                    arr = self._leaves[li] = np.empty(
                        meta["shape"],
                        dtype=ckpt_io.resolve_dtype(meta["dtype"]))
        return arr

    def _read_entry(self, step, rank, li, sh) -> None:
        r = self._reader(step, rank)
        if _full_cover(sh, self._meta[li]["shape"]):
            # a full-cover shard is by construction the leaf's ONLY shard
            self._leaves[li] = r.read(sh["key"])
        else:
            # disjoint destination slices: concurrent writers never overlap
            idx = tuple(slice(a, b) for a, b in sh["index"])
            self._dest(li)[idx] = r.read(sh["key"])

    def result(self, timeout: float = 300.0):
        first_err = None
        for f in self._futures:
            try:
                f.result(timeout=timeout)
            except BaseException as e:  # noqa: BLE001
                if first_err is None:
                    first_err = e
        self.close()
        if first_err is not None:
            raise first_err
        t0 = time.perf_counter()
        out = _place_tree(self._leaves, self._flat_sh, self._tree,
                          self._arenas)
        self.place_ms = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    def close(self) -> None:
        """Release the shared readers (idempotent; ``result()`` calls it).
        Callers that abandon the job after a failure elsewhere in the
        restart MUST close it, or the pread fds leak."""
        with self._rlock:
            for r in self._readers.values():
                r.close()


def _require_chunked(manifest: dict) -> None:
    if manifest.get("format", 1) != ckpt_io.FORMAT_VERSION:
        raise ValueError(f"checkpoint format {manifest.get('format', 1)} is "
                         f"not the chunked container "
                         f"(format {ckpt_io.FORMAT_VERSION})")


def place_leaf(arr: np.ndarray, device, staging: torch.Tensor | None = None):
    """Put one reassembled host leaf where the restore wants it: ``None``
    keeps the host array (possibly a read-only view over the decoded
    bytes); a ``torch.device`` gets a tensor there, bfloat16 through its
    ``uint16`` bits.  A card's tensor is copied ``non_blocking`` from
    ``staging``, the leaf's pinned region of a host arena, which the caller
    keeps until it has synchronized (``_place_tree``)."""
    if device is None:
        return arr
    device = torch.device(device)
    host = staging if staging is not None \
        else torch.empty(arr.nbytes, dtype=torch.uint8)
    if arr.nbytes:
        host.numpy()[:] = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    out = host.to(device, non_blocking=True) if device.type == "cuda" else host
    return out.view(torch_dtype(arr.dtype)).view(tuple(arr.shape))


def _place_tree(leaves, flat_sh, tree, arenas=()):
    """Place every leaf (``place_leaf``).  The card's leaves are staged
    through ONE pinned buffer: the first free arena of ``arenas`` (the
    writer's pair), else a transient one; it is held until the copies have
    completed.  The arena is reserved for the whole tree in the snapshot's
    layout, so the next snapshot of what was restored reuses it as is.
    There is no CPU fallback: a card that is missing raises."""
    to_card = {i for i, sh in enumerate(flat_sh)
               if sh is not None and torch.device(sh).type == "cuda"}
    offs, total = arena_layout(leaves)
    arena = next((a for a in arenas if a.try_acquire()), None) \
        if to_card else None
    try:
        buf = None
        if to_card:
            if not torch.cuda.is_available():
                raise RuntimeError("restore onto cuda, but no CUDA device "
                                   "is present")
            buf = (arena or HostArena()).reserve(total, pinned=True)
        out = [place_leaf(arr, sh, buf[offs[i]:offs[i] + arr.nbytes]
                          if i in to_card else None)
               for i, (arr, sh) in enumerate(zip(leaves, flat_sh))]
        for dev in {torch.device(flat_sh[i]) for i in to_card}:
            torch.cuda.synchronize(dev)
    finally:
        if arena is not None:
            arena.release()
    return tree_unflatten(tree, out)


def _load_leaves_v2_seq(source, manifest: dict) -> list:
    """Sequential v2 loader: same format, same group plan, same zero-copy
    full-cover path, ZERO threads — the baseline the parallel restore is
    checked against, and the fallback when a caller cannot afford a
    pool."""
    leaves_meta = manifest["leaves"]
    leaves: list = [None] * len(leaves_meta)
    for (step, rank), shards in plan_leaf_reads(manifest).items():
        with source.reader(step, rank) as r:
            for li, sh in shards:
                meta = leaves_meta[li]
                if _full_cover(sh, meta["shape"]):
                    leaves[li] = r.read(sh["key"])
                    continue
                if leaves[li] is None:
                    leaves[li] = np.empty(
                        meta["shape"],
                        dtype=ckpt_io.resolve_dtype(meta["dtype"]))
                idx = tuple(slice(a, b) for a, b in sh["index"])
                leaves[li][idx] = r.read(sh["key"])
    return leaves


def load_arrays(ckpt, shardings, *, io_workers=None, parallel=True,
                pool=None, arenas=()):
    """Reassemble every leaf from per-rank shard containers and place it
    with the NEW shardings (tree matching the manifest leaf order) — the new
    mesh / device count may differ from checkpoint time (elastic reshape).

    ``ckpt`` is a committed step directory OR any checkpoint source (see
    :func:`as_source`).  ``parallel=True`` fans shard-group reads out over
    ``pool`` (or a transient pool of ``io_workers``); ``parallel=False`` is
    the sequential baseline.  ``arenas`` (a writer's pinned pair) stage the
    leaves bound for the card."""
    src = as_source(ckpt)
    manifest = src.manifest()
    _require_chunked(manifest)
    if parallel:
        own = pool is None
        if own:
            pool = ckpt_io.IOPool(
                io_workers or ckpt_io.default_workers(manifest["world_size"]))
        try:
            return ArrayRestoreJob(src, manifest, shardings, pool,
                                   arenas=arenas).result()
        finally:
            if own:
                pool.close()
    leaves = _load_leaves_v2_seq(src, manifest)
    flat_sh = tree_leaves(shardings)
    if len(flat_sh) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                         f"target tree has {len(flat_sh)}")
    return _place_tree(leaves, flat_sh, shardings, arenas)


# ---------------------------------------------------------------------------
# checkpoint directory scanning: manifests, rank images, resume chains
# ---------------------------------------------------------------------------

def load_manifest(ckpt_dir) -> dict:
    return json.loads((Path(ckpt_dir) / "manifest.json").read_text())


def load_rank_state(ckpt_dir, rank: int) -> dict:
    p = Path(ckpt_dir) / f"rank{rank:05d}" / "state.json"
    return json.loads(p.read_text())


# ---------------------------------------------------------------------------
# checkpoint sources: where an image's bytes live (disk dir, RAM tier, ...)
# ---------------------------------------------------------------------------

class DirCheckpointSource:
    """The canonical checkpoint source: one committed ``step_XXXXXXXX``
    directory on disk.

    A checkpoint *source* is the restore engine's storage abstraction —
    anything exposing ``name`` / ``manifest()`` / ``rank_state(rank)`` /
    ``reader(step, rank)`` can serve a restore: this class for the disk
    tier, ``ckpt_tiers.TierImage`` for the peer-replicated RAM tier.
    ``reader`` takes an explicit step because delta manifests point clean
    shards at PRIOR steps' containers (``plan_leaf_reads``), which for a
    directory source live under sibling step dirs of the same base."""

    def __init__(self, step_dir):
        self.path = Path(step_dir)
        self._root = self.path.parent
        self._state_texts: dict[int, str] = {}

    @property
    def name(self) -> str:
        return self.path.name

    def manifest(self) -> dict:
        return load_manifest(self.path)

    def rank_state(self, rank: int) -> dict:
        # cache the TEXT, parse per call: rebinding mutates descriptor meta
        # in place, so parsed state must never be shared between ranks
        text = self._state_texts.get(rank)
        if text is None:
            p = self.path / f"rank{rank:05d}" / "state.json"
            text = self._state_texts[rank] = p.read_text()
        return json.loads(text)

    def reader(self, step: int, rank: int) -> ckpt_io.RankShardReader:
        return ckpt_io.RankShardReader(
            self._root / f"step_{step:08d}" / f"rank{rank:05d}")


def as_source(ckpt):
    """Coerce ``ckpt`` (a step-dir path, or any object already satisfying
    the checkpoint-source protocol) into a source."""
    if callable(getattr(ckpt, "reader", None)) \
            and callable(getattr(ckpt, "manifest", None)):
        return ckpt
    return DirCheckpointSource(ckpt)


def completed_steps(base_dir) -> list:
    """Sorted committed step dirs under a checkpoint base dir (``.tmp`` and
    uncommitted dirs are invisible: half-written checkpoints can never be
    restored from)."""
    base = Path(base_dir)
    if not base.is_dir():
        return []
    return sorted(d for d in base.iterdir()
                  if d.name.startswith("step_")
                  and not d.name.endswith(".tmp")
                  and (d / "COMMIT").exists())


def verify_checkpoint(step_dir, *, deep: bool = True) -> list:
    """Integrity-check one committed checkpoint dir.  Returns a list of
    problems (empty = the checkpoint verifies):

      * manifest / per-rank ``index.json`` / ``state.json`` must parse;
      * every entry's chunk extents must fit inside ``shards.bin`` (catches
        truncation — a torn write at power loss);
      * with ``deep=True`` every entry is decoded (corrupt compressed
        streams fail here) and, where the index records a content digest
        and the codec is lossless, re-hashed against it (catches silent
        bit-flips in raw chunks).

    Raw (``none``-codec) entries written without digests are structurally
    checked only — write with ``incremental=True`` or a compressed codec
    when corruption detection matters (the chaos harness does)."""
    step_dir = Path(step_dir)
    problems: list[str] = []
    try:
        manifest = load_manifest(step_dir)
    except (OSError, ValueError) as e:
        return [f"manifest unreadable: {e}"]
    # every rank the manifest promises must have its container: restart
    # reads rank{r}/state.json for r in range(world_size), so a lost rank
    # dir (partial copy, operator rm) makes the image unrestorable even
    # though everything still present verifies
    for r in range(manifest.get("world_size", 0)):
        if not (step_dir / f"rank{r:05d}").is_dir():
            problems.append(f"rank{r:05d}: container missing")
    for rdir in sorted(step_dir.iterdir()):
        if not rdir.is_dir() or not rdir.name.startswith("rank"):
            continue
        try:
            json.loads((rdir / "state.json").read_text())
        except (OSError, ValueError) as e:
            problems.append(f"{rdir.name}/state.json unreadable: {e}")
        try:
            index = ckpt_io.read_rank_index(rdir)
        except (OSError, ValueError) as e:
            problems.append(f"{rdir.name}/index.json unreadable: {e}")
            continue
        try:
            bin_size = (rdir / ckpt_io.BIN_NAME).stat().st_size
        except OSError as e:
            problems.append(f"{rdir.name}/{ckpt_io.BIN_NAME} missing: {e}")
            continue
        entries = index.get("entries", {})
        torn = False
        for key, ent in entries.items():
            end = ent["offset"] + sum(c[0] for c in ent["chunks"])
            if end > bin_size:
                problems.append(
                    f"{rdir.name}/{key}: entry extends to byte {end} but "
                    f"{ckpt_io.BIN_NAME} holds {bin_size} (truncated)")
                torn = True
        if torn or not deep or not entries:
            continue
        try:
            codec = ckpt_io.get_codec(index["codec"])
        except KeyError as e:
            problems.append(f"{rdir.name}: unknown codec: {e}")
            continue
        with ckpt_io.RankShardReader(rdir, codec) as r:
            for key, ent in entries.items():
                try:
                    arr = r.read(key)
                except Exception as e:  # noqa: BLE001 — any decode failure
                    problems.append(f"{rdir.name}/{key}: undecodable: {e}")
                    continue
                # lossy codecs round-trip to different bytes by design, so
                # their recorded (pre-quantization) digests cannot re-verify
                if ent.get("digest") and not codec.lossy:
                    if ckpt_io.shard_digest(arr) != ent["digest"]:
                        problems.append(
                            f"{rdir.name}/{key}: content digest mismatch")
    return problems


def find_resumable(base_dir, *, verify: bool = True, deep: bool = True):
    """Newest committed checkpoint that is actually RESTORABLE:

      * its delta chain fully resolves — every ``base_steps`` entry a delta
        manifest references must itself still be a committed step dir (GC
        protects live chains, but an operator rm / a partial copy can
        orphan one);
      * with ``verify=True`` (default) the checkpoint AND every base step
        its clean shards point at pass :func:`verify_checkpoint` — a torn
        or corrupted image that still carries its COMMIT marker is skipped,
        so recovery lands on the previous good checkpoint instead of
        failing mid-restore.

    Walks newest-to-oldest and returns the first intact checkpoint, or
    ``None`` — resume-from-latest must never pick an image whose shards
    have no (valid) backing bytes."""
    steps = completed_steps(base_dir)
    have: dict[int, Path] = {}
    for d in steps:
        try:
            have[int(d.name[len("step_"):])] = d
        except ValueError:
            continue
    verified: dict[str, bool] = {}

    def _ok(d: Path) -> bool:
        if d.name not in verified:
            verified[d.name] = not verify_checkpoint(d, deep=deep)
        return verified[d.name]

    for d in reversed(steps):
        try:
            man = load_manifest(d)
        except (OSError, ValueError):
            continue
        bases = man.get("base_steps", [])
        if not all(b in have for b in bases):
            continue
        if verify and not all(_ok(x) for x in [d] + [have[b] for b in bases]):
            continue
        return d
    return None
