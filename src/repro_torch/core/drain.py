"""Checkpoint-time quiesce protocol (paper §5 category 1).

MANA guarantees no rank is blocked in the lower half at checkpoint time and no
message is lost: pending point-to-point traffic is probed (MPI_Iprobe),
received into upper-half buffers (MPI_Recv), and outstanding requests are
completed (MPI_Test). Here the same protocol drains the host-side fabric and
the async-request descriptors (prefetch batches, async ckpt uploads).

The drain is the first half of the checkpoint's stop-the-world window, so it
is engineered for latency:

  * every rank quiesces CONCURRENTLY on a persistent thread pool (no
    per-checkpoint thread spawn) under ONE shared deadline;
  * outstanding requests are polled with a single batched
    ``backend.test_all`` call per round (MPI_Testall) instead of one
    round trip per request;
  * polling backs off exponentially from ``backoff`` seconds instead of
    napping a fixed 1 ms per incomplete request;
  * each drain phase owns a deadline slice — a slow request-completion
    phase can consume at most half the budget, so the fabric-drain phase is
    never silently starved — and a timeout reports what *was* drained.

``drain_world`` returns stats keyed by RANK ID (dead ranks are simply
absent); callers must never index the result positionally.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.core.callspec import COLL_TAG_MIN
from repro_torch.core.descriptors import Kind
from repro_torch.core.faults import failpoint

DEFAULT_TIMEOUT = 10.0
DEFAULT_BACKOFF = 5e-5          # first poll sleep; doubles up to _BACKOFF_CAP
_BACKOFF_CAP = 5e-3


class DrainStallError(TimeoutError):
    """A rank's quiesce blew its deadline slice: some request refused to
    complete or the fabric refused to drain.  Carries the stalled ``rank``
    and the partial ``stats`` so a supervisor can ESCALATE — classify the
    stall, fence the stuck rank, and recover from the last good checkpoint —
    instead of the checkpoint call crashing the job."""

    def __init__(self, rank: int, stats: dict, msg: str):
        self.rank = rank
        self.stats = stats
        super().__init__(msg)

_pool: ThreadPoolExecutor | None = None
_pool_size = 0
_pool_lock = threading.Lock()


def _drain_pool(workers: int) -> ThreadPoolExecutor:
    """Shared drain executor, grown (never shrunk) to the largest world seen.
    Every rank must run concurrently — they meet at a barrier — so the pool
    is sized to the world, and reused so a checkpoint never pays thread
    spawn on the blocking path."""
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None or _pool_size < workers:
            old = _pool
            _pool_size = max(workers, _pool_size, 4)
            _pool = ThreadPoolExecutor(max_workers=_pool_size,
                                       thread_name_prefix="drain")
            if old is not None:
                old.shutdown(wait=False)
        return _pool


def drain_rank(mana, timeout: float = DEFAULT_TIMEOUT, *,
               backoff: float = DEFAULT_BACKOFF,
               deadline: float | None = None) -> dict:
    """Quiesce one rank. Returns drain statistics.

    Phase 1 (request completion, MPI_Testall loop) may spend at most HALF
    the remaining budget; phase 2 (probe + receive) owns everything left,
    including whatever phase 1 did not use.  A shared ``deadline`` (from
    ``drain_world``) overrides the per-rank ``timeout``."""
    t0 = time.time()
    if deadline is None:
        deadline = t0 + timeout
    failpoint("drain.rank", rank=mana.rank)
    stats = {"rank": mana.rank, "messages_buffered": 0,
             "coll_messages_buffered": 0,
             "requests_completed": 0, "test_rounds": 0, "waited_s": 0.0}

    # 1. complete outstanding requests: one batched test per round, backoff
    #    between rounds (in-process backends complete on the first round)
    p1_deadline = t0 + (deadline - t0) / 2
    pending = [d for d in mana.vids.iter_kind(Kind.REQUEST)
               if not d.state.get("done")]
    delay = backoff
    while pending:
        flags = mana.backend.test_all([d.phys for d in pending])
        stats["test_rounds"] += 1
        still = []
        for d, done in zip(pending, flags):
            if done:
                d.state["done"] = True
                stats["requests_completed"] += 1
            else:
                still.append(d)
        pending = still
        if not pending:
            break
        if time.time() >= p1_deadline:
            stats["waited_s"] = round(time.time() - t0, 6)
            raise DrainStallError(
                mana.rank, stats,
                f"rank {mana.rank}: {len(pending)} request(s) refused to "
                f"complete within the {p1_deadline - t0:.3f}s request-phase "
                f"budget (first: {pending[0].vid:#x}); partial drain: {stats}")
        time.sleep(delay)
        delay = min(delay * 2, _BACKOFF_CAP)

    # 2. probe + receive every in-flight message into the upper half; this
    #    phase owns its own deadline slice (the full remaining budget)
    while True:
        probe = mana.backend.iprobe()
        if probe is None:
            break
        src, tag = probe
        payload = mana.backend.recv(src, tag)
        mana.pending_messages.append((src, tag, payload))
        stats["messages_buffered"] += 1
        if tag >= COLL_TAG_MIN:
            # in-flight collective (or split-protocol) payload: it drains
            # like p2p and re-delivers through the buffered receive when the
            # peer's collective call resumes after restart
            stats["coll_messages_buffered"] += 1
        if time.time() >= deadline:
            stats["waited_s"] = round(time.time() - t0, 6)
            raise DrainStallError(
                mana.rank, stats,
                f"rank {mana.rank}: fabric refused to drain within the "
                f"{deadline - t0:.3f}s budget; partial drain: {stats}")

    stats["waited_s"] = round(time.time() - t0, 6)
    return stats


def drain_peer(mana, peer: int, timeout: float = DEFAULT_TIMEOUT, *,
               backoff: float = DEFAULT_BACKOFF,
               deadline: float | None = None) -> dict:
    """SCOPED quiesce: drain only the traffic between ``mana`` and one
    ``peer`` — the per-rank drain a live membership change needs.  A full
    ``drain_world`` stops every rank; a graceful leave must only guarantee
    that nothing is in flight TO OR FROM the leaving rank, so survivors
    keep computing while the departing edge quiesces.

    Phase 1 completes this rank's outstanding requests addressed to
    ``peer`` (batched test + backoff, same discipline as the global drain);
    phase 2 probes and buffers every in-flight message FROM ``peer`` into
    ``pending_messages`` (redelivery via the buffered receive, exactly as
    at checkpoint time).  Raises the same typed :class:`DrainStallError`
    on a blown deadline so supervisors escalate identically."""
    t0 = time.time()
    if deadline is None:
        deadline = t0 + timeout
    failpoint("drain.peer", rank=mana.rank, peer=peer)
    stats = {"rank": mana.rank, "peer": peer, "messages_buffered": 0,
             "coll_messages_buffered": 0,
             "requests_completed": 0, "test_rounds": 0, "waited_s": 0.0}

    def _to_peer(d) -> bool:
        m = d.meta
        return peer in (m.get("peer"), m.get("dst"), m.get("src"))

    p1_deadline = t0 + (deadline - t0) / 2
    pending = [d for d in mana.vids.iter_kind(Kind.REQUEST)
               if not d.state.get("done") and _to_peer(d)]
    delay = backoff
    while pending:
        flags = mana.backend.test_all([d.phys for d in pending])
        stats["test_rounds"] += 1
        still = []
        for d, done in zip(pending, flags):
            if done:
                d.state["done"] = True
                stats["requests_completed"] += 1
            else:
                still.append(d)
        pending = still
        if not pending:
            break
        if time.time() >= p1_deadline:
            stats["waited_s"] = round(time.time() - t0, 6)
            raise DrainStallError(
                mana.rank, stats,
                f"rank {mana.rank}: {len(pending)} request(s) to peer "
                f"{peer} refused to complete within the "
                f"{p1_deadline - t0:.3f}s budget; partial drain: {stats}")
        time.sleep(delay)
        delay = min(delay * 2, _BACKOFF_CAP)

    while True:
        probe = mana.backend.iprobe(src=peer)
        if probe is None:
            break
        src, tag = probe
        payload = mana.backend.recv(src, tag)
        mana.pending_messages.append((src, tag, payload))
        stats["messages_buffered"] += 1
        if tag >= COLL_TAG_MIN:
            stats["coll_messages_buffered"] += 1
        if time.time() >= deadline:
            stats["waited_s"] = round(time.time() - t0, 6)
            raise DrainStallError(
                mana.rank, stats,
                f"rank {mana.rank}: peer {peer} traffic refused to drain "
                f"within the {deadline - t0:.3f}s budget; "
                f"partial drain: {stats}")

    stats["waited_s"] = round(time.time() - t0, 6)
    return stats


def _drain_rank_once(mana) -> tuple:
    """One nonblocking quiesce sweep over a rank: a single batched test of
    its outstanding requests plus a full (never-waiting) message drain.
    Returns ``(stats, quiesced)``; ``quiesced=False`` means requests remain
    incomplete — this rank must WAIT on the lower half and the world should
    quiesce on the parallel path instead (the partial stats still count)."""
    stats = {"rank": mana.rank, "messages_buffered": 0,
             "coll_messages_buffered": 0,
             "requests_completed": 0, "test_rounds": 0, "waited_s": 0.0}
    pending = [d for d in mana.vids.iter_kind(Kind.REQUEST)
               if not d.state.get("done")]
    if pending:
        flags = mana.backend.test_all([d.phys for d in pending])
        stats["test_rounds"] = 1
        for d, done in zip(pending, flags):
            if done:
                d.state["done"] = True
                stats["requests_completed"] += 1
        if not all(flags):
            return stats, False
    while True:
        probe = mana.backend.iprobe()
        if probe is None:
            break
        src, tag = probe
        mana.pending_messages.append((src, tag, mana.backend.recv(src, tag)))
        stats["messages_buffered"] += 1
        if tag >= COLL_TAG_MIN:
            stats["coll_messages_buffered"] += 1
    return stats, True


def drain_world(manas, timeout: float = DEFAULT_TIMEOUT, *,
                backoff: float = DEFAULT_BACKOFF) -> dict:
    """Quiesce the world under ONE shared deadline.  Returns ``{rank_id:
    stats}`` — keyed by physical rank id, so with dead ranks the stats can
    never attach to the wrong survivor.

    Adaptive concurrency: parallelism only buys wall time when ranks must
    WAIT on the lower half, so the common case — every request completes on
    its first batched test, messages pop without blocking — is a single
    sequential sweep with no thread handoffs at all (the rendezvous the
    barrier provides is implicit when one sweep quiesces the whole world).
    The moment any rank's requests stay incomplete, the world switches to
    the concurrent path: every rank drains in parallel on a persistent pool
    with exponential-backoff batched polling, then meets at a barrier whose
    deadline guarantees one failed rank can never park the others' pool
    threads forever (the root-cause drain error is surfaced over secondary
    barrier timeouts)."""
    manas = list(manas)
    if not manas:
        return {}
    deadline = time.time() + timeout
    stats: dict[int, dict] = {}
    quiesced = True
    for m in manas:
        stats[m.rank], quiesced = _drain_rank_once(m)
        if not quiesced:
            break
    if quiesced:
        return stats

    # some rank must wait: concurrent quiesce (idempotent over the partial
    # sweep — completed requests stay done, drained messages stay buffered,
    # and the sweep's counts are MERGED in so ranks drained before the
    # switch don't report zeros in their checkpoint image)
    sweep, stats = stats, {}
    n = len(manas)
    pool = _drain_pool(n)

    def one(m):
        st = drain_rank(m, timeout, backoff=backoff, deadline=deadline)
        # barrier grace scales with the budget (capped at the historical 5 s)
        # so a supervisor running a tight drain_timeout gets a proportionally
        # tight escalation latency, not deadline + 5 s of dead air
        m.barrier(expected=n, timeout=max(deadline - time.time(), 0.1)
                  + min(5.0, timeout / 2))
        return st

    futures = {m.rank: pool.submit(one, m) for m in manas}
    errs: list[Exception] = []
    for rank, f in futures.items():
        try:
            st = f.result(timeout=timeout + 10)
            for k in ("messages_buffered", "coll_messages_buffered",
                      "requests_completed", "test_rounds"):
                st[k] += sweep.get(rank, {}).get(k, 0)
            stats[rank] = st
        except Exception as e:  # noqa: BLE001
            errs.append(e)
    if errs:
        errs.sort(key=lambda e: "barrier" in str(e))
        raise errs[0]
    return stats

