"""Live rescale engine: membership change WITHOUT a restart (ROADMAP 5).

Every recovery path so far — disk, delta chain, RAM tier — is a restore:
tear the world down, rebuild every lower half, rebind every vid, reload
the arrays.  That bounds MTTR by image size.  A membership change does
not need any of it: when a rank leaves (preemption notice, node death)
or a spare joins, the surviving ranks' state is ALREADY CORRECT — only
the world communicator, the replica ring, and the departed rank's
in-flight traffic need attention.  This module is that protocol; its
downtime is bounded by a constant (one scoped drain + one re-point), not
by checkpoint size.

**Graceful leave** (:func:`shrink`, the preemption path):

  1. scoped drain — the leaving rank quiesces (its own requests + inbox,
     ``drain.drain_rank``) and every survivor drains just its edge TO the
     leaving rank (``drain.drain_peer``): after this nothing is in flight
     on any edge touching the leaver, while survivor<->survivor traffic
     keeps flowing;
  2. handoff — the leaver pushes its departure payload to its state
     inheritor (its ring successor in the post-shrink world) over the
     interposed p2p plane under the internal ``rescale`` tag: its
     buffered user p2p messages (so drained-but-undelivered traffic
     re-delivers from the inheritor, never drops), its RAM-tier
     containers, and an opaque workload cursor (the data pipeline's);
  3. scavenge — anything still queued at the leaver's fabric inbox is
     redelivered (user tags -> the inheritor's buffered receive) or
     CANCELLED with a typed record (internal collective tags: their
     round dies with the old membership), never silently dropped; the
     inbox is then retired so later sends raise ``DepartedRankError``;
  4. re-point — every survivor frees its old world COMM vid, rebuilds
     the lower half's world communicator over the (sparse) survivor
     list, and registers the new world vid (``restore.repoint_world``);
     identical member lists hash to identical ggids, so all survivors
     agree on the new vid without coordination;
  5. re-pair — the replica tier's ring is repaired
     (``ReplicaTier.repair``) so every held container is redundant again.

A DEAD leaver (no graceful window) skips 1's leaver half and 2: its RAM
containers already live in its ring partner's memory — that is what the
replica tier is for — and the supervisor falls back to the restore
ladder only when even those are gone.

**Live join** (:func:`join`): the spare attaches via a handshake on the
``rescale`` rendezvous channel — announce, ``elastic.join.ready``
failpoint (where the ``join_timeout`` fault stalls it), welcome — then
the sponsor (lowest surviving rank) streams the newest image's
containers to the joiner as ``MemoryShardReader``-backed pushes, each
verified against its push-time checksum on arrival.  Only after the
digest-verified transfer does membership change (``Cluster.resize``); a
joiner that stalls mid-handshake is fenced (slot dead, inbox retired)
and the running world never sees it.

Cross-flavor rule (the ABI-interop constraint, arXiv:2503.11138): a
joiner speaks the CLUSTER's backend flavor — handles are session-local
and never cross the wire (only serialized container bytes do), so the
join protocol itself is flavor-oblivious, exactly like the restart
matrix.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.callspec import TAG_BASES, coll_tag, handle_vid
from repro_torch.core.drain import drain_peer, drain_rank
from repro_torch.core.faults import failpoint

#: rendezvous channel for the join handshake: the joiner has no world
#: communicator yet, so the comm-vid half of the tag is 0 by convention
JOIN_TAG = (TAG_BASES["rescale"] << 32) | 0

_USER_TAG_MAX = 1 << 32          # tags below this are user p2p traffic


class RescaleError(RuntimeError):
    """A live membership change could not complete; the caller (the
    supervisor's rescale rung) falls through to the restore ladder."""


class JoinTimeoutError(RescaleError):
    """A joining rank stalled mid-handshake.  The joiner is FENCED (its
    slot is dead, its inbox retired); the running world's membership
    never changed, so survivors continue untouched."""

    def __init__(self, rank: int, msg: str):
        self.rank = rank
        super().__init__(msg)


@dataclass
class RescaleReport:
    """What one membership change did, with its downtime breakdown."""
    kind: str                               # "shrink" | "join"
    rank: int                               # who left / who joined
    graceful: bool
    members: list = field(default_factory=list)   # post-change world
    inheritor: int | None = None            # shrink: who inherited state
    redelivered: int = 0                    # user msgs re-aimed at inheritor
    cancelled: list = field(default_factory=list)  # [(src, tag), ...] typed
    handoff_items: int = 0                  # containers + cursors handed off
    workload_cursor: object = None          # opaque cursor for the workload
    slice_verified: bool | None = None      # join: digest check outcome
    repair: dict = field(default_factory=dict)     # ReplicaTier.repair stats
    timings: dict = field(default_factory=dict)    # drain/handoff/repoint ms
    downtime_ms: float = 0.0


def _rescale_tag(mana) -> int:
    return coll_tag("rescale", handle_vid(mana.comm_world()))


def _inheritor_of(rank: int, members_after: list) -> int | None:
    """The state inheritor is the leaver's ring successor in the
    post-shrink world — the same wrapping rule the replica tier pairs by,
    so the inheritor usually already holds the leaver's newest replica."""
    from repro_torch.core.ckpt_tiers import ring_partner
    return ring_partner(rank, members_after)


# ---------------------------------------------------------------------------
# shrink: graceful leave / death without restore
# ---------------------------------------------------------------------------

def shrink(cluster, leaving: int, *, tier=None, cursor=None,
           timeout: float = 10.0) -> RescaleReport:
    """Shrink the world by ``leaving`` — live, no restart.

    ``cursor`` is an opaque workload payload the leaver hands to its
    inheritor (a trainer would pass its data-pipeline cursor); it comes
    back on the report as ``workload_cursor`` for the workload's rescale
    hook.  ``tier`` (a ``ReplicaTier``) rides along: the leaver hands its
    held containers over, and the ring re-pairs after the re-point.

    Raises :class:`RescaleError` when the world cannot shrink (last
    member) and propagates :class:`DrainStallError` when the scoped drain
    blows its deadline — the supervisor treats either as "fall through to
    the restore ladder"."""
    t0 = time.perf_counter()
    failpoint("elastic.shrink", rank=leaving)
    slot = cluster.ranks[leaving]
    graceful = slot.alive and not slot.halted
    members_after = [r for r in cluster.survivors() if r != leaving]
    if not members_after:
        raise RescaleError(f"cannot shrink: rank {leaving} is the last "
                           f"member of the world")
    inheritor = _inheritor_of(leaving, members_after)
    report = RescaleReport(kind="shrink", rank=leaving, graceful=graceful,
                           members=members_after, inheritor=inheritor)
    deadline = time.time() + timeout

    # 1. scoped drain of every edge touching the leaver
    t1 = time.perf_counter()
    if graceful:
        drain_rank(cluster.mana(leaving), timeout, deadline=deadline)
    for s in members_after:
        drain_peer(cluster.mana(s), leaving, timeout, deadline=deadline)
    report.timings["drain_ms"] = round((time.perf_counter() - t1) * 1e3, 3)

    # 2. handoff: the leaver pushes its departure payload to the inheritor
    #    over the interposed p2p plane (rescale tag, old world vid — both
    #    ends still share it; the re-point happens after)
    t2 = time.perf_counter()
    if graceful:
        lm, im = cluster.mana(leaving), cluster.mana(inheritor)
        user_pending = [(s, t, p) for s, t, p in lm.pending_messages
                        if t < _USER_TAG_MAX]
        # internal chunks the leaver's drain buffered (a collective round
        # it never entered): the round dies with the old membership — a
        # typed cancellation record, never a silent drop
        report.cancelled.extend((s, t) for s, t, _ in lm.pending_messages
                                if t >= _USER_TAG_MAX)
        held = {}
        if tier is not None:
            with tier._lock:
                held = {k: c for k, c in tier.stores.get(leaving, {}).items()}
        payload = {"op": "leave", "rank": leaving,
                   "pending": user_pending, "cursor": cursor,
                   "containers": [
                       {"step": c.step, "rank": c.rank, "index": c.index,
                        "data": c.data, "state": c.state, "sha": c.sha}
                       for c in held.values()]}
        lm.backend.send(inheritor, _rescale_tag(lm), payload)
        msg = im._recv_any(leaving, _rescale_tag(im))
        report.redelivered += len(msg["pending"])
        im.pending_messages.extend(tuple(p) for p in msg["pending"])
        report.workload_cursor = msg["cursor"]
        report.handoff_items = len(msg["containers"]) \
            + len(msg["pending"]) + (1 if cursor is not None else 0)
        if tier is not None and msg["containers"]:
            from repro_torch.core.ckpt_tiers import Container
            with tier._lock:
                for c in msg["containers"]:
                    tier.stores.setdefault(inheritor, {})[
                        (c["step"], c["rank"])] = Container(
                            c["step"], c["rank"], c["index"], c["data"],
                            c["state"], c["sha"])
    report.timings["handoff_ms"] = round((time.perf_counter() - t2) * 1e3, 3)

    # 3. scavenge the leaver's inbox, then retire it: user traffic is
    #    redelivered through the inheritor's buffered receive; internal
    #    collective rounds die with the old membership and are cancelled
    #    with a typed record — nothing is ever silently dropped
    im = cluster.mana(inheritor)
    for src, tag, payload in cluster.fabric.scavenge(leaving):
        if tag < _USER_TAG_MAX:
            im.pending_messages.append((src, tag, payload))
            report.redelivered += 1
        else:
            report.cancelled.append((src, tag))
    cluster.remove_rank(leaving)
    if report.cancelled:
        cluster.events.append(("rescale_cancelled_msgs", leaving,
                               list(report.cancelled), time.time()))

    # 4. re-point COMM_WORLD on the shrunken world
    t3 = time.perf_counter()
    cluster.resize(members_after)
    report.timings["repoint_ms"] = round((time.perf_counter() - t3) * 1e3, 3)

    # 5. re-pair the replica ring
    if tier is not None:
        report.repair = tier.repair(cluster)
    report.timings["total_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    report.downtime_ms = report.timings["total_ms"]
    cluster.events.append(("rescaled", "shrink", leaving,
                           tuple(members_after), time.time()))
    return report


# ---------------------------------------------------------------------------
# join: a spare attaches, live
# ---------------------------------------------------------------------------

def join(cluster, *, tier=None, source=None, cursor=None,
         timeout: float = 10.0) -> RescaleReport:
    """Grow the world by one rank — live, no restart.

    The joiner handshakes with a sponsor (the lowest surviving rank) on
    the rescale rendezvous channel, receives the newest image's
    containers as streamed, checksum-verified p2p pushes, and only then
    becomes a member (``Cluster.resize``).  ``source`` overrides where
    the slice streams from (default: the RAM tier's newest image;
    ``None`` with no tier means a stateless join).  ``cursor`` seeds the
    joiner's workload cursor (a trainer would pass a re-sharded
    data-pipeline position).

    A handshake stall (the ``join_timeout`` fault arms the
    ``elastic.join.ready`` failpoint) fences the joiner and raises
    :class:`JoinTimeoutError`; the running world's membership is
    untouched."""
    t0 = time.perf_counter()
    members_before = cluster.survivors()
    if not members_before:
        raise RescaleError("cannot join an empty world")
    sponsor = members_before[0]
    joiner = cluster.add_rank()
    new_rank = joiner.rank
    report = RescaleReport(kind="join", rank=new_rank, graceful=True,
                           members=members_before + [new_rank])

    t1 = time.perf_counter()
    try:
        # announce -> ready gate -> welcome, all on the rendezvous tag
        joiner.backend.send(sponsor, JOIN_TAG,
                            {"op": "join", "rank": new_rank})
        failpoint("elastic.join.ready", rank=new_rank)
        sm = cluster.mana(sponsor)
        hello = sm._recv_any(new_rank, JOIN_TAG)
        if hello.get("op") != "join":
            raise RescaleError(f"bad join announce: {hello!r}")
        sm.backend.send(new_rank, JOIN_TAG,
                        {"op": "welcome", "members": members_before,
                         "sponsor": sponsor})
        welcome = joiner._recv_any(sponsor, JOIN_TAG)
        if welcome.get("op") != "welcome":
            raise RescaleError(f"bad join welcome: {welcome!r}")
    except Exception as e:  # noqa: BLE001 — fence, never poison the world
        cluster.ranks[new_rank].alive = False
        cluster.fabric.retire(new_rank)
        cluster.events.append(("join_fenced", new_rank, time.time()))
        raise JoinTimeoutError(
            new_rank, f"joining rank {new_rank} fenced: {e}") from e
    report.timings["handshake_ms"] = round(
        (time.perf_counter() - t1) * 1e3, 3)

    # stream the slice: sponsor pushes the newest image's containers to
    # the joiner over the rendezvous channel, checksum-verified on arrival
    t2 = time.perf_counter()
    image = source
    if image is None and tier is not None:
        image = tier.image(cluster)
    if image is not None and getattr(image, "containers", None):
        from repro_torch.core.ckpt_tiers import Container, container_sha
        sm = cluster.mana(sponsor)
        sent = list(image.containers.values())
        for c in sent:
            sm.backend.send(new_rank, JOIN_TAG,
                            {"op": "shard", "step": c.step, "rank": c.rank,
                             "index": c.index, "data": c.data,
                             "state": c.state, "sha": c.sha})
        sm.backend.send(new_rank, JOIN_TAG, {"op": "done", "count": len(sent)})
        got: dict[tuple, object] = {}
        verified = True
        while True:
            msg = joiner._recv_any(sponsor, JOIN_TAG)
            if msg.get("op") == "done":
                break
            if container_sha(msg["data"]) != msg["sha"]:
                verified = False
                continue
            got[(msg["step"], msg["rank"])] = Container(
                msg["step"], msg["rank"], msg["index"], msg["data"],
                msg["state"], msg["sha"])
        report.handoff_items = len(got)
        report.slice_verified = verified and len(got) == len(sent)
        if tier is not None and got:
            with tier._lock:
                for key, c in got.items():
                    tier.stores.setdefault(new_rank, {})[key] = c
    report.workload_cursor = cursor
    report.timings["stream_ms"] = round((time.perf_counter() - t2) * 1e3, 3)

    # membership changes only now — after the verified transfer
    t3 = time.perf_counter()
    cluster.resize(members_before + [new_rank])
    report.timings["repoint_ms"] = round((time.perf_counter() - t3) * 1e3, 3)
    if tier is not None:
        report.repair = tier.repair(cluster)
    report.timings["total_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    report.downtime_ms = report.timings["total_ms"]
    cluster.events.append(("rescaled", "join", new_rank,
                           tuple(report.members), time.time()))
    return report
