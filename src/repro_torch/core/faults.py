"""Fault-injection harness: scheduled, first-class failures for chaos testing.

The NERSC production follow-up to MANA (Chouhan et al.) is blunt about where
transparent checkpointing earns its keep: surviving *real* failures — dead
ranks, torn writes, stalled drains — not the happy path.  This module makes
failure a schedulable event instead of a hand-rolled ``Cluster.kill_rank``
call, so the supervisor (``repro_torch.core.supervisor``) and the chaos matrix
(``tests/scenarios/chaos_matrix.py``) can continuously exercise every
recovery path.

Two mechanisms:

**Failpoints** — named injection sites compiled into production code
(``failpoint("ckpt.snapshot_batch", ...)``).  Disarmed, a failpoint is one
dict lookup returning ``None``; armed, the registered handler runs with the
site's context and may raise.  This is how a fault lands *inside* a layer
(mid-``snapshot_batch``, mid-``RankShardWriter.add``) without threading
test-only parameters through every signature.

**FaultInjector** — interprets a :class:`FaultPlan` (a list of
:class:`FaultSpec`) against a live cluster.  Each spec fires once at a
scheduled step and simulates one production failure class:

  ==============  ========================================================
  kind            mechanics
  ==============  ========================================================
  kill_rank       the victim's lower half dies: backend swapped for a
                  :class:`DeadLowerHalf` that raises on any call, and the
                  rank stops renewing its heartbeat lease
  stall_drain     a poisoned never-completing request is planted on the
                  victim, so the next ``drain_world`` blows its deadline
                  slice (``DrainStallError`` -> supervisor escalation)
  corrupt_shard   random bytes overwrite the middle of a committed
                  checkpoint's ``shards.bin`` (or ``index.json``) — the
                  checkpoint *looks* complete but digest-verification
                  must reject it
  truncate_shard  a committed ``shards.bin`` is truncated to 60% (torn
                  write at power loss)
  drop_token      the victim's session token for COMM_WORLD is freed out
                  from under it (fabric-direct nonce tokens are the
                  motivating case; every flavor dangles uniformly via
                  ``comm_free``), detected by the supervisor's active probe
  snapshot_error  the ``ckpt.snapshot_batch`` failpoint raises mid-batch,
                  failing a checkpoint inside its blocking window
  partner_death   the victim AND its ring replica partner die together
                  before any pull: both RAM copies of the victim's newest
                  container are gone, so the supervisor's ladder must
                  escalate past the RAM tier to disk
  corrupt_replica byte-flips BOTH in-memory copies of the victim's newest
                  container (the push-time checksum is left alone), so the
                  RAM tier's verification must reject the image
  double_fault    kills the victim AND arms the supervisor's
                  ``supervisor.pre_restore`` failpoint: a second rank dies
                  while the restore is in flight — the incident must
                  absorb it, never drop it
  restore_error   kills the victim AND arms the ``restore.rebind_world``
                  failpoint one-shot: the first restore attempt dies
                  mid-rebind, exercising the ladder's bounded per-rung
                  retry
  preempt_notice  SIGTERM-style preemption notice with a grace deadline:
                  the victim is still ALIVE and must leave gracefully —
                  the supervisor's rescale rung drains its edge, hands
                  its state to survivors, and the world shrinks without
                  any restore
  join_timeout    arms the ``elastic.join.ready`` failpoint one-shot: the
                  next joining rank stalls mid-handshake and must be
                  FENCED without poisoning the running world (membership
                  only changes after the handshake completes)
  migrate_corrupt arms the ``serve.migrate.chunk`` failpoint one-shot: the
                  next live-migration chunk has its payload bytes flipped
                  AFTER its digest was recorded (a torn transfer on the
                  wire) — the receiver must reject the whole session and
                  the source must keep serving it
  ==============  ========================================================

Nothing here imports the checkpoint/restore stack — injection sites call in,
never the reverse — so arming faults can never change happy-path behavior.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path

FAULT_KINDS = ("kill_rank", "stall_drain", "corrupt_shard", "truncate_shard",
               "drop_token", "snapshot_error", "partner_death",
               "corrupt_replica", "double_fault", "restore_error",
               "preempt_notice", "join_timeout", "migrate_corrupt")

#: fault -> the checkpoint-cycle phase where it lands (the chaos matrix
#: sweeps (kind, phase, backend family); kill/drop can also fire at the
#: checkpoint boundary, where death is discovered by the drain instead of
#: the lease detector)
DEFAULT_PHASE = {"kill_rank": "compute", "stall_drain": "drain",
                 "corrupt_shard": "commit", "truncate_shard": "commit",
                 "drop_token": "compute", "snapshot_error": "snapshot",
                 "partner_death": "compute", "corrupt_replica": "compute",
                 "double_fault": "compute", "restore_error": "compute",
                 "preempt_notice": "compute", "join_timeout": "compute",
                 "migrate_corrupt": "compute"}


class InjectedFault(RuntimeError):
    """Raised by failpoint handlers that inject an error (distinguishable
    from organic failures in logs; the supervisor treats both the same)."""


class PreemptNotice(Exception):
    """A rank received a preemption notice (SIGTERM from the scheduler, a
    spot-instance reclaim, a drain decision): the lower half is STILL ALIVE
    and has ``grace_s`` seconds to leave gracefully.  The supervisor's
    rescale rung handles this class without fencing first — the victim
    participates in its own departure (scoped drain + state handoff)."""

    def __init__(self, rank: int, grace_s: float = 5.0):
        self.rank = rank
        self.grace_s = grace_s
        super().__init__(f"rank {rank}: preemption notice "
                         f"(grace {grace_s:.1f}s)")


# ---------------------------------------------------------------------------
# failpoints
# ---------------------------------------------------------------------------

_ARMED: dict[str, list] = {}
_ARM_LOCK = threading.Lock()


def failpoint(name: str, **ctx) -> None:
    """Injection site hook.  Production code calls this at named sites;
    the disarmed cost is a single dict lookup.  Handlers run with the
    site's context kwargs and may raise to inject a failure."""
    handlers = _ARMED.get(name)
    if not handlers:
        return
    for h in list(handlers):
        h(name, ctx)


def arm(name: str, handler) -> None:
    """Register ``handler(name, ctx)`` at a failpoint site."""
    with _ARM_LOCK:
        _ARMED.setdefault(name, []).append(handler)


def disarm(name: str, handler=None) -> None:
    """Remove one handler (or every handler of ``name``)."""
    with _ARM_LOCK:
        if handler is None:
            _ARMED.pop(name, None)
            return
        hs = _ARMED.get(name, [])
        if handler in hs:
            hs.remove(handler)
        if not hs:
            _ARMED.pop(name, None)


def disarm_all() -> None:
    with _ARM_LOCK:
        _ARMED.clear()


def armed() -> list:
    return sorted(_ARMED)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

@dataclass
class FaultSpec:
    """One scheduled fault."""
    kind: str
    at_step: int = 0             # workload step at which the fault fires
    rank: int | None = None      # victim rank (None -> highest alive rank)
    phase: str | None = None     # compute | drain | snapshot | commit
    target: str = "shards"       # corrupt/truncate target: shards | index
    grace_s: float = 5.0         # preempt_notice grace deadline (seconds)
    fired: bool = False

    _PHASES = ("compute", "commit", "drain", "snapshot", "checkpoint")

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        if self.phase is None:
            self.phase = DEFAULT_PHASE[self.kind]
        # a typo'd phase would match NEITHER firing point and the fault
        # would silently never inject — the operator would believe
        # resilience was exercised when nothing happened
        if self.phase not in self._PHASES:
            raise ValueError(f"unknown fault phase {self.phase!r}; "
                             f"known: {self._PHASES}")

    def to_dict(self) -> dict:
        return {"kind": self.kind, "at_step": self.at_step,
                "rank": self.rank, "phase": self.phase,
                "target": self.target, "grace_s": self.grace_s}


@dataclass
class FaultPlan:
    """An ordered list of scheduled faults, parseable from the CLI
    (``train.py --fault-plan``) as inline JSON or a path to a JSON file:
    ``[{"kind": "kill_rank", "at_step": 12, "rank": 1}, ...]``."""
    specs: list = field(default_factory=list)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        s = text.strip()
        if not s.startswith("[") and not s.startswith("{"):
            s = Path(text).read_text()
        data = json.loads(s)
        if isinstance(data, dict):
            data = [data]
        return cls([FaultSpec(**{k: v for k, v in spec.items()
                                 if k != "fired"}) for spec in data])

    def to_json(self) -> str:
        return json.dumps([s.to_dict() for s in self.specs])

    def pending(self) -> list:
        return [s for s in self.specs if not s.fired]


# ---------------------------------------------------------------------------
# dead lower half
# ---------------------------------------------------------------------------

class RankDeadError(RuntimeError):
    """Any call into a dead rank's lower half (the MPI library of a crashed
    node does not answer)."""

    def __init__(self, rank, msg: str | None = None):
        self.rank = rank
        super().__init__(msg or f"rank {rank}: lower half is dead")


class DeadLowerHalf:
    """Backend stand-in for a crashed node: every call raises
    :class:`RankDeadError`.  ``Cluster.halt_rank`` swaps this in so death is
    OBSERVABLE (a drain probing the dead rank fails, the supervisor's active
    probe fails) rather than the rank merely being flagged dead in the
    coordinator's bookkeeping."""

    def __init__(self, rank: int, name: str = "dead"):
        self.rank = rank
        self.name = name
        self.world_size = 0

    def shutdown(self):             # idempotent teardown stays callable
        pass

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        rank = object.__getattribute__(self, "rank")

        def _dead(*a, **k):
            raise RankDeadError(rank, f"rank {rank}: lower-half call "
                                      f"{attr!r} on a dead node")
        return _dead


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

class FaultInjector:
    """Fires a :class:`FaultPlan` against a live cluster.

    The supervisor (or a driver loop) calls :meth:`on_step` once per
    workload step; each due spec fires exactly once.  ``fired`` records
    ``(step, spec)`` for assertions; every fired fault also lands in
    ``cluster.events`` as ``("fault_injected", kind, rank, step)``."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: list = []
        self._armed: list = []      # (site, handler) pairs to disarm
        self.tier = None            # supervisor-wired ReplicaTier, if any

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Disarm every failpoint this injector registered."""
        for site, handler in self._armed:
            disarm(site, handler)
        self._armed.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- firing -------------------------------------------------------------
    _STEP_PHASES = ("compute", "commit")
    _CKPT_PHASES = ("drain", "snapshot", "checkpoint")

    def _fire_due(self, step: int, cluster, phases) -> list:
        out = []
        for spec in self.plan.specs:
            if spec.fired or step < spec.at_step or spec.phase not in phases:
                continue
            spec.fired = True
            # record BEFORE firing: some kinds (preempt_notice) fire by
            # raising, and the record must survive the propagating fault
            self.fired.append((step, spec))
            out.append(spec)
            self._fire(spec, step, cluster)
        return out

    def on_step(self, step: int, cluster) -> list:
        """Fire every due compute/commit-phase spec (called once per
        workload step, before the step runs).  Returns the specs fired."""
        return self._fire_due(step, cluster, self._STEP_PHASES)

    def on_checkpoint(self, step: int, cluster) -> list:
        """Fire every due drain/snapshot/checkpoint-phase spec (called
        immediately before a checkpoint, so the fault lands inside the
        stop-the-world window — discovered by the drain or the snapshot
        engine rather than the lease detector)."""
        return self._fire_due(step, cluster, self._CKPT_PHASES)

    def _victim(self, spec: FaultSpec, cluster) -> int:
        if spec.rank is not None:
            return spec.rank
        alive = cluster.survivors()
        if not alive:
            raise RuntimeError("no alive rank to inject into")
        return alive[-1]

    def _fire(self, spec: FaultSpec, step: int, cluster) -> None:
        fn = getattr(self, f"_fire_{spec.kind}")
        fn(spec, step, cluster)
        cluster.events.append(("fault_injected", spec.kind,
                               spec.rank, step))

    # -- kill_rank ----------------------------------------------------------
    def _fire_kill_rank(self, spec, step, cluster):
        victim = spec.rank = self._victim(spec, cluster)
        cluster.halt_rank(victim)

    # -- stall_drain --------------------------------------------------------
    def _fire_stall_drain(self, spec, step, cluster):
        """Plant a poisoned request on the victim: its descriptor is pending
        and the lower half reports it incomplete forever, so the next
        ``drain_world`` burns its request-phase deadline slice and raises
        ``DrainStallError`` — which the supervisor must catch and escalate
        instead of letting the checkpoint crash the job."""
        from repro_torch.core.descriptors import request_desc
        victim = spec.rank = self._victim(spec, cluster)
        mana = cluster.ranks[victim].mana
        backend = mana.backend
        phys = backend.request_create({"op": "isend", "dst": victim,
                                       "tag": -1, "poisoned": True})
        d = request_desc("isend", peer=victim, tag=-1)
        mana._register(d, phys)
        poisoned = {id(phys)}
        real_test_all, real_test = backend.test_all, backend.test

        def test_all(requests):
            flags = real_test_all(requests)
            return [False if id(r) in poisoned else f
                    for r, f in zip(requests, flags)]

        def test(request):
            if id(request) in poisoned:
                return False
            return real_test(request)

        backend.test_all, backend.test = test_all, test

    # -- corrupt / truncate -------------------------------------------------
    def _latest_committed(self, cluster) -> Path:
        from repro_torch.core.restore import completed_steps
        if cluster.writer is None:
            raise RuntimeError("corrupt/truncate fault needs a ckpt_dir")
        cluster.writer.wait_idle()     # the torn write targets COMMITTED bytes
        done = completed_steps(cluster.writer.base)
        if not done:
            raise RuntimeError("no committed checkpoint to corrupt")
        return done[-1]

    def _victim_file(self, spec, cluster) -> Path:
        from repro_torch.core import ckpt_io
        step_dir = self._latest_committed(cluster)
        rdirs = sorted(d for d in step_dir.iterdir()
                       if d.name.startswith("rank"))
        # the torn write must hit a container that actually HOLDS entries:
        # on a meshless run every shard lands in rank 0's container and the
        # other rank dirs are empty — corrupting one of those would be a
        # silent no-op and the chaos cell would "pass" without testing
        # anything
        if spec.rank is not None:
            victims = [rdirs[spec.rank]]
        else:
            victims = [d for d in reversed(rdirs)
                       if ckpt_io.read_rank_index(d).get("entries")]
            if not victims:
                raise RuntimeError(f"no rank container with entries under "
                                   f"{step_dir} to corrupt")
        rdir = victims[0]
        spec.rank = rdirs.index(rdir)
        name = ckpt_io.INDEX_NAME if spec.target == "index" \
            else ckpt_io.BIN_NAME
        return rdir / name

    def _fire_corrupt_shard(self, spec, step, cluster):
        path = self._victim_file(spec, cluster)
        size = path.stat().st_size
        blob = os.urandom(max(16, min(256, size // 4)))
        with open(path, "r+b") as f:
            f.seek(max(0, size // 2 - len(blob) // 2))
            f.write(blob)

    def _fire_truncate_shard(self, spec, step, cluster):
        path = self._victim_file(spec, cluster)
        os.truncate(path, int(path.stat().st_size * 0.6))

    # -- drop_token ---------------------------------------------------------
    def _fire_drop_token(self, spec, step, cluster):
        """Free the victim's COMM_WORLD object out from under its session
        token.  Every flavor dangles the same way (``comm_free`` removes the
        entry its handle resolves through); fabric-direct is the motivating
        case — its tokens embed a session nonce and nothing survives.  The
        descriptor's cached phys is also dropped so the stale binding cannot
        mask the dangling token."""
        from repro_torch.core.descriptors import Kind
        victim = spec.rank = self._victim(spec, cluster)
        mana = cluster.ranks[victim].mana
        backend = mana.backend
        backend.comm_free(backend.world_comm())
        for d in mana.vids.iter_kind(Kind.COMM):
            if d.meta.get("axis_name") == "world":
                d.phys = backend.world_comm()  # stale token, now dangling

    # -- snapshot_error -----------------------------------------------------
    def _fire_snapshot_error(self, spec, step, cluster):
        """Arm the ``ckpt.snapshot_batch`` failpoint: the NEXT pipelined
        snapshot raises mid-batch, inside the blocking window.  One-shot:
        the handler disarms itself before raising."""
        site = "ckpt.snapshot_batch"

        def handler(name, ctx):
            disarm(site, handler)
            raise InjectedFault(
                f"injected snapshot fault at batch {ctx.get('batch')} "
                f"(rank {ctx.get('rank')})")

        arm(site, handler)
        self._armed.append((site, handler))

    # -- RAM-tier faults ----------------------------------------------------
    def _tier(self):
        """The supervisor wires its ReplicaTier onto the injector
        (``injector.tier``); RAM-tier faults are meaningless without one."""
        tier = getattr(self, "tier", None)
        if tier is None:
            raise RuntimeError("RAM-tier fault needs a supervisor replica "
                               "tier (Supervisor(tier=ReplicaTier()))")
        return tier

    def _fire_partner_death(self, spec, step, cluster):
        """The victim and its ring replica partner die TOGETHER before any
        pull — the correlated-failure case partner replication cannot
        cover: both RAM copies of the victim's newest container are lost,
        and recovery must escalate past the RAM tier to disk.  Needs world
        >= 3 for any rank to survive."""
        from repro_torch.core.ckpt_tiers import ring_partner
        victim = spec.rank = self._victim(spec, cluster)
        partner = ring_partner(victim, cluster.survivors())
        cluster.halt_rank(victim)
        if partner is not None:
            cluster.halt_rank(partner)

    def _fire_corrupt_replica(self, spec, step, cluster):
        """Byte-flip EVERY in-memory copy of the victim's newest container,
        leaving the push-time checksum alone, so the RAM tier's
        verification pass must reject the image (TierVerifyError -> ladder
        escalates to disk).  Waits for the in-flight commit and drains the
        replication queue first, so there is deterministically a fresh
        replicated step to poison.  Pair with a later ``kill_rank`` of the
        same rank to force a recovery through the poisoned tier."""
        tier = self._tier()
        if cluster.writer is not None:
            cluster.writer.wait_idle()
        tier.drain_commits(cluster)
        step_n = tier.newest_step
        if step_n is None:
            raise RuntimeError("no replicated step in the RAM tier "
                               "to corrupt")
        if spec.rank is None:
            # the poison must hit a container that actually holds bytes
            # (meshless runs put every shard in rank 0's container)
            cands = sorted({r for st in tier.stores.values()
                            for (s, r), c in st.items()
                            if s == step_n and len(c.data)})
            if not cands:
                raise RuntimeError(f"no non-empty RAM container at step "
                                   f"{step_n} to corrupt")
            spec.rank = cands[0]
        victim = spec.rank
        flipped = 0
        for store in tier.stores.values():
            c = store.get((step_n, victim))
            if c is not None and len(c.data):
                buf = bytearray(c.data)
                mid = len(buf) // 2
                for i in range(mid, min(mid + 64, len(buf))):
                    buf[i] ^= 0xFF
                c.data = bytes(buf)
                flipped += 1
        if not flipped:
            raise RuntimeError(f"rank {victim} holds no bytes in the RAM "
                               f"tier at step {step_n}")

    def _fire_double_fault(self, spec, step, cluster):
        """Kill the victim, then arm a one-shot handler on the supervisor's
        ``supervisor.pre_restore`` failpoint: while the FIRST recovery's
        restore is in flight, a second rank (the highest survivor) dies too
        — classic cascading failure.  The supervisor must absorb the new
        death into the same incident (re-fence, recount, restart the
        ladder), never drop it."""
        victim = spec.rank = self._victim(spec, cluster)
        cluster.halt_rank(victim)
        site = "supervisor.pre_restore"

        def handler(name, ctx):
            disarm(site, handler)
            cl = ctx.get("cluster", cluster)
            alive = cl.survivors()
            if not alive:
                return
            second = alive[-1]
            cl.halt_rank(second)
            raise RankDeadError(second, f"rank {second}: died mid-recovery "
                                        f"(injected double fault)")

        arm(site, handler)
        self._armed.append((site, handler))

    def _fire_preempt_notice(self, spec, step, cluster):
        """Deliver a preemption notice for the victim: the victim stays
        ALIVE (this is the whole point — graceful leave needs a live lower
        half to drain and hand off through) and the notice propagates as a
        :class:`PreemptNotice` out of the injector, which the supervisor
        classifies and routes to its rescale rung."""
        victim = spec.rank = self._victim(spec, cluster)
        cluster.events.append(("fault_injected", spec.kind, victim, step))
        raise PreemptNotice(victim, spec.grace_s)

    def _fire_join_timeout(self, spec, step, cluster):
        """Arm the ``elastic.join.ready`` failpoint one-shot: the NEXT
        joining rank stalls mid-handshake.  ``elastic.join`` must fence the
        stalled joiner (its slot never becomes a member) and surface a
        typed ``JoinTimeoutError`` — the running world continues
        untouched."""
        site = "elastic.join.ready"

        def handler(name, ctx):
            disarm(site, handler)
            raise InjectedFault(f"injected join stall: rank "
                                f"{ctx.get('rank')} wedged mid-handshake")

        arm(site, handler)
        self._armed.append((site, handler))

    def _fire_migrate_corrupt(self, spec, step, cluster):
        """Arm the ``serve.migrate.chunk`` failpoint one-shot: the next
        live-migration chunk gets its payload bytes flipped AFTER the
        digest was recorded.  The receiver's per-chunk verification must
        reject the whole session (``MigrationError`` at the source, which
        keeps serving it) — torn transfers never half-land."""
        site = "serve.migrate.chunk"

        def handler(name, ctx):
            disarm(site, handler)
            msg = ctx.get("msg")
            if msg and msg.get("data"):
                data = bytearray(msg["data"])
                data[len(data) // 2] ^= 0xFF
                msg["data"] = bytes(data)

        arm(site, handler)
        self._armed.append((site, handler))

    def _fire_restore_error(self, spec, step, cluster):
        """Kill the victim and arm a one-shot fault INSIDE the restore path
        (the ``restore.rebind_world`` failpoint): the first restore attempt
        dies mid-rebind, and the ladder's bounded per-rung retry must land
        the second attempt from the SAME tier."""
        victim = spec.rank = self._victim(spec, cluster)
        cluster.halt_rank(victim)
        site = "restore.rebind_world"

        def handler(name, ctx):
            disarm(site, handler)
            raise InjectedFault(f"injected restore fault mid-rebind "
                                f"({ctx.get('ranks')} rank(s))")

        arm(site, handler)
        self._armed.append((site, handler))
