"""Supervised auto-recovery: detect -> classify -> restore -> resume.

The paper's checkpoint/restart machinery (fast pipelined checkpoint, elastic
cross-backend restore) is only as valuable as the loop that USES it when
something actually dies.  This module is that loop — the control plane the
NERSC production deployment of MANA grew around the mechanism:

  * :class:`LeaseDetector` — a heartbeat/lease failure detector over the
    coordinator's rank table.  Passive: a rank whose lease (last heartbeat +
    ``lease_s``) expires is declared dead.  Active: each poll also PROBES
    every rank's lower half (``comm_ranks(world_comm())`` — one table deref,
    no traffic), which catches crashed nodes immediately and dangling
    session tokens (fabric-direct nonces) that a heartbeat would never see.

  * :class:`Supervisor` — drives a workload (``Server`` / ``ServeEngine``: any
    object with ``step``, ``step_once()``, ``checkpoint()``,
    ``recover(ckpt, new_world_size=)``) one step at a time.  Any failure
    — a detector verdict, a ``DrainStallError`` escalated out of the
    checkpoint's quiesce, a ``RankDeadError`` from a lower-half call, an
    error mid-``snapshot_batch`` — is caught, CLASSIFIED, and recovered
    through a policy-driven **escalation ladder** (multi-level C/R): fence
    the faulty rank if the failure class implies a dead node, then walk the
    tiers newest-first —

      0. ``rescale``    live shrink (``elastic.shrink``): drain just the
                        victim's traffic, hand its RAM-tier shards and
                        pipeline cursor to its ring successor, re-point
                        ``COMM_WORLD`` on the survivors, and CONTINUE at
                        the same step — no rewind, no image read.  Tried
                        BEFORE fencing (a preempted rank must stay alive
                        for its own graceful handoff); falls through to
                        the restore ladder when the world cannot shrink;
      1. ``ram``        the peer-replicated in-memory image
                        (``ckpt_tiers.ReplicaTier``), checksum-verified,
                        only when it is at least as new as the newest
                        committed disk image;
      2. ``disk``       the newest committed disk image, accepted only if
                        its manifest parses, its delta chain resolves, and
                        every shard digest re-verifies end-to-end;
      3. ``disk_chain`` each older committed image in turn, same
                        acceptance test (the ``find_resumable`` walk
                        unrolled into explicit ladder rungs).

    Each rung gets bounded retries with exponential backoff + jitter and a
    per-level timeout; deterministic verification verdicts (a corrupt RAM
    replica, a torn disk image) skip straight to the next rung.  A SECOND
    rank death surfacing while a restore is in flight is ABSORBED into the
    same incident — the new victim is fenced, the surviving world recount
    happens again, and the ladder restarts from the top — never dropped.
    Retries are bounded; every incident records which tier served the
    restore, the full ladder transcript, any absorbed mid-recovery faults,
    and ``{detect,classify,restore,resume}_ms``.

Failure classes and their recovery policy:

  ==============  =========================  ============================
  class           typical cause              world after recovery
  ==============  =========================  ============================
  rank_dead       node crash / kill_rank     survivors (live shrink if the
                                             rescale rung serves, else
                                             fence + restore)
  drain_stall     wedged lower half          survivors (stall rank fenced)
  preempt_notice  SIGTERM / scheduler        survivors (graceful leave:
                  eviction warning           drain + handoff + shrink
                                             within the grace window)
  lost_token      dropped session token      unchanged (lower halves
                                             rebuilt, tokens re-minted)
  snapshot_error  fault inside the blocking  unchanged
                  window
  ckpt_corrupt    torn/corrupted image       unchanged (handled by the
                  found at recovery time     verified-resumable walk)
  unknown         anything else              unchanged
  ==============  =========================  ============================
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field, replace

from repro_torch.core.ckpt_tiers import TierVerifyError
from repro_torch.core.drain import DrainStallError
from repro_torch.core.faults import (InjectedFault, PreemptNotice, RankDeadError,
                               failpoint)
from repro_torch.core.restore import (completed_steps, load_manifest,
                                verify_checkpoint)

FAILURE_CLASSES = ("rank_dead", "drain_stall", "lost_token",
                   "snapshot_error", "ckpt_corrupt", "preempt_notice",
                   "unknown")

#: failure classes whose victim rank is fenced (treated as a dead node), so
#: recovery relaunches on the shrunken surviving world.  preempt_notice is
#: fenced ONLY after the rescale rung fails — a preempted rank is still
#: alive and must stay usable for its own graceful departure
_FENCING = {"rank_dead", "drain_stall", "preempt_notice"}

#: failure classes the rescale rung (live shrink, no restore) may serve
#: before the restore ladder is consulted — a membership problem is cheaper
#: to RESIZE AROUND than to restore from
_RESCALABLE = {"preempt_notice", "rank_dead", "drain_stall"}


@dataclass(frozen=True)
class SupervisorConfig:
    """Recovery policy knobs (CLI-threadable: ``--backoff-floor`` /
    ``--backoff-ceiling`` on ``launch/serve.py --supervise``).

    Backoff applies in two places with the same curve — between consecutive
    recovery ATTEMPTS of the run loop, and between retries of one ladder
    rung: ``min(ceiling, floor * 2**(n-1)) * (1 + jitter*U[0,1))``.  A
    floor of 0 disables sleeping entirely (test/bench mode)."""
    lease_s: float = 2.0
    probe: bool = True
    max_retries: int = 3
    backoff_floor_s: float = 0.05
    backoff_ceiling_s: float = 2.0
    backoff_jitter: float = 0.25
    level_retries: int = 2          # restore attempts per ladder rung
    level_timeout_s: float = 30.0   # wall budget per rung before escalating
    absorb_budget: int = 4          # mid-recovery faults absorbed per incident
    rescale: str = "preempt"        # rescale-rung policy: "off" (never),
                                    # "preempt" (graceful leaves only —
                                    # rank_dead keeps restore semantics),
                                    # "all" (shrink-and-continue on any
                                    # membership failure)

    def rescale_classes(self) -> set:
        """Failure classes the rescale rung may serve under this policy."""
        return {"off": set(), "preempt": {"preempt_notice"},
                "all": set(_RESCALABLE)}[self.rescale]


class TierRejected(RuntimeError):
    """A ladder rung failed its acceptance test (unresolved delta chain,
    digest mismatch) — deterministic verdicts that retrying cannot fix, so
    the ladder escalates immediately instead of burning rung retries."""


class WorldFailure(RuntimeError):
    """Detector verdict: one or more ranks failed their lease or probe.
    ``dead`` is ``[(rank, reason), ...]`` with reason in
    {"lease_expired", "rank_dead", "lost_token"}."""

    def __init__(self, dead: list):
        self.dead = dead
        super().__init__("failure detected: " + ", ".join(
            f"rank {r} ({why})" for r, why in dead))


class RecoveryFailed(RuntimeError):
    """The supervisor exhausted its retry budget or found no digest-valid
    resumable checkpoint; the incident log rides along for the post-mortem."""

    def __init__(self, msg: str, incidents: list | None = None):
        self.incidents = incidents or []
        super().__init__(msg)


def classify_failure(exc: BaseException) -> tuple:
    """Map a caught failure to ``(failure_class, victim_rank | None)``."""
    if isinstance(exc, PreemptNotice):
        return "preempt_notice", exc.rank
    if isinstance(exc, DrainStallError):
        return "drain_stall", exc.rank
    if isinstance(exc, RankDeadError):
        return "rank_dead", exc.rank
    if isinstance(exc, WorldFailure):
        reasons = {why for _, why in exc.dead}
        if reasons == {"lost_token"}:
            return "lost_token", exc.dead[0][0]
        # mixed verdicts: the victim to FENCE must be an actually-dead rank,
        # never a healthy one that merely lost its session token
        rank = next(r for r, why in exc.dead if why != "lost_token")
        return "rank_dead", rank
    if isinstance(exc, InjectedFault):
        return "snapshot_error", None
    msg = str(exc).lower()
    if "token" in msg or "dangling" in msg:
        return "lost_token", None
    if "snapshot" in msg or "batch" in msg:
        return "snapshot_error", None
    return "unknown", None


@dataclass
class Incident:
    """One detected-and-recovered failure, with the latency breakdown the
    chaos matrix and ``bench_recovery`` report on."""
    kind: str
    rank: int | None
    step: int                    # workload step when the failure surfaced
    resumed_step: int            # step recovered to (checkpoint step)
    ckpt: str | None             # source name restored from
                                 # ("ram:step_..." or "step_...")
    error: str
    attempt: int
    world_before: int
    world_after: int
    timings: dict = field(default_factory=dict)   # {detect,classify,
                                                  #  restore,resume,total}_ms
    tier: str | None = None      # ladder rung that served the recovery
                                 # ("rescale" | "ram" | "disk" | "disk_chain")
    ladder: list = field(default_factory=list)    # per-rung transcript
    absorbed: list = field(default_factory=list)  # faults folded in
                                                  # mid-recovery
    rehomed: int | None = None   # serving fleets: live sessions re-homed
                                 # onto the surviving world by this recovery

    def to_dict(self) -> dict:
        return {"kind": self.kind, "rank": self.rank, "step": self.step,
                "resumed_step": self.resumed_step, "ckpt": self.ckpt,
                "error": self.error, "attempt": self.attempt,
                "world_before": self.world_before,
                "world_after": self.world_after, "timings": self.timings,
                "tier": self.tier, "ladder": self.ladder,
                "absorbed": self.absorbed, "rehomed": self.rehomed}


class LeaseDetector:
    """Heartbeat/lease + active-probe failure detector over a Cluster."""

    def __init__(self, cluster, *, lease_s: float = 2.0, probe: bool = True):
        self.cluster = cluster
        self.lease_s = lease_s
        self.probe = probe

    def beat(self) -> None:
        """Renew every rank's lease (the coordinator refuses renewals for
        halted ranks — dead nodes don't heartbeat)."""
        for r in range(len(self.cluster.ranks)):
            self.cluster.heartbeat(r)

    def _probe_rank(self, mana) -> str | None:
        """One lower-half liveness probe.  Returns a failure reason or
        ``None``.  ``comm_ranks(world_comm())`` forces a real handle deref
        under every flavor, so a dead node raises ``RankDeadError`` and a
        dangling session token raises its backend's lookup error."""
        try:
            mana.backend.comm_ranks(mana.backend.world_comm())
            return None
        except RankDeadError:
            return "rank_dead"
        except Exception:  # noqa: BLE001 — dangling token / freed handle
            return "lost_token"

    def poll(self) -> list:
        """One detector round: ``[(rank, reason), ...]`` for every rank that
        failed its lease or probe this round (ranks already marked dead are
        not re-reported)."""
        now = time.time()
        dead = []
        for i, r in enumerate(self.cluster.ranks):
            if not r.alive:
                continue
            if now - r.last_heartbeat > self.lease_s:
                dead.append((i, "lease_expired"))
            elif self.probe:
                reason = self._probe_rank(r.mana)
                if reason is not None:
                    dead.append((i, reason))
        for i, why in dead:
            if why != "lost_token":      # token loss is not node death
                self.cluster.ranks[i].alive = False
            self.cluster.events.append(("failure_detected", i, why, now))
        return dead


class Supervisor:
    """Runs a workload under failure supervision with bounded retries.

    ``injector`` (a :class:`~repro_torch.core.faults.FaultInjector`) is optional
    and only consulted at the two scheduling points — before each step
    (compute/commit-phase faults) and immediately before each checkpoint
    (drain/snapshot-phase faults) — so production supervision and chaos
    testing run the identical loop.

    ``tier`` (a :class:`~repro_torch.core.ckpt_tiers.ReplicaTier`) enables the
    in-RAM checkpoint level: the supervisor hooks the writer's commit
    callback, ring-pushes every committed image between the loop's steps,
    and tries the RAM image first when recovering.  ``config`` carries the
    full recovery policy; the legacy ``lease_s``/``probe``/``max_retries``
    kwargs override it when given (back-compat)."""

    def __init__(self, workload, *, injector=None, lease_s: float | None = None,
                 probe: bool | None = None, max_retries: int | None = None,
                 verbose: bool = True, tier=None,
                 config: SupervisorConfig | None = None):
        cfg = config or SupervisorConfig()
        overrides = {k: v for k, v in (("lease_s", lease_s), ("probe", probe),
                                       ("max_retries", max_retries))
                     if v is not None}
        if overrides:
            cfg = replace(cfg, **overrides)
        self.config = cfg
        self.workload = workload
        self.injector = injector
        self.tier = tier
        if injector is not None:
            # fault kinds that sabotage the RAM tier (corrupt_replica) need
            # a handle on it
            injector.tier = tier
        self.max_retries = cfg.max_retries
        self.verbose = verbose
        self.incidents: list[Incident] = []
        self.backoff_s = 0.0          # total jittered backoff slept
        self.detector = LeaseDetector(workload.cluster, lease_s=cfg.lease_s,
                                      probe=cfg.probe)
        self._last_ok = time.perf_counter()
        self._hook_writer()

    @property
    def cluster(self):
        return self.workload.cluster

    def _hook_writer(self) -> None:
        if self.tier is not None:
            self.tier.attach(self.cluster)
            if self.cluster.writer is not None:
                self.cluster.writer.on_commit = self.tier.note_commit

    def _sleep_backoff(self, n: int) -> float:
        """Sleep the nth (1-based) exponential-backoff delay; returns the
        jittered delay actually slept."""
        cfg = self.config
        if cfg.backoff_floor_s <= 0:
            return 0.0
        delay = min(cfg.backoff_ceiling_s,
                    cfg.backoff_floor_s * (2 ** (n - 1)))
        delay *= 1.0 + cfg.backoff_jitter * random.random()
        time.sleep(delay)
        return delay

    # ------------------------------------------------------------------
    def run(self, n_steps: int, *, ckpt_every: int = 0) -> list:
        """Drive the workload ``n_steps`` steps (absolute target: recovery
        rewinds the step counter, the budget does not restart).  Returns the
        incident log; raises :class:`RecoveryFailed` when a single failure
        burns more than ``max_retries`` recovery attempts."""
        w = self.workload
        target = w.step + n_steps
        attempt = 0
        fail_step = -1
        # leases start NOW: the gap between cluster construction and
        # supervision (model init, kernel builds) must not count against
        # anyone's heartbeat
        self.detector.beat()
        self._last_ok = time.perf_counter()
        while w.step < target:
            try:
                if self.tier is not None:
                    # push freshly committed images to partner ranks BEFORE
                    # this step's faults can fire — replication always runs
                    # on the supervisor thread, between steps
                    self.tier.drain_commits(self.cluster)
                if self.injector is not None:
                    self.injector.on_step(w.step, self.cluster)
                dead = self.detector.poll()
                if dead:
                    raise WorldFailure(dead)
                metrics = w.step_once()
                log = getattr(w, "log_step", None)
                if log is not None and metrics is not None:
                    log(metrics)     # supervised runs must not go blind
                self.detector.beat()
                if ckpt_every and w.step % ckpt_every == 0:
                    if self.injector is not None:
                        self.injector.on_checkpoint(w.step, self.cluster)
                    w.checkpoint()
                    if self.tier is not None \
                            and self.cluster.writer is not None:
                        # level-1 sync point: replication rides the commit
                        # (``note_commit`` on the finalize thread), so wait
                        # for it — when this returns, the RAM tier is
                        # exactly as new as the newest disk image and every
                        # rank's replica is pushed.  The pipelined overlap
                        # is traded for that determinism; a background
                        # write failure surfaces here and is supervised
                        # like any other checkpoint fault
                        self.cluster.writer.wait_idle()
                    # the blocking window (drain + batched D2H) is
                    # legitimate synchronous time: a checkpoint slower than
                    # lease_s must not read as an all-rank lease expiry
                    self.detector.beat()
                if attempt and w.step > fail_step:
                    # the budget resets only on progress PAST the failure
                    # point: replayed steps between the checkpoint and a
                    # deterministically recurring failure must not reset
                    # it, or the loop livelocks instead of giving up
                    attempt = 0
                self._last_ok = time.perf_counter()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — supervise EVERYTHING
                attempt += 1
                fail_step = max(fail_step, w.step)
                if attempt > self.max_retries:
                    raise RecoveryFailed(
                        f"giving up after {self.max_retries} recovery "
                        f"attempts (last failure: {e})",
                        self.incidents) from e
                if attempt > 1:
                    # consecutive incidents: back off before touching the
                    # cluster again (deterministically recurring failures
                    # must not hot-loop the restore path)
                    self.backoff_s += self._sleep_backoff(attempt - 1)
                self._recover(e, attempt)
        return self.incidents

    # ------------------------------------------------------------------
    def _ladder(self) -> list:
        """Build the escalation ladder for THIS recovery, newest-first:
        ``[(rung_name, candidate_fn), ...]`` where ``candidate_fn`` returns
        a checkpoint source (or ``None`` = rung unavailable) and raises when
        its acceptance test fails.  The RAM rung only appears when its image
        is at least as new as the newest committed disk image — a stale RAM
        copy must never beat a newer disk commit."""
        levels = []
        steps = list(reversed(completed_steps(self.cluster.writer.base)))
        newest_disk = None
        if steps:
            try:
                newest_disk = int(steps[0].name[len("step_"):])
            except ValueError:
                pass
        tier = self.tier
        if tier is not None and tier.newest_step is not None \
                and (newest_disk is None or tier.newest_step >= newest_disk):
            levels.append(("ram", lambda: tier.image(self.cluster)))
        for i, d in enumerate(steps):
            levels.append(("disk" if i == 0 else "disk_chain",
                           lambda d=d: self._verified_dir(d)))
        return levels

    def _verified_dir(self, d):
        """``find_resumable``'s acceptance test scoped to ONE candidate:
        manifest parses, the delta chain resolves against committed
        siblings, and every dir in the chain digest-verifies end-to-end.
        Raises :class:`TierRejected` (non-retryable) on any verdict."""
        try:
            man = load_manifest(d)
        except Exception as e:  # noqa: BLE001
            raise TierRejected(f"{d.name}: unreadable manifest: {e}") from e
        have = {}
        for p in completed_steps(self.cluster.writer.base):
            try:
                have[int(p.name[len("step_"):])] = p
            except ValueError:
                continue
        chain = [d]
        for b in man.get("base_steps", []):
            if b not in have:
                raise TierRejected(f"{d.name}: delta base step_{b:08d} "
                                   f"missing — chain unresolved")
            chain.append(have[b])
        for x in chain:
            problems = verify_checkpoint(x)
            if problems:
                more = f" (+{len(problems) - 1} more)" \
                    if len(problems) > 1 else ""
                raise TierRejected(f"{x.name}: {problems[0]}{more}")
        return d

    def _try_rescale(self, exc, kind, rank, attempt, detect_ms, classify_ms,
                     world_before) -> tuple:
        """The ladder's TOP rung: shrink the live world around the victim
        instead of restoring.  No rewind, no image read — downtime is one
        scoped drain plus one COMM_WORLD re-point, so it beats every
        restore tier whenever the surviving world can continue.  Same
        per-rung policy as the other rungs (``level_retries`` /
        ``level_timeout_s`` / backoff).  Returns ``(incident, log)``;
        ``incident=None`` means fall through to the restore ladder, whose
        incident inherits ``log`` so the rescale attempts are never lost
        from the transcript."""
        from repro_torch.core import elastic
        w = self.workload
        cfg = self.config
        survivors_after = [r for r in self.cluster.survivors() if r != rank]
        if not survivors_after:
            return None, [{"level": "rescale", "skipped": "last_member"}]
        # a preemption notice carries its grace window; dead-rank shrinks
        # get a tight budget — a wedged drain must fall through quickly
        grace = getattr(exc, "grace_s", None)
        drain_timeout = min(grace, 5.0) if grace else 2.0
        cursor = None
        prep = getattr(w, "prepare_leave", None)
        if prep is not None:
            try:
                cursor = prep(rank)
            except Exception:  # noqa: BLE001 — cursor handoff is best-effort
                cursor = None
        t1 = time.perf_counter()
        log: list[dict] = []
        report = None
        for level_try in range(1, cfg.level_retries + 1):
            try:
                failpoint("supervisor.pre_rescale", cluster=self.cluster,
                          rank=rank, attempt=level_try)
                report = elastic.shrink(self.cluster, rank, tier=self.tier,
                                        cursor=cursor,
                                        timeout=drain_timeout)
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as le:  # noqa: BLE001
                retryable = not isinstance(le, elastic.RescaleError)
                log.append({"level": "rescale", "attempt": level_try,
                            "error": f"{type(le).__name__}: {le}",
                            "retryable": retryable})
                if not retryable:
                    break         # deterministic: the world cannot shrink
                if time.perf_counter() - t1 > cfg.level_timeout_s:
                    log.append({"level": "rescale",
                                "skipped": "level_timeout"})
                    break
                if level_try < cfg.level_retries:
                    self.backoff_s += self._sleep_backoff(level_try)
        if report is None:
            return None, log
        hook = getattr(w, "rescale", None)
        if hook is not None:
            hook(report)
        rescale_ms = (time.perf_counter() - t1) * 1e3
        log.append({"level": "rescale", "served": True,
                    "downtime_ms": report.downtime_ms,
                    "members": list(report.members)})
        incident = Incident(
            kind=kind, rank=rank, step=w.step, resumed_step=w.step,
            ckpt=None, error=str(exc), attempt=attempt,
            world_before=world_before, world_after=len(report.members),
            tier="rescale", ladder=log,
            timings={"detect_ms": round(detect_ms, 3),
                     "classify_ms": round(classify_ms, 3),
                     "restore_ms": round(report.downtime_ms, 3),
                     "resume_ms": round(
                         max(0.0, rescale_ms - report.downtime_ms), 3),
                     "total_ms": round(
                         detect_ms + classify_ms + rescale_ms, 3)})
        self.incidents.append(incident)
        # the SAME cluster lives on (that is the whole point): no tier
        # reset — the ring re-paired inside shrink — no writer re-hook,
        # just fresh leases from the rescale point
        self.detector.beat()
        w.cluster.events.append(("incident", kind, rank, incident.step))
        self._last_ok = time.perf_counter()
        if self.verbose:
            print(f"!! rescaled around rank {rank} (tier=rescale, "
                  f"world {world_before}->{len(report.members)}) in "
                  f"{report.downtime_ms:.1f}ms — no rewind, step {w.step} "
                  f"continues", flush=True)
        return incident, log

    def _recover(self, exc: BaseException, attempt: int) -> Incident:
        w = self.workload
        cfg = self.config
        t_fail = time.perf_counter()
        detect_ms = max(0.0, (t_fail - self._last_ok) * 1e3)
        if isinstance(exc, WorldFailure):
            # lease-based detection latency is the victim's silent window
            leases = [self.cluster.ranks[r].last_heartbeat
                      for r, why in exc.dead if why == "lease_expired"]
            if leases:
                detect_ms = max(0.0, (time.time() - min(leases)) * 1e3)
        t0 = time.perf_counter()
        kind, rank = classify_failure(exc)
        classify_ms = (time.perf_counter() - t0) * 1e3
        world_before = len(self.cluster.ranks)
        # rescale rung: ABOVE the whole restore ladder.  A membership
        # failure is cheaper to resize around — live shrink, no rewind, no
        # image read — than to restore from any tier.  It runs BEFORE
        # fencing because a preempted rank is still alive and must stay
        # usable for its own graceful departure; only when the rung fails
        # does the victim get fenced and the restore ladder walked.
        rescale_log: list = []
        if kind in self.config.rescale_classes() and rank is not None \
                and 0 <= rank < len(self.cluster.ranks):
            inc, rescale_log = self._try_rescale(
                exc, kind, rank, attempt, detect_ms, classify_ms,
                world_before)
            if inc is not None:
                return inc
        if kind in _FENCING and rank is not None \
                and not self.cluster.ranks[rank].halted:
            self.cluster.halt_rank(rank)
        if self.cluster.writer is None:
            raise RecoveryFailed("cannot recover without a ckpt_dir",
                                 self.incidents) from exc
        step_at_failure = w.step
        if self.verbose:
            print(f"!! incident: {kind} (rank={rank}) at step "
                  f"{step_at_failure}: {exc}", flush=True)
        try:
            self.cluster.writer.wait_idle()
        except Exception as drain_err:  # noqa: BLE001
            # an undelivered background write failure surfacing here is
            # SUPERSEDED by the incident being recovered: the writer is
            # about to be abandoned by the restart, and letting it escape
            # this except-handler would bypass the retry budget entirely
            if self.verbose:
                print(f"!! abandoned in-flight checkpoint had failed: "
                      f"{drain_err}", flush=True)
        t1 = time.perf_counter()
        ladder_log: list[dict] = list(rescale_log)
        absorbed: list[dict] = []
        fenced = {rank} if rank is not None else set()
        budget = cfg.absorb_budget
        served = None                 # (rung_name, source_name)
        while served is None:
            # recount AFTER any fencing (including faults absorbed below):
            # every ladder pass restores onto the CURRENT surviving world
            new_ws = len(self.cluster.survivors()) \
                if (kind in _FENCING or absorbed) else world_before
            if new_ws == 0:
                raise RecoveryFailed("no surviving rank to recover on",
                                     self.incidents) from exc
            refault = None
            for level, candidate in self._ladder():
                level_t0 = time.perf_counter()
                for level_try in range(1, cfg.level_retries + 1):
                    try:
                        failpoint("supervisor.pre_restore",
                                  cluster=self.cluster, level=level,
                                  attempt=level_try)
                        src = candidate()
                        if src is None:
                            ladder_log.append({"level": level,
                                               "skipped": "unavailable"})
                            break
                        w.recover(src, new_world_size=new_ws)
                        served = (level, getattr(src, "name", str(src)))
                        break
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except RecoveryFailed:
                        raise
                    except BaseException as le:  # noqa: BLE001
                        retryable = not isinstance(
                            le, (TierRejected, TierVerifyError))
                        ladder_log.append({
                            "level": level, "attempt": level_try,
                            "error": f"{type(le).__name__}: {le}",
                            "retryable": retryable})
                        k2, r2 = classify_failure(le)
                        if k2 in _FENCING and r2 is not None \
                                and 0 <= r2 < len(self.cluster.ranks) \
                                and r2 not in fenced:
                            # a SECOND rank died while this restore was in
                            # flight: absorb it into the same incident —
                            # fence, recount, restart the ladder — never
                            # drop it
                            fenced.add(r2)
                            if not self.cluster.ranks[r2].halted:
                                self.cluster.halt_rank(r2)
                            absorbed.append({"kind": k2, "rank": r2,
                                             "during": level})
                            refault = le
                            break
                        if not retryable:
                            break     # deterministic verdict: next rung
                        if time.perf_counter() - level_t0 \
                                > cfg.level_timeout_s:
                            ladder_log.append({"level": level,
                                               "skipped": "level_timeout"})
                            break
                        if level_try < cfg.level_retries:
                            self.backoff_s += self._sleep_backoff(level_try)
                if served is not None or refault is not None:
                    break
            if served is not None:
                break
            if refault is not None:
                budget -= 1
                if budget < 0:
                    raise RecoveryFailed(
                        f"absorbed-fault budget exhausted mid-recovery "
                        f"(last: {refault})", self.incidents) from refault
                if self.verbose:
                    print(f"!! absorbed mid-recovery fault: "
                          f"{absorbed[-1]['kind']} "
                          f"(rank={absorbed[-1]['rank']}) — restarting "
                          f"ladder on the shrunken world", flush=True)
                continue
            raise RecoveryFailed(
                "every tier exhausted: RAM image unavailable and no "
                "digest-valid resumable checkpoint", self.incidents) from exc
        tier_name, src_name = served
        recover_wall_ms = (time.perf_counter() - t1) * 1e3
        restart_ms = w.cluster.restart_timings.get("total_ms",
                                                   recover_wall_ms)
        incident = Incident(
            kind=kind, rank=rank, step=step_at_failure,
            resumed_step=w.step, ckpt=src_name, error=str(exc),
            attempt=attempt, world_before=world_before,
            world_after=len(w.cluster.ranks),
            tier=tier_name, ladder=ladder_log, absorbed=absorbed,
            rehomed=getattr(w, "last_rehomed", None),
            timings={"detect_ms": round(detect_ms, 3),
                     "classify_ms": round(classify_ms, 3),
                     "restore_ms": round(restart_ms, 3),
                     "resume_ms": round(
                         max(0.0, recover_wall_ms - restart_ms), 3),
                     "total_ms": round(
                         detect_ms + classify_ms + recover_wall_ms, 3)})
        self.incidents.append(incident)
        # the workload owns a FRESH cluster now: drop every stale RAM copy
        # (rank numbering changed), re-hook the new writer's commit
        # callback, re-aim the detector, and start everyone's lease from
        # the recovery point
        if self.tier is not None:
            self.tier.reset()
        self._hook_writer()
        self.detector.cluster = w.cluster
        self.detector.beat()
        w.cluster.events.append(("incident", kind, rank, step_at_failure))
        self._last_ok = time.perf_counter()
        if self.verbose:
            t = incident.timings
            print(f"!! recovered from {src_name} (tier={tier_name}) -> "
                  f"step {w.step} "
                  f"(world {world_before}->{incident.world_after}; "
                  f"detect {t['detect_ms']:.1f}ms restore "
                  f"{t['restore_ms']:.1f}ms resume {t['resume_ms']:.1f}ms)",
                  flush=True)
        return incident
