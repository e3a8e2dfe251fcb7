"""Continuous-batching scheduler: admission, join/retire, fairness.

Classic continuous batching: the decode "batch" is not a fixed group that
lives and dies together — sequences JOIN the running set the step they are
admitted (prefill interleaved with everyone else's decode) and RETIRE the
step they finish, so lanes never idle behind the longest sequence.

State machine per session::

    QUEUED ──admit──► RUNNING ──finish──► DONE
      ▲                 │  │
      └───preempt───────┘  └──migrate──► MIGRATED

* ``QUEUED``    in the admission queue (fresh, or swapped out by a
                preemption — the swap payload lives with the engine);
* ``RUNNING``   holds a decode lane and pool pages; decoded every step;
* ``DONE``      reached ``max_new_tokens``; lane and pages released, the
                generated stream stays readable;
* ``MIGRATED``  shipped to another engine (the migration transport comes
                with the checkpoint/restart plane).

Fairness + priority: admission order is (priority desc, arrival seq asc) —
strict priority, FIFO within a priority class.  A preempted session keeps
its ORIGINAL arrival seq, so it re-admits ahead of later arrivals of its
class instead of going to the back of the line.  On pool OOM the engine
asks the pool for a victim strictly below the candidate's priority; when
none exists the candidate head-of-line waits (admission never evicts an
equal-or-higher-priority session, so priority inversion cannot happen).

The scheduler is pure bookkeeping — no model, no pool, no arrays — which
is what makes its state a three-line JSON snapshot and its edge cases
unit-testable without a device. This is a copy of the JAX package's
``serving/scheduler.py``: the same states, tickets and snapshot format, so
a snapshot taken by either package restores in the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field

QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"
MIGRATED = "MIGRATED"

STATES = (QUEUED, RUNNING, DONE, MIGRATED)


@dataclass
class SessionTicket:
    """One session's scheduling record."""
    sid: str
    priority: int = 0
    seq: int = 0                 # arrival order; preserved across preemption
    state: str = QUEUED
    preemptions: int = 0
    field_history: list = field(default_factory=list)


class ContinuousBatchScheduler:
    """Admission queue + running set with per-step join/retire."""

    def __init__(self, *, max_running: int = 4):
        if max_running <= 0:
            raise ValueError("max_running must be positive")
        self.max_running = int(max_running)
        self.tickets: dict[str, SessionTicket] = {}
        self._running: list[str] = []    # decode order = admission order
        self._seq = 0

    # -- introspection ------------------------------------------------------
    @property
    def running(self) -> list:
        return list(self._running)

    def queued(self) -> list:
        """Queued sids in admission order (priority desc, seq asc)."""
        q = [t for t in self.tickets.values() if t.state == QUEUED]
        return [t.sid for t in sorted(q, key=lambda t: (-t.priority, t.seq))]

    def live(self) -> list:
        """Every session still owed tokens (queued or running)."""
        return [t.sid for t in sorted(self.tickets.values(),
                                      key=lambda t: t.seq)
                if t.state in (QUEUED, RUNNING)]

    def state(self, sid: str) -> str:
        return self.tickets[sid].state

    def lanes_free(self) -> int:
        return self.max_running - len(self._running)

    # -- transitions --------------------------------------------------------
    def _move(self, sid: str, to: str) -> SessionTicket:
        t = self.tickets[sid]
        t.field_history.append((t.state, to))
        t.state = to
        return t

    def submit(self, sid: str, *, priority: int = 0) -> SessionTicket:
        if sid in self.tickets:
            raise ValueError(f"session {sid!r} already submitted")
        self._seq += 1
        t = SessionTicket(sid=sid, priority=int(priority), seq=self._seq)
        self.tickets[sid] = t
        return t

    def next_admission(self) -> str | None:
        """Best queued candidate, or ``None`` when no lane is free."""
        if self.lanes_free() <= 0:
            return None
        q = self.queued()
        return q[0] if q else None

    def admitted(self, sid: str) -> None:
        self._move(sid, RUNNING)
        self._running.append(sid)

    def preempted(self, sid: str) -> None:
        t = self._move(sid, QUEUED)
        t.preemptions += 1
        self._running.remove(sid)

    def retired(self, sid: str) -> None:
        self._move(sid, DONE)
        if sid in self._running:
            self._running.remove(sid)

    def migrated(self, sid: str) -> None:
        self._move(sid, MIGRATED)
        if sid in self._running:
            self._running.remove(sid)

    def forget(self, sid: str) -> None:
        self.tickets.pop(sid, None)
        if sid in self._running:
            self._running.remove(sid)

    # -- snapshot (the JSON form the JAX package's fleet cursor carries) ----
    def snapshot(self) -> dict:
        return {"max_running": self.max_running, "seq": self._seq,
                "running": list(self._running),
                "tickets": {t.sid: {"priority": t.priority, "seq": t.seq,
                                    "state": t.state,
                                    "preemptions": t.preemptions}
                            for t in self.tickets.values()}}

    def restore(self, snap: dict) -> None:
        self.max_running = int(snap.get("max_running", self.max_running))
        self._seq = int(snap.get("seq", 0))
        self.tickets.clear()
        for sid, row in (snap.get("tickets") or {}).items():
            self.tickets[sid] = SessionTicket(
                sid=sid, priority=int(row.get("priority", 0)),
                seq=int(row.get("seq", 0)),
                state=row.get("state", QUEUED),
                preemptions=int(row.get("preemptions", 0)))
        self._running = [s for s in snap.get("running", [])
                         if s in self.tickets]
