"""In-process 'network fabric' shared by all logical ranks.

Plays the role of the interconnect for MANA-internal host-metadata traffic
(paper §5 category 1 and 3): tagged point-to-point queues between ranks.
Tensor-data collectives live inside compiled XLA programs and are NOT routed
here — exactly like MANA, which never touches the application's MPI traffic,
only probes/drains it at checkpoint time.

On a real cluster this object is replaced by a TCP/gRPC side channel between
rank processes; the interface is the same.
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque


class DepartedRankError(RuntimeError):
    """Send addressed to a rank that has LEFT the world (live shrink).

    Distinct from the plain ``ValueError`` raised for a rank id that never
    existed: a departed rank is a *membership* condition the elastic layer
    can handle (redeliver to the state inheritor, or surface a typed
    cancellation to the caller) — never a programming error."""

    def __init__(self, dst: int):
        self.dst = dst
        super().__init__(f"rank {dst} has departed the world")


class Fabric:
    def __init__(self, world_size: int):
        self.world_size = world_size
        self._lock = threading.Lock()
        # (dst, src, tag) -> deque of payloads
        self._queues: dict[tuple, deque] = {}
        self._cv = threading.Condition(self._lock)
        self._barrier_gen = 0
        self._barrier_count = 0
        self._barrier_cv = threading.Condition(self._lock)
        self.delivered = 0
        self._retired: set[int] = set()

    def send(self, src: int, dst: int, tag: int, payload):
        if not (0 <= dst < self.world_size):
            raise ValueError(f"bad destination rank {dst}")
        with self._cv:
            if dst in self._retired:
                raise DepartedRankError(dst)
            self._queues.setdefault((dst, src, tag), deque()).append(payload)
            self.delivered += 1
            self._cv.notify_all()

    def resize(self, new_world_size: int):
        """Grow the addressable rank-id space (live join).  Shrinking is
        expressed by :meth:`retire`, never by lowering ``world_size`` —
        survivor rank ids are stable across membership changes."""
        with self._cv:
            if new_world_size < self.world_size:
                raise ValueError("fabric never shrinks; retire ranks instead")
            self.world_size = new_world_size
            self._cv.notify_all()

    def retire(self, rank: int):
        """Mark ``rank`` departed: subsequent sends to it raise the typed
        :class:`DepartedRankError`.  Its already-queued inbox is left in
        place for the elastic layer to scavenge (redeliver or cancel)."""
        with self._cv:
            self._retired.add(rank)
            self._cv.notify_all()

    def scavenge(self, rank: int) -> list[tuple[int, int, object]]:
        """Drain and return every queued message addressed to ``rank`` as
        ``(src, tag, payload)`` triples, in per-queue FIFO order."""
        out: list[tuple[int, int, object]] = []
        with self._lock:
            for (dst, s, t), q in list(self._queues.items()):
                if dst != rank:
                    continue
                while q:
                    out.append((s, t, q.popleft()))
        return out

    def iprobe(self, rank: int, src: int = -1, tag: int = -1):
        """Any pending message for `rank` (src/tag = -1 wildcards)?
        Returns (src, tag) or None."""
        with self._lock:
            for (dst, s, t), q in self._queues.items():
                if dst != rank or not q:
                    continue
                if (src in (-1, s)) and (tag in (-1, t)):
                    return (s, t)
        return None

    def recv(self, rank: int, src: int, tag: int, timeout: float = 30.0):
        """Blocking receive (ranks run as threads for collective protocols)."""
        deadline = timeout
        with self._cv:
            while True:
                q = self._queues.get((rank, src, tag))
                if q:
                    return q.popleft()
                if deadline <= 0:
                    raise LookupError(
                        f"no message for rank {rank} from {src} tag {tag}")
                self._cv.wait(timeout=0.5)
                deadline -= 0.5

    def pending_count(self, rank: int) -> int:
        with self._lock:
            return sum(len(q) for (dst, _, _), q in self._queues.items()
                       if dst == rank)

    def barrier(self, rank: int, expected: int | None = None,
                timeout: float | None = None):
        """Meet ``expected`` ranks.  ``timeout`` (seconds) bounds the wait —
        on expiry the arrival is withdrawn (so the barrier state stays
        consistent for the next round) and TimeoutError raised; the drain
        protocol uses this so one failed rank can never park the others'
        pool threads forever."""
        expected = expected or self.world_size
        deadline = None if timeout is None else _time.time() + timeout
        with self._barrier_cv:
            gen = self._barrier_gen
            self._barrier_count += 1
            if self._barrier_count >= expected:
                self._barrier_count = 0
                self._barrier_gen += 1
                self._barrier_cv.notify_all()
            else:
                while self._barrier_gen == gen:
                    wait = 30.0 if deadline is None else deadline - _time.time()
                    if wait <= 0:
                        self._barrier_count = max(0, self._barrier_count - 1)
                        raise TimeoutError(
                            f"barrier timed out: rank {rank} waited "
                            f"{timeout}s for {expected} arrivals")
                    self._barrier_cv.wait(timeout=min(wait, 30.0))
