"""Lower-half runtime backend contract.

This is the paper's §5 'MPI subset requirements' as an ABC. A backend is one
'MPI implementation': it owns physical handles (representation is backend-
private!), the constants discipline (§4.3), and the host-side message plumbing
MANA needs. The interpose layer (stub library) is written ONCE against this
contract — 'develop once, run everywhere'.

Categories (paper §5):
  1. drain:    iprobe / recv / test
  2. decode:   comm_group / group_translate_ranks / type_get_envelope / _contents
  3. internal: send / recv / alltoall
plus object creation/free, which MANA replays at restart.

`capabilities()` advertises optional surface (e.g. ExaMPI has no comm_split;
the interpose layer emulates it with group math + comm_create).
"""
from __future__ import annotations

import abc
from typing import Any, Optional

PREDEFINED_DTYPES = (
    # (name, itemsize, aliases-with) — INT8/CHAR aliasing mirrors ExaMPI §4.3
    ("MPI_CHAR", 1, "MPI_INT8_T"),
    ("MPI_INT8_T", 1, "MPI_CHAR"),
    ("MPI_INT32_T", 4, None),
    ("MPI_INT64_T", 8, None),
    ("MPI_FLOAT", 4, None),
    ("MPI_DOUBLE", 8, None),
    ("MPI_BFLOAT16", 2, None),
)

PREDEFINED_OPS = ("MPI_SUM", "MPI_MAX", "MPI_MIN", "MPI_PROD")

#: the collective surface a FULL implementation advertises; subset flavors
#: (ExaMPI, fabric-direct) advertise fewer and the interpose layer derives
#: the rest from p2p (see repro_torch.core.callspec)
COLLECTIVE_CAPS = ("bcast", "reduce", "allreduce", "scatter", "gather",
                   "allgather", "reduce_scatter", "scan", "alltoall")

# multi-phase native algorithms separate phases by the registry's tag
# offset (the callspec tag schema spaces collective bases 100 << 32 apart)
from repro_torch.core.callspec import PHASE2  # noqa: E402

_UNSET = object()


class Backend(abc.ABC):
    """One logical-rank view of the lower half."""

    name: str = "abstract"
    #: Implementation family for restart-time capability translation
    #: (``repro_torch.core.restore``): record-replay of HYBRID-strategy objects is
    #: only attempted when checkpoint and restart flavors share a family
    #: (e.g. Cray MPI is MPICH-derived); across families every non-constant
    #: object is rebuilt from its serialized description.
    family: str = "abstract"

    def __init__(self, fabric, rank: int, world_size: int):
        self.fabric = fabric
        self.rank = rank
        self.world_size = world_size

    def alias_dtype(self, name: str) -> str:
        """Canonical predefined-dtype name under THIS implementation's
        aliasing discipline (ExaMPI reinterpret-casts MPI_INT8_T to
        MPI_CHAR; most flavors alias nothing).  The restore path re-encodes
        datatype envelopes through this hook so a handle checkpointed under
        one aliasing discipline rebinds to the target's canonical constant."""
        return name

    # -- lifecycle ---------------------------------------------------------
    @abc.abstractmethod
    def init_constants(self) -> None:
        """Resolve predefined constants per this implementation's discipline
        (fixed ints / startup functions / lazy shared pointers)."""

    @abc.abstractmethod
    def world_comm(self) -> Any:
        """Physical handle of COMM_WORLD (may differ across sessions!)."""

    @abc.abstractmethod
    def predefined_dtype(self, name: str) -> Any:
        """Physical handle of a predefined datatype."""

    @abc.abstractmethod
    def predefined_op(self, name: str) -> Any:
        ...

    def capabilities(self) -> set:
        return {"comm_split", "comm_create", "type_create", "op_create",
                *COLLECTIVE_CAPS}

    # -- object creation (replayed at restart) ------------------------------
    @abc.abstractmethod
    def comm_create(self, ranks) -> Any:
        ...

    def comm_split(self, comm, color: int, key: int, members_by_color) -> Any:
        """Default split: backends in the MPICH family implement natively."""
        return self.comm_create(members_by_color)

    @abc.abstractmethod
    def comm_free(self, comm) -> None:
        ...

    @abc.abstractmethod
    def comm_group(self, comm) -> Any:
        ...

    @abc.abstractmethod
    def group_translate_ranks(self, group) -> list:
        ...

    @abc.abstractmethod
    def type_create(self, envelope: dict) -> Any:
        ...

    @abc.abstractmethod
    def type_get_envelope(self, dtype) -> dict:
        ...

    def type_get_contents(self, dtype) -> dict:
        return self.type_get_envelope(dtype)

    @abc.abstractmethod
    def op_create(self, name: str, commutative: bool) -> Any:
        ...

    @abc.abstractmethod
    def comm_ranks(self, comm) -> list:
        """Decode a communicator's member ranks (for reconstruction)."""

    def resize_world(self, members) -> Any:
        """Live membership change: rebuild the world communicator over
        ``members`` (a possibly-sparse, ordered rank-id list) and return its
        new physical handle.  Rank ids are STABLE across a resize — a
        survivor keeps its id; only the member list changes.  Works for
        every flavor because each one stores its world comm in ``_world``
        and implements :meth:`comm_create`."""
        members = list(members)
        if self.rank not in members:
            raise ValueError(
                f"{self.name}: rank {self.rank} not in new world {members}")
        self.world_size = len(members)
        self._world = self.comm_create(members)
        return self._world

    # -- messaging (host metadata) ------------------------------------------
    def send(self, dst: int, tag: int, payload) -> None:
        self.fabric.send(self.rank, dst, tag, payload)

    def recv(self, src: int, tag: int):
        return self.fabric.recv(self.rank, src, tag)

    def iprobe(self, src: int = -1, tag: int = -1):
        return self.fabric.iprobe(self.rank, src, tag)

    def isend(self, dst: int, tag: int, payload) -> Any:
        """Returns a backend request handle."""
        self.fabric.send(self.rank, dst, tag, payload)
        return self.request_create({"op": "isend", "dst": dst, "tag": tag})

    @abc.abstractmethod
    def request_create(self, info: dict) -> Any:
        ...

    @abc.abstractmethod
    def test(self, request) -> bool:
        ...

    def test_all(self, requests) -> list:
        """MPI_Testall-style batched completion test: one lower-half call for
        the whole request vector instead of one round trip per request.  The
        drain protocol polls through this, so flavors override it with their
        native batched form; the default is the portable per-request loop."""
        return [self.test(r) for r in requests]

    def barrier(self, expected: int | None = None,
                timeout: float | None = None) -> None:
        self.fabric.barrier(self.rank, expected, timeout)

    # -- native collectives --------------------------------------------------
    # One method per advertised COLLECTIVE_CAPS entry.  Every RECEIVE goes
    # through ``recv`` — the upper half's buffered receive — so payloads the
    # quiesce protocol drained into the checkpoint image re-deliver after
    # restart exactly like user p2p traffic.  ``fold`` (for reductions) is
    # applied in communicator-rank order: the fold order is part of the
    # call's determinism contract.  ``root`` is a POSITION in the
    # communicator's rank list, MPI-style.  Subset flavors that do not
    # advertise a capability never see the corresponding method called (the
    # interpose layer routes to its derived p2p composition instead).

    def _coll_ranks(self, comm) -> tuple:
        # same typed error the derived compositions raise, so the
        # native/derived distinction never leaks through error handling
        from repro_torch.core.callspec import NotInCommunicatorError
        ranks = self.comm_ranks(comm)
        try:
            return ranks, ranks.index(self.rank)
        except ValueError:
            raise NotInCommunicatorError(
                f"{self.name}: rank {self.rank} is not a member of "
                f"{ranks}") from None

    @staticmethod
    def _coll_root(ranks, root: int):
        if not 0 <= root < len(ranks):
            raise ValueError(f"root {root} out of range for a "
                             f"{len(ranks)}-member communicator")
        return ranks[root]

    def bcast(self, comm, root: int, value, *, tag: int, recv):
        """Linear fan-out from the root (Open MPI's base algorithm; the
        MPICH family overrides with a binomial tree)."""
        ranks, _ = self._coll_ranks(comm)
        root_rank = self._coll_root(ranks, root)
        if self.rank == root_rank:
            for dst in ranks:
                if dst != self.rank:
                    self.send(dst, tag, value)
            return value
        return recv(root_rank, tag)

    def reduce(self, comm, root: int, value, fold, *, tag: int, recv):
        """Rooted reduce: contributions received and folded at the root in
        rank order; returns the result at root, None elsewhere."""
        ranks, _ = self._coll_ranks(comm)
        root_rank = self._coll_root(ranks, root)
        if self.rank != root_rank:
            self.send(root_rank, tag, value)
            return None
        acc = _UNSET
        for src in ranks:
            x = value if src == self.rank else recv(src, tag)
            acc = x if acc is _UNSET else fold(acc, x)
        return acc

    def allreduce(self, comm, value, fold, *, tag: int, recv):
        """Rooted reduce + broadcast: two phases, O(n) messages (the
        derived p2p composition is a one-phase O(n^2) full exchange)."""
        red = self.reduce(comm, 0, value, fold, tag=tag, recv=recv)
        return self.bcast(comm, 0, red, tag=tag + PHASE2, recv=recv)

    def scatter(self, comm, root: int, values, *, tag: int, recv):
        ranks, _ = self._coll_ranks(comm)
        root_rank = self._coll_root(ranks, root)
        if self.rank == root_rank:
            if values is None or len(values) != len(ranks):
                raise ValueError(
                    f"scatter root needs one value per member "
                    f"({len(ranks)}), got "
                    f"{None if values is None else len(values)}")
            for q, dst in enumerate(ranks):
                if dst != self.rank:
                    self.send(dst, tag, values[q])
            return values[root]
        return recv(root_rank, tag)

    def gather(self, comm, root: int, value, *, tag: int, recv):
        ranks, _ = self._coll_ranks(comm)
        root_rank = self._coll_root(ranks, root)
        if self.rank != root_rank:
            self.send(root_rank, tag, value)
            return None
        return [value if src == self.rank else recv(src, tag)
                for src in ranks]

    def allgather(self, comm, value, *, tag: int, recv):
        """Gather to position 0 + broadcast of the assembled list (Open MPI
        overrides with its ring algorithm)."""
        got = self.gather(comm, 0, value, tag=tag, recv=recv)
        return self.bcast(comm, 0, got, tag=tag + PHASE2, recv=recv)

    def reduce_scatter(self, comm, values, fold, *, tag: int, recv):
        """Gather the full vectors to position 0, fold slot-wise in rank
        order, scatter the folded chunks."""
        ranks, _ = self._coll_ranks(comm)
        if values is None or len(values) != len(ranks):
            raise ValueError(f"reduce_scatter needs one value per member "
                             f"({len(ranks)}), got "
                             f"{None if values is None else len(values)}")
        gathered = self.gather(comm, 0, values, tag=tag, recv=recv)
        chunks = None
        if gathered is not None:
            chunks = []
            for q in range(len(ranks)):
                acc = _UNSET
                for contrib in gathered:
                    acc = contrib[q] if acc is _UNSET \
                        else fold(acc, contrib[q])
                chunks.append(acc)
        return self.scatter(comm, 0, chunks, tag=tag + PHASE2, recv=recv)

    def scan(self, comm, value, fold, *, tag: int, recv):
        """Inclusive prefix: gather to position 0, compute every prefix in
        rank order, scatter each member its own."""
        ranks, _ = self._coll_ranks(comm)
        gathered = self.gather(comm, 0, value, tag=tag, recv=recv)
        prefixes = None
        if gathered is not None:
            acc, prefixes = _UNSET, []
            for v in gathered:
                acc = v if acc is _UNSET else fold(acc, v)
                prefixes.append(acc)
        return self.scatter(comm, 0, prefixes, tag=tag + PHASE2, recv=recv)

    def alltoall(self, comm, payloads: list, *, tag: int, recv) -> list:
        """Personalized exchange: payloads[q] to position q (self-message
        included, through the fabric), received back in rank order."""
        ranks, _ = self._coll_ranks(comm)
        if len(payloads) != len(ranks):
            raise ValueError(f"alltoall needs one payload per member "
                             f"({len(ranks)}), got {len(payloads)}")
        for dst, payload in zip(ranks, payloads):
            self.send(dst, tag, payload)
        return [recv(src, tag) for src in ranks]

    # -- teardown -----------------------------------------------------------
    def shutdown(self) -> None:
        """Lower half is simply discarded (never checkpointed)."""
