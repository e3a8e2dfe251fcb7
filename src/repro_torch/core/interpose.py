"""The MANA stub library (interposition layer, paper Fig. 1).

The application sees opaque 64-bit handles whose FIRST 32 BITS are the MANA
virtual id (mirroring 'the vid occupies the first 4 bytes of whatever handle
type mpi.h declares', §1.2 point 2).  Every wrapper translates virtual ->
physical on entry and physical -> virtual on exit; object-creating calls are
appended to the record-replay log.  The same class runs unmodified against
all five backend flavors — the implementation-oblivious property under test.

Since the declarative call-spec registry landed, this module holds ONLY the
per-rank runtime plumbing: the vid table, descriptor registration, the hot
translation path (fast / slow / none), lazy constant binding (§4.3), the
buffered receive that re-delivers drained messages, and snapshot/restore.
Every MPI wrapper — communicators, datatypes, ops, p2p, requests, and the
full collective surface — is GENERATED from its :class:`~repro_torch.core.callspec
.CallSpec` by :func:`repro_torch.core.callspec.install`, so translate/log/
failpoint behavior is defined in exactly one place and cannot drift per
call.  The generated API is documented in docs/mpi_api.md (auto-generated
by tools/gen_api_docs.py).

`translation='slow'` routes lookups through the LEGACY per-kind string-keyed
tables (paper §4.1) — the measured baseline for the virtId speedup and the
FSGSBASE-style fast/slow path comparison in benchmarks/bench_overhead.py.
`translation='none'` is the accounting-free deref (no virtualization cost
model), used as the third leg of the translation-parity tests.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from repro_torch.core import callspec
from repro_torch.core.backends import make_backend
from repro_torch.core.callspec import (HANDLE_MAGIC, TAG_USER, handle_vid,
                                 make_handle)
from repro_torch.core.descriptors import (Descriptor, Kind, Strategy, comm_desc,
                                    datatype_desc, op_desc)
from repro_torch.core.legacy_vid import LegacyVidTables
from repro_torch.core.vid import VidTable, vid_kind

_TAG_USER = TAG_USER            # legacy alias (pre-registry name)

_KIND_NAME = {Kind.COMM: "MPI_Comm", Kind.GROUP: "MPI_Group",
              Kind.REQUEST: "MPI_Request", Kind.OP: "MPI_Op",
              Kind.DATATYPE: "MPI_Datatype"}


class Mana:
    """Per-rank interposition runtime (upper half).

    MPI wrappers are installed by ``callspec.install(Mana)`` at import
    time; see ``Mana.CALLSPECS`` for the registry."""

    def __init__(self, backend_name: str, fabric, rank: int, world_size: int,
                 *, translation: str = "fast", ggid_policy: str = "eager"):
        assert translation in ("fast", "slow", "none")
        self.backend_name = backend_name
        self.rank = rank
        self.world_size = world_size
        self.fabric = fabric
        self.translation = translation
        self.vids = VidTable(ggid_policy)
        self.legacy = LegacyVidTables() if translation == "slow" else None
        self._legacy_of: dict[int, int] = {}   # vid -> legacy vid
        self.log: list = []                    # record-replay creation log
        self.pending_messages: list = []       # drained in-flight messages
        self.transcript: deque = deque(maxlen=callspec.TRANSCRIPT_CAP)
        self.translate_count = 0
        self.backend = make_backend(backend_name, fabric, rank, world_size)
        self._register_world()

    # ------------------------------------------------------------------
    # handle plumbing
    # ------------------------------------------------------------------
    def _register(self, desc: Descriptor, phys) -> int:
        desc.phys = phys
        desc.meta["order"] = self._order = getattr(self, "_order", 0) + 1
        vid = self.vids.insert(desc)
        if self.legacy is not None:
            lvid = self.legacy.insert(_KIND_NAME[desc.kind], phys)
            self._legacy_of[vid] = lvid
            for k, v in desc.meta.items():
                if isinstance(v, (int, str, float, bool)) or v is None:
                    self.legacy.set_attr(_KIND_NAME[desc.kind], lvid, k, v)
        return vid

    def _desc(self, handle: int) -> Descriptor:
        return self.vids.lookup(handle_vid(handle))

    def _phys(self, handle: int):
        """virtual -> physical on every call: THE hot path.  The generated
        wrappers call this exactly once per declared handle argument."""
        vid = handle_vid(handle)
        d = self.vids.lookup(vid)
        if d.phys is None:
            self._bind_lazy(d)
        if self.translation == "none":
            # no-virtualization baseline: plain deref, no accounting
            return d.phys
        self.translate_count += 1
        if self.legacy is not None:
            # legacy path: string-compare map select + 3 attribute lookups
            kn = _KIND_NAME[vid_kind(vid)]
            lvid = self._legacy_of[vid]
            phys = self.legacy.virtual_to_real(kn, lvid)
            for attr in ("ranks", "axis_name", "parent"):
                try:
                    self.legacy.get_attr(kn, lvid, attr)
                except KeyError:
                    pass
            return phys
        return d.phys

    def _bind_lazy(self, d: Descriptor):
        """Late binding for constants (ExaMPI lazy shared pointers, §4.3)."""
        if d.kind == Kind.COMM and d.meta.get("axis_name") == "world":
            d.phys = self.backend.world_comm()
        elif d.kind == Kind.DATATYPE and d.meta.get("envelope", {}).get(
                "combiner") == "named":
            d.phys = self.backend.predefined_dtype(d.meta["envelope"]["name"])
        elif d.kind == Kind.OP and d.meta.get("predefined"):
            d.phys = self.backend.predefined_op(d.meta["name"])
        else:
            raise KeyError(f"vid {d.vid:#x} has no physical binding")
        if self.legacy is not None and d.vid in self._legacy_of:
            kn = _KIND_NAME[d.kind]
            self.legacy._maps[kn][self._legacy_of[d.vid]] = d.phys

    def _register_world(self):
        # upper-half constants (macros): bound to lower-half results of the
        # 'constant functions' — lazily, to honor ExaMPI's discipline.
        d = comm_desc(range(self.world_size), axis_name="world",
                      strategy=Strategy.SERIALIZE)
        self.world_handle = make_handle(self._register(d, None))
        self.dtype_handles = {}
        from repro_torch.core.backends.base import PREDEFINED_DTYPES, PREDEFINED_OPS
        for nm, size, _ in PREDEFINED_DTYPES:
            dd = datatype_desc({"combiner": "named", "name": nm, "itemsize": size})
            self.dtype_handles[nm] = make_handle(self._register(dd, None))
        self.op_handles = {}
        for nm in PREDEFINED_OPS:
            od = op_desc(nm)
            od.meta["predefined"] = True
            self.op_handles[nm] = make_handle(self._register(od, None))

    def comm_world(self) -> int:
        """Handle of COMM_WORLD (an upper-half constant, not a call)."""
        return self.world_handle

    # ------------------------------------------------------------------
    # monomorphic fast-path wrappers (opt-in, per instance)
    # ------------------------------------------------------------------
    @property
    def fastpath_enabled(self) -> bool:
        return bool(getattr(self, "_fastpath", False))

    def enable_fastpath(self, *, transcripts: bool = True) -> None:
        """Shadow every generated MPI wrapper with a monomorphic compiled
        version (``callspec.compile_fastpath``) specialized to THIS
        instance's translation mode, backend capability set, and transcript
        setting.  ``transcripts=False`` omits transcript recording entirely
        from the compiled wrappers (record-replay logging and drain
        participation are unaffected — see docs/performance.md for exactly
        what is and isn't recorded).

        Instance-level only: the class-level generic wrappers stay intact,
        and :meth:`disable_fastpath` restores them.  Call again after
        anything that swaps ``self.backend`` to a different flavor, so the
        capability gate is re-resolved."""
        import types
        for spec in callspec.REGISTRY:
            fn = callspec.compile_fastpath(spec, self, transcripts=transcripts)
            self.__dict__[spec.name] = types.MethodType(fn, self)
        self._fastpath = True
        self._fastpath_transcripts = transcripts

    def disable_fastpath(self) -> None:
        """Drop the compiled instance wrappers; calls fall through to the
        generic class-level wrappers again."""
        for spec in callspec.REGISTRY:
            self.__dict__.pop(spec.name, None)
        self._fastpath = False

    # ------------------------------------------------------------------
    # buffered receive: the drain-redelivery guarantee, shared by user
    # p2p AND every collective (native and derived alike)
    # ------------------------------------------------------------------
    def _recv_any(self, src: int, tag: int):
        """Receive (src, tag) — drained-at-checkpoint messages first, then
        the live fabric.  The single choke point that makes in-flight
        traffic buffered by the quiesce protocol re-deliver transparently
        after restart, for collectives exactly like point-to-point."""
        for i, (s, t, payload) in enumerate(self.pending_messages):
            if s == src and t == tag:
                self.pending_messages.pop(i)
                return payload
        return self.backend.recv(src, tag)

    # ------------------------------------------------------------------
    # checkpoint support (the upper-half snapshot of this subsystem)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {"backend_name": self.backend_name,
                "translation": self.translation,
                "vids": self.vids.snapshot(),
                "log": self.log,
                "pending": list(self.pending_messages),
                "translate_count": self.translate_count}

    @classmethod
    def restore(cls, snap: dict, fabric, rank: int, world_size: int,
                backend_name: Optional[str] = None, *, pool=None) -> "Mana":
        """Rebuild on a NEW lower half — possibly a different backend flavor
        (ckpt under Cray, restart under Open MPI: the paper's §9 future work,
        implemented via the capability-translation layer in
        ``repro_torch.core.restore``).  ``pool`` routes the re-bind through the
        dependency-ordered parallel engine; ``None`` binds sequentially."""
        m = cls(backend_name or snap["backend_name"], fabric, rank, world_size,
                translation=snap["translation"])
        from repro_torch.core.restore import rebind_objects
        rebind_objects(m, snap, pool=pool)
        return m


# generate every MPI wrapper from the declarative registry: translation,
# kind checks, logging, transcripts, and failpoint arming in ONE place
callspec.install(Mana)
