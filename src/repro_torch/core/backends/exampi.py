"""ExaMPI backend: the experimental implementation (paper §3, §4.3, §6.2).

Design quirks faithfully modeled:
  * handles are SMART SHARED POINTERS (refcounted wrappers), not raw ints;
  * primitive datatypes live in an enum class, and some constants ALIAS each
    other (MPI_INT8_T and MPI_CHAR share a pointer via reinterpret casts);
  * global constants are resolved LAZILY, on first use — their addresses are
    not known at library startup (MANA must tolerate late binding);
  * only a SUBSET of the API exists: no native comm_split (the interpose layer
    emulates it per paper §5 — MANA needs only the core subset).
"""
from __future__ import annotations

import enum

from repro_torch.core.backends.base import (Backend, PREDEFINED_DTYPES,
                                      PREDEFINED_OPS)


class ExaDtype(enum.Enum):
    """Primitive datatypes as an enum class (conflicts with naive templates —
    the reason the old MANA design broke on ExaMPI, paper §3)."""
    CHAR = ("MPI_CHAR", 1)
    INT32 = ("MPI_INT32_T", 4)
    INT64 = ("MPI_INT64_T", 8)
    FLOAT = ("MPI_FLOAT", 4)
    DOUBLE = ("MPI_DOUBLE", 8)
    BF16 = ("MPI_BFLOAT16", 2)


_ALIASES = {"MPI_INT8_T": "MPI_CHAR"}  # shared pointer via reinterpret cast


class SharedPtr:
    """Smart shared pointer wrapper (use_count + payload)."""
    __slots__ = ("obj", "use_count")

    def __init__(self, obj):
        self.obj = obj
        self.use_count = 1

    def get(self):
        return self.obj

    def __eq__(self, other):
        return isinstance(other, SharedPtr) and self.obj is other.obj

    def __hash__(self):
        return id(self.obj)


class ExaMpiBackend(Backend):
    name = "exampi"
    family = "exampi"

    def __init__(self, fabric, rank, world_size):
        super().__init__(fabric, rank, world_size)
        self._world = None
        self._lazy_dtypes: dict[str, SharedPtr] = {}
        self._lazy_ops: dict[str, SharedPtr] = {}
        self.init_constants()

    def capabilities(self):
        # core subset only: no native comm_split, and of the collective
        # surface just bcast/allreduce are native — everything else the
        # interpose layer derives from p2p under the same session token
        # (paper §5: MANA needs only the core subset)
        return {"comm_create", "type_create", "op_create",
                "bcast", "allreduce"}

    def alias_dtype(self, name):
        # INT8/CHAR share a pointer via reinterpret cast: the restore path
        # re-encodes envelopes through this so cross-backend rebinds land on
        # the canonical constant
        return _ALIASES.get(name, name)

    # -- constants: LAZY ------------------------------------------------------
    def init_constants(self):
        # deliberately does (almost) nothing: ExaMPI resolves lazily
        self._world = None

    def world_comm(self):
        if self._world is None:  # first use
            self._world = SharedPtr({"kind": "comm",
                                     "ranks": list(range(self.world_size))})
        return self._world

    def predefined_dtype(self, name):
        name = _ALIASES.get(name, name)
        sp = self._lazy_dtypes.get(name)
        if sp is None:  # resolved on first use; INT8/CHAR share this pointer
            member = next(m for m in ExaDtype if m.value[0] == name)
            sp = SharedPtr({"kind": "datatype", "enum": member,
                            "envelope": {"combiner": "named", "name": name,
                                         "itemsize": member.value[1]}})
            self._lazy_dtypes[name] = sp
        else:
            sp.use_count += 1
        return sp

    def predefined_op(self, name):
        sp = self._lazy_ops.get(name)
        if sp is None:
            sp = SharedPtr({"kind": "op", "name": name, "commutative": True})
            self._lazy_ops[name] = sp
        return sp

    # -- objects ---------------------------------------------------------------
    @staticmethod
    def _deref(kind, sp):
        if not isinstance(sp, SharedPtr):
            raise TypeError(f"exampi handles are SharedPtr, got {type(sp)!r}")
        obj = sp.get()
        if obj is None or obj.get("kind") != kind:
            raise KeyError(f"exampi: dangling/mistyped {kind} handle")
        return obj

    def comm_create(self, ranks):
        return SharedPtr({"kind": "comm", "ranks": list(ranks)})

    def comm_split(self, comm, color, key, members_by_color):
        raise NotImplementedError("ExaMPI subset has no comm_split")

    def comm_free(self, comm):
        obj = self._deref("comm", comm)
        comm.use_count -= 1
        if comm.use_count <= 0:
            comm.obj = None

    def comm_group(self, comm):
        obj = self._deref("comm", comm)
        return SharedPtr({"kind": "group", "ranks": list(obj["ranks"])})

    def group_translate_ranks(self, group):
        return list(self._deref("group", group)["ranks"])

    def comm_ranks(self, comm):
        return list(self._deref("comm", comm)["ranks"])

    def type_create(self, envelope):
        return SharedPtr({"kind": "datatype", "envelope": dict(envelope)})

    def type_get_envelope(self, dtype):
        return dict(self._deref("datatype", dtype)["envelope"])

    def op_create(self, name, commutative):
        return SharedPtr({"kind": "op", "name": name, "commutative": commutative})

    def request_create(self, info):
        return SharedPtr({"kind": "request", "info": dict(info), "done": False})

    def test(self, request):
        obj = self._deref("request", request)
        obj["done"] = True
        return True

    def test_all(self, requests):
        # ExaMPI subset: testall exists (only waitany is missing); the smart
        # pointers are dereferenced as a batch before completion is recorded
        objs = [self._deref("request", sp) for sp in requests]
        for obj in objs:
            obj["done"] = True
        return [True] * len(objs)
