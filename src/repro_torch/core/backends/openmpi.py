"""Open MPI backend: physical ids are 64-bit POINTERS to internal structs
(paper §3) and global constants are macros expanding to FUNCTION CALLS whose
results are resolved at library startup and differ between sessions and
between the (dynamically linked) upper half and (statically linked) lower half
(paper §4.3). We model a pointer as the Python object id of the struct, which
naturally varies per session."""
from __future__ import annotations

import itertools

from repro_torch.core.backends.base import (Backend, PREDEFINED_DTYPES,
                                      PREDEFINED_OPS)


class _OmpiStruct:
    """An ompi_communicator_t / ompi_group_t / ... internal struct."""
    __slots__ = ("kind", "data", "refcount")

    def __init__(self, kind, **data):
        self.kind = kind
        self.data = data
        self.refcount = 1


class OpenMpiBackend(Backend):
    name = "openmpi"
    family = "ompi"

    def __init__(self, fabric, rank, world_size):
        super().__init__(fabric, rank, world_size)
        self._live: dict[int, _OmpiStruct] = {}  # ptr -> struct (keeps alive)
        self._world = None
        self._dtypes = {}
        self._ops = {}
        self.init_constants()

    # -- pointers ------------------------------------------------------------
    def _ptr(self, struct: _OmpiStruct) -> int:
        p = id(struct)            # 64-bit pointer; session-dependent
        self._live[p] = struct
        return p

    def _deref(self, kind: str, ptr: int) -> _OmpiStruct:
        st = self._live.get(ptr)
        if st is None:
            raise KeyError(f"{self.name}: dangling pointer {ptr:#x}")
        if st.kind != kind:
            raise ValueError(f"{self.name}: {ptr:#x} is {st.kind}, wanted {kind}")
        return st

    # -- constants: resolved by function call at startup ----------------------
    def init_constants(self):
        # the 'ompi_mpi_comm_world' function — a fresh pointer every session
        self._world = self._ptr(_OmpiStruct(
            "comm", ranks=list(range(self.world_size))))
        for nm, size, _ in PREDEFINED_DTYPES:
            self._dtypes[nm] = self._ptr(_OmpiStruct(
                "datatype", envelope={"combiner": "named", "name": nm,
                                      "itemsize": size}))
        for nm in PREDEFINED_OPS:
            self._ops[nm] = self._ptr(_OmpiStruct("op", name=nm, commutative=True))

    def world_comm(self):
        return self._world

    def predefined_dtype(self, name):
        return self._dtypes[name]

    def predefined_op(self, name):
        return self._ops[name]

    # -- objects ---------------------------------------------------------------
    def comm_create(self, ranks):
        return self._ptr(_OmpiStruct("comm", ranks=list(ranks)))

    def comm_split(self, comm, color, key, members_by_color):
        self._deref("comm", comm)
        return self._ptr(_OmpiStruct("comm", ranks=list(members_by_color),
                                     split=(color, key)))

    def comm_free(self, comm):
        st = self._live.pop(comm, None)
        if st is None:
            raise KeyError(f"double free of comm pointer {comm:#x}")

    def comm_group(self, comm):
        st = self._deref("comm", comm)
        return self._ptr(_OmpiStruct("group", ranks=list(st.data["ranks"])))

    def group_translate_ranks(self, group):
        return list(self._deref("group", group).data["ranks"])

    def comm_ranks(self, comm):
        return list(self._deref("comm", comm).data["ranks"])

    def type_create(self, envelope):
        return self._ptr(_OmpiStruct("datatype", envelope=dict(envelope)))

    def type_get_envelope(self, dtype):
        return dict(self._deref("datatype", dtype).data["envelope"])

    def op_create(self, name, commutative):
        return self._ptr(_OmpiStruct("op", name=name, commutative=commutative))

    def request_create(self, info):
        return self._ptr(_OmpiStruct("request", info=dict(info), done=False))

    def test(self, request):
        st = self._deref("request", request)
        st.data["done"] = True
        return True

    def test_all(self, requests):
        # ompi_request_test_all over the pointer vector: every struct is
        # dereferenced up front, completion recorded in one sweep
        structs = [self._deref("request", r) for r in requests]
        for st in structs:
            st.data["done"] = True
        return [True] * len(structs)

    # -- native collectives ---------------------------------------------------
    def allgather(self, comm, value, *, tag, recv):
        """Ring allgather (Open MPI's tuned large-message algorithm): each
        step forwards the block received last step to the right neighbor,
        so every member sends/receives exactly n-1 blocks.  Per-step tag
        offsets keep a step's block from being consumed a step early."""
        ranks, me = self._coll_ranks(comm)
        n = len(ranks)
        out = [None] * n
        out[me] = value
        right, left = ranks[(me + 1) % n], ranks[(me - 1) % n]
        block, cur = me, value
        for step in range(n - 1):
            step_tag = tag + (step << 52)
            self.send(right, step_tag, (block, cur))
            block, cur = recv(left, step_tag)
            out[block] = cur
        return out
