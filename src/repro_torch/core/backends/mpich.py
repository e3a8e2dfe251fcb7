"""MPICH-family backend: physical ids are special 32-bit ints addressing a
2-level table (paper §3), and predefined constants are fixed integers that are
identical in upper/lower halves and across sessions (paper §4.3)."""
from __future__ import annotations

from repro_torch.core.backends.base import (Backend, PREDEFINED_DTYPES,
                                      PREDEFINED_OPS)

# kind prefixes mirror real MPICH handle encoding (MPI_COMM_WORLD=0x44000000)
_KIND_PREFIX = {"comm": 0x44, "group": 0x48, "request": 0x4C, "op": 0x50,
                "datatype": 0x54}
_L1_BITS, _L2_BITS = 8, 16


class MpichBackend(Backend):
    name = "mpich"
    family = "mpich"

    def __init__(self, fabric, rank, world_size):
        super().__init__(fabric, rank, world_size)
        # the 2-level physical table: kind -> L1 directory of L2 pages
        self._tables = {k: [None] * (1 << _L1_BITS) for k in _KIND_PREFIX}
        self._counts = {k: 0 for k in _KIND_PREFIX}
        self._world = None
        self._dtypes = {}
        self._ops = {}
        self.init_constants()

    # -- handle plumbing -----------------------------------------------------
    def _alloc(self, kind: str, struct: dict) -> int:
        idx = self._counts[kind]
        self._counts[kind] += 1
        hi, lo = idx >> _L2_BITS, idx & ((1 << _L2_BITS) - 1)
        table = self._tables[kind]
        if table[hi] is None:
            table[hi] = {}
        table[hi][lo] = struct
        return (_KIND_PREFIX[kind] << 24) | idx

    def _deref(self, kind: str, handle: int) -> dict:
        if (handle >> 24) != _KIND_PREFIX[kind]:
            raise ValueError(f"{self.name}: handle {handle:#x} is not a {kind}")
        idx = handle & 0xFFFFFF
        hi, lo = idx >> _L2_BITS, idx & ((1 << _L2_BITS) - 1)
        page = self._tables[kind][hi]
        if page is None or lo not in page:
            raise KeyError(f"{self.name}: dangling {kind} handle {handle:#x}")
        return page[lo]

    # -- constants: fixed ints, stable across sessions ------------------------
    def init_constants(self):
        self._world = self._alloc("comm", {"ranks": list(range(self.world_size))})
        for i, (nm, size, alias) in enumerate(PREDEFINED_DTYPES):
            self._dtypes[nm] = 0x4C000000 | (size << 8) | i  # fixed encoding
        for i, nm in enumerate(PREDEFINED_OPS):
            self._ops[nm] = 0x58000000 | i

    def world_comm(self):
        return self._world

    def predefined_dtype(self, name):
        return self._dtypes[name]

    def predefined_op(self, name):
        return self._ops[name]

    # -- objects ---------------------------------------------------------------
    def comm_create(self, ranks):
        return self._alloc("comm", {"ranks": list(ranks)})

    def comm_split(self, comm, color, key, members_by_color):
        self._deref("comm", comm)  # validate parent
        return self._alloc("comm", {"ranks": list(members_by_color),
                                    "split": (color, key)})

    def comm_free(self, comm):
        idx = comm & 0xFFFFFF
        hi, lo = idx >> _L2_BITS, idx & ((1 << _L2_BITS) - 1)
        page = self._tables["comm"][hi]
        if page is None or page.pop(lo, None) is None:
            raise KeyError(f"double free of comm {comm:#x}")

    def comm_group(self, comm):
        st = self._deref("comm", comm)
        return self._alloc("group", {"ranks": list(st["ranks"])})

    def group_translate_ranks(self, group):
        return list(self._deref("group", group)["ranks"])

    def comm_ranks(self, comm):
        return list(self._deref("comm", comm)["ranks"])

    def type_create(self, envelope):
        return self._alloc("datatype", {"envelope": dict(envelope)})

    def type_get_envelope(self, dtype):
        if isinstance(dtype, int) and (dtype >> 24) == 0x4C and (dtype & 0xFF) < 64:
            # predefined dtype: decode from the fixed encoding
            for nm, size, _ in PREDEFINED_DTYPES:
                if self._dtypes.get(nm) == dtype:
                    return {"combiner": "named", "name": nm, "itemsize": size}
        return dict(self._deref("datatype", dtype)["envelope"])

    def op_create(self, name, commutative):
        return self._alloc("op", {"name": name, "commutative": commutative})

    def request_create(self, info):
        return self._alloc("request", {"info": dict(info), "done": False})

    def test(self, request):
        st = self._deref("request", request)
        st["done"] = True  # in-process fabric delivers eagerly
        return st["done"]

    def test_all(self, requests):
        # native MPI_Testall: one pass over the 2-level table, derefing the
        # whole vector before flipping completion flags (single host call)
        structs = [self._deref("request", r) for r in requests]
        for st in structs:
            st["done"] = True
        return [st["done"] for st in structs]

    # -- native collectives ---------------------------------------------------
    def bcast(self, comm, root, value, *, tag, recv):
        """Binomial-tree broadcast — MPICH's default small-message
        algorithm: rank `rel` (relative to the root) receives from
        ``rel ^ lowbit(rel)`` and forwards down its subtree.  Semantically
        identical to the base linear fan-out; the message pattern is the
        family-specific part."""
        ranks, _ = self._coll_ranks(comm)
        self._coll_root(ranks, root)
        n = len(ranks)
        rel = (ranks.index(self.rank) - root) % n
        mask = 1
        while mask < n:
            if rel & mask:
                value = recv(ranks[((rel ^ mask) + root) % n], tag)
                break
            mask <<= 1
        mask >>= 1
        while mask > 0:
            child = rel | mask
            if child != rel and child < n:
                self.send(ranks[(child + root) % n], tag, value)
            mask >>= 1
        return value
