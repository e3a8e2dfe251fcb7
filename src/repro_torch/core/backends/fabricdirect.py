"""Fabric-direct backend: a thin MPI personality straight over the
interconnect provider (think libfabric/OFI endpoints with an MPI shim, the
way exascale runtimes increasingly ship one).  Fifth flavor in the restart
matrix — its whole point is to be UNLIKE the other four at once:

  * physical handles are opaque STRING TOKENS (``fi://comm/5f3a-0003``):
    neither MPICH's fixed ints, Open MPI's pointers, nor ExaMPI's smart
    pointers — the oblivious layer must survive a non-numeric handle type;
  * every token embeds a per-session NONCE, so no handle value ever survives
    a restart (strictly harsher than Open MPI, where at least the bit width
    is stable);
  * constants are resolved eagerly at startup (MPICH-style discipline) but
    their VALUES are session-scoped (Open MPI-style instability) — the
    worst of both for a checkpointer;
  * only the core subset exists: no native ``comm_split`` (the interpose
    layer emulates it with group math + ``comm_create``, paper §5).

No other flavor shares its family, so cross-restarting into or out of
``fabric`` exercises the pure-SERIALIZE column/row of the restart matrix.
"""
from __future__ import annotations

import itertools
import secrets

from repro_torch.core.backends.base import (Backend, PREDEFINED_DTYPES,
                                      PREDEFINED_OPS)


class FabricDirectBackend(Backend):
    name = "fabric"
    family = "fabric"

    def __init__(self, fabric, rank, world_size):
        super().__init__(fabric, rank, world_size)
        self._nonce = secrets.token_hex(2)      # session-scoped token prefix
        self._serial = itertools.count(1)
        self._objects: dict[str, dict] = {}     # token -> endpoint struct
        self._world = None
        self._dtypes: dict[str, str] = {}
        self._ops: dict[str, str] = {}
        self.init_constants()

    def capabilities(self):
        # pure core subset: NO native collectives at all — every collective
        # (bcast..scan, alltoall) reaches this flavor only as the interpose
        # layer's derived p2p composition, making fabric-direct the
        # all-derived column of the capability matrix
        return {"comm_create", "type_create", "op_create"}

    # -- tokens ---------------------------------------------------------------
    def _token(self, kind: str, struct: dict) -> str:
        tok = f"fi://{kind}/{self._nonce}-{next(self._serial):04x}"
        self._objects[tok] = struct
        return tok

    def _deref(self, kind: str, tok) -> dict:
        if not isinstance(tok, str) or not tok.startswith(f"fi://{kind}/"):
            raise TypeError(f"{self.name}: {tok!r} is not a {kind} token")
        st = self._objects.get(tok)
        if st is None:
            raise KeyError(f"{self.name}: dangling endpoint token {tok}")
        return st

    # -- constants: eager, but session-scoped values --------------------------
    def init_constants(self):
        self._world = self._token(
            "comm", {"ranks": list(range(self.world_size))})
        for nm, size, _ in PREDEFINED_DTYPES:
            self._dtypes[nm] = self._token(
                "datatype", {"envelope": {"combiner": "named", "name": nm,
                                          "itemsize": size}})
        for nm in PREDEFINED_OPS:
            self._ops[nm] = self._token("op", {"name": nm,
                                               "commutative": True})

    def world_comm(self):
        return self._world

    def predefined_dtype(self, name):
        return self._dtypes[name]

    def predefined_op(self, name):
        return self._ops[name]

    # -- objects ---------------------------------------------------------------
    def comm_create(self, ranks):
        return self._token("comm", {"ranks": list(ranks)})

    def comm_split(self, comm, color, key, members_by_color):
        raise NotImplementedError("fabric-direct subset has no comm_split")

    def comm_free(self, comm):
        # _deref raises on a mistyped token AND on double free (the first
        # free removed the token, so the second no longer resolves)
        self._deref("comm", comm)
        del self._objects[comm]

    def comm_group(self, comm):
        st = self._deref("comm", comm)
        return self._token("group", {"ranks": list(st["ranks"])})

    def group_translate_ranks(self, group):
        return list(self._deref("group", group)["ranks"])

    def comm_ranks(self, comm):
        return list(self._deref("comm", comm)["ranks"])

    def type_create(self, envelope):
        return self._token("datatype", {"envelope": dict(envelope)})

    def type_get_envelope(self, dtype):
        return dict(self._deref("datatype", dtype)["envelope"])

    def op_create(self, name, commutative):
        return self._token("op", {"name": name, "commutative": commutative})

    def request_create(self, info):
        return self._token("request", {"info": dict(info), "done": False})

    def test(self, request):
        st = self._deref("request", request)
        st["done"] = True
        return True

    def test_all(self, requests):
        # one sweep over the endpoint table for the whole vector
        structs = [self._deref("request", r) for r in requests]
        for st in structs:
            st["done"] = True
        return [True] * len(structs)
