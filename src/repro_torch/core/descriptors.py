"""Descriptor structs behind every virtual id (paper §4.2).

Each descriptor stores: the object kind, the current *physical* handle owned by
the lower-half runtime backend (int / pointer / lazy enum — opaque to MANA),
MANA-internal metadata sufficient to rebuild the object at restart, and the
per-object reconstruction strategy (paper §1.2 point 4):

  RECORD_REPLAY — replay the recorded creation call against the new backend
  SERIALIZE     — rebuild from the decoded description (e.g. datatype envelope)
  HYBRID        — replay if the same backend flavor, else deserialize

The physical handle is explicitly excluded from snapshots: only upper-half
state enters the checkpoint image.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class Kind(enum.Enum):
    COMM = 0
    GROUP = 1
    REQUEST = 2
    OP = 3
    DATATYPE = 4


class Strategy(enum.Enum):
    RECORD_REPLAY = "record_replay"
    SERIALIZE = "serialize"
    HYBRID = "hybrid"


@dataclass
class Descriptor:
    kind: Kind
    meta: dict = field(default_factory=dict)
    strategy: Strategy = Strategy.HYBRID
    phys: Any = None          # lower-half handle; NEVER serialized
    vid: int = -1
    # transient bookkeeping (requests): completion status, buffered payload
    state: dict = field(default_factory=dict)

    def snapshot(self) -> dict:
        return {"kind": self.kind.name, "meta": _jsonable(self.meta),
                "strategy": self.strategy.value, "vid": self.vid,
                "state": _jsonable(self.state)}

    @classmethod
    def restore(cls, snap: dict) -> "Descriptor":
        return cls(kind=Kind[snap["kind"]], meta=snap["meta"],
                   strategy=Strategy(snap["strategy"]), phys=None,
                   vid=snap["vid"], state=snap.get("state", {}))


def _jsonable(d):
    def conv(v):
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (int, float, str, bool)) or v is None:
            return v
        return repr(v)
    return conv(d)


# -- convenience constructors ----------------------------------------------

def comm_desc(ranks, *, axis_name=None, parent=None, color=None, key=None,
              strategy=Strategy.HYBRID) -> Descriptor:
    return Descriptor(Kind.COMM, meta={
        "ranks": list(ranks), "axis_name": axis_name, "parent": parent,
        "color": color, "key": key}, strategy=strategy)


def group_desc(ranks, *, parent=None, strategy=Strategy.HYBRID) -> Descriptor:
    return Descriptor(Kind.GROUP, meta={"ranks": list(ranks), "parent": parent},
                      strategy=strategy)


def request_desc(op, *, peer=None, tag=0, payload_ref=None) -> Descriptor:
    return Descriptor(Kind.REQUEST, meta={
        "op": op, "peer": peer, "tag": tag, "payload_ref": payload_ref},
        strategy=Strategy.RECORD_REPLAY, state={"done": False})


def op_desc(name, commutative=True) -> Descriptor:
    return Descriptor(Kind.OP, meta={"name": name, "commutative": commutative},
                      strategy=Strategy.RECORD_REPLAY)


def datatype_desc(envelope: dict) -> Descriptor:
    """`envelope` mirrors MPI_Type_get_envelope/_contents: enough to rebuild
    the dtype+layout on ANY backend (the paper's §5 category-2 decode)."""
    return Descriptor(Kind.DATATYPE, meta={"envelope": envelope},
                      strategy=Strategy.SERIALIZE)
