"""Live session migration between serving engines — across backend flavors.

A session decoding on an engine whose cluster runs flavor A (say MPICH)
can move MID-SEQUENCE to an engine running flavor B (say the raw fabric
reference): its pool payload (token rows + block state), decode cursor,
and scheduler standing ship over the interposed p2p plane and the session
resumes decoding at the destination with a gap- and duplicate-free token
stream.  This works because the pool payload is flavor-neutral numpy —
exactly the paper's thesis applied sideways: the MPI implementation is an
I/O detail of the lower half, so serving state that never references it
can land anywhere.

Wire protocol (one session; all messages on ``MIGRATE_TAG``):

    {"op": "session", sid, cursor, sched_state, parked, table, leaves}
    {"op": "chunk", sid, section, key, data, dtype, shape, sha}   * N
    {"op": "commit", sid, count: N}

then ONE ack back on ``MIGRATE_ACK_TAG``: ``{"ok": bool, sid, error?}``.

Digest rules (same discipline as the elastic-join shard stream): every
chunk carries ``sha = container_sha(data)`` computed at export; the
receiver re-hashes on arrival and a single mismatch fails the WHOLE
session.  The header's StateLeaf descriptors, after re-encoding through
the destination's ``translation_plan``, are then checked against every
imported array (canonical dtype + shape) — a descriptor mismatch rejects
the session the same way.  The commit/ack handshake is two-phase, so the
source releases its copy only after the destination acknowledges a
fully-verified import.
On any failure the session keeps decoding at the source (at-most-once
placement: it never runs in two places, and never in zero).

The ``serve.migrate.chunk`` failpoint sits just before each chunk send —
the ``migrate_corrupt`` fault kind flips payload bytes there (leaving the
recorded sha) to prove the digest check rejects torn transfers.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import callspec
from repro_torch.core.backends.fabric import Fabric
from repro_torch.core.ckpt_tiers import container_sha
from repro_torch.core.faults import failpoint
from repro_torch.core.interpose import Mana
from repro_torch.core.restore import translation_plan
from repro_torch.core.runtime_state import StateLeaf, reencode_leaves, \
    transport_dtype

MIGRATE_TAG = (callspec.TAG_BASES["migrate"] << 32) | 0
MIGRATE_ACK_TAG = (callspec.TAG_BASES["migrate"] << 32) | 1


class MigrationError(RuntimeError):
    """The transfer failed verification (or was refused); the session is
    still live at the SOURCE."""


@dataclass
class MigrationReport:
    """Telemetry for one ``migrate_sessions`` call."""
    src_flavor: str
    dst_flavor: str
    sessions: list = field(default_factory=list)
    chunks: int = 0
    bytes: int = 0
    reencoded_leaves: int = 0

    def to_dict(self) -> dict:
        return {"src_flavor": self.src_flavor, "dst_flavor": self.dst_flavor,
                "sessions": list(self.sessions), "chunks": self.chunks,
                "bytes": self.bytes,
                "reencoded_leaves": self.reencoded_leaves}


class MigrationLink:
    """A 2-rank bridge world: rank 0 speaks the source engine's flavor,
    rank 1 the destination's, both over one shared fabric — the wire
    format is flavor-oblivious, so mixed-flavor endpoints interoperate
    (the same construction the cross-flavor interop tests use)."""

    def __init__(self, src_flavor: str, dst_flavor: str):
        self.src_flavor = src_flavor
        self.dst_flavor = dst_flavor
        self.fabric = Fabric(2)
        self.src = Mana(src_flavor, self.fabric, 0, 2)
        self.dst = Mana(dst_flavor, self.fabric, 1, 2)

    def send_to_dst(self, msg: dict) -> None:
        self.src.backend.send(1, MIGRATE_TAG, msg)

    def recv_at_dst(self) -> dict:
        return self.dst._recv_any(0, MIGRATE_TAG)

    def ack_to_src(self, msg: dict) -> None:
        self.dst.backend.send(0, MIGRATE_ACK_TAG, msg)

    def recv_ack(self) -> dict:
        return self.src._recv_any(1, MIGRATE_ACK_TAG)


def _payload_chunks(sid: str, payload: dict):
    """Flatten a pool payload into wire chunks (sorted for a deterministic
    stream order)."""
    for section in ("tokens", "blocks"):
        for key in sorted(payload.get(section) or {}):
            arr = np.ascontiguousarray(payload[section][key])
            data = arr.tobytes()
            yield {"op": "chunk", "sid": sid, "section": section,
                   "key": key, "data": data, "dtype": arr.dtype.name,
                   "shape": list(arr.shape), "sha": container_sha(data)}


def _payload_leaves(payload: dict) -> list:
    """StateLeaf descriptors for the payload arrays, in chunk order —
    these ride the header so the receiver can apply the same transport
    re-encode discipline runtime-state restores use."""
    out = []
    for section in ("tokens", "blocks"):
        for key in sorted(payload.get(section) or {}):
            arr = np.asarray(payload[section][key])
            out.append(StateLeaf(
                name=f"{section}/{key}", dtype=arr.dtype.name,
                shape=tuple(arr.shape),
                mpi_dtype=transport_dtype(arr.dtype.name)).to_json())
    return out


def migrate_sessions(src_engine, dst_engine, sids, *, link=None):
    """Move ``sids`` live from ``src_engine`` to ``dst_engine`` (possibly a
    different backend flavor), one session at a time, two-phase each.

    Returns a :class:`MigrationReport`; raises :class:`MigrationError` on
    the first session whose transfer fails verification (that session and
    all following ones stay at the source)."""
    src_flavor = src_engine.cluster.backend_name
    dst_flavor = dst_engine.cluster.backend_name
    if link is None:
        link = MigrationLink(src_flavor, dst_flavor)
    plan = translation_plan(src_flavor, dst_flavor,
                            dst_engine.cluster.mana(0).backend)
    report = MigrationReport(src_flavor=src_flavor, dst_flavor=dst_flavor)
    for sid in sids:
        state = src_engine.export_session_state(sid)
        payload = state["pool"]
        chunks = list(_payload_chunks(sid, payload))
        link.send_to_dst({"op": "session", "sid": sid,
                          "cursor": state["cursor"],
                          "sched_state": state["sched_state"],
                          "parked": bool(state["parked"]),
                          "table": payload.get("table"),
                          "leaves": _payload_leaves(payload)})
        for ch in chunks:
            # chaos hook: migrate_corrupt flips ch["data"] bytes HERE,
            # after the sha was recorded — the receiver must catch it
            failpoint("serve.migrate.chunk", msg=ch)
            link.send_to_dst(ch)
        link.send_to_dst({"op": "commit", "sid": sid, "count": len(chunks)})
        ack = _receive_session(link, dst_engine, plan, report)
        if not ack.get("ok"):
            raise MigrationError(
                f"migration of {sid!r} rejected by destination: "
                f"{ack.get('error', 'unknown')} — session stays at source")
        src_engine.release_session(sid)
        report.sessions.append(sid)
    return report


def _receive_session(link, dst_engine, plan, report) -> dict:
    """Destination side of one session: drain header→commit, verify every
    chunk digest, import atomically, ack the verdict to the source."""
    header = link.recv_at_dst()
    sid = header["sid"]
    sections: dict = {"tokens": {}, "blocks": {}}
    n_chunks, nbytes, error = 0, 0, None
    while True:
        msg = link.recv_at_dst()
        if msg["op"] == "commit":
            if msg["count"] != n_chunks and error is None:
                error = (f"chunk count mismatch: sent {msg['count']}, "
                         f"received {n_chunks}")
            break
        n_chunks += 1
        nbytes += len(msg["data"])
        if container_sha(msg["data"]) != msg["sha"]:
            error = error or (f"digest mismatch on {msg['section']}/"
                              f"{msg['key']} — torn transfer")
            continue          # keep draining so the stream stays framed
        arr = np.frombuffer(msg["data"], dtype=np.dtype(msg["dtype"]))
        sections[msg["section"]][msg["key"]] = \
            arr.reshape(msg["shape"]).copy()
    if error is None:
        leaves, n_re = reencode_leaves(header.get("leaves") or [], plan)
        report.reencoded_leaves += n_re
        # the re-encoded descriptors are the post-transport contract:
        # every imported array must match the canonical dtype/shape they
        # advertise, whatever transport alias its bytes rode under — a
        # mismatch rejects the session exactly like a digest failure
        for lj in leaves:
            section, _, key = lj["name"].partition("/")
            arr = sections.get(section, {}).get(key)
            if arr is None:
                error = f"leaf {lj['name']} advertised but never received"
                break
            if arr.dtype.name != lj["dtype"] \
                    or list(arr.shape) != list(lj["shape"]):
                error = (f"leaf {lj['name']}: received {arr.dtype.name}"
                         f"{tuple(arr.shape)} != descriptor {lj['dtype']}"
                         f"{tuple(lj['shape'])}")
                break
    if error is None:
        payload = {"table": header.get("table"),
                   "tokens": sections["tokens"],
                   "blocks": sections["blocks"]}
        try:
            dst_engine.import_session_state(
                sid, {"cursor": header["cursor"],
                      "sched_state": header["sched_state"],
                      "parked": header["parked"], "pool": payload})
        except Exception as e:        # refuse rather than half-import
            error = f"import failed: {e}"
    report.chunks += n_chunks
    report.bytes += nbytes
    ack = {"ok": error is None, "sid": sid}
    if error is not None:
        ack["error"] = error
    link.ack_to_src(ack)
    return link.recv_ack()
