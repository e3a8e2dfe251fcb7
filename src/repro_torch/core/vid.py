"""The paper's contribution, part 1: the new virtual-id subsystem (§4.2).

One 32-bit type-tagged virtual id for all five MPI-object kinds, backed by a
two-level table (like a 2-level page table) of pointers to descriptor structs.
The descriptor carries BOTH the current physical handle (whatever the runtime
backend uses: int, pointer, lazy enum member — MANA stays oblivious) AND the
MANA-internal metadata needed to rebuild the object at restart.

Layout of a vid (32 bits):
      [ 3 bits kind | 29 bits index ]
For COMM/GROUP kinds the index is the *ggid* (global group id — a stable hash
of the member ranks + a per-group sequence number), so communicators created
in the same order on every rank get the same vid without coordination, exactly
as in MANA. For REQUEST/OP/DATATYPE the index is a per-kind running counter.

The index maps into the two-level table: high bits select an L1 directory slot,
low bits the slot within an L2 page. Translation is two array indexations —
O(1), no string compares (the legacy design this replaces is in
legacy_vid.py and benchmarked against this one in benchmarks/bench_vid.py).
"""
from __future__ import annotations

import zlib
from typing import Any, Optional

from repro_torch.core.descriptors import Descriptor, Kind

KIND_BITS = 3
INDEX_BITS = 29
PAGE_BITS = 12                   # 4096 descriptors per L2 page
PAGE_SIZE = 1 << PAGE_BITS
L1_SIZE = 1 << (INDEX_BITS - PAGE_BITS)
VID_MASK = (1 << 32) - 1


def pack_vid(kind: Kind, index: int) -> int:
    if not 0 <= index < (1 << INDEX_BITS):
        raise ValueError(f"vid index out of range: {index}")
    return (kind.value << INDEX_BITS) | index


def vid_kind(vid: int) -> Kind:
    return Kind((vid >> INDEX_BITS) & ((1 << KIND_BITS) - 1))


def vid_index(vid: int) -> int:
    return vid & ((1 << INDEX_BITS) - 1)


def compute_ggid(member_ranks, seq: int) -> int:
    """Stable 'global group id' from the member ranks (paper §4.2): every rank
    computes the same ggid for the same communicator without extra messages.
    `seq` disambiguates repeated create/free of identical groups (the paper's
    §9 eager policy; see VidTable.ggid_policy for the lazy/hybrid variants)."""
    blob = (",".join(map(str, sorted(member_ranks))) + f"#{seq}").encode()
    return zlib.crc32(blob) & ((1 << INDEX_BITS) - 1)


class VidTable:
    """Two-level kind-tagged descriptor table. One instance per rank.

    The table itself is part of the upper half: it is saved in the checkpoint
    image and its descriptors are re-bound (physical handles replaced) at
    restart — handles stored anywhere in application state stay valid.
    """

    def __init__(self, ggid_policy: str = "eager"):
        assert ggid_policy in ("eager", "lazy", "hybrid")
        self.ggid_policy = ggid_policy
        # L1 directory (sparse) -> L2 pages; indexed by the FULL 32-bit vid,
        # so the kind tag participates in addressing (one table, five kinds)
        self._l1: dict[int, list] = {}
        # live-vid index: iteration (snapshot, drain's per-kind scan) walks
        # only live descriptors instead of every slot of every 4096-entry
        # page — snapshot capture is part of the checkpoint's stop-the-world
        # window, so iteration cost is blocking cost
        self._live: dict[int, Descriptor] = {}
        self._count = {k: 0 for k in Kind}
        self._ggid_seq: dict[tuple, int] = {}
        self._free_seq = 0   # bumps on free under the eager policy

    # -- slot management -------------------------------------------------
    def _page_for(self, vid: int, create: bool):
        hi, lo = vid >> PAGE_BITS, vid & (PAGE_SIZE - 1)
        page = self._l1.get(hi)
        if page is None:
            if not create:
                raise KeyError(f"no L2 page for vid {vid:#x}")
            page = self._l1[hi] = [None] * PAGE_SIZE
        return page, lo

    def insert(self, desc: Descriptor) -> int:
        """Assign a vid for the descriptor and store it. Returns the vid."""
        kind = desc.kind
        if kind in (Kind.COMM, Kind.GROUP):
            key = (kind, tuple(sorted(desc.meta.get("ranks", ()))))
            seq = self._ggid_seq.get(key, 0)
            # linear-probe ggid collisions / repeated identical groups
            while True:
                index = compute_ggid(desc.meta.get("ranks", ()), seq)
                page, lo = self._page_for(pack_vid(kind, index), create=True)
                if page[lo] is None:
                    break
                seq += 1
            self._ggid_seq[key] = seq + 1
        else:
            index = self._count[kind]
        vid = pack_vid(kind, index)
        page, lo = self._page_for(vid, create=True)
        if page[lo] is not None:
            raise RuntimeError(f"vid slot collision for {vid:#x}")
        page[lo] = desc
        desc.vid = vid
        self._live[vid] = desc
        self._count[kind] += 1
        return vid

    def lookup(self, vid: int) -> Descriptor:
        """virtual -> descriptor: two indexations, no search (the fast path the
        paper credits for the up-to-1.6% end-to-end win)."""
        page, lo = self._page_for(vid, create=False)
        d = page[lo]
        if d is None:
            raise KeyError(f"dangling vid {vid:#x}")
        return d

    def phys(self, vid: int) -> Any:
        return self.lookup(vid).phys

    def reverse(self, kind: Kind, phys: Any) -> Optional[int]:
        """physical -> virtual. O(n) over the kind's live descriptors — used by
        exactly one wrapper in MANA (paper §4.1 point 5), kept deliberately
        un-indexed to match."""
        for d in self.iter_kind(kind):
            if d.phys == phys:
                return d.vid
        return None

    def free(self, vid: int):
        page, lo = self._page_for(vid, create=False)
        if page[lo] is None:
            raise KeyError(f"double free of vid {vid:#x}")
        page[lo] = None
        self._live.pop(vid, None)
        if self.ggid_policy == "eager":
            self._free_seq += 1

    def iter_kind(self, kind: Kind):
        for d in self.all_descriptors():
            if d.kind == kind:
                yield d

    def all_descriptors(self):
        # vid-ascending, same order the page walk produced (hi directory
        # slots carry the vid's top bits, so sorting vids sorts pages)
        for vid in sorted(self._live):
            yield self._live[vid]

    def live_count(self, kind: Optional[Kind] = None) -> int:
        n = 0
        for d in self.all_descriptors():
            if kind is None or d.kind == kind:
                n += 1
        return n

    # -- checkpoint / restart --------------------------------------------
    def snapshot(self) -> dict:
        """Serializable form: descriptors WITHOUT physical handles (the lower
        half is never saved — physical ids are rebound at restart)."""
        return {
            "ggid_policy": self.ggid_policy,
            "counts": {k.name: v for k, v in self._count.items()},
            "ggid_seq": [[list(k[1]), k[0].name, v]
                         for k, v in self._ggid_seq.items()],
            "descriptors": [d.snapshot() for d in self.all_descriptors()],
        }

    @classmethod
    def restore(cls, snap: dict) -> "VidTable":
        t = cls(snap["ggid_policy"])
        t._count = {Kind[k]: v for k, v in snap["counts"].items()}
        t._ggid_seq = {(Kind[name], tuple(ranks)): v
                       for ranks, name, v in snap["ggid_seq"]}
        for ds in snap["descriptors"]:
            d = Descriptor.restore(ds)
            page, lo = t._page_for(d.vid, create=True)
            page[lo] = d
            t._live[d.vid] = d
        return t
