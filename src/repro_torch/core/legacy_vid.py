"""The *old* MANA virtual-id design (paper §4.1) — kept as the measured
baseline for benchmarks/bench_vid.py and the MANA-vs-MANA+virtId comparisons
(paper Figures 2-4).

Faithful to the drawbacks the paper lists:
  1. one separate map per MPI-object kind,
  2. selected via macro-encoded *string* comparison on every call,
  3. the table stores only the virtual->real binding — all other per-object
     data lives in N parallel maps, so k attributes cost k lookups,
  4. real->virtual translation is O(n) iteration,
  5. plain int virtual ids with no embedded kind tag.
"""
from __future__ import annotations

from typing import Any


_KIND_NAMES = ("MPI_Comm", "MPI_Group", "MPI_Request", "MPI_Op", "MPI_Datatype")


class LegacyVidTables:
    def __init__(self):
        # one string-keyed singleton map per kind (drawback 1)
        self._maps: dict[str, dict[int, Any]] = {n: {} for n in _KIND_NAMES}
        # parallel attribute maps (drawback 3)
        self._attr_maps: dict[str, dict[str, dict[int, Any]]] = {
            n: {} for n in _KIND_NAMES}
        self._next: dict[str, int] = {n: 1 for n in _KIND_NAMES}

    def _map_for(self, kind_name: str):
        # macro-encoded string comparison chain (drawback 2)
        for name in _KIND_NAMES:
            if name == kind_name:
                return self._maps[name]
        raise KeyError(kind_name)

    def insert(self, kind_name: str, phys) -> int:
        m = self._map_for(kind_name)
        vid = self._next[kind_name]
        self._next[kind_name] = vid + 1
        m[vid] = phys
        return vid

    def virtual_to_real(self, kind_name: str, vid: int):
        return self._map_for(kind_name)[vid]

    def real_to_virtual(self, kind_name: str, phys):
        m = self._map_for(kind_name)
        for v, p in m.items():          # O(n) (drawback 4)
            if p == phys:
                return v
        return None

    def set_attr(self, kind_name: str, vid: int, attr: str, value):
        self._map_for(kind_name)        # string compare again
        self._attr_maps[kind_name].setdefault(attr, {})[vid] = value

    def get_attr(self, kind_name: str, vid: int, attr: str):
        self._map_for(kind_name)        # and again (drawback 3)
        return self._attr_maps[kind_name][attr][vid]

    def free(self, kind_name: str, vid: int):
        del self._map_for(kind_name)[vid]
        for amap in self._attr_maps[kind_name].values():
            amap.pop(vid, None)
