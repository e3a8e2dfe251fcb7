"""Runtime state as a first-class checkpointable object (ROADMAP item 4).

The checkpoint plane has so far been demonstrated for *parameter* state
only: a preempted serving or generation job loses its KV caches, SSM/conv
recurrent states, RNG streams, and data-pipeline cursors on restart (the
``serve.py`` treedef gap).  This module closes that gap with a registry of
named, versioned runtime-state *providers*:

- a provider owns one piece of live state (a KV-cache tree, a threefry
  key stream, a JSON cursor) and knows how to snapshot it
  into (array subtree, JSON meta) and how to restore it;
- :class:`StateLeaf` descriptors record per-leaf dtype/shape/layout plus an
  MPI *transport* datatype name, so the restore plane can re-encode runtime
  envelopes through exactly the canonical-dtype aliasing discipline it
  already applies to predefined constants (``PairPlan.dtype_aliases``,
  ExaMPI INT8/CHAR reinterpret-cast — paper §4.3);
- the array subtrees ride the ordinary checkpoint container under a
  conventional top-level ``"runtime"`` key: same incremental delta digests,
  same codecs, same tier replication, but tagged ``kind="runtime"`` in the
  container index and manifest so tooling can tell state from params;
- JSON meta (including a serialized *tree skeleton* per provider) rides the
  per-rank ``state.json``, so a restore can rebuild the exact pytree
  structure — and therefore the shardings tree — without any live state
  (no prefill-before-resume).

Nothing here imports the model or launch layers; providers are closures
registered by the workloads (``serving/engine.py``).  Trees are nested
dicts/lists of torch tensors or numpy arrays, flattened in the JAX package's
order (dict keys sorted), so a snapshot written by either package restores
in the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core import ckpt_io
from repro_torch.core.ckpt_pipeline import host_dtype
from repro_torch.models.params import tree_leaves

FORMAT = 1                  # registry meta format version
RUNTIME_KIND = "runtime"    # container entry kind for runtime leaves

# numpy dtype name -> MPI transport datatype constant.  Dtypes with no
# predefined MPI constant (float8s, packed bools, ...) travel as byte
# envelopes — MPI_CHAR under every flavor's aliasing table.
_NP_TO_MPI = {
    "int8": "MPI_INT8_T",
    "uint8": "MPI_CHAR",
    "int32": "MPI_INT32_T",
    "int64": "MPI_INT64_T",
    "float32": "MPI_FLOAT",
    "float64": "MPI_DOUBLE",
    "bfloat16": "MPI_BFLOAT16",
}
_BYTE_TRANSPORT = "MPI_CHAR"


def transport_dtype(np_name: str) -> str:
    """MPI transport constant for a numpy dtype name."""
    return _NP_TO_MPI.get(np_name, _BYTE_TRANSPORT)


# ---------------------------------------------------------------------------
# tree skeletons: JSON-able pytree structure with leaf placeholders
# ---------------------------------------------------------------------------
# dicts flatten in sorted-key order (as in the JAX package); the skeleton
# walk mirrors that so skeleton leaf order == ``tree_leaves`` order.

def tree_skeleton(tree) -> dict:
    """JSON-able structural skeleton of a pytree (dict/list/tuple
    containers, everything else a leaf)."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"t": "dict", "k": list(keys),
                "v": [tree_skeleton(tree[k]) for k in keys]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "v": [tree_skeleton(x) for x in tree]}
    return {"t": "leaf"}


def skeleton_fill(skel: dict, fill: Callable[[], Any]):
    """Rebuild a pytree from a skeleton, calling ``fill()`` once per leaf in
    flatten order."""
    t = skel["t"]
    if t == "none":
        return None
    if t == "leaf":
        return fill()
    if t == "dict":
        return {k: skeleton_fill(v, fill) for k, v in zip(skel["k"], skel["v"])}
    if t in ("list", "tuple"):
        seq = [skeleton_fill(v, fill) for v in skel["v"]]
        return seq if t == "list" else tuple(seq)
    raise ValueError(f"unknown skeleton node type {t!r}")


def null_tree(skel: dict):
    """Pytree with the skeleton's structure and ``None`` at every leaf —
    the null-sharding tree the restore plane feeds ``load_arrays``."""
    return skeleton_fill(skel, lambda: None)


def skeleton_leaf_count(skel: dict) -> int:
    t = skel["t"]
    if t == "leaf":
        return 1
    if t == "none":
        return 0
    return sum(skeleton_leaf_count(v) for v in skel["v"])


# ---------------------------------------------------------------------------
# StateLeaf descriptors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StateLeaf:
    """Descriptor of one runtime-state array leaf.

    ``mpi_dtype`` is the *transport* datatype the leaf would travel under on
    the wire; cross-flavor restores re-encode it through the destination's
    aliasing table exactly like predefined-constant envelopes."""
    name: str                      # "<provider>/<leaf index>"
    dtype: str                     # canonical numpy dtype name
    shape: tuple                   # logical shape
    layout: str = "replicated"     # replicated | sharded
    mpi_dtype: str = _BYTE_TRANSPORT

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype,
                "shape": list(self.shape), "layout": self.layout,
                "mpi_dtype": self.mpi_dtype}

    @classmethod
    def from_json(cls, d: dict) -> "StateLeaf":
        return cls(name=d["name"], dtype=d["dtype"],
                   shape=tuple(d["shape"]), layout=d.get("layout", "replicated"),
                   mpi_dtype=d.get("mpi_dtype", _BYTE_TRANSPORT))


def describe_tree(provider: str, tree, *, layout: str = "replicated"):
    """StateLeaf descriptors for every array leaf of ``tree`` in flatten
    order."""
    out = []
    for i, leaf in enumerate(tree_leaves(tree)):
        dt = ckpt_io.dtype_name(host_dtype(leaf))
        out.append(StateLeaf(name=f"{provider}/{i}", dtype=dt,
                             shape=tuple(int(d) for d in np.shape(leaf)),
                             layout=layout, mpi_dtype=transport_dtype(dt)))
    return out


def reencode_leaves(leaves_json: list, plan) -> tuple:
    """Re-encode StateLeaf transport dtypes through a restart
    :class:`~repro_torch.core.restore.PairPlan` — the same canonical-dtype
    discipline the rebind engine applies to datatype envelopes.  Returns
    ``(new_leaves_json, n_reencoded)``."""
    rules = getattr(plan, "runtime", None) or {}
    aliases = rules.get("dtype_aliases") or {}
    if not rules.get("reencode"):
        return list(leaves_json), 0
    out, n = [], 0
    for lj in leaves_json:
        cur = lj.get("mpi_dtype", _BYTE_TRANSPORT)
        canon = aliases.get(cur, cur)
        if canon != cur:
            lj = {**lj, "mpi_dtype": canon}
            n += 1
        out.append(lj)
    return out, n


# ---------------------------------------------------------------------------
# providers
# ---------------------------------------------------------------------------

class StateProvider:
    """One named, versioned piece of runtime state.

    ``snapshot()`` returns ``(arrays_subtree_or_None, json_meta)``; the
    subtree (if any) is checkpointed as ordinary array leaves under
    ``arrays["runtime"][name]`` and the meta rides rank state.  ``restore``
    receives the re-loaded subtree (same structure) and the meta."""
    name: str = "state"
    version: int = 1

    def snapshot(self):  # -> (subtree | None, dict)
        raise NotImplementedError

    def restore(self, arrays, meta: dict) -> None:
        raise NotImplementedError


class PyTreeProvider(StateProvider):
    """Generic provider over a pytree of arrays behind get/set closures
    (KV caches, SSM ``{"state","conv"}`` / xLSTM ``{"C","n","m","conv"}``
    recurrent dicts).  The snapshot persists the tree *skeleton*, so a
    restore on a fresh process rebuilds the exact treedef without running a
    prefill first."""

    def __init__(self, name: str, get: Callable[[], Any],
                 set: Callable[[Any], None], *, version: int = 1,
                 layout: str = "sharded"):
        self.name, self.version = name, version
        self._get, self._set, self._layout = get, set, layout

    def snapshot(self):
        tree = self._get()
        if tree is None:
            return None, {"empty": True}
        return tree, {"skeleton": tree_skeleton(tree), "layout": self._layout}

    def restore(self, arrays, meta: dict) -> None:
        if meta.get("empty"):
            self._set(None)
            return
        if arrays is None:
            raise ValueError(f"runtime provider {self.name!r}: snapshot has "
                             "leaves but restore received none")
        self._set(arrays)


THREEFRY = "threefry2x32"
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry_key(seed: int) -> np.ndarray:
    """The raw data of ``jax.random.key(seed)`` under threefry2x32 with JAX's
    default 32-bit integers: the seed's low 32-bit word after a zero word."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """The Threefry-2x32 block cipher (20 rounds) of Salmon et al., SC'11, as
    the JAX package's PRNG computes it: ``key`` uint32[2], counters x0/x1."""
    def rotl(v, d):
        return (v << np.uint32(d)) | (v >> np.uint32(32 - d))
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def threefry_split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` on raw key data, with
    ``jax_threefry_partitionable`` on (JAX's default): key ``i`` is the
    cipher of counter (0, i).  Returns uint32[num, 2]."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(np.asarray(key, np.uint32),
                              np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def threefry_fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` on raw threefry2x32 key data: the
    cipher of counter (0, data), ``data`` taken as uint32 (JAX seeds the
    counter pair from it as (high word, low word) of a 32-bit value).
    Returns uint32[2]."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(np.asarray(key, np.uint32), np.zeros(1, np.uint32),
                              np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


class RngStateProvider(StateProvider):
    """A threefry2x32 key stream (the JAX package's typed ``jax.random`` key),
    held as its raw key data: uint32[2] persisted as one leaf plus the impl
    name, so the JAX package restores it with ``jax.random.wrap_key_data``
    and the port advances it with :func:`threefry_split`."""

    def __init__(self, name: str, get: Callable[[], Any],
                 set: Callable[[Any], None], *, version: int = 1):
        self.name, self.version = name, version
        self._get, self._set = get, set

    def snapshot(self):
        key = self._get()
        if key is None:
            return None, {"empty": True}
        data = np.array(key, dtype=np.uint32)
        return data, {"skeleton": {"t": "leaf"}, "layout": "replicated",
                      "impl": THREEFRY}

    def restore(self, arrays, meta: dict) -> None:
        if meta.get("empty"):
            self._set(None)
            return
        impl = meta.get("impl", THREEFRY)
        if impl != THREEFRY:
            raise ValueError(f"runtime provider {self.name!r}: key impl "
                             f"{impl!r} is not {THREEFRY}")
        self._set(np.array(arrays, dtype=np.uint32))


class PagedCacheProvider(StateProvider):
    """Paged KV/recurrent-cache state behind a :class:`~repro_torch.serving.kv_pool.
    PagePool`-shaped object (anything with ``export_state()`` /
    ``import_state(arrays, table)``).

    The snapshot serializes the *page table* (session -> page list, lengths,
    priorities, free map) as JSON meta and the *page contents* — one array
    per (session, cache leaf) plus per-session recurrent blocks — as ordinary
    ``kind="runtime"`` leaves, so a serving fleet's in-flight sessions ride
    the same container path (delta digests, codecs, tier replication, the
    cross-flavor transport-dtype re-encode) as params.  This is what the
    live-migration plane snapshots through."""

    def __init__(self, name: str, get: Callable[[], Any], *,
                 version: int = 1, layout: str = "replicated"):
        self.name, self.version = name, version
        self._get, self._layout = get, layout

    def snapshot(self):
        pool = self._get()
        if pool is None:
            return None, {"empty": True}
        arrays, table = pool.export_state()
        if not arrays:
            return None, {"empty": True, "table": table}
        return arrays, {"skeleton": tree_skeleton(arrays),
                        "layout": self._layout, "table": table}

    def restore(self, arrays, meta: dict) -> None:
        pool = self._get()
        if pool is None:
            raise ValueError(f"runtime provider {self.name!r}: no live pool "
                             "to restore into")
        if meta.get("empty"):
            pool.import_state({}, meta.get("table"))
            return
        if arrays is None:
            raise ValueError(f"runtime provider {self.name!r}: snapshot has "
                             "pages but restore received none")
        pool.import_state(arrays, meta.get("table"))


class JsonStateProvider(StateProvider):
    """Pure-JSON state with no array leaves (data-pipeline cursors, decode
    positions).  Rides rank state only."""

    def __init__(self, name: str, get: Callable[[], dict],
                 set: Callable[[dict], None], *, version: int = 1):
        self.name, self.version = name, version
        self._get, self._set = get, set

    def snapshot(self):
        return None, {"state": self._get()}

    def restore(self, arrays, meta: dict) -> None:
        self._set(meta.get("state"))


def warn_skipped(stats: Optional[dict], where: str) -> Optional[str]:
    """One-line diagnostic when a restore skipped providers the live registry
    doesn't know — a legacy image restored by newer code, or a renamed
    provider.  Silently dropping the report makes those resumes undebuggable;
    callers (both CLIs) print the returned line.  Returns ``None`` when
    nothing was skipped."""
    skipped = (stats or {}).get("skipped") or []
    if not skipped:
        return None
    line = (f"WARNING: {where}: runtime-state restore skipped unknown "
            f"provider(s) {', '.join(sorted(skipped))} — their snapshot "
            f"state was NOT applied")
    print(line, flush=True)
    return line


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class RuntimeStateRegistry:
    """Named, versioned runtime-state providers that the checkpoint plane
    snapshots and restores alongside params."""

    def __init__(self):
        self._providers: dict[str, StateProvider] = {}

    # -- registration -------------------------------------------------------
    def register(self, provider: StateProvider) -> StateProvider:
        if provider.name in self._providers:
            raise ValueError(f"runtime provider {provider.name!r} already "
                             "registered")
        self._providers[provider.name] = provider
        return provider

    def unregister(self, name: str) -> None:
        self._providers.pop(name, None)

    def names(self) -> list:
        return sorted(self._providers)

    def __contains__(self, name: str) -> bool:
        return name in self._providers

    # -- snapshot -----------------------------------------------------------
    def snapshot(self) -> tuple:
        """``(arrays, meta)``: ``arrays`` is a dict of provider-name ->
        array subtree (providers with no leaves are omitted); ``meta`` is
        JSON-able and self-sufficient for a structure-only restore."""
        arrays: dict = {}
        meta: dict = {"format": FORMAT, "providers": {}}
        for name in sorted(self._providers):
            p = self._providers[name]
            sub, pmeta = p.snapshot()
            ent = {"version": p.version, "provider": type(p).__name__,
                   "meta": pmeta}
            if sub is not None:
                arrays[name] = sub
                ent["leaves"] = [l.to_json() for l in describe_tree(
                    name, sub, layout=pmeta.get("layout", "replicated"))]
            meta["providers"][name] = ent
        return arrays, meta

    # -- structure-only restore planning ------------------------------------
    def shardings(self, meta: dict) -> dict:
        """Null-sharding tree matching the ``arrays`` dict a
        :meth:`snapshot` under this ``meta`` produced — built from metadata
        alone, so restore needs no live state (this is what closes the
        serve-side prefill-before-resume treedef gap)."""
        out: dict = {}
        for name, ent in (meta or {}).get("providers", {}).items():
            if "leaves" not in ent:
                continue
            skel = ent.get("meta", {}).get("skeleton")
            if skel is None:
                out[name] = [None] * len(ent["leaves"])
            else:
                if skeleton_leaf_count(skel) != len(ent["leaves"]):
                    raise ValueError(
                        f"runtime provider {name!r}: skeleton has "
                        f"{skeleton_leaf_count(skel)} leaves, descriptor "
                        f"list has {len(ent['leaves'])}")
                out[name] = null_tree(skel)
        return out

    def leaves(self, meta: dict) -> list:
        """All StateLeaf descriptors recorded in ``meta``."""
        out = []
        for ent in (meta or {}).get("providers", {}).values():
            out.extend(StateLeaf.from_json(d) for d in ent.get("leaves", []))
        return out

    # -- restore ------------------------------------------------------------
    def restore(self, arrays: Optional[dict], meta: dict, *,
                plan=None) -> dict:
        """Dispatch restored subtrees + meta back into the providers.

        ``plan`` (a :class:`~repro_torch.core.restore.PairPlan`) applies the
        cross-flavor transport-dtype re-encode before providers see their
        descriptors.  Unknown provider names in ``meta`` are skipped (and
        reported); a meta entry newer than the registered provider raises.
        Returns restore stats."""
        stats = {"providers": 0, "skipped": [], "reencoded_leaves": 0}
        arrays = arrays or {}
        for name, ent in (meta or {}).get("providers", {}).items():
            p = self._providers.get(name)
            if p is None:
                stats["skipped"].append(name)
                continue
            if int(ent.get("version", 1)) > p.version:
                raise ValueError(
                    f"runtime provider {name!r}: snapshot version "
                    f"{ent.get('version')} is newer than registered "
                    f"version {p.version}")
            if plan is not None and ent.get("leaves"):
                ent = dict(ent)
                ent["leaves"], n = reencode_leaves(ent["leaves"], plan)
                stats["reencoded_leaves"] += n
            p.restore(arrays.get(name), ent.get("meta", {}))
            stats["providers"] += 1
        return stats
