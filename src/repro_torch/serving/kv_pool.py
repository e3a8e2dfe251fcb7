"""Paged KV-cache pool on the device: the serving fleet's cache memory.

A copy of the JAX package's ``serving/kv_pool.py`` allocator: one fixed
pool of ``n_pages`` pages of ``page_size`` token positions for every
*pageable* cache leaf, per-session *block* state for leaves without a
sequence axis, ordered page lists per session, ``admit`` /
``ensure_capacity`` / ``release``, the OOM policy ``preempt_victim``
(lowest priority, newest arrival among ties), ``truncate``, ``defrag`` and
OOM-safe parking. Every decision is the reference's, so the same calls
give the same page tables.

What differs is where the bytes live. Each leaf's store is a tensor on the
pool's device, ``[n_pages, page_size, numel]``, and it IS the cache: the
engine's decode writes each new K/V row straight into its page and the
paged decode kernel reads the pages through the page table, with no dense
working copy (``kernel_view`` gives the kernel's ``[P, page, K, D]`` view
of a one-layer store, ``layer_view`` the per-layer strided view of a
stacked one). ``write_tokens`` / ``read_tokens`` are one batched device
index op per leaf.

A session's *blocks* (the leaves with no sequence axis: xLSTM's
recurrent states and conv rows) are tensors on the pool's device too, one
per leaf, and the fleet's decode updates them in place: they stay on the
card while the session runs, and go to the host only when it is parked,
exported or snapshotted, where their bytes are the reference's.

Host payloads are in the reference's format, ``{"table": {length,
priority, seq}, "tokens": {key: [L, numel]}, "blocks": {...}}`` with numpy
arrays. numpy has no bfloat16 without ``ml_dtypes``, so the pool holds a
bfloat16 leaf on the host (a parked session) as its ``uint16`` bits under
``ckpt_io.BFLOAT16``, as the checkpoint container does. Only the migration
boundary speaks another form: ``export_session`` gives plain ``uint16``
bits and records ``"dtypes": {key: "bfloat16"}`` in the table, for token
rows and blocks alike (float32 payloads carry no such entry), and ``import_session`` / ``park_payload``
read it, so a session moves between the two packages.

The whole-pool snapshot (``export_state``, which a fleet checkpoint takes)
is the reference's tree with the rows left on the device: each session's
rows are gathered on the card, and the checkpoint's side stream copies
them into its pinned arena. Parked sessions pass through as they are held,
so the JSON page table equals the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import ckpt_io
from repro_torch.device import resolve_device

#: torch dtypes numpy cannot hold: held as their bits under a tagged dtype
_BITS_DTYPES = {"bfloat16": torch.bfloat16}


def to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy; a bfloat16 tensor comes back as its bits under
    ``ckpt_io.BFLOAT16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ckpt_io.BFLOAT16)
    return t.numpy()


def host_bits(arr, dtype_name=None) -> np.ndarray:
    """A host payload array in the pool's own form. bfloat16 in any of the
    forms it arrives in (plain bits that ``dtype_name`` names, an
    ``ml_dtypes`` array as the JAX package exports, or bits already under
    ``ckpt_io.BFLOAT16``) becomes bits under ``ckpt_io.BFLOAT16``."""
    a = np.asarray(arr)
    if ckpt_io.dtype_name(a.dtype) == "bfloat16":
        dtype_name = "bfloat16"
    if dtype_name is None:
        return a
    if dtype_name not in _BITS_DTYPES or a.dtype.itemsize != 2:
        raise ValueError(f"cannot read {a.dtype} bits as {dtype_name!r}")
    return a.view(np.uint16).view(ckpt_io.resolve_dtype(dtype_name))


def to_device(arr, device, dtype_name=None) -> torch.Tensor:
    """A payload array (numpy, or a tensor) as a tensor on ``device``;
    bfloat16 host arrays are read as :func:`host_bits` reads them."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    a = host_bits(arr, dtype_name)
    name = ckpt_io.dtype_name(a.dtype)
    if name in _BITS_DTYPES:
        t = torch.from_numpy(np.array(a.view(np.int16)))
        return t.view(_BITS_DTYPES[name]).to(device)
    return torch.from_numpy(np.array(a)).to(device)


class PoolOOMError(RuntimeError):
    """Not enough free pages; caller preempts (or queues) and retries."""

    def __init__(self, needed: int, free: int):
        self.needed, self.free = needed, free
        super().__init__(f"page pool exhausted: need {needed} page(s), "
                         f"{free} free")


@dataclass
class SessionAlloc:
    """Per-session pool bookkeeping: the block list plus recurrent blocks."""
    sid: str
    pages: list = field(default_factory=list)   # ordered pool page indices
    length: int = 0                             # tokens written
    priority: int = 0
    seq: int = 0                                # admission order (fairness)
    blocks: dict = field(default_factory=dict)  # key -> tensor on the pool's device


class PagePool:
    """Fixed-size paged allocator whose stores live on ``device`` (the card
    unless the caller names another)."""

    def __init__(self, n_pages: int, page_size: int, *, device=None):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.device = resolve_device(device)
        self.stores: dict[str, torch.Tensor] = {}  # key -> [P, page, numel]
        self.sessions: dict[str, SessionAlloc] = {}
        self.parked: dict[str, dict] = {}          # swapped-out payloads (host)
        self._free: list[int] = list(range(self.n_pages))
        self._seq = 0

    # -- capacity -----------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size) if n_tokens > 0 else 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    # -- allocation ---------------------------------------------------------
    def _take(self, n: int) -> list:
        if n > len(self._free):
            raise PoolOOMError(n, len(self._free))
        taken, self._free = self._free[:n], self._free[n:]
        return taken

    def admit(self, sid: str, n_tokens: int, *, priority: int = 0,
              pages: list | None = None) -> SessionAlloc:
        """Reserve capacity for ``n_tokens`` (0 is legal: a zero-length
        prompt owns no pages until its first decode). ``pages`` pins the
        exact page ids (the restore path). Raises :class:`PoolOOMError`
        untouched: the preempt policy runs above this layer."""
        if sid in self.sessions:
            raise ValueError(f"session {sid!r} already admitted")
        if pages is not None:
            missing = [p for p in pages if p not in self._free]
            if missing:
                raise PoolOOMError(len(pages), len(self._free))
            self._free = [p for p in self._free if p not in set(pages)]
            got = list(pages)
        else:
            got = self._take(self.pages_for(n_tokens))
        self._seq += 1
        alloc = SessionAlloc(sid=sid, pages=got, priority=int(priority),
                             seq=self._seq)
        self.sessions[sid] = alloc
        return alloc

    def ensure_capacity(self, sid: str, n_tokens: int) -> None:
        """Grow ``sid``'s page list so ``n_tokens`` positions fit."""
        alloc = self.sessions[sid]
        need = self.pages_for(n_tokens) - len(alloc.pages)
        if need > 0:
            alloc.pages.extend(self._take(need))

    def release(self, sid: str) -> int:
        """Free every page the session owns; returns the count."""
        alloc = self.sessions.pop(sid, None)
        if alloc is None:
            return 0
        self._free.extend(alloc.pages)
        self._free.sort()
        return len(alloc.pages)

    def preempt_victim(self, below_priority: int | None = None,
                       exclude: set | None = None) -> str | None:
        """The OOM policy: the lowest-priority admitted session (newest
        arrival among ties). ``below_priority`` restricts to strictly
        lower-priority victims, so an admission never evicts an equal- or
        higher-priority session."""
        exclude = exclude or set()
        cands = [a for a in self.sessions.values() if a.sid not in exclude]
        if below_priority is not None:
            cands = [a for a in cands if a.priority < below_priority]
        if not cands:
            return None
        return min(cands, key=lambda a: (a.priority, -a.seq)).sid

    # -- page I/O -----------------------------------------------------------
    def store(self, key: str, numel: int, dtype: torch.dtype) -> torch.Tensor:
        """Leaf ``key``'s ``[n_pages, page_size, numel]`` store, zero-filled
        on the pool's device at first use."""
        st = self.stores.get(key)
        if st is None:
            st = torch.zeros((self.n_pages, self.page_size, numel), dtype=dtype,
                             device=self.device)
            self.stores[key] = st
        elif st.shape[2] != numel:
            raise ValueError(f"leaf {key!r}: numel {numel} != pool store "
                             f"{st.shape[2]}")
        return st

    def _slots(self, alloc: SessionAlloc, start: int, n: int) -> tuple:
        """(page, offset) index tensors of positions ``start..start+n-1``."""
        t = torch.arange(start, start + n)
        pages = torch.tensor(alloc.pages, dtype=torch.long)[t // self.page_size]
        return pages.to(self.device), (t % self.page_size).to(self.device)

    def write_tokens(self, sid: str, start: int, slices: dict) -> None:
        """Scatter per-token rows into the session's pages. ``slices`` maps
        leaf key -> ``[L, ...]`` (tensor or numpy; trailing dims flattened);
        rows land at absolute positions ``start..start+L-1`` in one index op
        per leaf. Extends the recorded length."""
        alloc = self.sessions[sid]
        lens = {arr.shape[0] for arr in slices.values()}
        if len(lens) > 1:
            raise ValueError(f"inconsistent slice lengths {sorted(lens)}")
        L = lens.pop() if lens else 0
        if L == 0:
            return
        self.ensure_capacity(sid, start + L)
        pages, offs = self._slots(alloc, start, L)
        for key, arr in slices.items():
            rows = to_device(arr, self.device).reshape(L, -1)
            st = self.store(key, rows.shape[1], rows.dtype)
            st[pages, offs] = rows.to(st.dtype)
        alloc.length = max(alloc.length, start + L)

    def write_blocks(self, sid: str, blocks: dict, dtypes: dict | None = None) -> None:
        """Store the session's non-paged (recurrent) state blocks as tensors
        on the pool's device: a tensor there is held as it is (the prefill's
        caches, which nothing else keeps), anything else is copied there
        (host arrays read as :func:`to_device` reads them, ``dtypes`` naming
        plain ``uint16`` bits)."""
        alloc = self.sessions[sid]
        dtypes = dtypes or {}
        for key, arr in blocks.items():
            alloc.blocks[key] = to_device(arr, self.device, dtypes.get(key))

    def read_tokens(self, sid: str) -> dict:
        """Gather every leaf back to dense ``[length, numel]`` tensors on the
        pool's device (one index op per leaf)."""
        alloc = self.sessions[sid]
        pages, offs = self._slots(alloc, 0, alloc.length)
        return {key: st[pages, offs] for key, st in self.stores.items()}

    def read_blocks(self, sid: str) -> dict:
        """The session's blocks: the live tensors on the pool's device,
        which the fleet's decode updates in place (copy them to keep them)."""
        return dict(self.sessions[sid].blocks)

    def truncate(self, sid: str, n_tokens: int) -> None:
        """Rewind a session: drop positions past ``n_tokens`` and free the
        now-unused tail pages."""
        alloc = self.sessions[sid]
        if n_tokens >= alloc.length:
            return
        alloc.length = int(n_tokens)
        keep = self.pages_for(alloc.length)
        tail, alloc.pages = alloc.pages[keep:], alloc.pages[:keep]
        self._free.extend(tail)
        self._free.sort()

    # -- swap / migration payloads ------------------------------------------
    def _gather(self, sid: str) -> dict:
        """A resident session's host payload in the pool's own form."""
        alloc = self.sessions[sid]
        return {"table": {"length": alloc.length, "priority": alloc.priority,
                          "seq": alloc.seq},
                "tokens": {k: to_host(t) for k, t in self.read_tokens(sid).items()},
                "blocks": {k: to_host(t) for k, t in self.read_blocks(sid).items()}}

    def export_session(self, sid: str) -> dict:
        """Self-contained byte-exact host payload of a resident or parked
        session: page-table row + gathered token rows (numpy) + recurrent
        blocks, the unit of migration, in the JAX package's form (bfloat16
        rows as plain ``uint16`` bits, named in the table's ``"dtypes"``)."""
        payload = self.parked[sid] if sid in self.parked else self._gather(sid)
        dtypes = {}

        def plain(section):
            out = {}
            for key, a in payload[section].items():
                if ckpt_io.dtype_name(a.dtype) in _BITS_DTYPES:
                    dtypes[key] = ckpt_io.dtype_name(a.dtype)
                    a = a.view(np.uint16)
                out[key] = a
            return out
        tokens, blocks = plain("tokens"), plain("blocks")
        table = dict(payload["table"])
        if dtypes:
            table["dtypes"] = dtypes
        return {"table": table, "tokens": tokens, "blocks": blocks}

    def import_session(self, sid: str, payload: dict, *,
                       priority: int | None = None) -> SessionAlloc:
        """Re-admit an exported session (swap-in / migrate-in). Raises
        :class:`PoolOOMError` before touching any state when pages are
        short, so a failed import never half-admits."""
        table = payload["table"]
        length = int(table["length"])
        if self.pages_for(length) > len(self._free):
            raise PoolOOMError(self.pages_for(length), len(self._free))
        alloc = self.admit(sid, length,
                           priority=table["priority"] if priority is None
                           else priority)
        seq = table.get("seq")
        if seq is not None:
            # a swap-in / migrate-in keeps its ORIGINAL arrival position in
            # preempt_victim tie-breaks; _seq stays monotonic past it
            alloc.seq = int(seq)
            self._seq = max(self._seq, alloc.seq)
        dtypes = table.get("dtypes") or {}
        self.write_tokens(sid, 0, {k: to_device(v, self.device, dtypes.get(k))
                                   for k, v in payload["tokens"].items()
                                   if v.shape[0]})
        alloc.length = length
        self.write_blocks(sid, payload["blocks"], dtypes)
        return alloc

    # -- parking (swap-preemption) ------------------------------------------
    # A preempted session's bytes move into the pool's parked store (host
    # side, no pages held): parked state is still pool state, so
    # export_state and migration capture swapped-out sessions as well.

    def park(self, sid: str) -> dict:
        """Swap a session out: gather its bytes to the host, free its pages,
        keep the payload in the parked store. Returns the payload."""
        payload = self._gather(sid)
        self.release(sid)
        self.parked[sid] = payload
        return payload

    def park_payload(self, sid: str, payload: dict) -> None:
        """Park an exported payload (migration-in under OOM), held in the
        pool's own form."""
        if sid in self.sessions:
            raise ValueError(f"session {sid!r} is admitted; park() it")
        table = dict(payload["table"])
        dtypes = table.pop("dtypes", None) or {}
        self.parked[sid] = {
            "table": table,
            "tokens": {k: host_bits(v, dtypes.get(k))
                       for k, v in payload["tokens"].items()},
            "blocks": {k: host_bits(v, dtypes.get(k))
                       for k, v in payload["blocks"].items()}}

    def unpark(self, sid: str) -> SessionAlloc:
        """Swap a parked session back in. Raises :class:`PoolOOMError` with
        the payload left parked, so a failed swap-in loses nothing."""
        payload = self.parked[sid]
        alloc = self.import_session(sid, payload)   # OOM-safe: checks first
        del self.parked[sid]
        return alloc

    def drop(self, sid: str) -> None:
        """Forget a session entirely (migrated away / client gone)."""
        self.release(sid)
        self.parked.pop(sid, None)

    # -- defrag -------------------------------------------------------------
    def defrag(self) -> dict:
        """Compact live pages down to the low indices, preserving every
        session's gathered contents bit for bit. Returns ``{"moved": n,
        "used": n}``."""
        mapping: dict[int, int] = {}
        next_page = 0
        for sid in sorted(self.sessions):
            for p in self.sessions[sid].pages:
                mapping[p] = next_page
                next_page += 1
        if mapping:
            old = torch.tensor(sorted(mapping), device=self.device)
            new = torch.tensor([mapping[p] for p in sorted(mapping)],
                               device=self.device)
            for st in self.stores.values():
                # the gather copies first: a destination may be another's source
                st[new] = st[old]
        moved = 0
        for sid in self.sessions:
            alloc = self.sessions[sid]
            new_pages = [mapping[p] for p in alloc.pages]
            moved += sum(1 for a, b in zip(alloc.pages, new_pages) if a != b)
            alloc.pages = new_pages
        self._free = [p for p in range(self.n_pages) if p >= next_page]
        return {"moved": moved, "used": next_page}

    # -- kernel views -------------------------------------------------------
    def kernel_view(self, sids: list, k_key: str, v_key: str,
                    n_kv_heads: int, head_dim: int) -> tuple:
        """The operand set ``paged_decode_attention`` takes: ``(k_pages [P,
        page, K, D], v_pages, page_table [B, n] int32, lengths [B] int32)``,
        the pages as views of the stores (no copy), the table and lengths on
        the pool's device. Table rows are padded with page 0 (entries past a
        length must be valid pool indices; the kernel reads none of them)."""
        k_st, v_st = self.stores[k_key], self.stores[v_key]
        K, D = int(n_kv_heads), int(head_dim)
        if k_st.shape[2] != K * D:
            raise ValueError(f"k leaf numel {k_st.shape[2]} != K*D {K * D}")
        n_max = max([len(self.sessions[s].pages) for s in sids] + [1])
        table = np.zeros((len(sids), n_max), dtype=np.int32)
        lengths = np.zeros((len(sids),), dtype=np.int32)
        for b, sid in enumerate(sids):
            alloc = self.sessions[sid]
            table[b, : len(alloc.pages)] = alloc.pages
            lengths[b] = alloc.length
        shape = (self.n_pages, self.page_size, K, D)
        return (k_st.view(shape), v_st.view(shape),
                torch.from_numpy(table).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def layer_view(self, key: str, n_layers: int, n_kv_heads: int,
                   head_dim: int) -> torch.Tensor:
        """A stacked leaf's store as ``[P, page, n_layers, K, D]`` (a view):
        its rows are layer-major ``[n_layers, K*D]``, so layer ``i``'s pages
        are the strided view ``[:, :, i]``, row stride ``n_layers*K*D``."""
        st = self.stores[key]
        if st.shape[2] != n_layers * n_kv_heads * head_dim:
            raise ValueError(f"leaf {key!r}: numel {st.shape[2]} != "
                             f"{n_layers}*{n_kv_heads}*{head_dim}")
        return st.view(self.n_pages, self.page_size, n_layers, n_kv_heads, head_dim)

    # -- whole-pool snapshot ------------------------------------------------
    def export_state(self) -> tuple:
        """Whole-pool snapshot ``(arrays, table)`` in the JAX package's form:
        ``arrays`` holds one subtree per session (free pages are not
        serialized) and ``table`` is the JSON page table. A resident
        session's token rows are gathered into fresh tensors on the pool's
        device (one index op per leaf, no copy to the host: the checkpoint
        copies them off the card), its blocks the live tensors (the
        checkpoint copies them off inside its blocking window, before the
        next decode); parked sessions are host arrays, as the pool holds
        them."""
        arrays: dict = {}
        table = {"n_pages": self.n_pages, "page_size": self.page_size,
                 "seq": self._seq, "sessions": {}, "parked": {}}
        for sid in sorted(self.sessions):
            alloc = self.sessions[sid]
            table["sessions"][sid] = {
                "pages": list(alloc.pages), "length": alloc.length,
                "priority": alloc.priority, "seq": alloc.seq}
            ent = {}
            toks = {k: v for k, v in self.read_tokens(sid).items() if v.shape[0]}
            if toks:
                ent["tokens"] = toks
            blocks = self.read_blocks(sid)
            if blocks:
                ent["blocks"] = blocks
            if ent:
                arrays[sid] = ent
        for sid in sorted(self.parked):
            payload = self.parked[sid]
            table["parked"][sid] = dict(payload["table"])
            ent = {}
            toks = {k: v for k, v in payload["tokens"].items() if v.shape[0]}
            if toks:
                ent["tokens"] = toks
            if payload["blocks"]:
                ent["blocks"] = {k: np.asarray(v)
                                 for k, v in payload["blocks"].items()}
            if ent:
                arrays[f"parked:{sid}"] = ent
        return arrays, table

    def import_state(self, arrays: dict, table: dict | None) -> None:
        """Rebuild the pool from a snapshot: sessions land on their exact
        original page ids, the free list is everything else. Rows may be
        tensors (already on the pool's device when the restore placed them
        there) or host arrays; a parked session comes back in the pool's
        own host form."""
        table = table or {}
        self.stores.clear()
        self.sessions.clear()
        self.parked.clear()
        self._free = list(range(self.n_pages))
        self._seq = int(table.get("seq", 0))
        for sid, row in sorted((table.get("sessions") or {}).items()):
            alloc = self.admit(sid, 0, priority=int(row.get("priority", 0)),
                               pages=list(row.get("pages", [])))
            alloc.seq = int(row.get("seq", alloc.seq))
            ent = (arrays or {}).get(sid) or {}
            toks = ent.get("tokens") or {}
            if toks:
                self.write_tokens(sid, 0, {k: to_device(v, self.device)
                                           for k, v in toks.items()})
            alloc.length = int(row.get("length", 0))
            blocks = ent.get("blocks") or {}
            if blocks:
                self.write_blocks(sid, blocks)
        for sid, row in sorted((table.get("parked") or {}).items()):
            ent = (arrays or {}).get(f"parked:{sid}") or {}
            self.parked[sid] = {
                "table": dict(row),
                "tokens": {k: host_bits(v)
                           for k, v in (ent.get("tokens") or {}).items()},
                "blocks": {k: host_bits(v)
                           for k, v in (ent.get("blocks") or {}).items()}}
        self._seq = max([self._seq] + [a.seq
                                       for a in self.sessions.values()])

