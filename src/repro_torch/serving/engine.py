"""Serving engines: the single-stream ``Server`` and the continuous-batching
``ServeEngine`` fleet.

The counterparts of the JAX package's ``serving/engine.Server`` and
``ServeEngine``.  The ``Server`` carries the whole checkpoint/restart plane:
a ``Cluster`` of logical ranks (each an interposed lower half of one MPI
flavor), a runtime-state registry (caches, RNG key stream, decode cursor),
transparent snapshots mid-decode, and restores under another flavor or
world size, into a fresh ``Server`` with no prefill.  Its snapshots are the
JAX package's container byte for byte, so a sequence moves mid-decode
between the two packages either way.  The ``ServeEngine`` fleet carries the
same plane over its page pool (``kind="runtime"`` leaves through
``runtime_state.PagedCacheProvider``, copied off the card on the
checkpoint's side stream), so its in-flight sessions survive a rank death
(the supervisor re-homes them onto the surviving world) and live-migrate
across MPI flavors (``serving/migrate.py``).  Both classes speak the
supervisor's workload protocol (``step`` / ``step_once`` / ``checkpoint`` /
``recover`` and the rescale hooks), so one
:class:`~repro_torch.core.supervisor.Supervisor` drives either.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import steps as ST
from repro_torch.core import Cluster
from repro_torch.core import runtime_state as RS
from repro_torch.core.restore import as_source, load_arrays, translation_plan
from repro_torch.device import resolve_device, sync
from repro_torch.models import Model
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.serving import scheduler as SCHED
from repro_torch.serving.kv_pool import PagePool, PoolOOMError
from repro_torch.serving.scheduler import ContinuousBatchScheduler

__all__ = ["FleetSession", "ServeEngine", "Server", "resolve_device"]


class Server:
    """Single-stream preemptible serving (one batched sequence),
    checkpointable between decode steps and resumable mid-sequence under
    another backend flavor or world size.

    ``params`` defaults to the seeded init on ``device``; tests hand in the
    JAX package's params through ``models.params.from_jax_params``.
    ``gla_schedule`` picks hymba's prefill GLA kernel ('chunk' or
    'parallel', ``kernels/ops.py``).  ``world_size`` / ``backend`` /
    ``ckpt_dir`` configure the ``Cluster`` that takes the snapshots.
    """

    def __init__(self, cfg, *, world_size=2, backend="mpich", ckpt_dir=None,
                 seed=0, params=None, device=None, gla_schedule="chunk"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg, gla_schedule=gla_schedule)
        self.cluster = Cluster(world_size, backend, ckpt_dir=ckpt_dir)
        self.params = params if params is not None \
            else self.model.init(seed, self.device)
        self.prefill_fn = ST.make_prefill_step(self.model)
        self.decode_fn = ST.make_decode_step(self.model)
        self.caches = None
        self.max_len = 0
        self.pos = 0
        self.generated = []
        # the next decode seed token, owned by the decode_cursor provider
        self._tok = None
        # sampling key stream (raw threefry2x32 data, as the JAX package's
        # ``jax.random.key(seed + 1)``): advanced once per decode step.
        # Greedy decode never consumes it, but a restored server must hold
        # the SAME key a sampling decode would
        self.rng_key = RS.threefry_key(seed + 1)
        self.last_runtime_restore = None
        # runtime-state providers: the cache tree (with its skeleton), the
        # key stream and the decode cursor — the upper-half serving state
        self.runtime = RS.RuntimeStateRegistry()
        self.runtime.register(RS.PyTreeProvider(
            "kv_caches", lambda: self.caches, self._set_caches))
        self.runtime.register(RS.RngStateProvider(
            "rng", lambda: self.rng_key, self._set_rng))
        self.runtime.register(RS.JsonStateProvider(
            "decode_cursor", self._cursor_state, self._apply_cursor))

    # -- runtime provider hooks ---------------------------------------------
    def _set_caches(self, tree):
        """Install a cache tree, so a restored server needs no prefill. Its
        capacity (``max_len``) is the rows of its full-attention leaves;
        None for a tree with no leaf that grows with the sequence (xLSTM's
        recurrent states), which decodes without a limit, as the
        reference's does."""
        self.caches = tree
        if tree is not None:
            self.max_len = T.cache_capacity(tree)

    def _set_rng(self, key):
        self.rng_key = key

    @property
    def resume_tok(self):
        """The next decode seed as numpy int32 [B] (None before decode)."""
        return None if self._tok is None \
            else self._tok.to(torch.int32).cpu().numpy()

    def _cursor_state(self) -> dict:
        st = {"pos": int(self.pos),
              "prefill_pos": int(self.pos - len(self.generated))}
        if self.generated:
            # the token that seeds the next decode step after a resume
            st["last_tok"] = np.asarray(self.generated[-1]).tolist()
        return st

    def _apply_cursor(self, st: dict) -> None:
        # rewinding pos must also rewind the generated stream, or the
        # tokens decoded between snapshot and failure appear TWICE
        prefill_pos = self.pos - len(self.generated)
        self.pos = int(st["pos"])
        keep = max(0, self.pos - prefill_pos)
        if len(self.generated) > keep:
            del self.generated[keep:]
        tok = st.get("last_tok")
        self._tok = None if tok is None else self._tokens(np.asarray(tok, np.int64))

    def _tokens(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        if t.numel() and (int(t.min()) < 0 or int(t.max()) >= self.cfg.padded_vocab):
            raise ValueError(f"token ids must lie in [0, {self.cfg.padded_vocab})")
        return t.to(self.device)

    def prefill(self, tokens, patch_embeds=None, pad_to=None):
        """tokens: [B,S]; ``patch_embeds`` [B, img_tokens, 1024] (llava's
        image, any float type). Caches are allocated at ``max(pad_to, S)``
        and hold the prompt's rows, each leaf by its kind (a window layer's
        ring is ``T.ring_width`` rows, as the JAX ``Server`` leaves it;
        xLSTM's recurrent states do not depend on it).
        Returns the last position's logits [B, Vp]."""
        t = self._tokens(tokens)
        S = t.shape[-1]
        pe = patch_embeds
        if pe is not None and not isinstance(pe, torch.Tensor):
            pe = torch.from_numpy(np.asarray(pe, np.float32))
        pe = None if pe is None else pe.to(self.device)
        logits, caches = self.prefill_fn(self.params, t, max_len=max(pad_to or S, S),
                                         patch_embeds=pe)
        self._set_caches(caches)
        self.pos = S
        return logits

    # -- supervisor workload protocol ---------------------------------------
    @property
    def step(self) -> int:
        return self.pos

    def start_decode(self, first_token):
        """Seed the decode loop (``step_once`` consumes it)."""
        self._tok = self._tokens(first_token)

    def step_once(self):
        """Decode ONE token from the internal seed; returns it as numpy [B]."""
        if self.max_len is not None and self.pos >= self.max_len:
            raise RuntimeError(f"cache full at {self.pos} positions")
        logits, self.caches = self.decode_fn(self.params, self._tok, self.pos,
                                             self.caches)
        self._tok = torch.argmax(logits[..., : self.cfg.vocab_size], dim=-1)
        self.rng_key = RS.threefry_split(self.rng_key)[0]
        out = self._tok.to(torch.int32).cpu().numpy()
        self.generated.append(out)
        self.pos += 1
        for r in range(len(self.cluster.ranks)):
            self.cluster.heartbeat(r)
        return out

    def decode(self, n_tokens, first_token):
        """Greedy decode of ``n_tokens``; returns (tokens, seconds)."""
        self.start_decode(first_token)
        sync(self.device)
        t0 = time.perf_counter()
        out = [self.step_once() for _ in range(n_tokens)]
        sync(self.device)
        return out, time.perf_counter() - t0

    # -- transparent serving snapshot ---------------------------------------
    def checkpoint(self, tag=None):
        """Drain every rank, snapshot the runtime state (caches copied off
        the device inside the blocking window) and write it in the
        background.  Returns the request; ``req.timings`` holds the
        blocking window's breakdown, ``persist_ms`` once it commits."""
        if tag is None:
            tag = self.pos
        rt_arrays, rt_meta = self.runtime.snapshot()
        arrays = {"runtime": rt_arrays}
        # pos/last_tok ride alongside the runtime section, as in the JAX
        # package's rank state
        extra = {"pos": int(self.pos), "runtime": rt_meta}
        if self.generated:
            extra["last_tok"] = np.asarray(self.generated[-1]).tolist()
        return self.cluster.checkpoint(tag, arrays, None,
                                       extra_rank_state=lambda r: dict(extra))

    def _on_device(self, tree):
        return tree_map(lambda _: self.device, tree)

    def restore(self, ckpt, *, new_backend=None, new_world_size=None,
                rebuild=False):
        """Resume mid-sequence from a serving snapshot (a committed step dir
        or any checkpoint source). ``new_backend`` / ``new_world_size`` /
        ``rebuild`` go through ``Cluster.restart``: fresh lower halves
        (possibly another flavor or world size) with the cache reads
        overlapping the descriptor re-bind; the restart's phase timings land
        in ``self.cluster.restart_timings``.

        Snapshots carry a runtime-state section (tree skeletons + StateLeaf
        descriptors), so a FRESH server restores the whole decode state —
        the caches land on its device — without running a prefill.  Both
        packages' ``checkpoint`` write that section; a snapshot without one
        is refused."""
        src = as_source(ckpt)
        manifest = src.manifest()
        rt_meta = src.rank_state(0).get("runtime")
        if rt_meta is None:
            raise ValueError(f"{ckpt}: not a serving snapshot (no runtime "
                             "section)")
        # placements rebuilt from snapshot metadata alone: the caches go to
        # the device, the key stays a host array
        sh = {"runtime": self.runtime.shardings(rt_meta)}
        if "kv_caches" in sh["runtime"]:
            sh["runtime"]["kv_caches"] = self._on_device(sh["runtime"]["kv_caches"])
        if new_backend is not None or new_world_size is not None or rebuild:
            self.cluster = self.cluster.restart(src,
                                                new_backend=new_backend,
                                                new_world_size=new_world_size,
                                                shardings=sh)
            arrays = self.cluster.restored_arrays
        else:
            writer = self.cluster.writer
            arrays = load_arrays(src, sh,
                                 arenas=writer.arenas if writer else ())
        plan = translation_plan(
            manifest.get("backend", self.cluster.backend_name),
            self.cluster.backend_name, self.cluster.mana(0).backend)
        self.last_runtime_restore = self.runtime.restore(
            arrays.get("runtime", {}), rt_meta, plan=plan)
        RS.warn_skipped(self.last_runtime_restore, "serve")

    def recover(self, ckpt_dir, *, new_world_size=None):
        """Supervisor entry point: rebuild the lower halves on the surviving
        world and rewind decode to the snapshot position."""
        self.restore(ckpt_dir, new_world_size=new_world_size, rebuild=True)

    # -- live rescale (zero-downtime elasticity) -----------------------
    def prepare_leave(self, rank):  # noqa: ARG002 — workload hook shape
        """Supervisor hook before a live shrink: decode state (caches, pos,
        seed token) lives in the upper half and is untouched by it."""
        return None

    def rescale(self, report):  # noqa: ARG002 — workload hook shape
        """Supervisor hook after a live rescale: decode continues at the
        SAME position with the SAME caches."""
        return None

    def resume_latest(self, *, new_backend=None):
        """Resume the newest snapshot whose delta chain resolves; returns the
        checkpoint dir or ``None`` when nothing restorable exists."""
        if self.cluster.writer is None:
            return None
        ck = self.cluster.writer.resumable()
        if ck is None:
            return None
        self.restore(ck, new_backend=new_backend)
        return ck


# ---------------------------------------------------------------------------
# the continuous-batching fleet engine
# ---------------------------------------------------------------------------

class FleetSession:
    """One client sequence: prompt, output stream and decode cursor. Its
    cache lives only in the pool's pages."""

    __slots__ = ("sid", "prompt", "max_new", "priority", "first_token",
                 "generated", "pos", "last_tok")

    def __init__(self, sid, prompt, *, max_new=8, priority=0, first_token=0):
        self.sid = sid
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.priority = int(priority)
        self.first_token = int(first_token)
        self.generated: list[int] = []
        self.pos = 0
        self.last_tok: int | None = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new

    def cursor(self) -> dict:
        return {"prompt": list(self.prompt), "max_new": self.max_new,
                "priority": self.priority, "first_token": self.first_token,
                "generated": list(self.generated), "pos": int(self.pos),
                "last_tok": self.last_tok}

    @classmethod
    def from_cursor(cls, sid: str, st: dict) -> "FleetSession":
        s = cls(sid, st.get("prompt", []), max_new=st.get("max_new", 8),
                priority=st.get("priority", 0),
                first_token=st.get("first_token", 0))
        s.generated = [int(t) for t in st.get("generated", [])]
        s.pos = int(st.get("pos", 0))
        lt = st.get("last_tok")
        s.last_tok = None if lt is None else int(lt)
        return s


class ServeEngine:
    """Continuous-batching multi-session serving over one model instance.

    Sessions decode at independent positions as B=1 lanes in scheduler
    order, join the running set the tick they are admitted and retire the
    tick they finish; admission, preemption and self-parking follow the JAX
    package's engine decision for decision. The page pool lives on the
    device and is the only cache: a prefill scatters the prompt's K/V rows
    into fresh pages, and each decode writes its row into the page slot of
    its position and attends through the page table (the paged decode
    kernel on the card). There is no dense working copy, so nothing is
    regathered after a swap-in or an import.

    A model whose cache leaves have no sequence axis (xLSTM) keeps them as
    the session's blocks, tensors on the pool's device: a lane decodes
    ``Model.decode_step`` at B = 1 over them, in place, and they reach the
    host only when the session is parked, exported or snapshotted. Such a
    session's pages follow the reference's accounting: its admission
    reserves the prompt's pages, its decode grows none (the reference
    writes no token rows), and a swap-in takes none.

    Capacity comes before compute: the page for ``pos`` is reserved (with
    the reference's preempt / self-park policy on OOM) before the forward
    pass writes into it. The reference decides from pool state alone, never
    from the logits, so the decisions, tickets and streams are the same.

    Speaks the supervisor workload protocol: ``step`` is the engine tick,
    ``checkpoint`` snapshots the pool, the cursors and the RNG key through
    the runtime-state registry (the container is the JAX engine's: the same
    entries, digests and JSON page table), and ``recover`` re-homes every
    in-flight session onto the surviving world (count in ``last_rehomed``,
    surfaced on the incident). ``export_session_state`` /
    ``import_session_state`` speak the JAX package's payload format, so a
    session moves between the two engines, and ``serving/migrate.py``
    moves one between two engines of different MPI flavors.
    """

    def __init__(self, cfg, *, world_size=2, backend="mpich", ckpt_dir=None,
                 seed=0, params=None, device=None, max_len=48, page_size=8,
                 n_pages=64, max_running=4):
        if cfg.n_codebooks > 1:
            raise NotImplementedError("ServeEngine supports single-codebook "
                                      "models; use Server for codebook archs")
        if cfg.block == "hymba":
            # its window layers' rings vary with the prompt in a non-sequence
            # way, which the reference's engine refuses too
            raise NotImplementedError(f"ServeEngine cannot page {cfg.name}'s ring caches; "
                                      f"its {cfg.block} blocks need the single-stream Server")
        self.cfg = cfg
        self.max_len = int(max_len)
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.cluster = Cluster(world_size, backend, ckpt_dir=ckpt_dir)
        self.params = params if params is not None \
            else self.model.init(seed, self.device)
        self.prefill_fn = ST.make_prefill_step(self.model)
        self.decode_fn = ST.make_paged_decode_step(self.model)
        self.block_decode_fn = ST.make_decode_step(self.model)
        self.pool = PagePool(n_pages, page_size, device=self.device)
        self.sched = ContinuousBatchScheduler(max_running=max_running)
        self.sessions: dict[str, FleetSession] = {}
        self.tick = 0
        # the JAX engine's ``jax.random.key(seed + 1)``, split once per tick
        self.rng_key = RS.threefry_key(seed + 1)
        self.last_runtime_restore = None
        self.last_rehomed = None
        self._sid_counter = 0
        # cache leaf geometry: shapes at max_len (on the meta device: nothing
        # is allocated), leaf keys in the JAX package's flatten order
        caches = T.alloc_caches(cfg, 1, self.max_len, "meta")
        leaves = tree_leaves(caches)
        self._leaf_specs = [(f"leaf{i:03d}", tuple(l.shape), l.dtype)
                            for i, l in enumerate(leaves)]
        self._keys = tree_unflatten(caches, [k for k, _, _ in self._leaf_specs])
        self._axis_cache: dict[int, list] = {}
        # the pool's stores, allocated once at the pool's full size
        self._pageable = {}
        probe = max(1, min(4, self.max_len - 1))
        for (key, axis), (_, shape, dtype) in zip(self._seq_axes(probe),
                                                  self._leaf_specs):
            if axis is not None:
                self._pageable[key] = (int(np.prod(shape)) // shape[axis], dtype)
                self.pool.store(key, *self._pageable[key])
        # runtime-state providers: page tables + pages, the RNG stream, and
        # the fleet cursor (per-session decode cursors + the scheduler
        # snapshot) — the complete upper-half fleet state
        self.runtime = RS.RuntimeStateRegistry()
        self.runtime.register(RS.PagedCacheProvider(
            "kv_pages", lambda: self.pool))
        self.runtime.register(RS.RngStateProvider(
            "rng", lambda: self.rng_key, self._set_rng))
        self.runtime.register(RS.JsonStateProvider(
            "fleet_cursor", self._fleet_state, self._apply_fleet))

    # -- runtime provider hooks ---------------------------------------------
    def _set_rng(self, key):
        self.rng_key = key

    def _fleet_state(self) -> dict:
        return {"tick": int(self.tick),
                "scheduler": self.sched.snapshot(),
                "sessions": {sid: s.cursor()
                             for sid, s in self.sessions.items()}}

    def _apply_fleet(self, st: dict) -> None:
        st = st or {}
        self.tick = int(st.get("tick", 0))
        self.sched.restore(st.get("scheduler") or {})
        self.sessions = {sid: FleetSession.from_cursor(sid, cur)
                         for sid, cur in (st.get("sessions") or {}).items()}

    # -- cache leaf geometry -------------------------------------------------
    def _seq_axes(self, S: int) -> list:
        """Per-leaf ``(key, seq_axis | None)`` for a prompt of length ``S``:
        the axis where the cache shape at S differs from the max_len shape is
        the sequence axis; leaves with identical shapes are block state."""
        axes = self._axis_cache.get(S)
        if axes is not None:
            return axes
        at_s = [tuple(t.shape) for t in
                tree_leaves(T.alloc_caches(self.cfg, 1, S, "meta"))] \
            if S else [None] * len(self._leaf_specs)
        axes = []
        for (key, shape, _), ls in zip(self._leaf_specs, at_s):
            if ls is None or ls == shape:
                axes.append((key, None))
                continue
            diff = [a for a, (x, y) in enumerate(zip(ls, shape)) if x != y]
            if len(diff) != 1 or ls[diff[0]] != S \
                    or shape[diff[0]] != self.max_len:
                raise NotImplementedError(
                    f"cache leaf {key} varies with prompt length in a "
                    f"non-sequence way ({ls} vs {shape}); "
                    "windowed/ring caches need the single-stream Server")
            axes.append((key, diff[0]))
        self._axis_cache[S] = axes
        return axes

    def _pool_views(self) -> list:
        """Per segment ``{"attn": {"k", "v"}}``: the pool's stores seen as
        ``[P, page, n_layers, K, hd]`` (views; layer ``i`` is ``[:, :, i]``);
        MLA's ``{"lat"}`` as ``[P, page, n_layers, 1, kv_lora + rope]``."""
        cfg = self.cfg
        K, hd = (1, cfg.kv_cache_width) if cfg.mla is not None \
            else (cfg.n_kv_heads, cfg.resolved_head_dim)
        views = []
        for seg, keys in zip(T.plan_segments(cfg), self._keys):
            seg_views = {}
            for name, key in keys["attn"].items():
                self.pool.store(key, *self._pageable[key])   # after import_state
                seg_views[name] = self.pool.layer_view(key, seg.n, K, hd)
            views.append({"attn": seg_views})
        return views

    # -- session lifecycle ---------------------------------------------------
    def submit(self, prompt, *, sid=None, priority=0, max_new_tokens=8,
               first_token=0) -> str:
        """Queue a new session; it joins the running batch at the next
        ``step_once`` with a free lane and pool capacity."""
        if sid is None:
            self._sid_counter += 1
            sid = f"s{self._sid_counter:04d}"
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size and prompt.size >= self.max_len:
            raise ValueError(f"prompt of {prompt.size} tokens >= max_len "
                             f"{self.max_len}")
        if prompt.size and (prompt.min() < 0 or prompt.max() >= self.cfg.padded_vocab):
            raise ValueError(f"token ids must lie in [0, {self.cfg.padded_vocab})")
        if max_new_tokens > 0:
            # prefill emits the first generated token, so a non-empty prompt
            # decodes max_new-1 times (a zero-length one max_new times); the
            # last decode writes its cache row at max(S, 1) + max_new - 2,
            # which must stay inside max_len
            last_pos = max(int(prompt.size), 1) + int(max_new_tokens) - 2
            if last_pos >= self.max_len:
                raise ValueError(
                    f"prompt of {prompt.size} tokens + {max_new_tokens} "
                    f"new tokens overruns max_len {self.max_len}")
        self.sessions[sid] = FleetSession(
            sid, prompt.tolist(), max_new=max_new_tokens, priority=priority,
            first_token=first_token)
        self.sched.submit(sid, priority=priority)
        return sid

    def stream(self, sid: str) -> list:
        """The client-visible token stream (gap- and duplicate-free across
        preemption and migration)."""
        return list(self.sessions[sid].generated)

    # -- admission / prefill -------------------------------------------------
    def _prefill(self, sess: FleetSession) -> None:
        """First admission: run the prompt (B=1), then scatter its cache rows
        into freshly-allocated pages, one device index op per leaf."""
        S = len(sess.prompt)
        self.pool.admit(sess.sid, S, priority=sess.priority)
        if S == 0:
            # zero-length prompt: no prefill; the request's first_token seeds
            # decode at position 0
            sess.pos = 0
            sess.last_tok = sess.first_token
            return
        tokens = torch.tensor([sess.prompt], dtype=torch.int64, device=self.device)
        logits, caches = self.prefill_fn(self.params, tokens)
        toks, blocks = {}, {}
        for (key, axis), leaf in zip(self._seq_axes(S), tree_leaves(caches)):
            if axis is None:
                blocks[key] = leaf      # the pool holds the tensor, on the device
            else:
                toks[key] = leaf.movedim(axis, 0)[:S].reshape(S, -1)
        self.pool.write_tokens(sess.sid, 0, toks)
        self.pool.write_blocks(sess.sid, blocks)
        sess.pos = S
        tok0 = int(torch.argmax(logits[0, : self.cfg.vocab_size]))
        sess.generated.append(tok0)
        sess.last_tok = tok0

    def _try_admit(self, sid: str) -> bool:
        """Admit one queued session (prefill, swap-in if parked, or lane grant
        if already pool-resident), preempting strictly-lower-priority victims
        on OOM. Returns False when the pool cannot make room at this
        priority."""
        sess = self.sessions[sid]
        if sid in self.pool.sessions:
            # migrated in while every lane was busy: its pages are resident
            return True
        while True:
            try:
                if sid in self.pool.parked:
                    self.pool.unpark(sid)
                else:
                    self._prefill(sess)
                return True
            except PoolOOMError:
                victim = self.pool.preempt_victim(
                    below_priority=sess.priority, exclude={sid})
                if victim is None:
                    return False
                self._preempt(victim)

    def _preempt(self, sid: str) -> None:
        """Swap a session out: its bytes move to the pool's parked store, its
        pages free, its lane releases; it re-queues at its original arrival
        position."""
        self.pool.park(sid)
        if self.sched.state(sid) == SCHED.RUNNING:
            self.sched.preempted(sid)

    def _retire(self, sid: str) -> None:
        self.pool.drop(sid)
        self.sched.retired(sid)

    # -- the engine tick -----------------------------------------------------
    @property
    def step(self) -> int:
        return self.tick

    def step_once(self):
        """One continuous-batching tick: retire finished sessions, admit from
        the queue (prefill interleaved with decode), decode one token on
        every running lane, one B=1 lane at a time in scheduler order."""
        for sid in self.sched.running:
            if self.sessions[sid].done:
                self._retire(sid)
        while True:
            cand = self.sched.next_admission()
            if cand is None:
                break
            if self.sessions[cand].done:      # zero-token request
                self.sched.retired(cand)
                continue
            if not self._try_admit(cand):
                break                          # head-of-line waits (fairness)
            self.sched.admitted(cand)
        for sid in self.sched.running:
            if self.sched.state(sid) != SCHED.RUNNING:
                continue      # parked by a growing lane's eviction this tick
            self._decode_one(self.sessions[sid])
        self.rng_key = RS.threefry_split(self.rng_key)[0]
        self.tick += 1
        for r in range(len(self.cluster.ranks)):
            self.cluster.heartbeat(r)

    def _reserve(self, sess: FleetSession) -> bool:
        """Make the page for ``sess.pos`` exist before the forward pass writes
        into it, with the reference's decode-growth policy: evict an equal-
        or lower-priority session (newest first) and retry; when every other
        resident outranks this one, park it and decode nothing this tick
        (returns False); when nobody else holds pages, raise
        :class:`PoolOOMError` (parking would free nothing: a livelock)."""
        while True:
            try:
                self.pool.ensure_capacity(sess.sid, sess.pos + 1)
                return True
            except PoolOOMError:
                # admission readmits only by evicting strictly lower, so a
                # grower and its victim cannot evict each other forever
                victim = self.pool.preempt_victim(
                    below_priority=sess.priority + 1, exclude={sess.sid})
                if victim is not None:
                    self._preempt(victim)
                    continue
                if any(s != sess.sid for s in self.pool.sessions):
                    self._preempt(sess.sid)
                    return False
                raise PoolOOMError(self.pool.pages_for(sess.pos + 1),
                                   self.pool.free_pages)

    def _lane_caches(self, alloc):
        """A blocks-only session's cache tree: the pool's block tensors
        (zeros for a leaf not written yet, as the reference decodes a
        zero-length prompt from zero caches), which its decode updates in
        place."""
        for key, shape, dtype in self._leaf_specs:
            if key not in alloc.blocks:
                alloc.blocks[key] = torch.zeros(shape, dtype=dtype, device=self.device)
        return tree_unflatten(self._keys, [alloc.blocks[key] for key, _, _ in self._leaf_specs])

    def _decode_one(self, sess: FleetSession) -> None:
        tok = torch.tensor([sess.last_tok], dtype=torch.int64, device=self.device)
        if not self._pageable:
            # no token rows: the reference's write-through writes none and
            # reserves no page
            logits, _ = self.block_decode_fn(self.params, tok, sess.pos,
                                             self._lane_caches(self.pool.sessions[sess.sid]))
        else:
            if not self._reserve(sess):
                return
            alloc = self.pool.sessions[sess.sid]
            logits = self.decode_fn(self.params, tok, sess.pos, self._pool_views(),
                                    alloc.pages)
            alloc.length = max(alloc.length, sess.pos + 1)
        nxt = int(torch.argmax(logits[0, : self.cfg.vocab_size]))
        sess.pos += 1
        sess.generated.append(nxt)
        sess.last_tok = nxt

    def run_until_drained(self, *, max_ticks=10_000) -> int:
        """Drive ticks until no session is queued or running; returns the
        tick count."""
        t0 = self.tick
        while self.sched.live() and self.tick - t0 < max_ticks:
            self.step_once()
        return self.tick - t0

    # -- checkpoint / recover ------------------------------------------------
    def checkpoint(self, tag=None):
        """Drain every rank and snapshot the fleet: the pool's rows are
        gathered on the card and copied off it on the checkpoint's side
        stream inside the blocking window, then written in the background.
        Returns the request (``req.timings``: the window's breakdown)."""
        if tag is None:
            tag = self.tick
        rt_arrays, rt_meta = self.runtime.snapshot()
        extra = {"tick": int(self.tick), "runtime": rt_meta}
        return self.cluster.checkpoint(tag, {"runtime": rt_arrays}, None,
                                       extra_rank_state=lambda r: dict(extra))

    def restore(self, ckpt, *, new_backend=None, new_world_size=None,
                rebuild=False):
        """Resume the whole fleet mid-flight: pool pages, page table,
        per-session cursors, scheduler state, RNG — possibly under another
        flavor or world size (``Cluster.restart``, whose phase timings land
        in ``self.cluster.restart_timings``). A resident session's rows and
        blocks go to the device through the writer's pinned arena; parked
        sessions stay host arrays."""
        src = as_source(ckpt)
        manifest = src.manifest()
        rt_meta = src.rank_state(0).get("runtime")
        if rt_meta is None:
            raise ValueError("not a fleet snapshot: no runtime section")
        sh = {"runtime": self.runtime.shardings(rt_meta)}
        for sid, ent in (sh["runtime"].get("kv_pages") or {}).items():
            if not sid.startswith("parked:"):
                for section in ("tokens", "blocks"):
                    if section in ent:
                        ent[section] = {k: self.device for k in ent[section]}
        if new_backend is not None or new_world_size is not None or rebuild:
            self.cluster = self.cluster.restart(src,
                                                new_backend=new_backend,
                                                new_world_size=new_world_size,
                                                shardings=sh)
            arrays = self.cluster.restored_arrays
        else:
            writer = self.cluster.writer
            arrays = load_arrays(src, sh,
                                 arenas=writer.arenas if writer else ())
        plan = translation_plan(
            manifest.get("backend", self.cluster.backend_name),
            self.cluster.backend_name, self.cluster.mana(0).backend)
        self.last_runtime_restore = self.runtime.restore(
            arrays.get("runtime", {}), rt_meta, plan=plan)
        RS.warn_skipped(self.last_runtime_restore, "serve-fleet")

    def recover(self, ckpt, *, new_world_size=None):
        """Supervisor entry point: restore the fleet image onto the
        surviving world — every in-flight session is RE-HOMED (their pages
        and cursors come back exactly as snapshotted; replayed ticks
        re-decode the same tokens, so streams stay duplicate-free)."""
        self.restore(ckpt, new_world_size=new_world_size, rebuild=True)
        self.last_rehomed = len(self.sched.live())

    # -- rescale hooks (same contract as Server) -----------------------------
    def prepare_leave(self, rank):  # noqa: ARG002 — workload hook shape
        """Supervisor hook before a live shrink: the pool's pages stay
        where they are, on the card."""
        return None

    def rescale(self, report):  # noqa: ARG002 — workload hook shape
        """Supervisor hook after a live rescale: every session continues at
        the same position over the same pages."""
        return None

    def resume_latest(self, *, new_backend=None):
        """Resume the newest snapshot whose delta chain resolves; returns the
        checkpoint dir or ``None`` when nothing restorable exists."""
        if self.cluster.writer is None:
            return None
        ck = self.cluster.writer.resumable()
        if ck is None:
            return None
        self.restore(ck, new_backend=new_backend)
        return ck

    # -- migration support (the JAX package's payload format) ----------------
    def export_session_state(self, sid: str) -> dict:
        """Cursor + host pool payload for one session, ready to ship."""
        return {"cursor": self.sessions[sid].cursor(),
                "sched_state": self.sched.state(sid),
                "parked": sid in self.pool.parked,
                "pool": self.pool.export_session(sid)}

    def import_session_state(self, sid: str, state: dict) -> None:
        """Accept a migrated-in session: pool bytes land first (parked on OOM
        rather than evicting residents), then the cursor and a scheduler
        ticket; it decodes from its next tick here."""
        if sid in self.sessions:
            raise ValueError(f"session {sid!r} already lives here")
        sess = FleetSession.from_cursor(sid, state["cursor"])
        self.sessions[sid] = sess
        self.sched.submit(sid, priority=sess.priority)
        try:
            if not state.get("parked"):
                self.pool.import_session(sid, state["pool"])
                if self.sched.lanes_free() > 0:
                    self.sched.admitted(sid)
                return
        except PoolOOMError:
            pass
        self.pool.park_payload(sid, state["pool"])

    def release_session(self, sid: str) -> None:
        """Drop a session that migrated away (its stream lives on at the
        destination)."""
        self.pool.drop(sid)
        self.sched.migrated(sid)
