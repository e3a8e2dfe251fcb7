"""The training entry point, with MANA transparent checkpoint-restart (the
port of the JAX package's ``launch/train.py``).

Every run is a Cluster of logical ranks (threads in one process). The
training step is one device's step in PyTorch (no mesh): every layer's
attention runs the hand-written flash kernel forward and its backward
kernels on the card, hymba's SSD heads the GLA kernel (K4) and its
backward kernel, and xLSTM's sLSTM layers the recurrence's training
forward and backward kernels; the plain versions on the CPU. The MANA layer wraps
everything around it: virtual-id-tracked communicators, drained prefetch
requests, per-rank checkpoint images, failure detection and elastic
restart (another world size or MPI flavor on resume). A checkpoint holds
the reference's tree (``params``, ``opt``, ``runtime``) and rank state, so
the JAX ``Trainer`` resumes the port's checkpoints and the port resumes
the JAX ``Trainer``'s.

CLI (the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 40 \
        --ckpt-every 10 --world-size 4 --backend craympi --kill-rank-at 25 \
        --restart-backend exampi --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 16 \
        --ckpt-every 4 --ckpt-dir /tmp/sck \
        --fault-plan '[{"kind": "kill_rank", "at_step": 10}]'

On a CUDA device the trainer turns on ``torch.use_deterministic_algorithms``
(and sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` if it is unset) before its
first CUDA work, so that a run resumed from a checkpoint repeats the
uninterrupted run's params byte for byte.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from repro_torch import steps as ST
from repro_torch.configs import ARCH_IDS, CkptIOConfig, get_config, smoke_config
from repro_torch.core import BACKENDS, Cluster
from repro_torch.core import runtime_state as RS
from repro_torch.core.restore import as_source, translation_plan
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_map
from repro_torch.optim import make_optimizer, wsd


def set_deterministic(device: torch.device) -> None:
    """On a CUDA device, every op takes its deterministic algorithm (an op
    without one raises) and cuBLAS a fixed workspace: the kernels of the
    step sum in a fixed order, so equal inputs give equal bits."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


class Trainer:
    """One device's trainer (``mesh`` must be None). ``params`` for
    :meth:`init_state` default to ``Model.init(seed)`` on ``device``; tests
    hand in the JAX package's through ``models.params.from_jax_params``."""

    def __init__(self, cfg, *, batch_size=8, seq_len=64, world_size=2,
                 backend="mpich", ckpt_dir=None, translation="fast",
                 lr=3e-3, total_steps=1000, seed=0, mesh=None, ckpt_io=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError("the port trains on one device: mesh=None")
        T.check_trainable(cfg)
        self.device = resolve_device(device)
        set_deterministic(self.device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.model = Model(cfg)
        self.optimizer = make_optimizer(cfg, wsd(lr, max(total_steps // 20, 1),
                                                 total_steps))
        self.cluster = Cluster(world_size, backend, translation=translation,
                               ckpt_dir=ckpt_dir, ckpt_io=ckpt_io)
        self.pipeline = DataPipeline(cfg, batch_size, seq_len,
                                     seed=seed + 1, mana=self.cluster.mana(0))
        self.train_step = ST.make_train_step(self.model, self.optimizer)
        self.seed = seed
        self.step = 0
        self.params = None
        self.opt_state = None
        self.history = []
        self.restart_timings = {}
        self.last_runtime_restore = None
        self._log_t0 = time.time()
        # training key stream (raw threefry2x32 data of the reference's
        # jax.random.key(seed + 2)): advanced once per step with fold_in
        # (stochastic ops — dropout, data augmentation — would draw from
        # it); checkpointed so a resumed run continues the exact stream
        self.rng_key = RS.threefry_key(seed + 2)
        # runtime-state providers: the key stream plus the data-pipeline
        # cursor, snapshotted/restored by the checkpoint plane alongside
        # params (repro_torch.core.runtime_state)
        self.runtime = RS.RuntimeStateRegistry()
        self.runtime.register(RS.RngStateProvider(
            "rng", lambda: self.rng_key, self._set_rng))
        self.runtime.register(RS.JsonStateProvider(
            "data_cursor", lambda: self.pipeline.state(),
            self._resume_pipeline))

    # -- runtime provider hooks ---------------------------------------------
    def _set_rng(self, key):
        self.rng_key = key

    def _resume_pipeline(self, state):
        self.pipeline = DataPipeline.resume(self.cfg, state,
                                            mana=self.cluster.mana(0))

    # ------------------------------------------------------------------
    def init_state(self, params=None):
        """Seeded params (or ``params``) and zeroed optimizer state, step 0."""
        self.params = params if params is not None \
            else self.model.init(self.seed, self.device)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0

    def _device_batch(self, batch):
        """The pipeline's numpy batch on the device: tokens and targets as
        int64, llava's patch embeddings as they come (float32)."""
        out = {k: torch.from_numpy(batch[k]).to(self.device, torch.int64)
               for k in ("tokens", "targets")}
        if "patch_embeds" in batch:
            out["patch_embeds"] = torch.from_numpy(batch["patch_embeds"]).to(self.device)
        return out

    def _placements(self):
        """Where a restore puts each checkpointed params/opt leaf: the
        device. The state's tree is the optimizer's own ``init`` over
        shape-only (meta) params, so it is the tree the checkpoint holds."""
        meta = tree_map(lambda s: torch.empty(s.shape, device="meta"),
                        self.model.specs())
        return {"params": tree_map(lambda _: self.device, meta),
                "opt": tree_map(lambda _: self.device, self.optimizer.init(meta))}

    # ------------------------------------------------------------------
    def step_once(self):
        """One training step: next batch -> forward, backward and update on
        the device -> world allreduce of the step loss on the MANA plane ->
        heartbeat every rank.  The unit the supervisor drives; ``run``
        loops over it.

        The metrics allreduce is the training step's MPI hot path: every
        live rank enters ``allreduce`` over COMM_WORLD through the
        generated interposition layer, so a dead lower half or a dangling
        session token surfaces HERE (fail-fast, classified by the
        supervisor) rather than only at the next checkpoint."""
        batch = self._device_batch(self.pipeline.next())
        self.params, self.opt_state, metrics = self.train_step(
            self.params, self.opt_state, batch, self.step)
        self.rng_key = RS.threefry_fold_in(self.rng_key, self.step)
        self.step += 1
        world = max(len(self.cluster.manas), 1)
        # async-start/late-wait overlap: the rank threads start NOW and
        # block on the device transfer inside the pool (the value callable
        # reads `metrics["loss"]`) while this thread sends the heartbeats;
        # the handle is waited within the same step
        handle = ST.host_allreduce_async(
            self.cluster, lambda r: float(metrics["loss"]))
        for r in range(len(self.cluster.ranks)):
            self.cluster.heartbeat(r)
        metrics = dict(metrics)
        metrics["world_loss"] = handle.wait() / world
        return metrics

    def log_step(self, metrics, log_every=25, force=False):
        """Record/print progress every ``log_every`` steps (``run`` and the
        supervisor both route through here)."""
        if self.step % log_every and not force:
            return
        m = {k: float(v) for k, v in metrics.items()}
        m["tokens_per_s"] = (self.batch_size * self.seq_len * log_every
                             / max(time.time() - self._log_t0, 1e-9))
        self._log_t0 = time.time()
        m["step"] = self.step
        self.history.append(m)
        print(f"step {self.step:5d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.3f} tok/s {m['tokens_per_s']:.0f}",
              flush=True)

    def run(self, n_steps, *, ckpt_every=0, kill_rank_at=None,
            new_world_size_on_restart=None, new_backend_on_restart=None,
            log_every=25):
        self._log_t0 = time.time()
        target = self.step + n_steps
        while self.step < target:
            if kill_rank_at is not None and self.step == kill_rank_at:
                kill_rank_at = None
                self._fail_and_recover(new_world_size_on_restart,
                                       new_backend_on_restart)
                continue
            metrics = self.step_once()
            if ckpt_every and self.step % ckpt_every == 0:
                self.checkpoint()
            self.log_step(metrics, log_every, force=self.step == target)
        return self.history

    # ------------------------------------------------------------------
    def checkpoint(self):
        """Drain, snapshot (the card's leaves copied off it through the
        writer's pinned arena) and write in the background. Returns the
        request; ``req.timings`` holds the blocking window's parts."""
        rt_arrays, rt_meta = self.runtime.snapshot()
        arrays = {"params": self.params, "opt": self.opt_state,
                  "runtime": rt_arrays}
        pipe_state = self.pipeline.state()

        def extra(rank):
            # legacy pipeline/train_step/seed keys ride alongside the
            # runtime section, as in the reference's rank state
            return {"pipeline": pipe_state, "train_step": self.step,
                    "seed": self.seed, "runtime": rt_meta}

        return self.cluster.checkpoint(self.step, arrays, None,
                                       extra_rank_state=extra)

    def _fail_and_recover(self, new_world_size=None, new_backend=None):
        """Injected node failure -> detect -> elastic restart from latest ckpt."""
        victim = len(self.cluster.ranks) - 1
        print(f"!! injecting failure of rank {victim}", flush=True)
        self.cluster.kill_rank(victim)
        self.cluster.writer.wait_idle()
        ck = self.cluster.writer.latest()
        if ck is None:
            raise RuntimeError("failure before first checkpoint — cold restart")
        self.restore(ck, new_world_size=new_world_size, new_backend=new_backend)
        print(f"!! recovered from {ck.name} at step {self.step} "
              f"(world={len(self.cluster.ranks)}, backend="
              f"{self.cluster.backend_name})", flush=True)

    def restore(self, ckpt, *, new_world_size=None, new_backend=None):
        """Elastic restart from a checkpoint source — a committed step dir
        or an in-RAM ``TierImage``: array-leaf reads overlap descriptor
        re-binding on one pool (``Cluster.restart``), the params and
        optimizer state land on the device, and the phase timings in
        ``self.restart_timings``."""
        src = as_source(ckpt)
        manifest = src.manifest()
        rs = src.rank_state(0)
        rt_meta = rs.get("runtime")
        if rt_meta is None:
            raise ValueError("not a trainer checkpoint: no runtime section")
        self.pipeline.stop()
        shardings = self._placements()
        rt_sh = self.runtime.shardings(rt_meta)
        if rt_sh:
            shardings["runtime"] = rt_sh
        self.cluster = self.cluster.restart(src,
                                            new_world_size=new_world_size,
                                            new_backend=new_backend,
                                            shardings=shardings)
        arrays = self.cluster.restored_arrays
        self.restart_timings = self.cluster.restart_timings
        self.params, self.opt_state = arrays["params"], arrays["opt"]
        self.step = rs["train_step"]
        plan = translation_plan(
            manifest.get("backend", self.cluster.backend_name),
            self.cluster.backend_name, self.cluster.mana(0).backend)
        self.last_runtime_restore = self.runtime.restore(
            arrays.get("runtime", {}), rt_meta, plan=plan)
        RS.warn_skipped(self.last_runtime_restore, "train")
        return manifest

    # -- live rescale (zero-downtime elasticity) -----------------------
    def prepare_leave(self, rank):
        """Supervisor hook, called BEFORE ``elastic.shrink``: if the
        departing rank owns the data pipeline, freeze it and return its
        cursor so the shrink protocol hands it to the inheritor (the
        producer must stop first: it mints prefetch requests on the
        leaving Mana, which would keep the scoped drain from quiescing)."""
        if self.pipeline.mana is not None \
                and self.pipeline.mana.rank == rank:
            cursor = self.pipeline.state()
            self.pipeline.stop()
            return cursor
        return None

    def rescale(self, report):
        """Supervisor hook, called AFTER a successful live rescale: re-home
        the data pipeline if its owning rank departed, nothing else. Params
        and optimizer state are untouched: a live shrink never restores
        arrays, so survivor parameters stay byte-identical."""
        owner = self.pipeline.mana.rank if self.pipeline.mana is not None \
            else None
        members = list(report.members)
        if owner is None or owner not in members:
            self.pipeline.reattach(self.cluster.mana(members[0]))

    def recover(self, ckpt_dir, *, new_world_size=None):
        """Supervisor entry point: elastic restore onto the (possibly
        shrunken) surviving world; the params are byte-identical to a
        fault-free run re-run from the same checkpoint."""
        self.restore(ckpt_dir, new_world_size=new_world_size)

    def resume_latest(self, *, new_backend=None, new_world_size=None):
        """Resume from the newest committed checkpoint whose delta chain
        resolves; returns the checkpoint dir, or ``None`` (cold start)."""
        if self.cluster.writer is None:
            return None
        ck = self.cluster.writer.resumable()
        if ck is None:
            return None
        self.restore(ck, new_world_size=new_world_size,
                     new_backend=new_backend)
        return ck


def install_preempt_handler(workload):
    """SIGTERM = scheduler preemption warning (SLURM ``--signal``, k8s
    ``preStop``): convert it into a :class:`PreemptNotice` raised in the
    main thread, so the supervisor's rescale rung performs a GRACEFUL
    leave — scoped drain, state handoff, live shrink — inside the grace
    window instead of the process dying mid-step."""
    import signal

    from repro_torch.core.faults import PreemptNotice

    def on_sigterm(signum, frame):  # noqa: ARG001 — signal API shape
        alive = workload.cluster.survivors()
        # evict the highest surviving rank; rank 0 (pipeline/lease owner)
        # leaves only when it is the last one standing
        victim = alive[-1] if len(alive) > 1 else alive[0]
        raise PreemptNotice(victim, grace_s=5.0)

    try:
        signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded/test use) — handler skipped


def main(argv=None):
    """Returns the Trainer after the run."""
    flavors = sorted(BACKENDS)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions under autograd")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--backend", default="mpich", choices=flavors)
    ap.add_argument("--translation", default="fast", choices=["fast", "slow"])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kill-rank-at", type=int, default=None)
    ap.add_argument("--restart-backend", default=None, choices=flavors)
    ap.add_argument("--restart-world-size", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest committed checkpoint in "
                         "--ckpt-dir whose delta chain resolves")
    ap.add_argument("--restore-backend", default=None, choices=flavors,
                    help="backend flavor to restart under on --resume "
                         "(cross-backend restart; default: --backend)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-codec", default="zlib",
                    choices=["none", "zlib", "lz4", "int8"],
                    help="shard codec (int8 is LOSSY — optimizer-moment use)")
    ap.add_argument("--ckpt-incremental", action="store_true", default=True,
                    help="write only dirty shards (full every --ckpt-keep'th)")
    ap.add_argument("--no-ckpt-incremental", dest="ckpt_incremental",
                    action="store_false")
    ap.add_argument("--ckpt-io-workers", type=int, default=0,
                    help="writer/reader pool size (0 = min(world, cpu))")
    ap.add_argument("--ckpt-keep", type=int, default=3)
    ap.add_argument("--ckpt-pipeline", action="store_true", default=True,
                    help="pipelined double-buffered snapshot (the port's only path)")
    ap.add_argument("--no-ckpt-pipeline", dest="ckpt_pipeline",
                    action="store_false",
                    help="refused: the port has no snapshot-all-then-write path")
    ap.add_argument("--snapshot-batch-mb", type=float, default=8.0,
                    help="raw MB per batched device->host transfer group")
    ap.add_argument("--drain-backoff", type=float, default=5e-5,
                    help="first quiesce poll sleep in seconds (doubles)")
    ap.add_argument("--drain-timeout", type=float, default=10.0,
                    help="shared quiesce deadline in seconds (a blown slice "
                         "raises DrainStallError for the supervisor)")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the auto-recovery supervisor: failures "
                         "are detected (heartbeat lease + lower-half probe), "
                         "classified, and recovered from the newest "
                         "digest-valid checkpoint on the surviving world")
    ap.add_argument("--fault-plan", default=None,
                    help="chaos testing: inline JSON or a path to a JSON "
                         "fault plan, e.g. "
                         '\'[{"kind": "kill_rank", "at_step": 12}]\'; '
                         "implies --supervise")
    ap.add_argument("--lease-s", type=float, default=2.0,
                    help="supervisor heartbeat lease (s)")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="supervisor recovery attempts per failure")
    ap.add_argument("--backoff-floor", type=float, default=0.05,
                    help="supervisor backoff floor in seconds (0 disables)")
    ap.add_argument("--backoff-ceiling", type=float, default=2.0,
                    help="supervisor backoff ceiling in seconds")
    ap.add_argument("--rescale", default="preempt",
                    choices=["off", "preempt", "all"],
                    help="rescale-rung policy: live shrink-and-continue on "
                         "preemption notices only (default), on any "
                         "membership failure (all), or never (off)")
    ap.add_argument("--ram-tier", action="store_true", default=True,
                    help="replicate each committed snapshot to partner "
                         "ranks' RAM; recovery tries this tier before disk "
                         "(default)")
    ap.add_argument("--no-ram-tier", dest="ram_tier", action="store_false",
                    help="disk-only recovery (skip peer replication)")
    args = ap.parse_args(argv)
    if not args.ckpt_pipeline:
        ap.error("--no-ckpt-pipeline: the port has only the pipelined snapshot")

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ckpt_io = CkptIOConfig(codec=args.ckpt_codec,
                           incremental=args.ckpt_incremental,
                           io_workers=args.ckpt_io_workers,
                           keep=args.ckpt_keep,
                           snapshot_batch_mb=args.snapshot_batch_mb,
                           drain_backoff=args.drain_backoff,
                           drain_timeout=args.drain_timeout)
    tr = Trainer(cfg, batch_size=args.batch_size, seq_len=args.seq_len,
                 world_size=args.world_size, backend=args.backend,
                 translation=args.translation, ckpt_dir=args.ckpt_dir,
                 lr=args.lr, total_steps=args.steps, ckpt_io=ckpt_io,
                 device=args.device)
    tr.init_state()
    n_steps = args.steps
    if args.resume:
        # the CLI's --world-size wins over the checkpoint's recorded world:
        # elastic resume onto whatever fleet exists now
        ck = tr.resume_latest(new_backend=args.restore_backend,
                              new_world_size=args.world_size)
        if ck is not None:
            t = tr.restart_timings
            print(f"resumed from {ck.name} at step {tr.step} under "
                  f"{tr.cluster.backend_name} "
                  f"(rebind {t['rebind_ms']:.1f}ms, arrays "
                  f"{t['arrays_ms']:.1f}ms, total {t['total_ms']:.1f}ms)",
                  flush=True)
            # --steps is the TOTAL budget: a job preempted at step 60 of
            # 100 resumes for the remaining 40, not another 100
            n_steps = max(args.steps - tr.step, 0)
        else:
            print("no resumable checkpoint found — cold start", flush=True)
    install_preempt_handler(tr)
    injector = None
    try:
        if args.supervise or args.fault_plan:
            from repro_torch.core.ckpt_tiers import ReplicaTier
            from repro_torch.core.faults import FaultInjector, FaultPlan
            from repro_torch.core.supervisor import Supervisor, SupervisorConfig
            plan = FaultPlan.parse(args.fault_plan) if args.fault_plan \
                else FaultPlan()
            injector = FaultInjector(plan)
            sup_cfg = SupervisorConfig(lease_s=args.lease_s,
                                       max_retries=args.max_retries,
                                       backoff_floor_s=args.backoff_floor,
                                       backoff_ceiling_s=args.backoff_ceiling,
                                       rescale=args.rescale)
            sup = Supervisor(tr, injector=injector, config=sup_cfg,
                             tier=ReplicaTier() if args.ram_tier else None)
            incidents = sup.run(n_steps, ckpt_every=args.ckpt_every)
            for inc in incidents:
                t = inc.timings
                print(f"incident: {inc.kind} rank={inc.rank} "
                      f"step={inc.step}->{inc.resumed_step} "
                      f"tier={inc.tier} ckpt={inc.ckpt} "
                      f"detect={t['detect_ms']:.1f}ms "
                      f"restore={t['restore_ms']:.1f}ms "
                      f"resume={t['resume_ms']:.1f}ms", flush=True)
            print(f"supervised run done: {len(incidents)} incident(s), "
                  f"world={len(tr.cluster.survivors())}", flush=True)
        else:
            from repro_torch.core.faults import PreemptNotice
            target = tr.step + n_steps
            kill_at = args.kill_rank_at
            while tr.step < target:
                try:
                    tr.run(target - tr.step, ckpt_every=args.ckpt_every,
                           kill_rank_at=kill_at,
                           new_world_size_on_restart=args.restart_world_size,
                           new_backend_on_restart=args.restart_backend)
                except PreemptNotice as pn:
                    # unsupervised graceful leave: shrink live and keep
                    # training on the survivors — no restart, no rewind
                    from repro_torch.core import elastic
                    rep = elastic.shrink(tr.cluster, pn.rank,
                                         cursor=tr.prepare_leave(pn.rank),
                                         timeout=pn.grace_s)
                    tr.rescale(rep)
                    print(f"!! preempted rank {pn.rank}: live shrink to "
                          f"world {len(rep.members)} in "
                          f"{rep.downtime_ms:.1f}ms — continuing at step "
                          f"{tr.step}", flush=True)
                    kill_at = None
                else:
                    break
    finally:
        if injector is not None:
            injector.close()
        # EVERY exit path — exception, Ctrl-C, or clean finish — must leave
        # the in-flight pipelined checkpoint committed (wait_idle inside
        # close) or cleanly abandoned, never half-owned by a dying process
        tr.pipeline.stop()
        if tr.cluster.writer is not None:
            try:
                tr.cluster.writer.close()
            except Exception as e:  # noqa: BLE001 — report, don't mask exit
                print(f"checkpoint writer shutdown failed: {e}",
                      file=sys.stderr)
    if tr.history:
        first, last = tr.history[0]["loss"], tr.history[-1]["loss"]
        print(f"done: loss {first:.4f} -> {last:.4f} over {n_steps} steps")
    elif not (args.supervise or args.fault_plan):
        print(f"done: nothing left to run (step {tr.step} >= "
              f"--steps {args.steps})")
    return tr


if __name__ == "__main__":
    main()
