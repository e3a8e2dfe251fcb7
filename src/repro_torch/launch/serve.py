"""Serving CLI: batched prefill + greedy decode on the smoke config, with
transparent snapshots mid-decode and resume under another MPI flavor.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --batch 4 --prompt-len 32 --gen 32 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --gla-schedule parallel --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b \
        --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --gen 10 --ckpt-dir /tmp/svk --snapshot-at 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --gen 10 --ckpt-dir /tmp/svk --resume --restore-backend fabric
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --batch 1 --prompt-len 4 --gen 10 --ckpt-dir /tmp/ssk \
        --fault-plan '[{"kind": "kill_rank", "at_step": 6}]'
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
        --fleet --device cpu --gen 10 --ckpt-dir /tmp/fsk --snapshot-at 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
        --fleet --device cpu --gen 10 --ckpt-dir /tmp/fsk --resume

``--supervise`` decodes under the auto-recovery supervisor
(``core/supervisor.py``): a snapshot every ``--snapshot-every`` steps,
peer-replicated to a partner's RAM unless ``--no-ram-tier``, and each
failure detected, classified and recovered over the escalation ladder.
A fault plan's ``at_step`` is the decode position (the prompt length
after the prefill), not the count of decoded tokens.

``--fleet`` serves the batch's prompts as sessions of the continuous-
batching ``ServeEngine`` instead (each ``--gen`` new tokens, a page pool
of FLEET_PAGE-position pages that holds them all, FLEET_LANES running at
once); ``--snapshot-at N``
then snapshots the fleet after N ticks, and ``--resume`` restores the
newest fleet snapshot and drains it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.core import BACKENDS
from repro_torch.kernels.ops import GLA_SCHEDULES
from repro_torch.serving.engine import ServeEngine, Server

#: the fleet mode's page size and running sessions
FLEET_PAGE, FLEET_LANES = 8, 2


def main(argv=None):
    """Returns the tokens this run decoded (numpy [batch] each): the whole
    stream, or after ``--resume`` the tail from the snapshot on."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernel versions")
    ap.add_argument("--gla-schedule", default="chunk", choices=GLA_SCHEDULES,
                    help="hymba's prefill GLA kernel: chunk-sequential or chunk-parallel")
    ap.add_argument("--backend", default="mpich", choices=sorted(BACKENDS))
    ap.add_argument("--ckpt-dir", default=None,
                    help="snapshot dir; enables mid-decode checkpointing")
    ap.add_argument("--snapshot-at", type=int, default=0,
                    help="take a serving snapshot after N decode steps")
    ap.add_argument("--resume", action="store_true",
                    help="resume the newest resolvable snapshot in "
                         "--ckpt-dir instead of prefilling from scratch")
    ap.add_argument("--restore-backend", default=None, choices=sorted(BACKENDS),
                    help="backend flavor to restart under on --resume")
    ap.add_argument("--supervise", action="store_true",
                    help="decode under the auto-recovery supervisor "
                         "(requires --ckpt-dir)")
    ap.add_argument("--fault-plan", default=None,
                    help="chaos testing: inline JSON or a path to a JSON "
                         "fault plan; implies --supervise")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="supervised mode: snapshot every N decode steps "
                         "(default gen/2)")
    ap.add_argument("--backoff-floor", type=float, default=0.05,
                    help="supervisor backoff floor in seconds (0 disables)")
    ap.add_argument("--backoff-ceiling", type=float, default=2.0,
                    help="supervisor backoff ceiling in seconds")
    ap.add_argument("--rescale", default="preempt",
                    choices=["off", "preempt", "all"],
                    help="rescale-rung policy: never, graceful leaves only, "
                         "or any membership failure")
    ap.add_argument("--ram-tier", action="store_true", default=True,
                    help="peer-replicate snapshots to partner RAM and try "
                         "that tier first on recovery (default)")
    ap.add_argument("--no-ram-tier", dest="ram_tier", action="store_false",
                    help="disk-only recovery (skip peer replication)")
    ap.add_argument("--fleet", action="store_true",
                    help="serve the prompts as sessions of the continuous-batching "
                         "ServeEngine (--snapshot-at counts its ticks)")
    args = ap.parse_args(argv)
    supervised = args.supervise or args.fault_plan
    if supervised and not args.ckpt_dir:
        raise SystemExit("--supervise requires --ckpt-dir")
    if supervised and args.fleet:
        raise SystemExit("--fleet decodes without the supervisor")
    cfg = smoke_config(args.arch)
    if args.fleet:
        return _fleet(cfg, args)
    srv = Server(cfg, backend=args.backend, ckpt_dir=args.ckpt_dir,
                 device=args.device, gla_schedule=args.gla_schedule)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    # llava's image: the stub frontend's patch embeddings, from the same rng
    pe = rng.standard_normal((args.batch, cfg.img_tokens, 1024)).astype(np.float32) \
        if cfg.img_tokens else None
    gen, first, done = args.gen, None, []
    # resume runs first, supervised or not: a snapshot carries the cache
    # tree, so a resume skips the prefill
    if args.resume and args.ckpt_dir:
        ck = srv.resume_latest(new_backend=args.restore_backend)
        if ck is not None:
            gen = max(args.prompt_len + args.gen - srv.pos, 0)
            first = srv.resume_tok
            print(f"resumed {ck.name} mid-sequence at pos {srv.pos} under "
                  f"{srv.cluster.backend_name}; {gen} tokens left")
    if first is None:
        # cold start, or a snapshot taken before any token was decoded
        logits = srv.prefill(prompts, pe, pad_to=args.prompt_len + args.gen)
        first = np.argmax(logits[..., : cfg.vocab_size].cpu().numpy(), axis=-1)
        first = first.astype(np.int32)
        if args.ckpt_dir and args.snapshot_at and not supervised:
            done, _ = srv.decode(min(args.snapshot_at, gen), first)
            srv.checkpoint(tag=srv.pos).wait()
            print(f"serving snapshot at pos {srv.pos} -> "
                  f"{srv.cluster.writer.latest().name}")
            gen -= len(done)
            first = done[-1]
    if supervised:
        return _supervised(srv, args, gen, first)
    toks, dt = srv.decode(gen, first)
    print(f"{args.arch}: generated {gen} tokens x batch {args.batch} on {srv.device} "
          f"in {dt:.2f}s ({gen * args.batch / max(dt, 1e-9):.1f} tok/s)")
    return done + toks


def _fleet(cfg, args):
    """The fleet: one session a prompt row, drained; returns {sid: stream}."""
    max_len = args.prompt_len + args.gen
    per = -(-max_len // FLEET_PAGE)
    eng = ServeEngine(cfg, backend=args.backend, ckpt_dir=args.ckpt_dir, device=args.device,
                      max_len=max_len, page_size=FLEET_PAGE, n_pages=args.batch * per,
                      max_running=FLEET_LANES)
    ck = eng.resume_latest(new_backend=args.restore_backend) \
        if args.resume and args.ckpt_dir else None
    if ck is not None:
        print(f"resumed {ck.name} at tick {eng.tick} under {eng.cluster.backend_name}; "
              f"{len(eng.sched.live())} sessions live")
    else:
        rng = np.random.default_rng(0)
        for i, p in enumerate(rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))):
            eng.submit(p, sid=f"s{i:04d}", max_new_tokens=args.gen)
        if args.ckpt_dir and args.snapshot_at:
            for _ in range(args.snapshot_at):
                eng.step_once()
            eng.checkpoint().wait()
            print(f"fleet snapshot at tick {eng.tick} -> {eng.cluster.writer.latest().name}")
    t0 = time.perf_counter()
    ticks = eng.run_until_drained()
    dt = time.perf_counter() - t0
    streams = {sid: eng.stream(sid) for sid in sorted(eng.sessions)}
    print(f"{args.arch} fleet: {len(streams)} sessions x {args.gen} tokens on {eng.device}, "
          f"{ticks} ticks in {dt:.2f}s")
    return streams


def _supervised(srv, args, gen, first):
    """Decode ``gen`` tokens under the supervisor; returns the tokens the
    run decoded (recoveries rewind the stream, so none repeats)."""
    from repro_torch.core.ckpt_tiers import ReplicaTier
    from repro_torch.core.faults import FaultInjector, FaultPlan
    from repro_torch.core.supervisor import Supervisor, SupervisorConfig
    plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else FaultPlan()
    srv.start_decode(first)
    n_before = len(srv.generated)
    t0 = time.time()
    sup_cfg = SupervisorConfig(backoff_floor_s=args.backoff_floor,
                               backoff_ceiling_s=args.backoff_ceiling,
                               rescale=args.rescale)
    with FaultInjector(plan) as injector:
        sup = Supervisor(srv, injector=injector, config=sup_cfg,
                         tier=ReplicaTier() if args.ram_tier else None)
        incidents = sup.run(gen, ckpt_every=args.snapshot_every
                            or max(gen // 2, 1))
    dt = time.time() - t0
    for inc in incidents:
        t = inc.timings
        print(f"incident: {inc.kind} rank={inc.rank} "
              f"pos={inc.step}->{inc.resumed_step} tier={inc.tier} "
              f"ckpt={inc.ckpt} "
              f"restore={t['restore_ms']:.1f}ms", flush=True)
    print(f"supervised decode: {gen} tokens x batch {args.batch} in "
          f"{dt:.2f}s, {len(incidents)} incident(s)")
    return srv.generated[n_before:]


if __name__ == "__main__":
    main()
