"""Serving CLI: batched prefill + greedy decode on the smoke config, with
transparent snapshots mid-decode and resume under another MPI flavor.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --batch 4 --prompt-len 32 --gen 32 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --gla-schedule parallel --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --gen 10 --ckpt-dir /tmp/svk --snapshot-at 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --gen 10 --ckpt-dir /tmp/svk --resume --restore-backend fabric
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.core import BACKENDS
from repro_torch.kernels.ops import GLA_SCHEDULES
from repro_torch.serving.engine import Server


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
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch)
    srv = Server(cfg, backend=args.backend, ckpt_dir=args.ckpt_dir,
                 device=args.device, gla_schedule=args.gla_schedule)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    gen, first, done = args.gen, None, []
    # a snapshot carries the cache tree, so a resume skips the prefill
    if args.resume and args.ckpt_dir:
        ck = srv.resume_latest(new_backend=args.restore_backend)
        if ck is not None:
            gen = max(args.prompt_len + args.gen - srv.pos, 0)
            first = srv.resume_tok
            print(f"resumed {ck.name} mid-sequence at pos {srv.pos} under "
                  f"{srv.cluster.backend_name}; {gen} tokens left")
    if first is None:
        # cold start, or a snapshot taken before any token was decoded
        logits = srv.prefill(prompts, pad_to=args.prompt_len + args.gen)
        first = np.argmax(logits[..., : cfg.vocab_size].cpu().numpy(), axis=-1)
        first = first.astype(np.int32)
        if args.ckpt_dir and args.snapshot_at:
            done, _ = srv.decode(min(args.snapshot_at, gen), first)
            srv.checkpoint(tag=srv.pos).wait()
            print(f"serving snapshot at pos {srv.pos} -> "
                  f"{srv.cluster.writer.latest().name}")
            gen -= len(done)
            first = done[-1]
    toks, dt = srv.decode(gen, first)
    print(f"{args.arch}: generated {gen} tokens x batch {args.batch} on {srv.device} "
          f"in {dt:.2f}s ({gen * args.batch / max(dt, 1e-9):.1f} tok/s)")
    return done + toks


if __name__ == "__main__":
    main()
