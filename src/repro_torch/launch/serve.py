"""Serving CLI: batched prefill + greedy decode on the smoke config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --batch 4 --prompt-len 32 --gen 32 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --gla-schedule parallel --device cuda
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.kernels.ops import GLA_SCHEDULES
from repro_torch.serving.engine import Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernel versions")
    ap.add_argument("--gla-schedule", default="chunk", choices=GLA_SCHEDULES,
                    help="hymba's prefill GLA kernel: chunk-sequential or chunk-parallel")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch)
    srv = Server(cfg, device=args.device, gla_schedule=args.gla_schedule)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    logits = srv.prefill(prompts, pad_to=args.prompt_len + args.gen)
    first = np.argmax(logits[..., : cfg.vocab_size].cpu().numpy(), axis=-1)
    toks, dt = srv.decode(args.gen, first.astype(np.int32))
    print(f"{args.arch}: generated {args.gen} tokens x batch {args.batch} on {srv.device} "
          f"in {dt:.2f}s ({args.gen * args.batch / dt:.1f} tok/s)")
    return toks


if __name__ == "__main__":
    main()
