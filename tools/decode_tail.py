#!/usr/bin/env python3
"""What the one-launch split-KV decode spends after its last block.

    python3 tools/decode_tail.py [--split N] [--g1] [--define MACROS ...] [--src DIR]

Times the shipped decode kernels (``csrc/decode_split.cuh``) on serving
shapes, where each (row, KV head) leaves several partials and the last
block to finish combines them, and on the same cache positions cut into
rows of one partial each (a split, or on the tensor-core kernel a block's
128 positions), where the output is written
directly: the same K/V bytes, with no ticket and no global combine. The
difference is the combine's tail. Beside each K2 case, SDPA's time on the
same inputs (the yardstick ``chip_smoke.py`` records) and the output's
largest distance from the plain version's. Shapes: K2 at
granite-3-2b's last decode step (B4 H32 K8 D64, length 1056), at
hymba-1.5b's window (B4 H25 K5 D64, 1024), at qwen2.5-14b's (B4 H40 K8
D128, 1056), at minicpm-2b's (B4 H36 K36 D64, 1056: G = 1, one query head
a KV head), at granite-moe-3b-a800m's (B4 H24 K8 D64, 1056: G = 3) and at
llava-next-34b's (B4 H56 K8 D128, 1056: G = 7); K3 at one fleet lane of
granite-3-2b (B1 H32 K8 D64, length 1056, page 16, each call another
layer's strided view of a 40-layer pool store, a shuffled page table; its
one-partial rows are lanes whose tables hold the same pages, a partial's
worth each), of qwen2.5-14b (B1 H40 K8 D128, a 48-layer store) and of
minicpm-2b (B1 H36 K36 D64, G = 1, a 40-layer store). ``--split`` gives the
rows' length (by default a partial's positions at each head dim);
``--g1`` runs the G = 1 cases alone. Each ``--define`` (comma-separated
macros) adds a build of both decode sources with those ``-D`` flags
(``nvcc`` in parallel, into ``src/repro_torch/_build/breakdown/``), timed
on the same cases after the shipped build through the wrappers'
``library`` hooks (``DEC_G1_STAGES=2`` gives the G = 1 kernel two items
in flight).
``--src DIR`` times another checkout's kernels (its ``src`` directory, as
``git archive`` unpacks a parent commit) with this script, so that two
commits compare in one process each on one card: run it in turns, parent,
change, change, parent. Times are the replay of a CUDA graph
(``repro_torch.kernels.timing``), as in ``chip_smoke.py``. Needs one CUDA
device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (kernel, B, H, K, D, length, layers of the paged store)
CASES = (("K2", 4, 32, 8, 64, 1056, 0), ("K2", 4, 25, 5, 64, 1024, 0),
         ("K2", 4, 40, 8, 128, 1056, 0), ("K2", 4, 36, 36, 64, 1056, 0),
         ("K2", 4, 24, 8, 64, 1056, 0), ("K2", 4, 56, 8, 128, 1056, 0),
         ("K3", 1, 32, 8, 64, 1056, 40), ("K3", 1, 40, 8, 128, 1056, 48),
         ("K3", 1, 36, 36, 64, 1056, 40))
PAGE = 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", type=int, default=None,
                    help="positions a one-partial row holds (default: a partial's)")
    ap.add_argument("--g1", action="store_true", help="the G = 1 cases alone")
    ap.add_argument("--define", action="append", default=[],
                    help="comma-separated macros of a further build (repeatable)")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch is timed (default: this tree's)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("decode_tail: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels.timing import cuda_ms

    builds = {"shipped": None}
    out_dir = build.BUILD_ROOT / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, macros in enumerate(args.define):
        libs = {}
        for src in ("decode_attention", "paged_decode_attention"):
            libs[src] = out_dir / f"lib{src}_d{i}.so"
            cmd = build.nvcc_command(src, libs[src], build.nvcc_path())
            cmd[1:1] = [f"-D{m}" for m in macros.split(",") if m]
            procs.append((macros, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
        builds[macros] = libs
    for macros, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed with {macros}:\n{log}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(f"[decode_tail] kernels of {args.src.resolve()}", flush=True)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    cases = [c for c in CASES if not args.g1 or c[2] == c[3]]
    for name, libs in builds.items():
        DA.library = libs and libs["decode_attention"]
        PA.library = libs and libs["paged_decode_attention"]
        try:
            run_cases(cases, name, args.split, randn, DA, PA, cuda_ms, torch, dev)
        finally:
            DA.library = PA.library = None
    return 0


def partial_len(DA, torch, D, G):
    """Cache positions one partial covers: a split, or on the tensor-core
    kernel (a tree that has one) a block's."""
    kernel = getattr(DA, "kernel", None)
    if kernel and kernel(torch.bfloat16, D, G) == "decode_mma_kernel":
        return DA.MMA_SPAN
    return DA.split_len(D)


def run_cases(cases, name, split_arg, randn, DA, PA, cuda_ms, torch, dev):
    """Time each case with the build the wrappers point at."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    for kern, B, H, K, D, L, layers in cases:
        unit = split_arg or partial_len(DA, torch, D, H // K)
        n_part = -(-L // unit)
        lib = ""
        if kern == "K2":
            rows = B * L // unit             # one partial each, the same positions
            many = [(randn(B, H, D), randn(B, L, K, D), randn(B, L, K, D)) for _ in range(8)]
            one = [(randn(rows, H, D), randn(rows, unit, K, D), randn(rows, unit, K, D))
                   for _ in range(8)]
            t_many = cuda_ms(lambda q, k, v: DA.decode_attention(q, k, v, L), many, iters=40)
            t_one = cuda_ms(lambda q, k, v: DA.decode_attention(q, k, v, unit), one,
                            iters=40)
            t_lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True),
                many, iters=40)
            q, k, v = many[0]
            err = (DA.decode_attention(q, k, v, L).float() - ref.naive_decode_attention(
                q, k.transpose(1, 2), v.transpose(1, 2), L).float()).abs().max().item()
            lib = f"; sdpa {t_lib * 1e3:.2f} us; max |err| against the plain version {err:.1e}"
        else:
            n, per = L // PAGE, unit // PAGE
            P = n + 3
            stores = [randn(P, PAGE, layers * K * D).view(P, PAGE, layers, K, D)
                      for _ in range(2)]
            table = torch.randperm(P, generator=torch.Generator().manual_seed(P))[:n]
            table = table.to(torch.int32).to(dev)
            # the lanes of the one-partial rows: a partial's worth of the same pages each
            lanes = n_part
            t_one_tab = torch.zeros(lanes, per, dtype=torch.int32, device=dev)
            lens_one = torch.empty(lanes, dtype=torch.int32, device=dev)
            for i in range(lanes):
                pages = table[i * per:(i + 1) * per]
                t_one_tab[i, :len(pages)] = pages
                lens_one[i] = min(unit, L - i * unit)
            lens = torch.tensor([L], dtype=torch.int32, device=dev)
            many = [(randn(1, H, D), stores[0][:, :, i], stores[1][:, :, i], table[None], lens)
                    for i in range(layers)]
            one = [(randn(lanes, H, D), stores[0][:, :, i], stores[1][:, :, i], t_one_tab,
                    lens_one) for i in range(layers)]

            def paged(q, kp, vp, t, ln):
                return PA.paged_decode_attention(q, kp, vp, t, ln)
            t_many = cuda_ms(paged, many, iters=40)
            t_one = cuda_ms(paged, one, iters=40)
            rows = lanes
        print(f"[{name}] {kern} bf16 H{H} K{K} D{D}: B{B} length {L} ({n_part} partials of "
              f"{unit} positions) {t_many * 1e3:.2f} us; the same {B * L} positions as "
              f"{rows} one-partial rows {t_one * 1e3:.2f} us; the combine's tail "
              f"{(t_many - t_one) * 1e3:.2f} us{lib}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
