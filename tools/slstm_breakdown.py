#!/usr/bin/env python3
"""Where the sLSTM recurrence kernel's bf16 steps spend their time.

    python3 tools/slstm_breakdown.py [--turns N]

Builds ``csrc/slstm_scan.cu`` once as shipped and once with each set of
diagnostic macros below (one ``nvcc`` each, all in parallel, into
``src/repro_torch/_build/breakdown/``), and times every build through the
wrapper's ``library`` hook at xlstm-350m's shapes, as ``chip_smoke.py``
phase 3 does (the replay of a CUDA graph, ``kernels.timing.cuda_ms``): the
prefill's B4 S1024 (two input sets) and a fleet lane's B1 S1 (32 sets).
Each macro takes one part of a step out, so a build's distance from the
shipped one is that part's cost: ``SLSTM_NO_MMA`` (the product),
``SLSTM_NO_CELL`` (the cell's exponentials), ``SLSTM_NO_HS`` (the hs
stores), ``SLSTM_LOCAL`` (the h pairs each block sends to itself eight
times: no DSMEM traffic), and all of them together (the step's skeleton:
the loop, the wx loads, the mbarrier waits). The builds' outputs are
wrong; only their times mean anything. ``--turns N`` times the builds N
times, in turns. Also prints the launch of S + 1 cluster barriers alone
(``slstm_scan.barrier``). Needs one CUDA device and nvcc; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

H, DH = 4, 256
#: build -> its macros
BUILDS = {
    "shipped": (),
    "no_mma": ("SLSTM_NO_MMA",),
    "no_cell": ("SLSTM_NO_CELL",),
    "no_hs": ("SLSTM_NO_HS",),
    "local": ("SLSTM_LOCAL",),
    "skeleton": ("SLSTM_NO_MMA", "SLSTM_NO_CELL", "SLSTM_NO_HS", "SLSTM_LOCAL"),
}


def build_all(out: Path) -> dict:
    from repro_torch.kernels import build
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, macros in BUILDS.items():
        lib = out / f"libslstm_{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *(f"-D{m}" for m in macros), "-o",
               str(lib), str(build.CSRC / "slstm_scan.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} build:\n{log}")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("slstm_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.kernels.build import BUILD_ROOT
    from repro_torch.kernels.timing import cuda_ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_all(BUILD_ROOT / "breakdown")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(350)

    def inputs(B, S):
        wx = torch.randn(B, S, 4 * H * DH, generator=gen, device=dev).bfloat16()
        r = (torch.randn(H, DH, 4 * DH, generator=gen, device=dev) / DH ** 0.5).bfloat16()
        return wx, r, ref.slstm_state0(B, H, DH, dev)

    shapes = {(4, 1024): [inputs(4, 1024) for _ in range(2)],
              (1, 1): [inputs(1, 1) for _ in range(32)]}
    times = {(name, shape): [] for name in BUILDS for shape in shapes}
    for _ in range(args.turns):
        for name, lib in libs.items():
            SL.library = lib
            for shape, sets in shapes.items():
                times[(name, shape)].append(cuda_ms(SL.slstm_scan, sets,
                                                    iters=10 if shape[1] > 1 else 40))
    SL.library = None
    for shape, sets in shapes.items():
        B, S = shape
        floor = cuda_ms(lambda *_: SL.barrier(B, S, H, DH, dev), sets[:1], iters=10)
        base = min(times[("shipped", shape)])
        print(f"B{B} S{S} H{H} dh{DH} bf16 (best of {args.turns}, us a call; us a step): "
              f"barriers alone {floor * 1e3:.1f} ({floor * 1e3 / (S + 1):.3f})", flush=True)
        for name in BUILDS:
            t = min(times[(name, shape)])
            print(f"  {name:9s} {t * 1e3:9.1f}  {t * 1e3 / S:7.3f}   saves "
                  f"{(base - t) * 1e3 / S:+.3f} a step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
