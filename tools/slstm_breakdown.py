#!/usr/bin/env python3
"""Where the sLSTM kernels' bf16 steps spend their time.

    python3 tools/slstm_breakdown.py [--turns N] [--parent DIR]             # serving forward
    python3 tools/slstm_breakdown.py --states [--turns N] [--parent DIR]    # training forward
    python3 tools/slstm_breakdown.py --bwd [--turns N] [--parent DIR]       # backward

Builds the kernel's source once as shipped and once with each set of its
diagnostic macros (one ``nvcc`` each, all in parallel, into
``src/repro_torch/_build/breakdown/``), and times every build through the
wrapper's library hook (``slstm_scan.library``, ``slstm_scan.bwd_library``)
at xlstm-350m's shapes, as ``chip_smoke.py`` phase 3 does (the replay of a
CUDA graph, ``kernels.timing.cuda_ms``). Each macro takes one part of a
step out, so a build's distance from the shipped one is that part's cost.
The builds' outputs are wrong; only their times mean anything.

- The serving forward (``csrc/slstm_scan.cu``), at the prefill's B4 S1024
  (two input sets) and a fleet lane's B1 S1 (32 sets): ``SLSTM_NO_MMA``
  (the product), ``SLSTM_NO_CELL`` (the cell's exponentials),
  ``SLSTM_NO_HS`` (the hs stores), ``SLSTM_LOCAL`` (the h pairs each block
  sends to itself eight times: no DSMEM traffic), and all of them together
  (the step's skeleton: the loop, the wx loads, the mbarrier waits).
- ``--states``: the training forward (``states=True``) at B4 S1024 as
  shipped and with ``SLSTM_NO_SAVES`` (nothing saved), beside the shipped
  serving launch.
- ``--bwd``: the backward kernel alone (``slstm_scan._bwd``) at B4 S1024 on
  the training forward's saved tensors: ``SLSTM_BWD_NO_MMA`` (the
  product), ``SLSTM_BWD_NO_CELL`` (the cell's exponentials),
  ``SLSTM_BWD_NO_DWX`` (the dwx stores), ``SLSTM_BWD_NO_SYNC`` (the block
  barrier), ``SLSTM_BWD_LOCAL`` (the partials each block sends to itself:
  no DSMEM traffic), and all of them (the skeleton); then one launch of
  the ``SLSTM_BWD_CLOCK`` build, whose warps of one block print their
  clock64 cycles a step in each phase (the loads and coefficients, the
  wait for the partials, the cell, the block barrier, the product and its
  st.async, the dwx stores).

``--parent DIR`` (a checkout of another commit, for example ``git
archive`` of the parent unpacked into a directory ``.gitignore`` lists)
also builds that tree's source as shipped and times it in turns with this
tree's shipped build, parent, change, change, parent, as ``tools/k1_ab.py``
does; the line says whether the two builds' outputs are equal bit for bit.
``--turns N`` times the builds N times, in turns. Also prints the launch of
S + 1 cluster barriers alone (``slstm_scan.barrier``), the latency floor.
Needs one CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

H, DH = 4, 256
#: mode -> (source, {build: its macros})
MODES = {
    "fwd": ("slstm_scan", {
        "shipped": (),
        "no_mma": ("SLSTM_NO_MMA",),
        "no_cell": ("SLSTM_NO_CELL",),
        "no_hs": ("SLSTM_NO_HS",),
        "local": ("SLSTM_LOCAL",),
        "skeleton": ("SLSTM_NO_MMA", "SLSTM_NO_CELL", "SLSTM_NO_HS", "SLSTM_LOCAL"),
    }),
    "states": ("slstm_scan", {
        "shipped": (),
        "no_saves": ("SLSTM_NO_SAVES",),
    }),
    "bwd": ("slstm_scan_bwd", {
        "shipped": (),
        "no_mma": ("SLSTM_BWD_NO_MMA",),
        "no_cell": ("SLSTM_BWD_NO_CELL",),
        "no_dwx": ("SLSTM_BWD_NO_DWX",),
        "no_sync": ("SLSTM_BWD_NO_SYNC",),
        "local": ("SLSTM_BWD_LOCAL",),
        "skeleton": ("SLSTM_BWD_NO_MMA", "SLSTM_BWD_NO_CELL", "SLSTM_BWD_NO_DWX",
                     "SLSTM_BWD_NO_SYNC", "SLSTM_BWD_LOCAL"),
        "clock": ("SLSTM_BWD_CLOCK",),
    }),
}


def build_all(out: Path, src: str, builds: dict, parent: Path | None) -> dict:
    """{build: library}: this tree's source under each build's macros and,
    with ``parent``, that tree's source as shipped (``"parent"``)."""
    from repro_torch.kernels import build
    out.mkdir(parents=True, exist_ok=True)
    jobs = {name: (build.CSRC / f"{src}.cu", macros) for name, macros in builds.items()}
    if parent is not None:
        jobs["parent"] = (parent.resolve() / "src" / "repro_torch" / "csrc" / f"{src}.cu", ())
    procs = {}
    for name, (cu, macros) in jobs.items():
        lib = out / f"lib{src}_{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *(f"-D{m}" for m in macros), "-o",
               str(lib), str(cu)]
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--states", action="store_true", help="the training forward")
    ap.add_argument("--bwd", action="store_true", help="the backward")
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another tree whose shipped source is timed in turns")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("slstm_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.kernels.build import BUILD_ROOT
    from repro_torch.kernels.timing import cuda_ms
    mode = "bwd" if args.bwd else "states" if args.states else "fwd"
    src, builds = MODES[mode]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_all(BUILD_ROOT / "breakdown", src, builds, args.parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(350)

    def inputs(B, S):
        wx = torch.randn(B, S, 4 * H * DH, generator=gen, device=dev).bfloat16()
        r = (torch.randn(H, DH, 4 * DH, generator=gen, device=dev) / DH ** 0.5).bfloat16()
        return wx, r, ref.slstm_state0(B, H, DH, dev)

    hook = "bwd_library" if mode == "bwd" else "library"
    if mode == "bwd":
        shapes = {}
        sets = []
        for _ in range(2):   # 128 MB of saved tensors each: two pass the L2
            wx, r, st0 = inputs(4, 1024)
            hs, _, saved = SL.slstm_scan(wx, r, st0, states=True)
            dhs = torch.randn(4, 1024, H, DH, generator=gen, device=dev).bfloat16()
            sets.append((r, st0, hs, saved, dhs))
        shapes[(4, 1024)] = sets
        fn, iters = SL._bwd, {1024: 10}
    elif mode == "states":
        shapes = {(4, 1024): [inputs(4, 1024) for _ in range(2)]}
        fn, iters = (lambda *a: SL.slstm_scan(*a, states=True)), {1024: 10}
    else:
        shapes = {(4, 1024): [inputs(4, 1024) for _ in range(2)],
                  (1, 1): [inputs(1, 1) for _ in range(32)]}
        fn, iters = SL.slstm_scan, {1024: 10, 1: 40}

    def timed(lib, sets, S):
        setattr(SL, hook, lib)
        try:
            return cuda_ms(fn, sets, iters=iters[S])
        finally:
            setattr(SL, hook, None)

    def outputs(lib, sets):
        setattr(SL, hook, lib)
        try:
            return fn(*sets[0])
        finally:
            setattr(SL, hook, None)

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for y in x for t in flat(y)]

    clock = libs.pop("clock", None)
    times = {(name, shape): [] for name in libs for shape in shapes}
    order = [n for n in libs if n != "parent"]
    if "parent" in libs:    # parent, change, change, parent, then the diagnostics
        order = ["parent", "shipped", "shipped", "parent"] + order[1:]
    for _ in range(args.turns):
        for name in order:
            for shape, sets in shapes.items():
                times[(name, shape)].append(timed(libs[name], sets, shape[1]))
    serving = {}
    if mode == "states":
        serving = {shape: cuda_ms(SL.slstm_scan, sets, iters=10)
                   for shape, sets in shapes.items()}
    for shape, sets in shapes.items():
        B, S = shape
        floor = cuda_ms(lambda *_: SL.barrier(B, S, H, DH, dev), sets[:1], iters=10)
        base = min(times[("shipped", shape)])
        what = {"fwd": "serving forward", "states": "training forward",
                "bwd": "backward"}[mode]
        print(f"{what} B{B} S{S} H{H} dh{DH} bf16 (best of {args.turns}, us a call; us a "
              f"step): barriers alone {floor * 1e3:.1f} ({floor * 1e3 / (S + 1):.3f})",
              flush=True)
        if mode == "states":
            t = serving[shape]
            print(f"  {'serving':9s} {t * 1e3:9.1f}  {t * 1e3 / S:7.3f}   (the shipped "
                  "serving launch)", flush=True)
        for name in libs:
            t = min(times[(name, shape)])
            every = " ".join(f"{v * 1e3:.1f}" for v in times[(name, shape)])
            print(f"  {name:9s} {t * 1e3:9.1f}  {t * 1e3 / S:7.3f}   saves "
                  f"{(base - t) * 1e3 / S:+.3f} a step   (each: {every})", flush=True)
        if "parent" in libs:
            same = all(torch.equal(a, b) for a, b in zip(flat(outputs(libs["shipped"], sets)),
                                                         flat(outputs(libs["parent"], sets))))
            print(f"  shipped and parent outputs equal bit for bit: {same}", flush=True)
    if clock is not None:   # the device's printf lines reach stdout at the synchronize
        sys.stdout.flush()
        outputs(clock, next(iter(shapes.values())))
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
