#!/usr/bin/env python3
"""Where the bf16 GLA kernels' time goes, on one NVIDIA GPU.

    python3 tools/gla_breakdown.py

Builds ``src/repro_torch/csrc/gla_chunk.cu`` as shipped and with each of
its diagnostic macros (``-D``; one ``nvcc`` each, in parallel, into
``src/repro_torch/_build/breakdown/``), then, at hymba-1.5b's serving
shape (bf16 B4 S1536 H25 N16 P64, chunk 256, head-stride-0 q/k, inputs
rotated through more than the L2), runs each build through the wrappers
(``kernels.gla_chunk.library``) and prints the device time per call of K4
(``gla_chunk``), K5's phase A and phase B (CUDA-graph replay,
``kernels/timing.cuda_ms``):

- ``base``: the kernels as shipped (32-column slices of P);
- ``pw16``: ``GLA_PW=16``, the same kernels on 16-column slices (twice
  the blocks, less shared memory a block, ptxas held to 3 blocks an SM);
- ``loadonly``: ``GLA_LOADONLY``, each chunk's (or item's) loads, barrier
  and nothing else: the staging pipeline's own time;
- ``noexp``: ``GLA_NOEXP``, every ``ex2`` returning its argument: the
  SFU's share;
- ``clock``: ``GLA_CLOCK``, one K4 block's phases at one chunk in
  ``clock64`` cycles, per warp (the next chunk's loads and the barrier,
  the intra rows, the delta, the partials with the next cumsum, the state
  with the next decays).

Beside them: a device copy of v (the bytes' yardstick) and, for ``base``
and ``pw16``, ptxas's registers and spills, the shared memory a block and
the blocks an SM that both allow, and each kernel's output against its
plain version. The other builds' outputs are wrong by design. Exits 1
with no CUDA device.

The GLA backward (K4b, ``gla_chunk_bwd``) at hymba-1.5b's training shape
(the same shape, with dy and K4's chunk start states; q and k as the
rows the heads share) runs through the
same builds: ``base`` (held to ``ref.gla_bwd``), ``loadonly`` (each
launch's loads and the waits on them, nothing else), ``noexp`` and
``clock`` (one block's phases in ``clock64`` cycles, as the source's
``GLA_CLOCK`` prints them), each timed as the whole call (CUDA-graph
replay) with each of its kernels' profiler time per call, and ptxas's
registers and spills of its bf16 kernels. ``--only fwd`` or ``--only
bwd`` runs one half. ``--groups 3,5,8`` also times the shipped K4b with
each of those heads a block of its dq and dk/dv launches in place of
``head_group``'s choice (the tool swaps the module's ``head_group`` for the
sweep and puts it back after).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: build name -> the macros it defines
VARIANTS = {
    "base": (),
    "pw16": ("GLA_PW=16",),
    "loadonly": ("GLA_LOADONLY",),
    "noexp": ("GLA_NOEXP",),
    "clock": ("GLA_CLOCK",),
}
#: the builds whose outputs are right, held to the plain versions
EXACT = ("base", "pw16")
SHAPE = (4, 1536, 25, 16, 64, 256)   # hymba-1.5b's SSD heads: B, S, H, N, P, chunk
REGS_PER_SM, SMEM_PER_SM, THREADS = 65536, 233472, 256
KERNELS = (("gla_chunk_kernel", "chunk"), ("gla_phase_a_kernel", "phase_a"),
           ("gla_phase_b_kernel", "phase_b"))
#: the backward's bf16 kernels, in launch order, by the name prefix ptxas
#: and the profiler show
BWD_KERNELS = ("gla_bwd_kernel", "gla_bwd_state_kernel", "gla_bwd_dq_kernel",
               "gla_bwd_dkdv_kernel", "gla_bwd_finish_kernel")


def ptxas_resources(log):
    """{kernel: (registers, spill line)} for the bf16 <16, 64> kernels in
    an ``nvcc -Xptxas -v`` log."""
    out, kernel = {}, None
    names = [k for k, _ in KERNELS] + list(BWD_KERNELS)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            continue
        if not (kernel and "bfloat16" in kernel and "ILi16ELi64E" in kernel):
            continue
        short = next((k for k in names if k + "I" in kernel), None)
        if short is None:
            continue
        regs, spill = out.get(short, (0, "no spill line"))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        out[short] = (regs, spill)
    return out


def build(out_dir):
    """One nvcc per build, in parallel; returns ({name: library path},
    {name: ptxas resources})."""
    from repro_torch.kernels import build as B
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, macros in VARIANTS.items():
        procs[name] = subprocess.Popen(
            [B.nvcc_path(), *B.NVCC_FLAGS, *(f"-D{m}" for m in macros), "-Xptxas", "-v",
             "-o", str(out_dir / f"lib{name}.so"), str(B.CSRC / "gla_chunk.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    res = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on build {name}:\n{log[-4000:]}")
        res[name] = ptxas_resources(log)
    return {n: out_dir / f"lib{n}.so" for n in VARIANTS}, res


def bwd_breakdown(libs, regs, GC, ref, cuda_ms, kernel_us, rn, groups=()):
    """K4b through each build at hymba's training shape (module
    docstring)."""
    import torch
    Bn, S, H, N, P, C = SHAPE
    sets = []
    for _ in range(4):                          # 4 x 62 MB, more than the L2
        q, k, v, lg = rn()
        GC.library = libs["base"]
        st = GC.gla_chunk(q, k, v, lg, chunk=C, starts=True)[2]
        # q and k as the rows the heads share (the SSD mixer's C_t and B_t)
        sets.append((q[:, :, 0], k[:, :, 0], v, lg, v.clone().normal_(), st))
    q, k, v, lg, dy, st = sets[0]
    want = ref.gla_bwd(q, k, v, lg, dy, st, chunk=C)

    def call(q, k, v, lg, dy, st):
        return GC.gla_chunk_bwd(q, k, v, lg, dy, st, chunk=C)

    for name, r in regs.items():
        for kernel in BWD_KERNELS:
            if kernel in r and name in ("base", "noexp"):
                print(f"[ptxas {name}] {kernel}<16, 64> bf16: {r[kernel][0]} registers; "
                      f"{r[kernel][1]}", flush=True)
    GC.library = libs["base"]
    shipped = GC.head_group
    for hg in groups:
        GC.head_group = lambda *_, hg=hg: hg
        try:
            ms = cuda_ms(call, sets)
            us = {key: t for key, t in kernel_us(call, sets, iters=20).items() if "gla_" in key}
        finally:
            GC.head_group = shipped
        parts = ", ".join(f"{next((k for k in BWD_KERNELS if k + '<' in key), key[:40])} "
                          f"{t:.1f} us" for key, t in us.items())
        print(f"[bwd groups of {hg}] {ms * 1e3:.1f} us a call; profiler per call: {parts}",
              flush=True)
    for name in ("base", "loadonly", "noexp", "clock", "base"):
        GC.library = libs[name]
        if name == "clock":
            call(*sets[0])
            torch.cuda.synchronize()
            continue
        if name == "base":
            got = call(*sets[0])
            err = " ".join(
                f"{n} {((a.float() - b.float()).abs().max() / b.float().abs().max()).item():.3e}"
                for n, a, b in zip(("dq", "dk", "dv", "dlg"), got, want))
            print(f"[bwd {name}] against ref.gla_bwd, max|a-b|/max|b|: {err}", flush=True)
        ms = cuda_ms(call, sets)
        us = {key: t for key, t in kernel_us(call, sets, iters=20).items() if "gla_" in key}
        parts = ", ".join(f"{next((k for k in BWD_KERNELS if k + '<' in key), key[:40])} "
                          f"{t:.1f} us" for key, t in us.items())
        print(f"[bwd {name}] K4b bf16 B{Bn} S{S} H{H} N{N} P{P} chunk {C}: "
              f"{ms * 1e3:.1f} us a call; profiler per call: {parts}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("fwd", "bwd"), default=None,
                    help="run only the forward kernels' or the backward's part")
    ap.add_argument("--groups", default="",
                    help="comma-separated heads a block of K4b's dq and dk/dv, each timed")
    args = ap.parse_args()
    groups = [int(x) for x in args.groups.split(",") if x]
    import torch
    if not torch.cuda.is_available():
        print("gla_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from repro_torch.kernels import build as B
    from repro_torch.kernels import gla_chunk as GC
    from repro_torch.kernels import ref
    from repro_torch.kernels.timing import cuda_ms
    sys.path.insert(0, str(ROOT))
    from chip_smoke import kernel_us

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    libs, regs = build(B.BUILD_ROOT / "breakdown")
    print(f"[build] {len(libs)} builds in {time.perf_counter() - t0:.1f}s", flush=True)

    Bn, S, H, N, P, C = SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs():
        def rn(*s):
            return torch.randn(s, generator=gen, device=dev)
        v = rn(Bn, S, H, P).bfloat16()
        lg = -F.softplus(rn(Bn, S, H)) * 0.3
        row = rn(Bn, S, H * P + 2 * N)
        row[..., H * P:H * P + N] *= 0.3
        row = row.bfloat16()
        k = row[..., H * P:H * P + N, None].transpose(-1, -2).expand(Bn, S, H, N)
        q = row[..., H * P + N:, None].transpose(-1, -2).expand(Bn, S, H, N)
        return q, k, v, lg

    if args.only == "bwd":
        try:
            bwd_breakdown(libs, regs, GC, ref, cuda_ms, kernel_us, inputs, groups)
        finally:
            GC.library = None
        return 0
    sets = [inputs() for _ in range(4)]          # 160 MB, more than the L2
    outs = [torch.empty_like(s[2]) for s in sets]
    copy = cuda_ms(lambda v, o: o.copy_(v), [(s[2], o) for s, o in zip(sets, outs)])
    done = set()
    print(f"[copy] device copy of v ({sets[0][2].numel() * 2 / 1e6:.1f} MB read and written): "
          f"{copy * 1e3:.1f} us", flush=True)
    q, k, v, lg = sets[0]
    want, _ = ref.chunked_gla(q, k, v, lg, chunk=C)
    pa, pg, pd = ref.gla_phase_a(q, k, v, lg, chunk=C)
    pstart, _ = ref.gla_scan(pg, pd)
    want_b = ref.gla_phase_b(q, lg, pstart, pa, chunk=C)

    def score(a, b):
        return ((a.float() - b.float()).abs() / (1 + b.float().abs())).max().item()

    try:
        # base and pw16 twice, in the order A B ... B A, to see drift
        for name in ("base", "pw16", "loadonly", "noexp", "clock", "pw16", "base"):
            GC.library = libs[name]
            if name == "clock":
                GC.gla_chunk(q, k, v, lg, chunk=C)
                torch.cuda.synchronize()
                continue
            if name in EXACT and name not in done:
                for kernel, kind in KERNELS:
                    r, spill = regs[name].get(kernel, (0, "not reported"))
                    smem = GC.smem_bytes(C, N, P, kind, torch.bfloat16)
                    per_sm = min(REGS_PER_SM // max(r * THREADS, 1),
                                 SMEM_PER_SM // (smem + 1024))
                    print(f"[ptxas {name}] {kernel}<16, 64> bf16: {r} registers; {spill}; "
                          f"{smem} B shared; {per_sm} blocks ({per_sm * THREADS // 32} warps) "
                          "an SM at most", flush=True)
                print(f"[{name}] against the plain versions, max |a-b|/(1+|b|): K4 "
                      f"{score(GC.gla_chunk(q, k, v, lg, chunk=C)[0], want):.3e}, phase A "
                      f"{score(GC.gla_phase_a(q, k, v, lg, chunk=C)[0], pa):.3e}, phase B "
                      f"{score(GC.gla_phase_b(q, lg, pstart, pa, chunk=C), want_b):.3e}",
                      flush=True)
            done.add(name)
            k4 = cuda_ms(lambda q, k, v, lg: GC.gla_chunk(q, k, v, lg, chunk=C), sets)
            ka = cuda_ms(lambda q, k, v, lg: GC.gla_phase_a(q, k, v, lg, chunk=C), sets)
            bsets = []
            for q_, k_, v_, lg_ in sets:
                yi, g, d = GC.gla_phase_a(q_, k_, v_, lg_, chunk=C)
                bsets.append((q_, lg_, GC.scan_chunks(g, d)[0], yi))
            kb = cuda_ms(lambda q, lg, st, yi: GC.gla_phase_b(q, lg, st, yi, chunk=C), bsets)
            print(f"[{name}] K4 {k4 * 1e3:.1f} us, phase A {ka * 1e3:.1f} us, "
                  f"phase B {kb * 1e3:.1f} us", flush=True)
            del bsets
        if args.only is None:
            del sets, outs
            bwd_breakdown(libs, regs, GC, ref, cuda_ms, kernel_us, inputs, groups)
    finally:
        GC.library = None
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
