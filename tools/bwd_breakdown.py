#!/usr/bin/env python3
"""Where K1's bf16 backward kernels' time goes, on one NVIDIA GPU.

    python3 tools/bwd_breakdown.py [--shape granite|qwen|minicpm3] [--only base,noload,...]

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` as shipped and with
each of its diagnostic macros (``-D``; one ``nvcc`` each, in parallel, into
``src/repro_torch/_build/breakdown/``), then, at a training shape
(``granite``, the default: granite-3-2b's bf16 B4 H32 K8 S1024 D64;
``qwen``: qwen2.5-14b's B4 H40 K8 S1024 D128, the head-dim-128 kernels;
``minicpm3``: minicpm3-4b's B4 H40 K40 S1024, q and k at 96, each build
timed twice, V at its 64 columns and V zero-padded to 96, the design of
head dim 96 on 128's tiles), causal, on the forward's own output and
logsumexp, inputs rotated through more than the L2, times each build's dQ
launch and dK/dV launch alone (CUDA-graph replay, ``kernels/timing.cuda_ms``):

- ``base``: the kernels as shipped;
- ``dq2``: ``BWD_DQ_WGS=2``, the dQ kernel on two consumer warpgroups
  (128 query rows a block) instead of three;
- ``noexp``: ``BWD_NOEXP``, P taken as its exponent's argument, no mask:
  the exponentials' and the mask's share;
- ``nosecond``: ``BWD_NOSECOND``, no dQ += dS K and no dV, dK products:
  the second products' share;
- ``noload``: ``BWD_NOLOAD``, the head-dim-128 dQ kernel
  (``dq_d128_kernel``, ``--shape qwen``) loads no K or V tile after each
  ring slot's first (the slot's data is reused): what the tiles' loads
  cost it;
- ``nostore``: ``BWD_NOSTORE``, that kernel stores no dQ (with no output
  read, ptxas may drop the products behind it, so this overstates the
  stores' share);
- ``order0``, ``order2``: ``K1_ORDER=0`` / ``2``, the persistent dQ
  kernel's tiles and the dK/dV grid's blocks heaviest first over every
  head, or grouped by head at every G (``csrc/hopper.cuh``: the shipped
  rule groups them at G = 1 only). At ``minicpm3``, ``order0`` with V
  padded is the design before the widths and the order, ``base`` with V
  padded the order alone, ``order0`` with V at 64 the widths alone.

Beside them: ptxas's registers at launch, spills and its notes on wgmma
(C75xx) for each build's bf16 kernels, and the shipped build's gradients
against the plain version. The other builds' outputs are wrong by design
(``dq2`` aside; it acts on ``dq_bf16_kernel`` at D <= 64 only, so at
``qwen`` it is ``base``). At head dim 128 dQ is ``dq_d128_kernel``, on
which ``noexp``, ``nosecond``, ``noload`` and ``nostore`` act as well. Last, SDPA's backward at the same shape, the
yardstick (``chip_smoke.sdpa_bwd_yardstick``: CUDA events, and the
profiler in a fresh process). Exits 1 with no CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: build name -> the macros it defines
VARIANTS = {"base": (), "dq2": ("BWD_DQ_WGS=2",), "noexp": ("BWD_NOEXP",),
            "nosecond": ("BWD_NOSECOND",), "noload": ("BWD_NOLOAD",),
            "nostore": ("BWD_NOSTORE",), "order0": ("K1_ORDER=0",),
            "order2": ("K1_ORDER=2",)}
#: training shapes: B, H, K, S, D, and V's widths each build is timed at
SHAPES = {"granite": (4, 32, 8, 1024, 64, (64,)), "qwen": (4, 40, 8, 1024, 128, (128,)),
          "minicpm3": (4, 40, 40, 1024, 96, (64, 96))}
#: the bf16 kernels, by their mangled names' stems
KERNELS = r"(dq_bf16_kernel|dkdv_bf16_kernel|dq_d128_kernel)((?:I?Li\d+E)*)"


def _name(m) -> str:
    return m.group(1) + ("<" + ", ".join(re.findall(r"Li(\d+)E", m.group(2))) + ">"
                         if m.group(2) else "")


def ptxas_notes(log: str) -> list[str]:
    """Registers, spills and C75xx notes of the bf16 kernels in a ``-v`` log."""
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(rf"Compiling entry function '\w*?{KERNELS}", line)
        if m:
            kernel = _name(m)
        elif "Compiling entry function" in line:
            kernel = None
        elif kernel and ("Used" in line or "spill" in line):
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        m = re.search(rf"\((C75\d\d)\) (.*?) in (?:the )?function '\w*?{KERNELS}",
                      re.sub(r" around line \d+", "", line))
        if m:
            out.append(f"{_name(re.search(KERNELS, m.group(0)))}: {m.group(1)} {m.group(2)}")
    return sorted(set(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="granite")
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated builds to make and time (default: all; "
                         "base is always built)")
    args = ap.parse_args()
    names = ["base"] + [n for n in args.only.split(",") if n and n != "base"]
    if unknown := [n for n in names if n not in VARIANTS]:
        ap.error(f"unknown builds {unknown}; known: {sorted(VARIANTS)}")
    import torch
    if not torch.cuda.is_available():
        print("bwd_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.timing import cuda_ms

    print(CS.card_line(), flush=True)
    out_dir = build.BUILD_ROOT / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        macros = VARIANTS[name]
        cmd = build.nvcc_command("flash_attention_bwd", out_dir / f"lib_{name}.so",
                                 build.nvcc_path())
        cmd[1:1] = ["-Xptxas", "-v", *(f"-D{m}" for m in macros)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for note in ptxas_notes(log):
            print(f"[ptxas] {name} {note}", flush=True)
        fn = ctypes.CDLL(str(out_dir / f"lib_{name}.so")).repro_flash_attention_bwd_v
        fn.argtypes, fn.restype = FA._bind_bwd().argtypes, ctypes.c_int
        fns[name] = fn

    B, H, K, S, D, widths = SHAPES[args.shape]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def launch(fn, kernel, Dv):
        def call(q, k, v, o, lse, do, dr):
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            delta = torch.empty_like(dr) if kernel == 1 else dr
            strides = (FA._I64 * 24)(*[s for x in (q, k, v, o, do, dq, dk, dv)
                                       for s in x.stride()[:3]])
            ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, delta, dq, dk, dv)]
            build.check(fn(kernel, *ptrs, B, H, K, S, D, Dv, strides, 0, 1,
                           torch.cuda.current_stream().cuda_stream), "bwd_breakdown")
            return dq, dk, dv
        return call

    for Dv in widths:
        # V (and O, dO) at Dv: a slice of the model's [B,S,K,Dv'] row, or the
        # first Dv' columns zero-padded to D as the reference pads MLA's V
        sets = []
        for _ in range(4):   # 4 x ~50 MB: each call finds its inputs cold, as a layer does
            q, k = (randn(B, S, n, D).transpose(1, 2) for n in (H, K))
            v = randn(B, S, K, widths[0]).transpose(1, 2)
            if Dv != v.shape[-1]:
                v = torch.nn.functional.pad(v, (0, Dv - v.shape[-1]))
            o, lse = FA.flash_attention(q, k, v, lse=True)
            do = randn(B, H, S, Dv)
            sets.append((q, k, v, o, lse, do, FA._bwd(q, k, v, o, lse, do)[3]))
        q, k, v, o, lse, do, dr = sets[0]
        dq = launch(fns["base"], 1, Dv)(*sets[0])[0]
        _, dk, dv = launch(fns["base"], 2, Dv)(*sets[0])
        want = ref.flash_attention_bwd(q, k, v, o, lse, do)
        print(f"[base] V at {Dv}: max|a-b|/max|b| " + ", ".join(
            f"{n} {CS.rel(a.float(), b.float()):.3e}" for n, a, b in zip(("dq", "dk", "dv"),
                                                                         (dq, dk, dv), want)))
        for name, fn in fns.items():
            err = CS.rel(launch(fn, 1, Dv)(*sets[0])[0].float(), want[0].float())
            print(f"[time] {name}: dQ {cuda_ms(launch(fn, 1, Dv), sets) * 1e3:.1f} us, dK/dV "
                  f"{cuda_ms(launch(fn, 2, Dv), sets) * 1e3:.1f} us (bf16 B{B} H{H} K{K} S{S} "
                  f"D{D} Dv{Dv}, causal, CUDA-graph replay); dq max|a-b|/max|b| {err:.3e}",
                  flush=True)
        del sets
    CS.sdpa_bwd_profiles([(B, H, K, S, D, Dv) for Dv in widths])
    for Dv in widths:
        CS.sdpa_bwd_yardstick(B, H, K, S, D, Dv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
