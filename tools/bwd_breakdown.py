#!/usr/bin/env python3
"""Where K1's bf16 backward kernels' time goes, on one NVIDIA GPU.

    python3 tools/bwd_breakdown.py

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` as shipped and with
each of its diagnostic macros (``-D``; one ``nvcc`` each, in parallel, into
``src/repro_torch/_build/breakdown/``), then, at granite-3-2b's training
shape (bf16 B4 H32 K8 S1024 D64, causal, on the forward's own output and
logsumexp, inputs rotated through more than the L2), times each build's dQ
launch and dK/dV launch alone (CUDA-graph replay, ``kernels/timing.cuda_ms``):

- ``base``: the kernels as shipped;
- ``dq2``: ``BWD_DQ_WGS=2``, the dQ kernel on two consumer warpgroups
  (128 query rows a block) instead of three;
- ``noexp``: ``BWD_NOEXP``, P taken as its exponent's argument, no mask:
  the exponentials' and the mask's share;
- ``nosecond``: ``BWD_NOSECOND``, no dQ += dS K and no dV, dK products:
  the second products' share.

Beside them: ptxas's registers at launch, spills and its notes on wgmma
(C75xx) for each build's bf16 kernels, and the shipped build's gradients
against the plain version. The other builds' outputs are wrong by design
(``dq2`` aside). Exits 1 with no CUDA device.
"""
from __future__ import annotations

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
            "nosecond": ("BWD_NOSECOND",)}
SHAPE = (4, 32, 8, 1024, 64)   # granite-3-2b's training shape: B, H, K, S, D


def ptxas_notes(log: str) -> list[str]:
    """Registers, spills and C75xx notes of the bf16 kernels in a ``-v`` log."""
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(dq|dkdv)_bf16_kernelILi(\d+)", line)
        if m:
            kernel = f"{m.group(1)} D{m.group(2)}"
        elif "Compiling entry function" in line:
            kernel = None
        elif kernel and ("Used" in line or "spill" in line):
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        m = re.search(r"\((C75\d\d)\) (.*?) in (?:the )?function "
                      r"'\w*?(dq|dkdv)_bf16_kernelILi(\d+)", re.sub(r" around line \d+", "", line))
        if m:
            out.append(f"{m.group(3)} D{m.group(4)}: {m.group(1)} {m.group(2)}")
    return sorted(set(out))


def main() -> int:
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
    for name, macros in VARIANTS.items():
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
        fn = ctypes.CDLL(str(out_dir / f"lib_{name}.so")).repro_flash_attention_bwd
        fn.argtypes, fn.restype = FA._bind_bwd().argtypes, ctypes.c_int
        fns[name] = fn

    B, H, K, S, D = SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    sets = []
    for _ in range(4):   # 4 x ~50 MB: each call finds its inputs cold, as a layer does
        q, k, v = (randn(B, S, n, D).transpose(1, 2) for n in (H, K, K))
        o, lse = FA.flash_attention(q, k, v, lse=True)
        do = randn(B, H, S, D)
        sets.append((q, k, v, o, lse, do, FA._bwd(q, k, v, o, lse, do)[3]))

    def launch(fn, kernel):
        def call(q, k, v, o, lse, do, dr):
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            delta = torch.empty_like(dr) if kernel == 1 else dr
            strides = (FA._I64 * 24)(*[s for x in (q, k, v, o, do, dq, dk, dv)
                                       for s in x.stride()[:3]])
            ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, delta, dq, dk, dv)]
            build.check(fn(kernel, *ptrs, B, H, K, S, D, strides, 0, 1,
                           torch.cuda.current_stream().cuda_stream), "bwd_breakdown")
            return dq, dk, dv
        return call

    q, k, v, o, lse, do, dr = sets[0]
    dq = launch(fns["base"], 1)(*sets[0])[0]
    _, dk, dv = launch(fns["base"], 2)(*sets[0])
    want = ref.flash_attention_bwd(q, k, v, o, lse, do)
    print("[base] max|a-b|/max|b| " + ", ".join(
        f"{n} {CS.rel(a.float(), b.float()):.3e}" for n, a, b in zip(("dq", "dk", "dv"),
                                                                     (dq, dk, dv), want)))
    for name, fn in fns.items():
        print(f"[time] {name}: dQ {cuda_ms(launch(fn, 1), sets) * 1e3:.1f} us, dK/dV "
              f"{cuda_ms(launch(fn, 2), sets) * 1e3:.1f} us (bf16 B{B} H{H} K{K} S{S} D{D}, "
              f"causal, CUDA-graph replay)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
