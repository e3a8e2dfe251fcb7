#!/usr/bin/env python3
"""K1's forward and backward against another tree's build of the same
kernels, in one process on one NVIDIA GPU.

    python3 tools/k1_ab.py --parent DIR [--rows fwd,bwd] [--reps 2]

``DIR`` is a checkout of another commit (for example ``git archive`` of the
parent unpacked into a directory ``.gitignore`` lists). Its
``src/repro_torch/csrc/flash_attention.cu`` and ``flash_attention_bwd.cu``
are built with ``nvcc`` into ``src/repro_torch/_build/ab/`` (in parallel),
this tree's through ``kernels.build``. Each row of ``PERF.md``'s table of
K1 is then timed in turns, parent, change, change, parent (``--reps``
rounds of the pair), by CUDA-graph replay over inputs rotated through more
than the L2 (``kernels/timing.cuda_ms``), with SDPA (forward rows) at the
same shape beside them:

- forward: rows 1 (granite-3-2b's prefill, B4 H32 K8 S1024 D64), 1h
  (hymba-1.5b's, B4 H25 K5 S1536 D64, window 1024 and none), 1m
  (minicpm-2b's, B4 H36 K36 S1024 D64), 1q (qwen2.5-14b's, B4 H40 K8
  S1024 D128), each build through ``kernels.flash_attention.library``;
- backward, each of its two launches alone: rows 1b (granite's training
  shape), 1bh (hymba's, both masks), 1bq (qwen's), through each build's C
  entry ``repro_flash_attention_bwd`` (kernel 1: dQ and the row sums, 2:
  dK/dV).

Every row also holds this tree's output to the plain version (max |a - b|
over max |b|) and says whether the two builds' outputs are equal bit for
bit. Exits 1 with no CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: row -> (B, H, K, S, D, window)
FWD_ROWS = {"1 granite-3-2b": (4, 32, 8, 1024, 64, None),
            "1h hymba-1.5b window 1024": (4, 25, 5, 1536, 64, 1024),
            "1h hymba-1.5b global": (4, 25, 5, 1536, 64, None),
            "1m minicpm-2b": (4, 36, 36, 1024, 64, None),
            "1q qwen2.5-14b": (4, 40, 8, 1024, 128, None)}
BWD_ROWS = {"1b granite-3-2b": (4, 32, 8, 1024, 64, None),
            "1bh hymba-1.5b window 1024": (4, 25, 5, 1536, 64, 1024),
            "1bh hymba-1.5b global": (4, 25, 5, 1536, 64, None),
            "1bq qwen2.5-14b": (4, 40, 8, 1024, 128, None)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other tree (its src/repro_torch/csrc is built)")
    ap.add_argument("--rows", default="fwd,bwd", help="fwd, bwd or both (default)")
    ap.add_argument("--reps", type=int, default=2, help="rounds of parent, change (default 2)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.timing import cuda_ms

    print(CS.card_line(), flush=True)
    out = build.BUILD_ROOT / "ab"
    out.mkdir(parents=True, exist_ok=True)
    csrc = args.parent.resolve() / "src" / "repro_torch" / "csrc"
    procs = {name: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("flash_attention", "flash_attention_bwd")}
    build.build_all()
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n{log}")
    rows = args.rows.split(",")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def views(B, H, K, S, D):
        # the model's [B,S,n,D] projections seen as [B,n,S,D]
        return tuple(torch.randn(B, S, n, D, generator=gen, device=dev).bfloat16()
                     .transpose(1, 2) for n in (H, K, K))

    def turns(fns):
        """{name: [ms, ...]} over reps rounds of parent, change, change, parent."""
        ms = {"parent": [], "change": []}
        for _ in range(args.reps):
            for name in ("parent", "change", "change", "parent"):
                ms[name].append(fns[name]())
        return ms

    def fmt(ms):
        return ", ".join(f"{n} " + " ".join(f"{t * 1e3:.1f}" for t in v) for n, v in ms.items())

    if "fwd" in rows:
        parent = out / "libflash_attention.so"
        for row, (B, H, K, S, D, w) in FWD_ROWS.items():
            sets = [views(B, H, K, S, D) for _ in range(4)]
            q, k, v = sets[0]
            got = FA.flash_attention(q, k, v, window=w)
            FA.library = parent
            try:
                same = torch.equal(got, FA.flash_attention(q, k, v, window=w))
            finally:
                FA.library = None
            err = CS.rel(got.float(), ref.naive_attention(q, k, v, window=w).float())

            def timed(lib):
                def call():
                    FA.library = lib
                    try:
                        return cuda_ms(lambda q, k, v: FA.flash_attention(q, k, v, window=w),
                                       sets, iters=40)
                    finally:
                        FA.library = None
                return call
            ms = turns({"parent": timed(parent), "change": timed(None)})
            if w:
                pos = torch.arange(S, device=dev)
                mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < w)
                lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True), sets, iters=40)
            else:
                lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), sets, iters=40)
            print(f"[ab] fwd {row} (bf16 B{B} H{H} K{K} S{S} D{D} window={w}, "
                  f"{FA.fwd_kernel(torch.bfloat16, D, H // K, w)}): {fmt(ms)} us; sdpa "
                  f"{lib * 1e3:.1f} us; change max|a-b|/max|b| {err:.3e}; outputs equal bit "
                  f"for bit {same}", flush=True)
            del sets, got

    if "bwd" in rows:
        fns = {"change": FA._bind_bwd()}
        fns["parent"] = ctypes.CDLL(str(out / "libflash_attention_bwd.so")).repro_flash_attention_bwd
        fns["parent"].argtypes, fns["parent"].restype = fns["change"].argtypes, ctypes.c_int
        for row, (B, H, K, S, D, w) in BWD_ROWS.items():
            sets = []
            for _ in range(4):
                q, k, v = views(B, H, K, S, D)
                o, lse = FA.flash_attention(q, k, v, window=w, lse=True)
                do = torch.randn(B, H, S, D, generator=gen, device=dev).bfloat16()
                sets.append((q, k, v, o, lse, do, FA._bwd(q, k, v, o, lse, do, window=w)[3]))

            def launch(fn, kernel):
                def call(q, k, v, o, lse, do, dr):
                    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                    delta = torch.empty_like(dr) if kernel == 1 else dr
                    strides = (FA._I64 * 24)(*[s for x in (q, k, v, o, do, dq, dk, dv)
                                               for s in x.stride()[:3]])
                    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, delta, dq, dk, dv)]
                    build.check(fn(kernel, *ptrs, B, H, K, S, D, strides, w or 0, 1,
                                   torch.cuda.current_stream().cuda_stream), "k1_ab")
                    return dq, dk, dv, delta
                return call
            q, k, v, o, lse, do, dr = sets[0]
            a = launch(fns["change"], 1)(*sets[0])
            b = launch(fns["parent"], 1)(*sets[0])
            same = torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])
            err = CS.rel(a[0].float(), ref.attention_bwd_dq(q, k, v, lse, do, dr,
                                                            window=w).float())
            for kernel, part in ((1, "dQ"), (2, "dK/dV")):
                ms = turns({n: (lambda n=n: cuda_ms(launch(fns[n], kernel), sets))
                            for n in ("parent", "change")})
                note = (f"; change dq max|a-b|/max|b| {err:.3e}; dq and row sums equal bit for "
                        f"bit {same}") if kernel == 1 else ""
                print(f"[ab] bwd {row} {part} (bf16 B{B} H{H} K{K} S{S} D{D} window={w}): "
                      f"{fmt(ms)} us{note}", flush=True)
            del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
