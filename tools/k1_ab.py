#!/usr/bin/env python3
"""K1's forward and backward against another tree's build of the same
kernels, in one process on one NVIDIA GPU.

    python3 tools/k1_ab.py --parent DIR [--rows fwd,bwd] [--only 1c,1bc] [--reps 2]

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
  S1024 D128), 1l (llava-next-34b's, B4 H56 K8 S1024 D128), 1e
  (granite-moe-3b-a800m's, B4 H24 K8 S1024 D64) and 1c (minicpm3-4b's, B4
  H40 K40 S1024, q and k at 96, V at 64), each build through
  ``kernels.flash_attention.library``;
- backward, each of its two launches alone: rows 1b (granite's training
  shape), 1bh (hymba's, both masks), 1bq (qwen's), 1bl (llava's), 1be
  (granite-moe's) and 1bc (minicpm3's), through each build's C entry
  (``repro_flash_attention_bwd_v`` of this tree, ``repro_flash_attention_bwd``
  of the parent; kernel 1: dQ and the row sums, 2: dK/dV).

At 1c and 1bc the parent is fed V (and O, dO) zero-padded to 96, as the
model padded them before this tree took V at its own 64 columns; O and dV
are compared on their first 64 columns, and SDPA is read in both forms.
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

#: row -> (B, H, K, S, D, window, Dv)
FWD_ROWS = {"1 granite-3-2b": (4, 32, 8, 1024, 64, None, 64),
            "1h hymba-1.5b window 1024": (4, 25, 5, 1536, 64, 1024, 64),
            "1h hymba-1.5b global": (4, 25, 5, 1536, 64, None, 64),
            "1m minicpm-2b": (4, 36, 36, 1024, 64, None, 64),
            "1q qwen2.5-14b": (4, 40, 8, 1024, 128, None, 128),
            "1l llava-next-34b": (4, 56, 8, 1024, 128, None, 128),
            "1e granite-moe-3b-a800m": (4, 24, 8, 1024, 64, None, 64),
            "1c minicpm3-4b": (4, 40, 40, 1024, 96, None, 64)}
BWD_ROWS = {"1b granite-3-2b": (4, 32, 8, 1024, 64, None, 64),
            "1bh hymba-1.5b window 1024": (4, 25, 5, 1536, 64, 1024, 64),
            "1bh hymba-1.5b global": (4, 25, 5, 1536, 64, None, 64),
            "1bq qwen2.5-14b": (4, 40, 8, 1024, 128, None, 128),
            "1bl llava-next-34b": (4, 56, 8, 1024, 128, None, 128),
            "1be granite-moe-3b-a800m": (4, 24, 8, 1024, 64, None, 64),
            "1bc minicpm3-4b": (4, 40, 40, 1024, 96, None, 64)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other tree (its src/repro_torch/csrc is built)")
    ap.add_argument("--rows", default="fwd,bwd", help="fwd, bwd or both (default)")
    ap.add_argument("--only", default="",
                    help="comma-separated row numbers (1c, 1bq, ...; default: all)")
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
    only = {r for r in args.only.split(",") if r}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def views(B, H, K, S, D, Dv):
        # the model's [B,S,n,D] projections seen as [B,n,S,D]; V at Dv
        return tuple(torch.randn(B, S, n, d, generator=gen, device=dev).bfloat16()
                     .transpose(1, 2) for n, d in ((H, D), (K, D), (K, Dv)))

    def pad(x, D):
        # x's columns zero-padded to D, as the model padded MLA's V
        return x if x.shape[-1] == D else F.pad(x, (0, D - x.shape[-1]))

    def turns(fns):
        """{name: [ms, ...]} over reps rounds of parent, change, change, parent."""
        ms = {"parent": [], "change": []}
        for _ in range(args.reps):
            for name in ("parent", "change", "change", "parent"):
                ms[name].append(fns[name]())
        return ms

    def fmt(ms):
        return ", ".join(f"{n} " + " ".join(f"{t * 1e3:.1f}" for t in v) for n, v in ms.items())

    def wanted(row):
        return not only or row.split()[0] in only

    if "fwd" in rows:
        parent = out / "libflash_attention.so"
        for row, (B, H, K, S, D, w, Dv) in FWD_ROWS.items():
            if not wanted(row):
                continue
            sets = [views(B, H, K, S, D, Dv) for _ in range(4)]
            psets = [(q, k, pad(v, D)) for q, k, v in sets]   # the parent's V
            q, k, v = sets[0]
            got = FA.flash_attention(q, k, v, window=w)
            FA.library = parent
            try:
                same = torch.equal(got, FA.flash_attention(*psets[0], window=w)[..., :Dv])
            finally:
                FA.library = None
            err = CS.rel(got.float(), ref.naive_attention(q, k, v, window=w).float())

            def timed(lib, ins):
                def call():
                    FA.library = lib
                    try:
                        return cuda_ms(lambda q, k, v: FA.flash_attention(q, k, v, window=w),
                                       ins, iters=40)
                    finally:
                        FA.library = None
                return call
            ms = turns({"parent": timed(parent, psets), "change": timed(None, sets)})
            if w:
                pos = torch.arange(S, device=dev)
                mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < w)
                kw = {"attn_mask": mask}
            else:
                kw = {"is_causal": True}
            forms = {f"V at {Dv}": sets}
            if Dv != D:
                forms[f"V zero-padded to {D}"] = psets
            libs = {f: cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **kw), ins, iters=40) for f, ins in forms.items()}
            print(f"[ab] fwd {row} (bf16 B{B} H{H} K{K} S{S} D{D} Dv{Dv} window={w}, "
                  f"{FA.fwd_kernel(torch.bfloat16, D, H // K, w)}): {fmt(ms)} us; sdpa "
                  + ", ".join(f"{f} {t * 1e3:.1f}" for f, t in libs.items())
                  + f" us; change max|a-b|/max|b| {err:.3e}; outputs equal bit for bit {same}",
                  flush=True)
            del sets, psets, got

    if "bwd" in rows:
        fns = {"change": FA._bind_bwd()}
        fns["parent"] = ctypes.CDLL(str(out / "libflash_attention_bwd.so")).repro_flash_attention_bwd
        fns["parent"].argtypes = (fns["change"].argtypes[:16]
                                  + fns["change"].argtypes[17:])   # no Dv
        fns["parent"].restype = ctypes.c_int
        for row, (B, H, K, S, D, w, Dv) in BWD_ROWS.items():
            if not wanted(row):
                continue
            sets, psets = [], []
            for _ in range(4):
                q, k, v = views(B, H, K, S, D, Dv)
                o, lse = FA.flash_attention(q, k, v, window=w, lse=True)
                do = torch.randn(B, H, S, Dv, generator=gen, device=dev).bfloat16()
                sets.append((q, k, v, o, lse, do, FA._bwd(q, k, v, o, lse, do, window=w)[3]))
                psets.append((q, k, pad(v, D), pad(o, D), lse, pad(do, D), sets[-1][6]))

            def launch(name, kernel):
                fn = fns[name]

                def call(q, k, v, o, lse, do, dr):
                    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                    delta = torch.empty_like(dr) if kernel == 1 else dr
                    strides = (FA._I64 * 24)(*[s for x in (q, k, v, o, do, dq, dk, dv)
                                               for s in x.stride()[:3]])
                    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, delta, dq, dk, dv)]
                    dims = (B, H, K, S, D) + ((v.shape[-1],) if name == "change" else ())
                    build.check(fn(kernel, *ptrs, *dims, strides, w or 0, 1,
                                   torch.cuda.current_stream().cuda_stream), "k1_ab")
                    return dq, dk, dv, delta
                return call
            q, k, v, o, lse, do, dr = sets[0]
            a1, b1 = launch("change", 1)(*sets[0]), launch("parent", 1)(*psets[0])
            a2, b2 = launch("change", 2)(*sets[0]), launch("parent", 2)(*psets[0])
            same_dq = torch.equal(a1[0], b1[0]) and torch.equal(a1[3], b1[3])
            same_kv = torch.equal(a2[1], b2[1]) and torch.equal(a2[2], b2[2][..., :Dv])
            err = CS.rel(a1[0].float(), ref.attention_bwd_dq(q, k, v, lse, do, dr,
                                                             window=w).float())
            for kernel, part in ((1, "dQ"), (2, "dK/dV")):
                ms = turns({n: (lambda n=n: cuda_ms(launch(n, kernel),
                                                    psets if n == "parent" else sets))
                            for n in ("parent", "change")})
                note = (f"; change dq max|a-b|/max|b| {err:.3e}; dq and row sums equal bit for "
                        f"bit {same_dq}") if kernel == 1 else (
                    f"; dk and dv{'[..., :%d]' % Dv if Dv != D else ''} equal bit for bit "
                    f"{same_kv}")
                print(f"[ab] bwd {row} {part} (bf16 B{B} H{H} K{K} S{S} D{D} Dv{Dv} "
                      f"window={w}): {fmt(ms)} us{note}", flush=True)
            del sets, psets
    return 0


if __name__ == "__main__":
    sys.exit(main())
