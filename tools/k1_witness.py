#!/usr/bin/env python3
"""Does a bf16 near tie among hymba's first tokens follow K1's arithmetic?

    python3 tools/k1_witness.py [--extra NAME=PATH ...]

Builds the port's flash prefill kernel (``csrc/flash_attention.cu``) as it
is, a copy that calls exact ``exp2f`` in place of ``ex2.approx``, and any
extra sources given (for example an earlier version taken from git with
``git show <commit>:src/repro_torch/csrc/flash_attention.cu > old.cu``).
For each build it prints

- its bf16 error against a float32 computation on the same inputs at
  hymba-1.5b's prefill shapes (B4 H25 K5 S1536 D64, window 1024 and none),
  beside the plain bf16 version's;
- hymba-1.5b's prefill (``chip_smoke.py``'s seeded weights and prompts)
  under both GLA schedules: the first tokens and each row's top three
  logits.

Every build has the same C entry, so each is launched in turn through the
wrapper's ``library`` setting. Needs one CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=PATH",
                    help="another flash_attention.cu to build and compare")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_witness: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.engine import Server

    out = build.BUILD_ROOT / "witness"
    out.mkdir(parents=True, exist_ok=True)
    current = (build.CSRC / "flash_attention.cu").read_text()
    exact = current.replace("= ex2(", "= exp2f(")
    if exact == current:
        raise RuntimeError("no ex2.approx call found to replace")
    (out / "flash_exact.cu").write_text(exact)
    # the copy includes nothing relative, so it builds from its own directory
    sources = {"current": build.CSRC / "flash_attention.cu", "exact_exp2f": out / "flash_exact.cu"}
    for item in args.extra:
        name, _, path = item.partition("=")
        sources[name] = Path(path).resolve()

    nvcc = build.nvcc_path()
    procs = {n: subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(out / f"lib{n}.so"),
                                  str(src)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, src in sources.items()}
    libs = {}
    for n, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {sources[n]}:\n{log}")
        libs[n] = out / f"lib{n}.so"

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        for w in (1024, None):
            q, k, v = (torch.randn(4, 1536, n, 64, generator=gen, device=dev).bfloat16()
                       .transpose(1, 2) for n in (25, 5, 5))
            want = ref.naive_attention(q.float(), k.float(), v.float(), window=w)
            plain = ref.naive_attention(q, k, v, window=w).float() - want
            for n, lib in libs.items():
                FA.library = lib
                d = FA.flash_attention(q, k, v, window=w).float() - want
                print(f"K1 {n} window={w}: vs float32: max {d.abs().max().item():.3e} rms "
                      f"{d.pow(2).mean().sqrt().item():.4e} mean {d.mean().item():+.3e}; "
                      f"plain bf16 version rms {plain.pow(2).mean().sqrt().item():.4e}",
                      flush=True)

        cfg = get_config("hymba-1.5b")
        prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 1536))
        params = Server(cfg, seed=0, device="cuda").params
        for n, lib in libs.items():
            FA.library = lib
            firsts = {}
            for schedule in ("chunk", "parallel"):
                srv = Server(cfg, params=params, device="cuda", gla_schedule=schedule)
                lg = srv.prefill(prompts, pad_to=1536 + 32)[:, : cfg.vocab_size].float()
                top = torch.topk(lg, 3, dim=-1)
                firsts[schedule] = top.indices[:, 0].tolist()
                rows = "; ".join(
                    f"row {i}: " + ", ".join(f"{t} {x:.6g}" for t, x in
                                             zip(top.indices[i].tolist(),
                                                 top.values[i].tolist()))
                    for i in range(lg.shape[0]))
                print(f"K1 {n}, {schedule} schedule: first tokens {firsts[schedule]}; top 3: "
                      f"{rows}", flush=True)
                del srv, lg
            print(f"K1 {n}: the schedules' first tokens agree on rows "
                  f"{[i for i, (a, b) in enumerate(zip(*firsts.values())) if a == b]}",
                  flush=True)
    finally:
        FA.library = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
