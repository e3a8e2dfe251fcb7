#!/usr/bin/env python3
"""What the one-launch split-KV decode spends after its last split.

    python3 tools/decode_tail.py

Times the shipped K2 kernel (``csrc/decode_split.cuh``) on a serving
shape, where each (row, KV head) has several splits and the last split
block to finish combines them, and on the same cache positions cut into
rows of one split each (``SPLIT`` positions), where every block writes its
output directly: the same K/V bytes and about as many blocks, with no
partials, no ticket and no combine. The difference is the combine's tail.
Times are the replay of a CUDA graph (``repro_torch.kernels.timing``),
as in ``chip_smoke.py``. Needs one
CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_tail: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels.timing import cuda_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())

    def sets(B, H, K, S, n):
        return [tuple(torch.randn(shape, generator=gen, device=dev).bfloat16()
                      for shape in ((B, H, 64), (B, S, K, 64), (B, S, K, 64)))
                for _ in range(n)]

    # granite-3-2b's last decode step, and hymba-1.5b's window (ring) length
    for B, H, K, L in ((4, 32, 8, 1056), (4, 25, 5, 1024)):
        rows = B * L // DA.SPLIT            # one split each, the same positions
        many = sets(B, H, K, L, 8)
        one = sets(rows, H, K, DA.SPLIT, 8)
        t_many = cuda_ms(lambda q, k, v: DA.decode_attention(q, k, v, L), many, iters=40)
        t_one = cuda_ms(lambda q, k, v: DA.decode_attention(q, k, v, DA.SPLIT), one,
                        iters=40)
        print(f"K2 bf16 H{H} K{K} D64: B{B} length {L} ({DA.n_splits(L)} splits, "
              f"{B * K * DA.n_splits(L)} blocks) {t_many * 1e3:.2f} us; the same "
              f"{B * L} positions as {rows} one-split rows ({rows * K} blocks) "
              f"{t_one * 1e3:.2f} us; the combine's tail {(t_many - t_one) * 1e3:.2f} us",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
