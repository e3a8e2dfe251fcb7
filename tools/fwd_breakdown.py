#!/usr/bin/env python3
"""Where K1's bf16 forward spends its time, on one NVIDIA GPU.

    python3 tools/fwd_breakdown.py [--shape qwen|granite|minicpm|hymba|hymba-global|minicpm3]
        [--only base,noexp,...]

Builds ``src/repro_torch/csrc/flash_attention.cu`` as shipped and with
each of its diagnostic macros (``-D``; one ``nvcc`` each, in parallel, into
``src/repro_torch/_build/breakdown/``), then times each build's forward
(``repro_flash_attention``, through the wrapper with
``kernels.flash_attention.library`` set to the build) at a prefill shape,
causal, inputs rotated through more than the L2, by CUDA-graph replay
(``kernels/timing.cuda_ms``):

- ``base``: the kernel as shipped;
- ``noexp``: ``FWD_NOEXP``, P taken as its exponent's argument, no mask:
  the exponentials' and the mask's share;
- ``nopv``: ``FWD_NOPV``, no O += P V product: its share;
- ``bn64``: ``FWD_BN=64``, ``flash_ws_kernel`` on 64-row KV tiles in a
  ring of four (its default is 128-row tiles, two a ring);
- ``q1``, ``q2``: ``FWD_QBUFS=1`` / ``2``, ``flash_ws_kernel`` with one or
  two Q buffers (its default is two at D = 128, the next output tile's Q
  loaded under this one, and one at 64);
- ``pvn64``: ``FWD_PV_N64``, ``flash_ws_kernel<128>``'s P V as two m64n64
  products a k16 step (its default is one m64n128);
- ``onetile``: ``FWD_ONE_TILE``, ``flash_ws_kernel``'s grid one block a
  tile, as a non-persistent kernel's (its default is one block an SM);
- ``noload``: ``FWD_NOLOAD``, no K or V load after each ring slot's first
  (the slot's data is reused): what the tiles' loads from L2 cost;
- ``nostore``: ``FWD_NOSTORE``, no O stores: the epilogue's share;
- ``order0``, ``order2``: ``K1_ORDER=0`` / ``2``, the output tiles
  heaviest first over every head, or grouped by head at every G
  (``csrc/hopper.cuh``: the shipped rule groups them at G = 1 only).

The shapes: ``qwen`` (qwen2.5-14b's B4 H40 K8 S1024 D128, the default),
``granite`` (B4 H32 K8 S1024 D64), ``minicpm`` (B4 H36 K36 S1024 D64),
``hymba`` (B4 H25 K5 S1536 D64, window 1024), ``hymba-global`` (the
same, no window) and ``minicpm3`` (minicpm3-4b's B4 H40 K40 S1024, q and k
at 96; each build timed twice, V at its 64 columns and V zero-padded to
96, the design of head dim 96 on 128's tiles: ``order0`` with V padded is
the design before this tree's widths and order, ``base`` with V padded
the order alone, ``order0`` with V at 64 the widths alone), each on
``flash_ws_kernel``, which every macro acts on.
Beside the times: ptxas's registers at
launch, spills and its notes on wgmma (C75xx) for each build's bf16
forward kernels, each build's output against the plain version
(``noexp``, ``nopv``, ``noload`` and ``nostore`` are wrong by design), and
SDPA at the same shape, the yardstick. Exits 1 with no CUDA device.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: build name -> the macros it defines
VARIANTS = {"base": (), "noexp": ("FWD_NOEXP",), "nopv": ("FWD_NOPV",),
            "bn64": ("FWD_BN=64",), "q1": ("FWD_QBUFS=1",), "q2": ("FWD_QBUFS=2",),
            "pvn64": ("FWD_PV_N64",), "onetile": ("FWD_ONE_TILE",),
            "noload": ("FWD_NOLOAD",), "nostore": ("FWD_NOSTORE",),
            "order0": ("K1_ORDER=0",), "order2": ("K1_ORDER=2",)}
#: prefill shapes: B, H, K, S, D, window, and V's widths each build is timed at
SHAPES = {"qwen": (4, 40, 8, 1024, 128, None, (128,)),
          "granite": (4, 32, 8, 1024, 64, None, (64,)),
          "minicpm": (4, 36, 36, 1024, 64, None, (64,)),
          "hymba": (4, 25, 5, 1536, 64, 1024, (64,)),
          "hymba-global": (4, 25, 5, 1536, 64, None, (64,)),
          "minicpm3": (4, 40, 40, 1024, 96, None, (64, 96))}
#: the bf16 forward kernels, by their mangled names' stems
KERNELS = r"(flash_bf16_kernel|flash_ws_kernel)((?:I?Li\d+E)*)"


def _name(m) -> str:
    return m.group(1) + ("<" + ", ".join(re.findall(r"Li(\d+)E", m.group(2))) + ">"
                         if m.group(2) else "")


def ptxas_notes(log: str) -> list[str]:
    """Registers, spills and C75xx notes of the bf16 forward kernels in a
    ``-v`` log."""
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
    ap.add_argument("--shape", choices=sorted(SHAPES), default="qwen")
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated builds to make and time (default: all)")
    args = ap.parse_args()
    names = [n for n in args.only.split(",") if n]
    if unknown := [n for n in names if n not in VARIANTS]:
        ap.error(f"unknown builds {unknown}; known: {sorted(VARIANTS)}")
    import torch
    if not torch.cuda.is_available():
        print("fwd_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.timing import cuda_ms

    print(CS.card_line(), flush=True)
    out_dir = build.BUILD_ROOT / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cmd = build.nvcc_command("flash_attention", out_dir / f"libfwd_{name}.so",
                                 build.nvcc_path())
        cmd[1:1] = ["-Xptxas", "-v", *(f"-D{m}" for m in VARIANTS[name])]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for note in ptxas_notes(log):
            print(f"[ptxas] {name} {note}", flush=True)

    B, H, K, S, D, window, widths = SHAPES[args.shape]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    # 4 sets of the model's [B,S,n,D] projections seen as [B,n,S,D] views
    # (~59 MB each at qwen's shape): each call finds its inputs cold; V at
    # its first width, or zero-padded from there to the next
    base = [(randn(B, S, H, D).transpose(1, 2), randn(B, S, K, D).transpose(1, 2),
             randn(B, S, K, widths[0]).transpose(1, 2)) for _ in range(4)]
    if window:   # the window as a boolean mask, as chip_smoke.py's hymba rows
        pos = torch.arange(S, device=dev)
        kw = {"attn_mask": (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)}
        pairs = window * (window + 1) / 2 + (S - window) * window
    else:
        kw = {"is_causal": True}
        pairs = S * S / 2

    def call(q, k, v):
        return FA.flash_attention(q, k, v, window=window)
    for Dv in widths:
        sets = [(q, k, torch.nn.functional.pad(v, (0, Dv - v.shape[-1]))) for q, k, v in base]
        shape = (f"bf16 B{B} H{H} K{K} S{S} D{D} Dv{Dv}, causal, window {window}, "
                 f"{FA.fwd_kernel(torch.bfloat16, D, H // K, window)}")
        q, k, v = sets[0]
        want = ref.naive_attention(q, k, v, window=window).float()
        try:
            for name in names:
                FA.library = out_dir / f"libfwd_{name}.so"
                got = call(q, k, v).float()
                err = CS.rel(got, want)
                ms = cuda_ms(call, sets, iters=40)
                print(f"[time] {name}: {ms * 1e3:.1f} us ({shape}, CUDA-graph replay); "
                      f"max|a-b|/max|b| {err:.3e}", flush=True)
        finally:
            FA.library = None
        del want
        lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw), sets, iters=40)
        bound, by = CS.bound_ms(2 * B * H * pairs * (D + widths[0]),
                                2 * (2 * B * H * S * D + 2 * B * K * S * D) if widths[0] == D
                                else 2 * (B * H * S * D + B * K * S * D + B * K * S * widths[0]
                                          + B * H * S * widths[0]))
        print(f"[time] sdpa V at {Dv} {lib * 1e3:.1f} us (yardstick); bound {bound * 1e3:.2f} us "
              f"({by})", flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
