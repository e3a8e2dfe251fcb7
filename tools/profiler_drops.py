"""Does ``torch.profiler`` keep every kernel record? Each variant runs in a
process of its own: K2 (the decode kernel) profiled once, then

  build  the GLA library built in this process, into a fresh directory
         under ``_build/`` (about 40 s of nvcc while the card idles);
  sleep  the GLA library already built, then 60 s asleep;
  none   the GLA library already built, nothing in between;

then three profiled windows, each after a warm-up step as
``chip_smoke.kernel_us`` takes them: 6 K4 calls, 6 K4 calls again, and
6 K4 calls with a small elementwise kernel before each and after the
last. Prints, for each window, the wrapper's launches, the records the
profiler kept and their order (G a K4 record, M an elementwise one).
Needs a CUDA device:

    python3 tools/profiler_drops.py               # every variant
    python3 tools/profiler_drops.py sleep none    # some
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("build", "sleep", "none")


def variant(name: str) -> None:
    """One variant, in this process."""
    import os

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import gla_chunk as GC
    from repro_torch.kernels import ops

    P, CUDA = torch.profiler, torch.autograd.DeviceType.CUDA
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(2, 8, 64, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(2, 300, 2, 64, generator=g, device=dev).bfloat16() for _ in range(2))
    if name != "build":
        build.build_all()
    DA.decode_attention(q, k, v, 300)
    torch.cuda.synchronize()
    with P.profile(activities=[P.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            DA.decode_attention(q, k, v, 300)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == CUDA)
    print(f"[{name}] K2: 3 launches, {n} records", flush=True)

    B, H, S, N, Pd = 2, 3, 512, 16, 64
    row = torch.randn(B, S, 2 * N + 8, generator=g, device=dev).bfloat16()
    gq = row[..., 8:8 + N, None].transpose(-1, -2).expand(B, S, H, N)
    gk = (row[..., 8 + N:, None] * 0.3).bfloat16().transpose(-1, -2).expand(B, S, H, N)
    gv = torch.randn(B, S, H, Pd, generator=g, device=dev).bfloat16()
    lg = -torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=dev)) * 0.3
    fresh = None
    if name == "build":
        fresh = build.BUILD_ROOT / f"fresh-{os.getpid()}"
        build.BUILD_ROOT = fresh
    elif name == "sleep":
        time.sleep(60)
    t0 = time.perf_counter()
    ops.gla(gq, gk, gv, lg, chunk=256)
    torch.cuda.synchronize()
    print(f"[{name}] K4 ready in {time.perf_counter() - t0:.1f} s", flush=True)
    mark = torch.zeros(1, device=dev)

    def window(marks):
        with P.profile(activities=[P.ProfilerActivity.CUDA],
                       schedule=P.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            ops.gla(gq, gk, gv, lg, chunk=256)
            torch.cuda.synchronize()
            prof.step()
            n0 = GC.launches
            for _ in range(6):
                if marks:
                    mark.add_(1)
                ops.gla(gq, gk, gv, lg, chunk=256)
            if marks:
                mark.add_(1)
            torch.cuda.synchronize()
            prof.step()
        evs = sorted((e for e in prof.events() if e.device_type == CUDA),
                     key=lambda e: e.time_range.start)
        order = "".join("G" if "gla_" in e.name else "M" for e in evs)
        launched = 6 + (7 if marks else 0)
        print(f"[{name}] window{' with marks' if marks else ''}: K4 launches "
              f"{GC.launches - n0}, {len(evs)} of {launched} records kept, order {order}",
              flush=True)

    for marks in (False, False, True):
        window(marks)
    if fresh is not None:
        shutil.rmtree(fresh, ignore_errors=True)


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}; known: {VARIANTS}")
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT / 'tools')!r}]; "
            "import profiler_drops; profiler_drops.variant(sys.argv[1])")
    rc = 0
    for name in names:   # each in a fresh process
        rc |= subprocess.run([sys.executable, "-c", code, name], timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    raise SystemExit(main(sys.argv[1:]))
