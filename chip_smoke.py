#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and the exit code is
not 0:
  1. card: the ``nvidia-smi`` name and power limit (no CUDA: exit 1);
  2. build: every CUDA kernel from ``src/repro_torch/csrc``;
  3. kernels: each kernel against its plain PyTorch version at the serving
     paths' shapes (bf16 and float32) and at the smoke CLI's, with the
     error beside its tolerance, the paged decode over a strided 40-layer
     pool view with a shuffled page table, and over in-order pages against
     the contiguous decode bit for bit; then the kernel's, the plain
     version's and the library call's times beside the kernel's bound, and
     the profiler's device times of the decode kernels' split and combine
     kernels apart;
  4. serve: full-width granite-3-2b (bf16, seeded random weights) prefills
     4 prompts x 1024 tokens and decodes 32 tokens through the kernels;
     the launch counts are checked, and the logits are held against the
     plain attention path;
  5. fleet: the continuous-batching ServeEngine on the same weights, 7
     sessions (prompts of 0 to 1024 tokens, 32 new tokens each, a later
     high-priority arrival) over a device page pool small enough to force
     preemption and readmission; the launch counts are checked (flash per
     non-empty prefill, paged decode per decoded token, no contiguous
     decode), each first token is held to the Server's B=1 one, and a
     float32 copy's streams are held to the float32 Server's exactly;
  6. cli: ``repro_torch.launch.serve`` once at smoke size on the card.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# bf16 keeps 8 significant bits: one rounding of an output near 1 is 2^-8;
# float32 differs from the plain version only in summation order
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# full model, max |a - b| logit over max |b| logit (see PERF.md): kernel vs
# plain bf16 path, and the kernel path's distance from the float32 model
# over the plain bf16 path's
LOGIT_REL_TOL = 5e-2
F32_DIST_RATIO = 2.0
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# the serving paths' shapes, whose errors go into the JSON record
F_MAIN = "bfloat16 B4 H32 K8 S1024 D64 window=None"
D_MAIN = "bfloat16 B4 H32 K8 S1056 D64 length=1056 window=None"
P_MAIN = "bfloat16 B1 H32 K8 D64 layer 20/40 lengths=[1056] window=None"
# the fleet: page size, lanes, pool pages, new tokens per session, the
# sessions' prompt lengths and the later high-priority arrival's (PERF.md)
FLEET_PAGE, FLEET_LANES, FLEET_PAGES, FLEET_NEW = 16, 4, 120, 32
FLEET_PROMPTS, FLEET_LATE, FLEET_LATE_AT = (1024, 0, 640, 900, 256, 96), 512, 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound_ms(flops, nbytes):
    """Least time on the card for bf16 work: the larger of the operations at
    the tensor-core peak and the bytes at the memory rate; and which."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def cuda_ms(fn, sets, iters=20, reps=3):
    """Mean device ms of one ``fn(*s)`` call. ``iters`` calls cycling through
    the input ``sets`` (together larger than the 50 MB L2, so each call finds
    its inputs cold, as a layer of the model does) are captured in one CUDA
    graph, which is replayed ``reps`` times between two events: the host's
    cost per call, which exceeds a small kernel's device time, stays out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm-up off the capture: handles, workspaces
        for s in sets:
            fn(*s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


def kernel_us(fn, sets, iters=40):
    """Device microseconds per call of each CUDA kernel ``fn`` launches, by
    name, from the profiler over ``iters`` calls cycling through ``sets``
    (the profiler reads each kernel's device time, so the host's pace does
    not enter)."""
    import torch
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / iters for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.models import Model
    from repro_torch.models.params import tree_map
    from repro_torch.serving.engine import ServeEngine, Server

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. card -------------------------------------------------------------
    card = card_line()
    print(card)
    print(f"[card] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}", flush=True)

    # -- 2. build ------------------------------------------------------------
    secs = build.build_all()
    print(f"[build] {', '.join(build.SOURCES)} for sm_90a in {secs:.1f}s", flush=True)

    # -- 3. each kernel against its plain version ----------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[kernels] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_inputs(B, H, K, S, D, dtype):
        # the model's [B,S,H,D] projections, seen as [B,H,S,D] views
        return tuple(randn(B, S, n, D, dtype=dtype).transpose(1, 2) for n in (H, K, K))

    def decode_inputs(B, H, K, S, D, dtype):
        return randn(B, H, D, dtype=dtype), randn(B, S, K, D, dtype=dtype), \
            randn(B, S, K, D, dtype=dtype)

    def paged_inputs(B, lengths, dtype, layer=20, n_layers=40, H=32, K=8, D=64):
        """q, then layer ``layer``'s strided [P, page, K, D] views of two
        stacked pool stores [P, page, n_layers*K*D] (the fleet's layout), a
        table of distinct shuffled pages with the entries past each length
        set to 0, and the int32 lengths."""
        n = max(-(-max(lengths) // FLEET_PAGE), 1)
        P = B * n + 3
        stores = [randn(P, FLEET_PAGE, n_layers * K * D, dtype=dtype) for _ in range(2)]
        kp, vp = (st.view(P, FLEET_PAGE, n_layers, K, D)[:, :, layer] for st in stores)
        order = torch.randperm(P, generator=torch.Generator().manual_seed(P * B))
        table = order[: B * n].view(B, n).to(torch.int32)
        for b, L in enumerate(lengths):
            table[b, -(-L // FLEET_PAGE):] = 0
        return (randn(B, H, D, dtype=dtype), kp, vp, table.to(dev),
                torch.tensor(lengths, dtype=torch.int32, device=dev))

    errs, bitwise = {}, {}

    def held(name, label, out, want, dtype):
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[str(dtype).split(".")[-1]]
        ok = math.isfinite(err) and err <= tol and torch.isfinite(out).all().item()
        print(f"[kernels] {name} {label}: max_abs_err {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        errs.setdefault(name, {})[label] = err

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for B, H, K, S, D, w in ((4, 32, 8, 1024, 64, None), (4, 32, 8, 1000, 64, None),
                                 (2, 8, 8, 1024, 64, None), (4, 32, 8, 1024, 64, 256),
                                 (2, 4, 2, 24, 32, None)):
            q, k, v = flash_inputs(B, H, K, S, D, dtype)
            held("flash_attention", f"{dn} B{B} H{H} K{K} S{S} D{D} window={w}",
                 FA.flash_attention(q, k, v, window=w),
                 ref.naive_attention(q, k, v, window=w), dtype)
        for B, H, K, S, D, length, w in ((4, 32, 8, 1056, 64, 1, None),
                                         (4, 32, 8, 1056, 64, DA.SPLIT, None),
                                         (4, 32, 8, 1056, 64, 1056, None),
                                         (4, 32, 8, 1056, 64, 1056, 300),
                                         (2, 4, 2, 24, 32, 17, None)):
            q, k, v = decode_inputs(B, H, K, S, D, dtype)
            held("decode_attention", f"{dn} B{B} H{H} K{K} S{S} D{D} length={length} "
                 f"window={w}", DA.decode_attention(q, k, v, length, window=w),
                 ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                            length, window=w), dtype)
        # the fleet's decode: one lane (and four), granite's 40-layer pool store
        # seen as layer 20's strided view, a shuffled table; lengths 1, a page
        # edge, a split edge and the full 1056
        for B, lengths, w in ((1, [1], None), (1, [FLEET_PAGE], None),
                              (1, [DA.SPLIT], None), (1, [1056], None), (1, [1056], 300),
                              (4, [1, FLEET_PAGE, DA.SPLIT, 1056], None)):
            q, kp, vp, table, lens = paged_inputs(B, lengths, dtype)
            held("paged_decode_attention", f"{dn} B{B} H32 K8 D64 layer 20/40 "
                 f"lengths={lengths} window={w}",
                 PA.paged_decode_attention(q, kp, vp, table, lens, window=w),
                 ref.naive_paged_decode_attention(q, kp, vp, table, lens, window=w), dtype)
        # over pages that lie in order, the paged decode runs the contiguous
        # decode's splits on the same rows: expected equal bit for bit
        q, k, v = decode_inputs(4, 32, 8, 1056, 64, dtype)
        n = 1056 // FLEET_PAGE
        table = torch.arange(4 * n, dtype=torch.int32, device=dev).view(4, n)
        for length in (1, 500, 1056):
            lens = torch.full((4,), length, dtype=torch.int32, device=dev)
            a = PA.paged_decode_attention(q, k.view(4 * n, FLEET_PAGE, 8, 64),
                                          v.view(4 * n, FLEET_PAGE, 8, 64), table, lens)
            b = DA.decode_attention(q, k, v, length)
            same = torch.equal(a, b)
            bitwise[f"{dn} length={length}"] = same
            print(f"[kernels] paged_decode_attention over in-order pages vs decode_attention "
                  f"{dn} B4 H32 K8 S1056 D64 length={length}: "
                  + ("equal bit for bit" if same else
                     f"NOT bit-equal, max |diff| {(a.float() - b.float()).abs().max().item():.3e}"),
                  flush=True)
    del q, k, v, kp, vp, a, b      # phase 4's peak memory counts live tensors

    # times at the serving paths' shapes, bf16
    B, H, K, S, D, bf = 4, 32, 8, 1024, 64, torch.bfloat16
    fsets = [flash_inputs(B, H, K, S, D, bf) for _ in range(4)]
    f_ms = cuda_ms(lambda q, k, v: FA.flash_attention(q, k, v), fsets)
    f_plain = cuda_ms(lambda q, k, v: ref.naive_attention(q, k, v), fsets, iters=5)
    f_lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), fsets)
    # causal: half the S x S score matrix; q, k, v read and o written once
    f_bound, f_by = bound_ms(4 * B * H * S * S * D / 2,
                             2 * (2 * B * H * S * D + 2 * B * K * S * D))

    Smax, length = 1056, 1056
    dsets = [decode_inputs(B, H, K, Smax, D, bf) for _ in range(8)]
    d_ms = cuda_ms(lambda q, k, v: DA.decode_attention(q, k, v, length), dsets, iters=40)
    d_plain = cuda_ms(lambda q, k, v: ref.naive_decode_attention(
        q, k.transpose(1, 2), v.transpose(1, 2), length), dsets)
    d_lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q[:, :, None], k[:, :length].transpose(1, 2), v[:, :length].transpose(1, 2),
        enable_gqa=True), dsets, iters=40)
    # the K/V rows below length, q read and o written once
    d_bound, d_by = bound_ms(4 * B * H * length * D,
                             2 * (2 * B * H * D + 2 * B * length * K * D))
    print(f"[kernels] flash_attention bf16 B{B} H{H} K{K} S{S} D{D}: {f_ms * 1e3:.1f} us, "
          f"plain {f_plain * 1e3:.1f} us, sdpa {f_lib * 1e3:.1f} us, "
          f"bound {f_bound * 1e3:.2f} us ({f_by})")
    print(f"[kernels] decode_attention bf16 B{B} H{H} K{K} S{Smax} len{length} D{D}: "
          f"{d_ms * 1e3:.1f} us, plain {d_plain * 1e3:.1f} us, sdpa {d_lib * 1e3:.1f} us, "
          f"bound {d_bound * 1e3:.2f} us ({d_by})", flush=True)

    # the fleet's decode, one lane at length 1056: each call reads another
    # layer's strided view of the 40-layer stores (86 MB of K/V rows in all)
    n = length // FLEET_PAGE
    P = n + 3
    stores = [randn(P, FLEET_PAGE, 40 * K * D, dtype=bf).view(P, FLEET_PAGE, 40, K, D)
              for _ in range(2)]
    table = torch.randperm(P, generator=torch.Generator().manual_seed(P))[:n]
    table = table.view(1, n).to(torch.int32).to(dev)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    psets = [(randn(1, H, D, dtype=bf), stores[0][:, :, i], stores[1][:, :, i], table, lens)
             for i in range(40)]
    p_ms = cuda_ms(lambda q, kp, vp, t, ln: PA.paged_decode_attention(q, kp, vp, t, ln),
                   psets, iters=40)
    p_plain = cuda_ms(lambda q, kp, vp, t, ln: ref.naive_paged_decode_attention(
        q, kp, vp, t, ln), psets)
    # yardstick: SDPA over each set's cache gathered beforehand (no PyTorch
    # call takes a page table)
    gsets = [(q, kp[table[0].long()].reshape(1, n * FLEET_PAGE, K, D).transpose(1, 2),
              vp[table[0].long()].reshape(1, n * FLEET_PAGE, K, D).transpose(1, 2))
             for q, kp, vp, _, _ in psets]
    p_lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q[:, :, None], k, v, enable_gqa=True), gsets, iters=40)
    # the K/V rows below length, q read and o written once, the table row
    # and the length read once
    p_bound, p_by = bound_ms(4 * H * length * D,
                             2 * (2 * H * D + 2 * length * K * D) + 4 * (n + 1))
    print(f"[kernels] paged_decode_attention bf16 B1 H{H} K{K} len{length} D{D} page "
          f"{FLEET_PAGE}, 40-layer strided pool: {p_ms * 1e3:.1f} us, plain "
          f"{p_plain * 1e3:.1f} us, sdpa over the gathered cache (yardstick) "
          f"{p_lib * 1e3:.1f} us, bound {p_bound * 1e3:.2f} us ({p_by})", flush=True)

    # where the decode kernels' time goes: split and combine apart
    split_us = {}
    for name, fn, sets in (
            ("decode_attention", lambda q, k, v: DA.decode_attention(q, k, v, length), dsets),
            ("paged_decode_attention",
             lambda q, kp, vp, t, ln: PA.paged_decode_attention(q, kp, vp, t, ln), psets)):
        us = kernel_us(fn, sets)
        split_us[name] = us
        print(f"[kernels] {name} profiler device time per call: "
              + "; ".join(f"{k[:72]} {v:.2f} us" for k, v in
                          sorted(us.items(), key=lambda kv: -kv[1]))
              + f" (sum {sum(us.values()):.2f} us)", flush=True)
    del fsets, dsets, psets, gsets, stores

    # -- 4. full-width granite-3-2b Server ------------------------------------
    cfg = get_config("granite-3-2b")
    n_prompt, n_gen, batch = 1024, 32, 4
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, n_prompt))
    srv = Server(cfg, seed=0, device="cuda")
    srv.prefill(prompts[:, :64], pad_to=64)          # warm-up: cuBLAS, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = DA.launches = PA.launches = 0
    t0 = time.perf_counter()
    logits = srv.prefill(prompts, pad_to=n_prompt + n_gen)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = (FA.launches, DA.launches)
    first = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).cpu().numpy()
    toks, dt = srv.decode(n_gen, first)
    launches = {"flash_attention": FA.launches, "decode_attention": DA.launches,
                "paged_decode_attention": PA.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve] granite-3-2b {cfg.param_count() / 1e9:.3f}B params bf16, "
          f"{cfg.n_layers} layers; prefill {batch}x{n_prompt}: {prefill_ms:.1f} ms; "
          f"decode {n_gen} steps x {batch}: {n_gen * batch / dt:.1f} tok/s "
          f"({dt / n_gen * 1e3:.2f} ms/step); peak memory {peak_gb:.2f} GB", flush=True)
    print(f"[serve] launches after prefill {after_prefill}, after decode "
          f"{launches} (expected {cfg.n_layers}, {cfg.n_layers * n_gen})")
    if after_prefill != (cfg.n_layers, 0) or launches != {
            "flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * n_gen, "paged_decode_attention": 0}:
        raise AssertionError(f"main path launch counts {after_prefill} / {launches}")
    stream = np.stack(toks, axis=1)
    if stream.shape != (batch, n_gen) or stream.min() < 0 or stream.max() >= cfg.vocab_size:
        raise AssertionError(f"bad token stream {stream.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")

    # The same weights through the plain attention path in bf16 and through
    # a float32 copy of the model (plain attention): 4 teacher-forced steps
    # feed every path the kernel path's tokens, so an argmax flip on a near
    # tie cannot make the streams diverge. bf16 rounding alone moves the
    # logits of a 40-layer random-weight model by a few percent, so the
    # kernel path is held to the plain bf16 path's own distance from float32.
    tokens = torch.as_tensor(prompts, device=dev)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                cache_dtype="float32")
    p32 = tree_map(lambda t: t.float(), srv.params)

    def run(model, params):
        lg, caches = model.prefill(params, tokens, max_len=n_prompt + 4)
        out = [lg]
        for i, t in enumerate([first] + toks[:3]):
            lg, caches = model.decode_step(params, torch.as_tensor(t, device=dev).long(),
                                           n_prompt + i, caches)
            out.append(lg)
        return out

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    got = run(srv.model, srv.params)
    want = run(Model(cfg, force="ref"), srv.params)
    truth = run(Model(cfg32, force="ref"), p32)
    del p32
    ok = True
    for i, (a, b, t) in enumerate(zip(got, want, truth)):
        r_kp, r_kt, r_pt = rel(a, b), rel(a, t), rel(b, t)
        good = (math.isfinite(r_kp) and r_kp <= LOGIT_REL_TOL
                and r_kt <= F32_DIST_RATIO * r_pt)
        ok = ok and good
        print(f"[serve] {'prefill' if i == 0 else f'decode step {i}'} logits, "
              f"max|a-b|/max|b|: kernel-plain {r_kp:.3e} (tol {LOGIT_REL_TOL:.0e}), "
              f"kernel-f32 {r_kt:.3e}, plain-f32 {r_pt:.3e} "
              f"(tol kernel-f32 <= {F32_DIST_RATIO:g} x plain-f32) {'ok' if good else 'FAIL'}")
    top2 = torch.topk(want[0][:, : cfg.vocab_size], 2, dim=-1).values
    plain_first = torch.argmax(want[0][:, : cfg.vocab_size], dim=-1).cpu().numpy()
    print(f"[serve] first token kernel {first.tolist()} plain {plain_first.tolist()} "
          f"(plain top-2 margin {(top2[:, 0] - top2[:, 1]).tolist()})", flush=True)
    if not (ok and np.array_equal(first, plain_first)):
        raise AssertionError("kernel path disagrees with the plain path")
    del got, want, truth, logits

    # where one decode step's time goes: device busy time from the profiler
    lg, caches = srv.model.prefill(srv.params, tokens, max_len=n_prompt + 2)
    tok = torch.as_tensor(first, device=dev).long()
    srv.model.decode_step(srv.params, tok, n_prompt, caches)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        srv.model.decode_step(srv.params, tok, n_prompt + 1, caches)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    step_ms = dt / n_gen * 1e3
    if busy_ms > 0:
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[serve] one decode step: device busy {busy_ms:.3f} ms of "
              f"{step_ms:.2f} ms/step ({1 - busy_ms / step_ms:.1%} idle); top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms "
                          f"x{e.count}" for e in top))
    else:
        print("[serve] one decode step: device busy time not measured "
              "(the profiler saw no CUDA kernels)")
    params = srv.params
    del srv, lg, caches, tokens
    torch.cuda.empty_cache()

    # -- 5. the continuous-batching fleet on a device page pool -----------------
    all_prompts = FLEET_PROMPTS + (FLEET_LATE,)
    fleet_prompts = [np.random.default_rng(1).integers(0, cfg.vocab_size, n)
                     for n in all_prompts]
    max_len = max(all_prompts) + FLEET_NEW

    def fleet(model_cfg, model_params):
        """The fleet's traffic through a fresh engine: the sessions, then after
        FLEET_LATE_AT ticks the high-priority arrival, drained. Returns the
        engine, the session ids, the main path's launch counts and seconds."""
        eng = ServeEngine(model_cfg, params=model_params, device="cuda", max_len=max_len,
                          page_size=FLEET_PAGE, n_pages=FLEET_PAGES,
                          max_running=FLEET_LANES)
        torch.cuda.synchronize()
        FA.launches = DA.launches = PA.launches = 0
        t0 = time.perf_counter()
        sids = [eng.submit(p, max_new_tokens=FLEET_NEW) for p in fleet_prompts[:-1]]
        for _ in range(FLEET_LATE_AT):
            eng.step_once()
        sids.append(eng.submit(fleet_prompts[-1], max_new_tokens=FLEET_NEW, priority=5))
        eng.run_until_drained()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return eng, sids, {"flash_attention": FA.launches, "decode_attention": DA.launches,
                           "paged_decode_attention": PA.launches}, secs

    def server_stream(srv, prompt, n):
        """The port Server's B=1 greedy stream of ``n`` tokens; an empty prompt
        decodes from first token 0 at position 0, as the fleet's does."""
        if len(prompt):
            lg = srv.prefill(prompt[None, :], pad_to=len(prompt) + n)
            first = int(torch.argmax(lg[0, : cfg.vocab_size]))
            toks, _ = srv.decode(n - 1, np.array([first]))
            return [first] + [int(t[0]) for t in toks]
        srv.caches, srv.pos = srv.model.alloc_caches(1, n, dev), 0
        toks, _ = srv.decode(n, np.array([0]))
        return [int(t[0]) for t in toks]

    def check_fleet(eng, sids, got, label):
        """The main path's launch counts, the tickets and the streams' shape."""
        n_full = sum(1 for p in fleet_prompts if len(p))
        decoded = sum(len(eng.stream(s)) for s in sids) - n_full
        want = {"flash_attention": cfg.n_layers * n_full, "decode_attention": 0,
                "paged_decode_attention": cfg.n_layers * decoded}
        swapped = [s for s in sids if eng.sched.tickets[s].preemptions]
        print(f"[fleet] {label}: launches {got} (expected {want}: {n_full} non-empty "
              f"prefills x {cfg.n_layers}, {decoded} decoded tokens x {cfg.n_layers}); "
              f"preempted and readmitted: {swapped}; ticks {eng.tick}", flush=True)
        if got != want:
            raise AssertionError(f"fleet main path launch counts {got} != {want}")
        if not swapped or any(eng.sched.state(s) != "DONE" for s in sids):
            raise AssertionError("fleet: no session was preempted and readmitted")
        for s in sids:
            st = eng.stream(s)
            if len(st) != FLEET_NEW or min(st) < 0 or max(st) >= cfg.vocab_size:
                raise AssertionError(f"fleet: bad stream for {s}: {st}")
        return swapped

    eng, sids, fleet_launches, secs = fleet(cfg, params)
    n_tok = sum(len(eng.stream(s)) for s in sids)
    fleet_ticks = eng.tick
    print(f"[fleet] granite-3-2b bf16, {cfg.n_layers} layers; {len(sids)} sessions, "
          f"prompts {list(all_prompts)}, {FLEET_NEW} new tokens each; pool "
          f"{FLEET_PAGES} pages x {FLEET_PAGE}, {FLEET_LANES} lanes: {n_tok} tokens in "
          f"{secs:.2f} s: {n_tok / secs:.1f} tok/s, {secs / fleet_ticks * 1e3:.1f} ms/tick "
          f"over {fleet_ticks} ticks; card {card}", flush=True)
    check_fleet(eng, sids, fleet_launches, "bf16")
    srv = Server(cfg, params=params, device="cuda")
    firsts = [(server_stream(srv, p, 1)[0], eng.stream(s)[0])
              for p, s in zip(fleet_prompts, sids)]
    print(f"[fleet] bf16 first tokens, Server B=1 vs fleet: {firsts}", flush=True)
    if any(a != b for a, b in firsts):
        raise AssertionError("fleet first tokens disagree with the Server's")

    # one steady tick of four decoding lanes: device busy time from the profiler
    for p in fleet_prompts[:4]:
        eng.submit(p[:256], max_new_tokens=4)
    eng.step_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_once()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.step_once()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    print(f"[fleet] one tick of 4 decoding lanes: {tick_ms:.2f} ms (host clock); device "
          f"busy {busy_ms:.3f} ms profiled ({1 - busy_ms / tick_ms:.1%} idle against the "
          "unprofiled tick); top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
              for e in top), flush=True)
    del eng, srv
    torch.cuda.empty_cache()

    # the same traffic through a float32 copy: every stream, the preempted
    # ones' included, equals the float32 Server's B=1 greedy stream exactly
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                cache_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    eng, sids, got32, secs32 = fleet(cfg32, p32)
    check_fleet(eng, sids, got32, "float32")
    srv = Server(cfg32, params=p32, device="cuda")
    same = [server_stream(srv, p, FLEET_NEW) == eng.stream(s)
            for p, s in zip(fleet_prompts, sids)]
    print(f"[fleet] float32, {cfg32.n_layers} layers: {sum(same)}/{len(same)} streams "
          f"equal the float32 Server's B=1 greedy streams exactly ({secs32:.2f} s)",
          flush=True)
    if not all(same):
        raise AssertionError(f"float32 fleet streams differ from the Server's: {same}")
    del eng, srv, p32, params
    torch.cuda.empty_cache()

    # -- 6. the CLI -------------------------------------------------------------
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--device", "cuda", "--batch", "2", "--prompt-len", "16",
                          "--gen", "8"], env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    print(f"[cli] rc {cli.returncode}: {cli.stdout.strip()}", flush=True)
    if cli.returncode != 0:
        raise AssertionError(f"CLI failed:\n{cli.stderr}")

    src = "src/repro_torch/csrc/"
    record = {"kernels": [
        {"name": "flash_attention", "route": "cuda", "source": src + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:45",
         "launches": launches["flash_attention"],
         "max_abs_err": errs["flash_attention"][F_MAIN],
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": f_lib},
        {"name": "decode_attention", "route": "cuda", "source": src + "decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:61",
         "launches": launches["decode_attention"],
         "max_abs_err": errs["decode_attention"][D_MAIN],
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound, "bound_by": d_by,
         "library_ms": d_lib},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": src + "paged_decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:137",
         "launches": fleet_launches["paged_decode_attention"],
         "max_abs_err": errs["paged_decode_attention"][P_MAIN],
         "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": p_lib},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
