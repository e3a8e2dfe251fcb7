#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and the exit code is
not 0:
  1. card: the ``nvidia-smi`` name and power limit (no CUDA: exit 1);
  2. build: every CUDA kernel from ``src/repro_torch/csrc``;
  3. kernels: each kernel against its plain PyTorch version at the serving
     paths' shapes (bf16 and float32; the flash and contiguous decode
     kernels at granite's and hymba's) and at the smoke CLI's, with the
     error beside its tolerance, the paged decode over a strided 40-layer
     pool view with a shuffled page table, and over in-order pages against
     the contiguous decode bit for bit; then the kernel's, the plain
     version's and the library call's times beside the kernel's bound (K1
     at granite's and at hymba's two prefill shapes), and the profiler's
     device time per call of the decode kernels (one kernel each) and of
     the GLA kernels (one K4, or one of each K5 phase, per call);
  4. serve: full-width granite-3-2b (bf16, seeded random weights) prefills
     4 prompts x 1024 tokens and decodes 32 tokens through the kernels;
     the launch counts are checked, and the logits are held against the
     plain attention path;
  ckpt: the checkpoint-restart plane on phase 4's weights: the Server
     prefills the same 4 x 1024 prompts, decodes 16 steps and snapshots
     them mid-decode (the caches copied off the card on a side stream into
     pinned memory, then written to a temporary directory, codec none),
     decodes 16 more (tail A), and a fresh Server restores the snapshot
     under another MPI flavor with no prefill and decodes 16 (tail B);
     tail B must equal tail A byte for byte, the restored caches' digests
     the snapshotted ones, and the restored decode must launch 40 x 16
     decode and no flash kernels.  The blocking window's breakdown (of
     that first snapshot, and of two later ones on a grown arena), the
     persist and restart times and the copy rate beside one pinned
     ``copy_`` of the same bytes are printed;
  5. fleet: the continuous-batching ServeEngine on the same weights, 7
     sessions (prompts of 0 to 1024 tokens, 32 new tokens each, a later
     high-priority arrival) over a device page pool small enough to force
     preemption and readmission; the launch counts are checked (flash per
     non-empty prefill, paged decode per decoded token, no contiguous
     decode), each first token is held to the Server's B=1 one, and a
     float32 copy's streams are held to the float32 Server's exactly;
  recover: the supervised recovery plane on phase 5's weights and traffic
     (the high-priority arrival comes with tick 4, so a rewind past it
     sees it arrive again): (a) the fleet snapshotted after tick 6 under
     mpich (the rows gathered on the card, copied off it on the side
     stream), resumed under exampi in a fresh engine and drained, its
     streams equal to phase 5's, with the blocking window and its parts
     (the resident rows' copies timed on the side stream beside one
     pinned ``copy_`` of the same bytes, the parked rows' host copy), the
     restart's phases and the
     resumed run's flash and paged-decode launch counts; (b) the fleet
     under the supervisor with rank 1 killed at tick 5 and a snapshot
     every 3 ticks, re-homed from the RAM tier (world 2 -> 1) and then
     again from disk (no RAM tier), each with its MTTR and parts and
     streams equal to phase 5's; (c) two running sessions of the
     snapshotted engine live-migrated to a fabric engine and drained
     there, their streams equal to phase 5's, with the stall, chunks and
     bytes; and phase 4's
     Server under the supervisor with a preemption notice, resolved on
     the rescale rung with no rewind and phase 4's tokens;
  6. hymba: full-width hymba-1.5b (bf16, seeded random weights) prefills
     4 prompts x 1536 tokens (longer than its 1024 window, so the ring
     rolls) under each GLA schedule and decodes 32 tokens; the launch
     counts are checked (flash and K4 per layer per prefill, K5's phases
     per layer under the parallel schedule, ring decode per windowed layer
     and contiguous decode per global layer per step), the two schedules'
     logits and first tokens (on every row whose top two logits are more
     than a bf16 ulp apart, at least half the rows) are held to each other,
     the logits to the
     plain path and a float32 copy, and, since bf16 rounding moves this
     random-weight model's logits by tens of percent, a float32 copy's
     kernel path (both schedules) to its plain path with equal first
     tokens;
  train: full-width granite-3-2b (bf16 params, float32 AdamW state, remat
     on, seeded random weights) through the port's Trainer (world 2,
     mpich), batch 4 x 1024 tokens from the data pipeline: step 1's loss,
     grad_norm and every leaf's gradient held to the same step on the plain
     attention path under autograd; the same step from the same state run
     twice, params equal byte for byte; ten steps through ``step_once``
     with the launch counts checked (K1's forward twice a layer under
     remat, each backward kernel once), the median step time, tok/s, the
     model-FLOPs share ``mfu``, the peak memory, and one profiled step's
     idle share and K1's forward and backward shares; then the C/R plane
     at granite's widths and 4 layers: 6 steps with a checkpoint every 3
     (codec none), rank 1 killed at step 4 and restarted under exampi, and
     the same under the supervisor served from the RAM tier, each run's
     params, optimizer state and loss trace equal the uninterrupted run's
     byte for byte, with the blocking windows, persist, the restart's
     phases and the MTTR;
  7. cli: ``repro_torch.launch.serve`` at smoke size on the card, granite
     and hymba (both GLA schedules), and ``repro_torch.launch.train`` at
     smoke size with a rank killed and the restart under exampi.
Phase 3 also holds K1's logsumexp output and its backward kernels (dQ,
which also writes the row sums rowsum(dO o), then dK/dV) and those row
sums to their plain versions at granite's training shape, at a ragged S
and with a window, in bf16 and float32 (two runs equal bit for bit, the
prefill's output unchanged with the logsumexp write on), and times the
backward beside its bound, its plain version and SDPA's backward.
Phase 3 also holds the GLA kernels (K4; K5's phases apart and together)
and the ring-window decode to their plain versions: the GLA at the
serving shape with the mixer's head-broadcast q/k (in bf16 also under
steep decays), a smoke shape, one 16-row tile a chunk, lengths the chunk
does not divide and head-stride-0 views; the ring below, at and far past
its width, wider and narrower than the window. Phase 6 prints the GLA
kernels' share of each hymba prefill.
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
import tempfile
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
# float32 keeps 15 more bits than bf16, so two float32 paths that differ
# only in summation order sit orders of magnitude closer to each other than
# the bf16 path sits to float32; this share of that distance leaves room
# for sums over thousands of terms (hold_to_plain, noisy models)
F32_NOISE_SHARE = 1e-2
# two bf16 logits this many ulps apart or closer are a tie: the two GLA
# schedules' first tokens are held equal on every other row, and at least
# this share of the rows must be held
TIE_ULPS = 1
MIN_HELD_SHARE = 0.5
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# the serving paths' shapes, whose largest errors go into the JSON record:
# granite's prefill and last decode step, hymba's prefill (windowed and
# global layers) and its global layers' first and last decode steps
F_MAIN = ("bfloat16 B4 H32 K8 S1024 D64 window=None",
          "bfloat16 B4 H25 K5 S1536 D64 window=1024",
          "bfloat16 B4 H25 K5 S1536 D64 window=None")
D_MAIN = ("bfloat16 B4 H32 K8 S1056 D64 length=1056 window=None",
          "bfloat16 B4 H25 K5 S1568 D64 length=1537 window=None",
          "bfloat16 B4 H25 K5 S1568 D64 length=1568 window=None")
P_MAIN = "bfloat16 B1 H32 K8 D64 layer 20/40 lengths=[1056] window=None"
# the GLA kernels are held to tests/test_kernels.py's GLA sweep tolerances
# (atol = rtol): the plain versions sum hundreds of decayed terms in
# another order, and the outputs are not bounded by 1
GLA_TOL = {"bfloat16": 5e-2, "float32": 5e-4}
# hymba's SSD heads at the serving shape: B, S, heads, N, P, chunk
G_SHAPE = (4, 1536, 25, 16, 64, 256)
G_MAIN = "bfloat16 B4 S1536 H25 N16 P64 chunk=256 head-stride-0 q/k"
# hymba's windowed decode: B4 H25 K5 D64, a 1024-slot ring, the last step
R_MAIN = "bfloat16 B4 H25 K5 D64 W_ring=1024 window=1024 pos=1567"
# K1's logsumexp (float32 in both dtypes) against the plain one: 1e-4
# absolute (ex2.approx and another summation order over the same scores),
# against values of order log S. The backward's gradients are not bounded
# by 1, so they are held by max |a - b| / max |b|: bf16 2e-2 (P and dS are
# rounded to bf16 for their products, as the forward rounds P, and the
# gradients to bf16 on output), float32 2e-5 (summation order only)
LSE_TOL = 1e-4
BWD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the backward at granite's training shape (the JSON record's errors), at a
# ragged S, and with a window at a smoke shape
BWD_SHAPES = ((4, 32, 8, 1024, 64, None), (4, 32, 8, 1000, 64, None),
              (2, 4, 2, 200, 32, 50))
B_MAIN = "bfloat16 B4 H32 K8 S1024 D64 window=None"
BWD_PARTS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
# the train phase: batch x tokens, timed steps, and its step 1 held to the
# same step on the plain attention path (bf16 both, on the card): the
# kernels round P and dS to bf16 where the plain version keeps float32, and
# forty random-weight layers carry that rounding into every gradient. The
# loss within 5e-4 and grad_norm within 1e-3 (relative; ~10x the 3.4e-5
# and 4.7e-5 read on the card), and each leaf's gradient within 1e-1 of
# the plain one's norm (||a - b|| / ||b||; 3.3e-2 read). The loss cannot
# see the backward at all; tools/train_fault_witness.py plants backward
# faults and reads what these bounds catch (PERF.md)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 10
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_GRAD_TOL = 5e-4, 1e-3, 1e-1
# its C/R part: granite's widths at CR_LAYERS layers (about 4.5 GB of params
# and AdamW state), CR_STEPS steps, a checkpoint every CR_EVERY, the last
# rank killed at step CR_KILL_AT
CR_LAYERS, CR_STEPS, CR_EVERY, CR_KILL_AT = 4, 6, 3, 4
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


def kernel_us(fn, sets, iters=40):
    """Device microseconds per call of each CUDA kernel ``fn`` launches, by
    name, from the profiler over ``iters`` calls cycling through ``sets``
    (the profiler reads each kernel's device time, so the host's pace does
    not enter). A warm-up step comes first: the tracer may drop the records
    of the first launches after it starts."""
    import torch
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                                 active=1, repeat=1)) as prof:
        fn(*sets[0])
        torch.cuda.synchronize()
        prof.step()
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
        prof.step()
    return {e.key: e.self_device_time_total / iters for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def rel(a, b):
    """max |a - b| over max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def bf16_ties(logits):
    """Rows whose top two logits lie within TIE_ULPS bf16 ulps (at the top
    logit's magnitude) of each other: there two bf16 paths that differ only
    in rounding may pick either token."""
    import torch
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs().clamp_min(1e-30))) - 7)
    return ((top2[:, 0] - top2[:, 1]) <= TIE_ULPS * ulp).cpu().numpy()


def hold_to_plain(tag, cfg, model, params, tokens, feed, dev, *, noisy=False):
    """The same weights through the plain kernel versions in the same dtype
    and through a float32 copy of the model (plain versions): the prefill
    of ``tokens`` and one teacher-forced decode step per token of ``feed``
    give every path the kernel path's tokens, so an argmax flip on a near
    tie cannot make the streams diverge. bf16 rounding alone moves the
    logits of a deep random-weight model, so the kernel path is held to
    the plain path's own distance from float32 (kernel-f32 within
    F32_DIST_RATIO times plain-f32), and:

    - ``noisy=False`` (granite, whose bf16 logits sit ~2% from float32):
      kernel-plain within LOGIT_REL_TOL, and equal first greedy tokens;
    - ``noisy=True`` (hymba, whose random-weight bf16 logits sit tens of
      percent from float32, so a near tie's argmax is noise; the JAX
      package drifts as far at full depth, see tests/test_torch_hymba.py
      ``test_bf16_drift_is_the_models_not_the_ports``): kernel-plain
      within F32_DIST_RATIO times plain-f32, the bf16 first tokens printed;
      and the deciding agreement in float32, where the float32 kernel path
      under each GLA schedule must sit within F32_NOISE_SHARE of plain-f32
      from the float32 plain path at every step, with equal first tokens.

    Returns (whether every check held, plain-f32 at each step)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.params import tree_map
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                cache_dtype="float32")
    n_prompt = tokens.shape[1]
    V = cfg.vocab_size

    def run(m, p):
        lg, caches = m.prefill(p, tokens, max_len=n_prompt + len(feed))
        out = [lg]
        for i, t in enumerate(feed):
            lg, caches = m.decode_step(p, torch.as_tensor(t, device=dev).long(),
                                       n_prompt + i, caches)
            out.append(lg)
        return out

    def firsts(label, a, b):
        fa, fb = (torch.argmax(x[0][:, :V], dim=-1).cpu().numpy() for x in (a, b))
        top2 = torch.topk(b[0][:, :V], 2, dim=-1).values
        print(f"[{tag}] {label} first token kernel {fa.tolist()} plain {fb.tolist()} "
              f"(plain top-2 margin {(top2[:, 0] - top2[:, 1]).tolist()})", flush=True)
        return np.array_equal(fa, fb)

    def step(i):
        return "prefill" if i == 0 else f"decode step {i}"

    got = run(model, params)
    want = run(dataclasses.replace(model, force="ref"), params)
    p32 = tree_map(lambda t: t.float(), params)
    truth = run(dataclasses.replace(model, cfg=cfg32, force="ref"), p32)
    ok, plain_f32 = True, []
    for i, (a, b, t) in enumerate(zip(got, want, truth)):
        r_kp, r_kt, r_pt = rel(a, b), rel(a, t), rel(b, t)
        plain_f32.append(r_pt)
        cap = F32_DIST_RATIO * r_pt if noisy else LOGIT_REL_TOL
        good = math.isfinite(r_kp) and r_kp <= cap and r_kt <= F32_DIST_RATIO * r_pt
        ok = ok and good
        print(f"[{tag}] {step(i)} logits, max|a-b|/max|b|: kernel-plain {r_kp:.3e} "
              f"(tol {cap:.3e}), kernel-f32 {r_kt:.3e}, plain-f32 {r_pt:.3e} "
              f"(tol kernel-f32 <= {F32_DIST_RATIO:g} x plain-f32) {'ok' if good else 'FAIL'}")
    same = firsts(str(cfg.compute_dtype), got, want)
    if not noisy:
        ok = ok and same
    else:
        for schedule in ("chunk", "parallel"):
            k32 = run(dataclasses.replace(model, cfg=cfg32, force=None,
                                          gla_schedule=schedule), p32)
            for i, (a, t) in enumerate(zip(k32, truth)):
                r, tol = rel(a, t), F32_NOISE_SHARE * plain_f32[i]
                good = math.isfinite(r) and r <= tol
                ok = ok and good
                print(f"[{tag}] float32 kernel path ({schedule} schedule) {step(i)} logits "
                      f"vs float32 plain path: max|a-b|/max|b| {r:.3e} (tol "
                      f"{F32_NOISE_SHARE:g} x plain-f32 = {tol:.3e}) {'ok' if good else 'FAIL'}")
            ok = firsts(f"float32 ({schedule} schedule)", k32, truth) and ok
            del k32
    del p32
    return ok, plain_f32


def decode_idle(tag, model, params, tokens, first, step_ms, dev):
    """Where one decode step's time goes: device busy time from the
    profiler against the measured ms/step."""
    import torch
    n_prompt = tokens.shape[1]
    _, caches = model.prefill(params, tokens, max_len=n_prompt + 2)
    tok = torch.as_tensor(first, device=dev).long()
    model.decode_step(params, tok, n_prompt, caches)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, tok, n_prompt + 1, caches)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms > 0:
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[{tag}] one decode step: device busy {busy_ms:.3f} ms of "
              f"{step_ms:.2f} ms/step ({1 - busy_ms / step_ms:.1%} idle); top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms "
                          f"x{e.count}" for e in top), flush=True)
    else:
        print(f"[{tag}] one decode step: device busy time not measured "
              "(the profiler saw no CUDA kernels)", flush=True)


def ckpt_phase(cfg, params, prompts, n_gen, card, dev, DA, FA):
    """Snapshot full-width granite mid-decode, restore it into a fresh Server
    under another flavor, and hold tail B to tail A (see the docstring)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import ckpt_io
    from repro_torch.core.ckpt_pipeline import host_dtype
    from repro_torch.core.restore import load_arrays
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.engine import Server

    def digest(t):
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return ckpt_io.shard_digest(bits.cpu().numpy().view(host_dtype(t)))

    n_prompt = prompts.shape[1]
    srv_dev = params["embed"].device
    with tempfile.TemporaryDirectory(prefix="ckpt_phase") as ckdir:
        srv = Server(cfg, params=params, device=dev, backend="mpich",
                     ckpt_dir=ckdir)
        logits = srv.prefill(prompts, pad_to=n_prompt + 2 * n_gen)
        first = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).cpu().numpy()
        toks, _ = srv.decode(n_gen, first)
        ref = [t.clone() for t in tree_leaves(srv.caches)]
        n_da = DA.launches
        # the writer's first snapshot: its pinned arena grows inside the window
        req = srv.checkpoint()
        if DA.launches != n_da:
            raise AssertionError("the snapshot launched a decode kernel")
        step = req.directory
        # tail A writes into the caches at once, while the write persists
        tail_a, _ = srv.decode(n_gen, toks[-1])
        req.wait()
        key_a = srv.rng_key.copy()
        # a second snapshot, on the arena the first one grew
        warm = srv.checkpoint()
        warm.wait()
        snap_bytes = sum(t.numel() * t.element_size() for t in ref)
        want = [digest(t) for t in ref]
        t0 = time.perf_counter()
        on_disk = tree_leaves(load_arrays(step, {"runtime": {"kv_caches": [
            {"attn": {"k": None, "v": None}}], "rng": None}})["runtime"]["kv_caches"])
        read_ms = (time.perf_counter() - t0) * 1e3
        if [ckpt_io.shard_digest(a) for a in on_disk] != want:
            raise AssertionError("the snapshot on disk differs from the caches at the snapshot")
        del srv, ref, on_disk
        torch.cuda.empty_cache()

        fresh = Server(cfg, params=params, device=dev, backend="mpich",
                       ckpt_dir=ckdir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.restore(step, new_backend="exampi", rebuild=True)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        got = [digest(t) for t in tree_leaves(fresh.caches)]
        if got != want:
            raise AssertionError("restored caches' digests differ from the snapshot's")
        if fresh.pos != n_prompt + n_gen or fresh.max_len != n_prompt + 2 * n_gen \
                or fresh.caches[0]["attn"]["k"].device != srv_dev:
            raise AssertionError(f"restored cursor pos {fresh.pos} max_len {fresh.max_len}")
        FA.launches = DA.launches = 0
        tail_b, _ = fresh.decode(n_gen, fresh.resume_tok)
        launches = (FA.launches, DA.launches)
        if launches != (0, cfg.n_layers * n_gen):
            raise AssertionError(f"restored decode launches (flash, decode) {launches}")
        a, b = np.stack(tail_a, axis=1), np.stack(tail_b, axis=1)
        if a.tobytes() != b.tobytes() or a.shape != (prompts.shape[0], n_gen):
            raise AssertionError(f"tail B differs from tail A:\n{a}\n{b}")
        if fresh.rng_key.tobytes() != key_a.tobytes():
            raise AssertionError("restored RNG key stream differs")
        rt = fresh.cluster.restart_timings
        backend = fresh.cluster.backend_name
        # the restored server's first snapshot, on the arena the restore grew
        after = fresh.checkpoint()
        after.wait()
        del fresh
        torch.cuda.empty_cache()

    # the yardstick: one pinned copy_ of the same bytes off the card
    copy_ms = pinned_copy_ms(snap_bytes, dev)
    tm, tw, tr = req.timings, warm.timings, after.timings
    print(f"[ckpt] snapshot of {snap_bytes / 1e6:.1f} MB of caches at pos "
          f"{n_prompt + n_gen}, the writer's first ({card}): blocking "
          f"{tm['blocking_ms']} ms = drain {tm['drain_ms']} ms, snapshot "
          f"{tm['snapshot_ms']} ms, enqueue {tm['enqueue_ms']} ms and the pinned "
          f"arena's growth; persist {tm['persist_ms']} ms", flush=True)
    print(f"[ckpt] later snapshots, on a grown arena ({card}): the second, at pos "
          f"{n_prompt + 2 * n_gen}: blocking {tw['blocking_ms']} ms (snapshot "
          f"{tw['snapshot_ms']} ms), persist {tw['persist_ms']} ms; the restored "
          f"Server's first, on the arena its restore grew: blocking "
          f"{tr['blocking_ms']} ms (snapshot {tr['snapshot_ms']} ms)", flush=True)
    print(f"[ckpt] restart mpich -> {backend} into a fresh Server ({card}): "
          f"{rt}; restore on the host clock {restore_ms:.1f} ms; the container "
          f"read to host arrays alone (load_arrays, no placement) {read_ms:.1f} ms",
          flush=True)
    print(f"[ckpt] device-to-host {snap_bytes / tm['snapshot_ms'] / 1e6:.2f} GB/s "
          f"(the first snapshot's copies), {snap_bytes / tw['snapshot_ms'] / 1e6:.2f} "
          f"GB/s (the second's) vs {snap_bytes / copy_ms / 1e6:.2f} GB/s for one pinned "
          f"copy_ of {snap_bytes / 1e6:.1f} MB ({copy_ms:.3f} ms) ({card})", flush=True)
    print(f"[ckpt] tail B ({n_gen} tokens x {a.shape[0]} after the restore) equals "
          f"tail A byte for byte; caches' digests equal; RNG key equal; restored "
          f"decode launches flash {launches[0]}, decode {launches[1]}", flush=True)


def bwd_times(fsets, B, H, K, S, D, randn, FA, ref, cuda_ms, F):
    """K1's backward at granite's training shape, bf16, on the forward's
    own output and logsumexp: the whole backward's CUDA-graph time against
    its operations bound (five products of the forward's size), the plain
    version's, and SDPA's backward as a yardstick (``torch.autograd.grad``
    of its causal GQA forward: the profiler's device time per call, summed
    over its kernels, since its autograd graph is not captured in a CUDA
    graph and the host paces it); then each of the two kernels' profiler
    time per call beside its own bound and its plain version's CUDA-graph
    time (the dQ kernel's with the row sums it writes). Returns {kernel:
    (ms, plain_ms, bound_ms, bound_by)}."""
    import torch
    bf = torch.bfloat16
    bsets, dsets = [], []
    for q, k, v in fsets:
        o, lse = FA.flash_attention(q, k, v, lse=True)
        do = randn(B, H, S, D, dtype=bf)
        bsets.append((q, k, v, o, lse, do))
        dsets.append((q, k, v, lse, do, ref.attention_bwd_delta(o, do)))
    ms = cuda_ms(lambda *a: FA.flash_attention_bwd(*a), bsets)
    plain = cuda_ms(lambda *a: ref.flash_attention_bwd(*a), bsets, iters=5)
    lib_sets = []
    for q, k, v, _, _, do in bsets:
        ins = tuple(x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(*ins, is_causal=True, enable_gqa=True)
        lib_sets.append((out, ins, do))

    def sdpa_bwd(out, ins, do):
        return torch.autograd.grad(out, ins, do, retain_graph=True)
    lib = sum(kernel_us(sdpa_bwd, lib_sets, iters=20).values()) / 1e3
    del lib_sets
    n_q, n_kv, rows, pairs = B * H * S * D, B * K * S * D, B * H * S, S * S / 2
    # q, k, v, o, dO and the logsumexp read once, dq, dk, dv written once
    bound, by = bound_ms(5 * 2 * B * H * pairs * D, 2 * (4 * n_q + 4 * n_kv) + 4 * rows)
    us = kernel_us(lambda *a: FA.flash_attention_bwd(*a), bsets, iters=20)

    def one(name):
        hits = [t for key, t in us.items() if name in key]
        if len(hits) != 1 or len(us) != 2:
            raise AssertionError(f"flash_attention_bwd: the profiler saw {list(us)}")
        return hits[0] / 1e3

    def plain_dq(q, k, v, o, lse, do):
        return ref.attention_bwd_dq(q, k, v, lse, do, ref.attention_bwd_delta(o, do))
    out = {
        # S, dP, dQ: three products, and the row sums (float32 multiply-adds
        # at the float32 rate, counted in tensor-core time); q, k, v, o, dO,
        # lse read, dq and the row sums written
        "flash_attention_bwd_dq": (
            one("dq_bf16_kernel"),
            cuda_ms(plain_dq, bsets, iters=5),
            *bound_ms(3 * 2 * B * H * pairs * D + 2 * n_q * PEAK_BF16_FLOPS / PEAK_F32_FLOPS,
                      2 * (4 * n_q + 2 * n_kv) + 8 * rows)),
        # S, dP, dV, dK: four products; q, k, v, dO, lse, Dr read, dk, dv written
        "flash_attention_bwd_dkdv": (
            one("dkdv_bf16_kernel"),
            cuda_ms(lambda *a: ref.attention_bwd_dkdv(*a), dsets, iters=5),
            *bound_ms(4 * 2 * B * H * pairs * D, 2 * (2 * n_q + 4 * n_kv) + 8 * rows)),
    }
    print(f"[kernels] flash_attention_bwd bf16 B{B} H{H} K{K} S{S} D{D} causal (the train "
          f"path's shape): {ms * 1e3:.1f} us (dQ + dK/dV), plain "
          f"{plain * 1e3:.1f} us, sdpa backward (yardstick, profiler) {lib * 1e3:.1f} us, bound "
          f"{bound * 1e3:.2f} us ({by}: 5 products of the forward's size); per kernel "
          f"(profiler): " + "; ".join(
              f"{n[20:]} {t[0] * 1e3:.1f} us (plain {t[1] * 1e3:.1f} us, bound "
              f"{t[2] * 1e3:.2f} us {t[3]})" for n, t in out.items()), flush=True)
    out["whole"] = (ms, plain, bound, by, lib)
    return out


def train_phase(card, dev):
    """Full-width granite-3-2b through the port's Trainer (see the module
    docstring, phase ``train``). Returns the backward kernels' launch counts
    over the ten timed steps."""
    import shutil
    import statistics

    import torch

    from repro_torch import steps as ST
    from repro_torch.configs import CkptIOConfig, get_config
    from repro_torch.core.ckpt_tiers import ReplicaTier
    from repro_torch.core.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.core.supervisor import Supervisor, SupervisorConfig
    from repro_torch.data import synth_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import Trainer
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import global_norm

    cfg = get_config("granite-3-2b")
    L, hd = cfg.n_layers, cfg.resolved_head_dim

    def counts():
        return {"flash_attention": FA.launches, "flash_attention_bwd_dq": FA.bwd_dq_launches,
                "flash_attention_bwd_dkdv": FA.bwd_dkdv_launches}

    def zero_counts():
        FA.launches = FA.bwd_dq_launches = FA.bwd_dkdv_launches = 0

    def expect(label, got, n_steps, n_layers=L):
        # remat runs each layer's forward twice a step, the backward once
        want = {k: (2 if k == "flash_attention" else 1) * n_layers * n_steps for k in got}
        if got != want:
            raise AssertionError(f"train: {label} launch counts {got} != {want}")
        return got

    def names(tree, path=""):
        if isinstance(tree, dict):
            return [n for k in sorted(tree) for n in names(tree[k], f"{path}/{k}")]
        if isinstance(tree, list):
            return [n for i, t in enumerate(tree) for n in names(t, f"{path}/{i}")]
        return [path[1:]]

    def rel_norm(a, b):
        return (torch.linalg.vector_norm(a.float() - b.float())
                / torch.linalg.vector_norm(b.float())).item()

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tr = Trainer(cfg, batch_size=TRAIN_B, seq_len=TRAIN_S, world_size=2, backend="mpich",
                 total_steps=TRAIN_STEPS, device=dev)
    if not torch.are_deterministic_algorithms_enabled():
        raise AssertionError("train: the Trainer did not turn on deterministic algorithms")
    tr.init_state()
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves({"p": tr.params, "o": tr.opt_state})) / 1e9
    # the pipeline's first batch, from its seed, for the holds below
    batch = tr._device_batch(synth_batch(cfg, TRAIN_B, TRAIN_S, tr.pipeline.seed, 0))

    # step 1's loss and gradients: the kernel path against the plain path
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g_k, _, loss_k, _ = ST.loss_and_grads(tr.model, tr.params, batch)
    torch.cuda.synchronize()
    fb_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step1 = expect("step 1", counts(), 1)
    gn_k = global_norm(g_k).item()
    g_p, _, loss_p, _ = ST.loss_and_grads(Model(cfg, force="ref"), tr.params, batch)
    if counts() != step1:
        raise AssertionError("train: the plain path launched a kernel")
    gn_p = global_norm(g_p).item()
    errs = [rel_norm(a, b) for a, b in zip(tree_leaves(g_k), tree_leaves(g_p))]
    finite = all(torch.isfinite(t).all().item() for t in tree_leaves(g_k))
    del g_k, g_p
    leaf = names(tr.params)
    worst = max(range(len(errs)), key=errs.__getitem__)
    r_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    r_gn = abs(gn_k - gn_p) / gn_p
    ok = (finite and r_loss <= TRAIN_LOSS_TOL and r_gn <= TRAIN_GNORM_TOL
          and max(errs) <= TRAIN_GRAD_TOL)
    print(f"[train] step 1 (batch 0 from the pipeline's seed), kernel path vs plain "
          f"attention path under autograd: loss {loss_k.item():.6f} vs {loss_p.item():.6f} "
          f"(rel {r_loss:.3e}, tol {TRAIN_LOSS_TOL:g}); grad_norm {gn_k:.6f} vs {gn_p:.6f} "
          f"(rel {r_gn:.3e}, tol {TRAIN_GNORM_TOL:g}); per-leaf gradient ||a-b||/||b|| "
          f"max {max(errs):.3e} at {leaf[worst]}, median {statistics.median(errs):.3e} "
          f"over {len(errs)} leaves (tol {TRAIN_GRAD_TOL:g}); launches {step1} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("train: step 1 on the kernel path disagrees with the plain path")

    # the same step from the same state, twice: equal bytes (step index 1,
    # whose learning rate is past the warm-up's 0)
    # (the step updates tr's params and state in place and returns them)
    head0 = tr.params["head"].clone()
    m1 = tr.train_step(tr.params, tr.opt_state, batch, 1)[2]
    snap = [t.clone() for t in tree_leaves(tr.params)]
    moved = not torch.equal(tr.params["head"], head0)
    first = (m1["loss"].item(), m1["grad_norm"].item())
    del m1, head0
    tr.init_state()
    m2 = tr.train_step(tr.params, tr.opt_state, batch, 1)[2]
    same = all(torch.equal(a, b) for a, b in zip(snap, tree_leaves(tr.params))) \
        and (m2["loss"].item(), m2["grad_norm"].item()) == first
    del snap, m2
    print(f"[train] the same step from the same state twice: params equal byte for byte "
          f"{same}, loss and grad_norm equal {same}; the step moved the params {moved}",
          flush=True)
    if not (same and moved):
        raise AssertionError("train: a repeated step differs (or moved nothing)")

    # ten steps through step_once: the pipeline, the update, the metrics
    # allreduce on the MANA plane and the heartbeats
    tr.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, hist = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.step_once()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        hist.append((float(m["loss"]), float(m["grad_norm"]), float(m["world_loss"])))
    main = expect(f"{TRAIN_STEPS} steps", counts(), TRAIN_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for h in hist for x in h) \
            or any(h[2] != h[0] for h in hist):
        raise AssertionError(f"train: bad metrics {hist}")
    step_ms = statistics.median(times[2:]) * 1e3
    tokens = TRAIN_B * TRAIN_S
    # model FLOPs: 6 N per token for the matmul params (the embedding table
    # is a lookup), and the causal attention's 6 products of S^2/2 pairs
    # (forward 2, backward 4; remat's recompute not counted)
    n_matmul = n_params - cfg.padded_vocab * cfg.d_model
    attn_flops = 6 * TRAIN_B * cfg.n_heads * TRAIN_S * TRAIN_S * hd * L
    mfu = (6 * n_matmul * tokens + attn_flops) / (step_ms / 1e3) / PEAK_BF16_FLOPS
    print(f"[train] granite-3-2b {n_params / 1e9:.3f}B params {cfg.param_dtype}, {L} layers, AdamW "
          f"float32 state, remat on, batch {TRAIN_B} x {TRAIN_S} tokens ({card}): "
          f"{TRAIN_STEPS} steps, step ms {[round(t * 1e3, 1) for t in times]}; median of "
          f"steps 3-{TRAIN_STEPS} {step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tok/s, "
          f"mfu {mfu:.3f} (6 x {n_matmul / 1e9:.3f}B matmul params x {tokens} tokens + "
          f"{attn_flops / 1e12:.2f} TFLOP attention, over 989 TFLOP/s); params + AdamW "
          f"state {state_gb:.2f} GB, peak memory {peak_gb:.2f} GB (forward and backward "
          f"alone, step 1: {fb_peak_gb:.2f} GB)", flush=True)
    print(f"[train] losses {[round(h[0], 4) for h in hist]}; grad_norm "
          f"{[round(h[1], 3) for h in hist]}; world_loss equals loss; launches {main} "
          f"(expected {2 * L}, {L}, {L} a step)", flush=True)

    # one profiled step after a warm-up one: the device's busy and idle
    # share and K1's forward and backward kernels' share of the step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                                 active=1, repeat=1)) as prof:
        tr.step_once()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        tr.step_once()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    fwd = sum(e.self_device_time_total for e in kern if "flash_bf16_kernel" in e.key) / 1e3
    bwd = {n: sum(e.self_device_time_total for e in kern if n in e.key) / 1e3
           for n in ("dq_bf16_kernel", "dkdv_bf16_kernel")}
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    if busy <= 0:
        print("[train] profiled step: device busy time not measured (the profiler saw no "
              "CUDA kernels)", flush=True)
    else:
        print(f"[train] one profiled step ({card}): {prof_ms:.1f} ms on the host clock, "
              f"device busy {busy:.1f} ms ({1 - busy / prof_ms:.1%} idle); K1 forward "
              f"{fwd:.2f} ms ({fwd / prof_ms:.1%} of the step, {2 * L} launches), backward "
              f"{sum(bwd.values()):.2f} ms ({sum(bwd.values()) / prof_ms:.1%}: dQ "
              f"{bwd['dq_bf16_kernel']:.2f}, dK/dV {bwd['dkdv_bf16_kernel']:.2f} ms); top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                          for e in top), flush=True)
    tr.pipeline.stop()
    del tr, batch
    torch.cuda.empty_cache()
    full_s = time.perf_counter() - t_phase

    # the C/R plane at granite's widths and CR_LAYERS layers
    t_cr = time.perf_counter()
    cfg_cr = dataclasses.replace(cfg, n_layers=CR_LAYERS)
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))

    def trainer(name):
        return Trainer(cfg_cr, batch_size=TRAIN_B, seq_len=TRAIN_S, world_size=2,
                       backend="mpich", total_steps=CR_STEPS, device=dev,
                       ckpt_dir=None if name is None else base / name,
                       ckpt_io=CkptIOConfig(codec="none"))

    def recorded(t):
        """Keep every checkpoint request the trainer makes (the supervisor
        and ``run`` both call ``checkpoint``)."""
        reqs, take = [], t.checkpoint

        def checkpoint():
            reqs.append(take())
            return reqs[-1]
        t.checkpoint = checkpoint
        return reqs

    def trace(t):
        return [(h["step"], h["loss"]) for h in t.history]

    try:
        a = trainer(None)
        a.init_state()
        a.run(CR_STEPS, log_every=1)
        want = dict(trace(a))
        ref_state = tree_leaves({"p": a.params, "o": a.opt_state})
        cr_gb = sum(t.numel() * t.element_size() for t in ref_state) / 1e9
        a.pipeline.stop()

        b = trainer("kill")
        b.init_state()
        reqs = recorded(b)
        b.run(CR_STEPS, ckpt_every=CR_EVERY, kill_rank_at=CR_KILL_AT,
              new_backend_on_restart="exampi", log_every=1)
        b.cluster.writer.wait_idle()
        same_b = all(torch.equal(x, y) for x, y in
                     zip(tree_leaves({"p": b.params, "o": b.opt_state}), ref_state))
        losses_b = trace(b)
        trace_b = all(want[s] == v for s, v in losses_b) and b.step == CR_STEPS
        rt_b, backend_b = b.restart_timings, b.cluster.backend_name
        b.pipeline.stop()
        b.cluster.writer.close()
        del b
        first = reqs[0].timings
        print(f"[train] C/R at {CR_LAYERS} layers ({cr_gb:.2f} GB of params and AdamW "
              f"state; {card}): {CR_STEPS} steps, a checkpoint every {CR_EVERY} (codec "
              f"none), rank 1 killed at step {CR_KILL_AT}, restarted under {backend_b}: "
              f"params and optimizer state equal the uninterrupted run's byte for byte "
              f"{same_b}; loss trace {[round(v, 6) for _, v in losses_b]} (steps "
              f"{[s for s, _ in losses_b]}) equal {trace_b}", flush=True)
        print(f"[train] the first checkpoint's blocking window ({card}): "
              f"{first['blocking_ms']} ms = drain {first['drain_ms']} ms, snapshot "
              f"{first['snapshot_ms']} ms (side-stream copies "
              f"{first.get('device_copy_ms')} ms), enqueue {first['enqueue_ms']} ms; "
              f"persist {first.get('persist_ms')} ms; "
              f"the next ones blocking "
              f"{[r.timings['blocking_ms'] for r in reqs[1:]]} ms, persist "
              f"{[r.timings.get('persist_ms') for r in reqs[1:]]} ms; the restart's "
              f"phases {rt_b}", flush=True)
        if not (same_b and trace_b and backend_b == "exampi"):
            raise AssertionError("train: the recovered run differs from the uninterrupted one")

        c = trainer("sup")
        c.init_state()
        reqs = recorded(c)
        plan = FaultPlan([FaultSpec("kill_rank", at_step=CR_KILL_AT, rank=1)])
        with FaultInjector(plan) as inj:
            sup = Supervisor(c, injector=inj, verbose=False, tier=ReplicaTier(),
                             config=SupervisorConfig(backoff_floor_s=0.0))
            incidents = sup.run(CR_STEPS, ckpt_every=CR_EVERY)
        c.cluster.writer.wait_idle()
        same_c = all(torch.equal(x, y) for x, y in
                     zip(tree_leaves({"p": c.params, "o": c.opt_state}), ref_state))
        trace_c = all(want[s] == v for s, v in trace(c)) and c.step == CR_STEPS
        rt_c = c.restart_timings
        c.pipeline.stop()
        c.cluster.writer.close()
        del c, a, ref_state
        inc, = incidents
        t = inc.timings
        print(f"[train] supervised at {CR_LAYERS} layers ({card}): {inc.kind} rank "
              f"{inc.rank} at step {inc.step} -> step {inc.resumed_step} from {inc.ckpt} "
              f"(tier {inc.tier}, world {inc.world_before}->{inc.world_after}); MTTR "
              f"{t['total_ms']} ms = detect {t['detect_ms']} + classify {t['classify_ms']} "
              f"+ restore {t['restore_ms']} + resume {t['resume_ms']} ms; the restart's "
              f"phases {rt_c}; checkpoints blocking "
              f"{[r.timings['blocking_ms'] for r in reqs]} ms, persist "
              f"{[r.timings.get('persist_ms') for r in reqs]} ms; params and optimizer "
              f"state equal the uninterrupted run's {same_c}; loss trace equal {trace_c}",
              flush=True)
        if not (same_c and trace_c and inc.tier == "ram" and inc.resumed_step == CR_EVERY):
            raise AssertionError("train: the supervised recovery differs")
    finally:
        shutil.rmtree(base, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"[train] phase seconds: full width {full_s:.1f} s, C/R {time.perf_counter() - t_cr:.1f} s",
          flush=True)
    return main


def pinned_copy_ms(nbytes, dev):
    """Device ms of one pinned, non-blocking ``copy_`` of ``nbytes`` off the
    card: the yardstick of a snapshot's copies."""
    import torch
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    devbuf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    host.copy_(devbuf)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    host.copy_(devbuf, non_blocking=True)
    ev1.record()
    ev1.synchronize()
    return ev0.elapsed_time(ev1)


def recover_phase(cfg, params, fleet_prompts, max_len, base, prompts, serve_stream,
                  card, dev, FA, DA, PA):
    """The supervised recovery plane on phase 5's fleet and phase 4's Server
    (see the docstring). ``base`` maps each fleet session to its phase-5
    stream, ``serve_stream`` is phase 4's [B, n] token stream."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.ckpt_tiers import ReplicaTier
    from repro_torch.core.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.core.supervisor import Supervisor, SupervisorConfig
    from repro_torch.serving import ServeEngine, Server, migrate_sessions
    from repro_torch.serving.scheduler import RUNNING

    late_sid = f"s{len(fleet_prompts):04d}"

    class Traffic(ServeEngine):
        """Phase 5's traffic: the late high-priority session arrives with
        tick FLEET_LATE_AT."""

        def step_once(self):
            if self.tick == FLEET_LATE_AT and late_sid not in self.sessions:
                self.submit(fleet_prompts[-1], sid=late_sid, max_new_tokens=FLEET_NEW,
                            priority=5)
            return super().step_once()

    def engine(backend, ckpt_dir, submit=True, cls=Traffic):
        eng = cls(cfg, params=params, device="cuda", backend=backend, ckpt_dir=ckpt_dir,
                  max_len=max_len, page_size=FLEET_PAGE, n_pages=FLEET_PAGES,
                  max_running=FLEET_LANES)
        if submit:
            for i, p in enumerate(fleet_prompts[:-1]):
                eng.submit(p, sid=f"s{i + 1:04d}", max_new_tokens=FLEET_NEW)
        return eng

    def streams(*engines):
        return {s: e.stream(s) for e in engines for s in e.sessions
                if e.sched.state(s) != "MIGRATED"}

    def resident_bytes(eng):
        per_row = sum(st.shape[2] * st.element_size() for st in eng.pool.stores.values())
        return sum(a.length for a in eng.pool.sessions.values()) * per_row

    def parked_bytes(eng):
        return sum(a.nbytes for pay in eng.pool.parked.values()
                   for part in ("tokens", "blocks") for a in pay[part].values())

    t_phase = time.perf_counter()
    n_layers = cfg.n_layers
    # -- (a) snapshot after tick 6 under mpich, resume under exampi -----------
    with tempfile.TemporaryDirectory(prefix="recover_a") as ckdir:
        eng = engine("mpich", ckdir)
        for _ in range(6):
            eng.step_once()
        torch.cuda.synchronize()
        snap_bytes, host_bytes = resident_bytes(eng), parked_bytes(eng)
        n_da = (DA.launches, PA.launches, FA.launches)
        t0 = time.perf_counter()
        req = eng.checkpoint()
        call_ms = (time.perf_counter() - t0) * 1e3
        req.wait()
        if (DA.launches, PA.launches, FA.launches) != n_da:
            raise AssertionError("the fleet snapshot launched a decode or flash kernel")
        t0 = time.perf_counter()
        warm = eng.checkpoint()            # the same state, on the grown arena
        warm_call_ms = (time.perf_counter() - t0) * 1e3
        warm.wait()
        at_snap = {s: len(eng.stream(s)) for s in eng.sessions}
        parked = sorted(eng.pool.parked)
        copy_ms = pinned_copy_ms(snap_bytes, dev)

        # -- (c) two running sessions of this engine move to a fabric engine --
        dst = engine("fabric", None, submit=False, cls=ServeEngine)
        moving = [s for s in eng.sched.running if eng.sched.state(s) == RUNNING][:2]
        if len(moving) != 2:
            raise AssertionError(f"fewer than two running sessions at tick 6: {moving}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = migrate_sessions(eng, dst, moving)
        stall_ms = (time.perf_counter() - t0) * 1e3
        # the source's other sessions are not decoded on: (a)'s resume below
        # runs every session on from the same tick-6 state
        if any(eng.sched.state(s) != "MIGRATED" for s in moving):
            raise AssertionError(f"the source did not release {moving}")
        dst.run_until_drained()
        torch.cuda.synchronize()
        got = streams(dst)
        if sorted(dst.sessions) != sorted(moving) or got != {s: base[s] for s in moving}:
            raise AssertionError(f"migrated streams differ from phase 5's: {moving}")
        print(f"[recover] (c) live migration at tick 6, mpich -> fabric: sessions "
              f"{rep.sessions}, stall {stall_ms:.1f} ms (host clock, both sessions), "
              f"{rep.chunks} chunks, {rep.bytes / 1e6:.1f} MB, "
              f"{rep.reencoded_leaves} leaves re-encoded; every stream equals phase 5's "
              f"({card})", flush=True)
        del eng, dst
        torch.cuda.empty_cache()

        fresh = engine("mpich", ckdir, submit=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fresh.resume_latest(new_backend="exampi") is None:
            raise AssertionError("no resumable fleet snapshot")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        rt = fresh.cluster.restart_timings
        if fresh.cluster.backend_name != "exampi" or fresh.tick != 6 \
                or any(t.device.type != dev.type for t in fresh.pool.stores.values()):
            raise AssertionError("the fleet did not resume on the card under exampi at tick 6")
        FA.launches = DA.launches = PA.launches = 0
        t0 = time.perf_counter()
        fresh.run_until_drained()
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        resumed = (FA.launches, DA.launches, PA.launches)
        if streams(fresh) != base:
            raise AssertionError("resumed fleet streams differ from phase 5's")
        prefills = sum(1 for s, n in at_snap.items()
                       if n == 0 and len(fresh.sessions[s].prompt))
        decoded = sum(len(base[s]) - n for s, n in at_snap.items()) - prefills
        want = (n_layers * prefills, 0, n_layers * decoded)
        if resumed != want:
            raise AssertionError(f"resumed fleet launches {resumed} != {want}")
        del fresh
        torch.cuda.empty_cache()
    tm, tw = req.timings, warm.timings
    print(f"[recover] (a) fleet snapshot after tick 6 ({len(at_snap)} sessions), "
          f"{snap_bytes / 1e6:.1f} MB of resident rows copied off the card and "
          f"{host_bytes / 1e6:.1f} MB of parked rows {parked} copied on the host, both "
          f"inside the window's snapshot part ({card}): the writer's "
          f"first: checkpoint() {call_ms:.1f} ms on the host clock, of it the blocking "
          f"window {tm['blocking_ms']} ms = drain {tm['drain_ms']} ms, snapshot "
          f"{tm['snapshot_ms']} ms, enqueue {tm['enqueue_ms']} ms and the pinned arena's "
          f"growth; persist {tm['persist_ms']} ms; the second on the grown arena: "
          f"checkpoint() {warm_call_ms:.1f} ms, blocking {tw['blocking_ms']} ms (snapshot "
          f"{tw['snapshot_ms']} ms), persist {tw['persist_ms']} ms", flush=True)
    for name, t in (("first", tm), ("second", tw)):
        # the two parts overlap: the side stream copies while the host does
        print(f"[recover] (a) the {name} snapshot part {t['snapshot_ms']} ms (host "
              f"clock) holds the parked rows' host copy {t['host_copy_ms']} ms "
              f"({host_bytes / 1e6:.1f} MB at "
              f"{host_bytes / max(t['host_copy_ms'], 1e-9) / 1e6:.2f} GB/s) and, "
              f"overlapping it, the resident rows' copies on the side stream "
              f"{t['device_copy_ms']} ms (CUDA events, {snap_bytes / 1e6:.1f} MB at "
              f"{snap_bytes / max(t['device_copy_ms'], 1e-9) / 1e6:.2f} GB/s); one "
              f"pinned copy_ of the {snap_bytes / 1e6:.1f} MB of resident rows takes "
              f"{copy_ms:.3f} ms ({snap_bytes / copy_ms / 1e6:.2f} GB/s) ({card})",
              flush=True)
    print(f"[recover] (a) resume mpich -> exampi into a fresh engine: {rt}; restore on "
          f"the host clock {restore_ms:.1f} ms; the resumed run {resumed_s:.2f} s launched "
          f"flash {resumed[0]} (expected {want[0]}: {prefills} prefills), paged decode "
          f"{resumed[2]} (expected {want[2]}: {decoded} tokens), contiguous decode "
          f"{resumed[1]}; every stream equals phase 5's ({card})", flush=True)

    # -- (b) a rank death re-homed by the supervisor, RAM tier then disk ------
    for tier in ("ram", "disk"):
        with tempfile.TemporaryDirectory(prefix=f"recover_b_{tier}") as ckdir:
            eng = engine("mpich", ckdir)
            ram = ReplicaTier() if tier == "ram" else None
            t0 = time.perf_counter()
            plan = FaultPlan([FaultSpec("kill_rank", at_step=5, rank=1)])
            with FaultInjector(plan) as inj:
                sup = Supervisor(eng, injector=inj, lease_s=1.0, tier=ram,
                                 config=SupervisorConfig(backoff_floor_s=0.0))
                incidents = sup.run(10, ckpt_every=3)
            eng.run_until_drained()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if len(incidents) != 1:
                raise AssertionError(f"{tier}: {len(incidents)} incidents")
            inc = incidents[0]
            if (inc.kind, inc.tier, inc.world_before, inc.world_after) != \
                    ("rank_dead", tier, 2, 1) or not inc.rehomed or inc.rehomed < 1:
                raise AssertionError(f"{tier}: incident {inc.to_dict()}")
            if streams(eng) != base:
                raise AssertionError(f"{tier}: re-homed streams differ from phase 5's")
            t = inc.timings
            extra = ""
            if ram is not None:
                st = ram.stats
                extra = (f"; RAM tier: {st['replicated_steps']} snapshots replicated, "
                         f"{st['push_ms_total'] / max(st['replicated_steps'], 1):.1f} ms "
                         f"and {st['pushed_bytes'] / max(st['replicated_steps'], 1) / 1e6:.1f}"
                         f" MB each")
            print(f"[recover] (b) kill_rank rank 1 at tick 5, served by {inc.tier} "
                  f"({inc.ckpt}), world {inc.world_before}->{inc.world_after}, "
                  f"{inc.rehomed} sessions re-homed, tick {inc.step}->{inc.resumed_step}: "
                  f"MTTR {t['total_ms']} ms = detect {t['detect_ms']} + classify "
                  f"{t['classify_ms']} + restore {t['restore_ms']} + resume "
                  f"{t['resume_ms']} ms{extra}; streams equal phase 5's; {secs:.1f} s "
                  f"({card})", flush=True)
            eng.cluster.writer.close()
            del eng
            torch.cuda.empty_cache()

    # -- phase 4's Server under a preemption notice: the rescale rung ---------
    n_gen = serve_stream.shape[1]
    srv = Server(cfg, params=params, device="cuda")
    logits = srv.prefill(prompts, pad_to=prompts.shape[1] + n_gen)
    srv.start_decode(torch.argmax(logits[:, : cfg.vocab_size], dim=-1).cpu().numpy())
    del logits
    torch.cuda.synchronize()
    DA.launches = 0
    with FaultInjector(FaultPlan([FaultSpec("preempt_notice", at_step=12, rank=1)])) as inj:
        sup = Supervisor(srv, injector=inj, config=SupervisorConfig(backoff_floor_s=0.0))
        incidents = sup.run(n_gen)
    if len(incidents) != 1:
        raise AssertionError(f"server: {len(incidents)} incidents")
    inc = incidents[0]
    if (inc.kind, inc.tier, inc.ckpt, inc.world_after) != ("preempt_notice", "rescale",
                                                           None, 1) \
            or inc.resumed_step != inc.step:
        raise AssertionError(f"server: incident {inc.to_dict()}")
    got = np.stack(srv.generated, axis=1)
    if got.tobytes() != serve_stream.tobytes() or DA.launches != n_layers * n_gen:
        raise AssertionError(f"server: supervised tokens differ from phase 4's "
                             f"(decode launches {DA.launches})")
    print(f"[recover] Server under a preemption notice at pos {inc.step}: tier "
          f"{inc.tier}, world {inc.world_before}->{inc.world_after}, no rewind (pos "
          f"{inc.step}->{inc.resumed_step}), no image read; downtime "
          f"{inc.timings['restore_ms']} ms, total {inc.timings['total_ms']} ms; {n_gen} "
          f"tokens x {got.shape[0]} equal phase 4's; decode launches {DA.launches} "
          f"({card})", flush=True)
    del srv
    torch.cuda.empty_cache()
    print(f"[recover] phase time {time.perf_counter() - t_phase:.1f} s", flush=True)


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
    from repro_torch.kernels import gla_chunk as GC
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels.timing import cuda_ms
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

    def gla_inputs(B, S, H, N, P, dtype, bcast, steep=False):
        """tests/test_kernels.py's GLA distributions. ``bcast``: q and k as
        the SSD mixer passes them, head-broadcast views (head stride 0) of
        the C and B columns of a projection row [B, S, H*P + 2N]. ``steep``:
        log decays uniform in [-20, 0] a step (hymba's -exp(a_log) dt can
        reach them), so a chunk's cum falls to about -2500."""
        v = randn(B, S, H, P, dtype=dtype)
        lg = -F.softplus(randn(B, S, H, dtype=torch.float32)) * 0.3
        if steep:
            lg = -20 * torch.rand(B, S, H, generator=gen, device=dev)
        if not bcast:
            return (randn(B, S, H, N, dtype=dtype),
                    (randn(B, S, H, N, dtype=torch.float32) * 0.3).to(dtype), v, lg)
        row = randn(B, S, H * P + 2 * N, dtype=torch.float32)
        row[..., H * P:H * P + N] *= 0.3
        row = row.to(dtype)
        k = row[..., H * P:H * P + N, None].transpose(-1, -2).expand(B, S, H, N)
        q = row[..., H * P + N:, None].transpose(-1, -2).expand(B, S, H, N)
        return q, k, v, lg

    errs, bitwise = {}, {}

    def held(name, label, out, want, dtype, gla=False):
        """max |out - want| <= TOL; for the GLA kernels |out - want| <=
        GLA_TOL * (1 + |want|) elementwise, as np.allclose with atol = rtol."""
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        err = diff.max().item()
        dn = str(dtype).split(".")[-1]
        if gla:
            tol = GLA_TOL[dn]
            score = (diff / (1 + want.float().abs())).max().item()
            crit = f"max |a-b|/(1+|b|) {score:.3e} (tol {tol:.0e})"
        else:
            tol, score = TOL[dn], err
            crit = f"(tol {tol:.0e})"
        ok = math.isfinite(score) and score <= tol and torch.isfinite(out).all().item()
        print(f"[kernels] {name} {label}: max_abs_err {err:.3e} {crit} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        errs.setdefault(name, {})[label] = err

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for B, H, K, S, D, w in ((4, 32, 8, 1024, 64, None), (4, 32, 8, 1000, 64, None),
                                 (2, 8, 8, 1024, 64, None), (4, 32, 8, 1024, 64, 256),
                                 (4, 25, 5, 1536, 64, 1024), (4, 25, 5, 1536, 64, None),
                                 (2, 4, 2, 24, 32, None)):
            q, k, v = flash_inputs(B, H, K, S, D, dtype)
            held("flash_attention", f"{dn} B{B} H{H} K{K} S{S} D{D} window={w}",
                 FA.flash_attention(q, k, v, window=w),
                 ref.naive_attention(q, k, v, window=w), dtype)
        for B, H, K, S, D, length, w in ((4, 32, 8, 1056, 64, 1, None),
                                         (4, 32, 8, 1056, 64, DA.SPLIT, None),
                                         (4, 32, 8, 1056, 64, 1056, None),
                                         (4, 32, 8, 1056, 64, 1056, 300),
                                         (4, 25, 5, 1568, 64, 1537, None),
                                         (4, 25, 5, 1568, 64, 1568, None),
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
        # K4 and K5: hymba's serving shape with the mixer's head-broadcast
        # q/k (in bf16 also under steep decays), a smoke shape with and
        # without them, one 16-row tile a chunk, and lengths the chunk does
        # not divide (96 with chunk 64 runs chunks of 32; 1000 with 256
        # halves down to 8). The float32 kernels, exact scalar products, are
        # not held under steep decays: there the float32 cum reaches -2500
        # and each exp(cum_i - cum_j), in the plain version as in the
        # kernel, carries |cum| 2^-24 of rounding, beyond GLA_TOL
        for B, S, H, N, P, chunk, bcast, steep in (
                G_SHAPE + (True, False), G_SHAPE + (True, True),
                (2, 40, 2, 8, 32, 8, False, False), (2, 40, 2, 8, 32, 8, True, False),
                (2, 48, 2, 16, 64, 16, True, False), (1, 96, 2, 16, 64, 64, False, False),
                (2, 1000, 4, 16, 64, 256, True, False)):
            if steep and dtype != torch.bfloat16:
                continue
            q, k, v, lg = gla_inputs(B, S, H, N, P, dtype, bcast, steep)
            lab = (f"{dn} B{B} S{S} H{H} N{N} P{P} chunk={chunk}"
                   + (" head-stride-0 q/k" if bcast else "") + (" steep" if steep else ""))
            yn, hn = ref.naive_gla(q, k, v, lg)
            yc, hc = ref.chunked_gla(q, k, v, lg, chunk=chunk)
            y4, s4 = GC.gla_chunk(q, k, v, lg, chunk=chunk)
            held("gla_chunk", lab, y4, yc, dtype, gla=True)
            held("gla_chunk", lab + " final state", s4, hc, dtype, gla=True)
            held("gla_chunk", lab + " vs naive_gla", y4, yn, dtype, gla=True)
            held("gla_chunk", lab + " final state vs naive_gla", s4, hn, dtype, gla=True)
            ya, g, d = GC.gla_phase_a(q, k, v, lg, chunk=chunk)
            pa, pg, pd = ref.gla_phase_a(q, k, v, lg, chunk=chunk)
            held("gla_phase_a", lab, ya, pa, dtype, gla=True)
            held("gla_phase_a", lab + " g", g, pg, dtype, gla=True)
            held("gla_phase_a", lab + " state delta", d, pd, dtype, gla=True)
            start = ref.gla_scan(pg, pd)[0].contiguous()
            held("gla_phase_b", lab, GC.gla_phase_b(q, lg, start, pa, chunk=chunk),
                 ref.gla_phase_b(q, lg, start, pa, chunk=chunk), dtype, gla=True)
            y5, s5 = GC.gla_chunk_parallel(q, k, v, lg, chunk=chunk)
            held("gla_chunk_parallel", lab + " vs naive_gla", y5, yn, dtype, gla=True)
            held("gla_chunk_parallel", lab + " final state vs naive_gla", s5, hn, dtype,
                 gla=True)
            held("gla_chunk vs gla_chunk_parallel", lab, y4, y5, dtype, gla=True)
        # K2 over hymba's ring: below, at and far past its width, the serving
        # decode's last step, a ring wider than the window (a prompt grown by
        # pad_to) and narrower; then at smoke size
        for B, H, K, D, W, w, pos in ((4, 25, 5, 64, 1024, 1024, 100),
                                      (4, 25, 5, 64, 1024, 1024, 1023),
                                      (4, 25, 5, 64, 1024, 1024, 1567),
                                      (4, 25, 5, 64, 1024, 1024, 5000),
                                      (4, 25, 5, 64, 1100, 1024, 1090),
                                      (4, 25, 5, 64, 600, 1024, 2000),
                                      (2, 4, 2, 32, 36, 32, 45)):
            q = randn(B, H, D, dtype=dtype)
            k, v = randn(B, W, K, D, dtype=dtype), randn(B, W, K, D, dtype=dtype)
            held("decode_attention_ring", f"{dn} B{B} H{H} K{K} D{D} W_ring={W} "
                 f"window={w} pos={pos}", DA.ring_decode_attention(q, k, v, pos, window=w),
                 ref.naive_ring_decode_attention(q, k, v, pos, window=w), dtype)
    del q, k, v, kp, vp, a, b, lg, yn, yc, y4, ya, pa, pd, d, start, y5   # phase 4's peak

    # K1's logsumexp and the backward's two kernels, the train phase's
    # path: the prefill's output with the logsumexp write on equals it
    # without bit for bit, the row sums the dQ launch writes hold to the
    # plain ones, and two backward runs agree bit for bit
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for B, H, K, S, D, w in BWD_SHAPES:
            lab = f"{dn} B{B} H{H} K{K} S{S} D{D} window={w}"
            q, k, v = flash_inputs(B, H, K, S, D, dtype)
            o, lse = FA.flash_attention(q, k, v, window=w, lse=True)
            same = torch.equal(o, FA.flash_attention(q, k, v, window=w))
            lse_err = (lse - ref.naive_attention_lse(q, k, window=w)).abs().max().item()
            do = randn(B, H, S, D, dtype=dtype)
            *got, delta = FA._bwd(q, k, v, o, lse, do, window=w)
            dr_err = (delta - ref.attention_bwd_delta(o, do)).abs().max().item()
            again = FA.flash_attention_bwd(q, k, v, o, lse, do, window=w)
            bits = all(torch.equal(x, y) for x, y in zip(got, again))
            want = ref.flash_attention_bwd(q, k, v, o, lse, do, window=w)
            r = {n: rel(x.float(), y.float()) for n, x, y in zip(("dq", "dk", "dv"), got, want)}
            err = {n: (x.float() - y.float()).abs().max().item()
                   for n, x, y in zip(("dq", "dk", "dv"), got, want)}
            ok = (same and bits and lse_err <= LSE_TOL and dr_err <= LSE_TOL
                  and all(math.isfinite(x) and x <= BWD_TOL[dn] for x in r.values()))
            print(f"[kernels] flash_attention_bwd {lab}: max|a-b|/max|b| dq {r['dq']:.3e} "
                  f"dk {r['dk']:.3e} dv {r['dv']:.3e} (tol {BWD_TOL[dn]:g}); logsumexp "
                  f"max_abs_err {lse_err:.3e}, row sums (the dQ launch's) max_abs_err "
                  f"{dr_err:.3e} (tol "
                  f"{LSE_TOL:g}); two runs equal bit for bit {bits}; the output with the "
                  f"logsumexp write equals the prefill's bit for bit {same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"flash_attention_bwd {lab} disagrees with its plain "
                                     "version or is not deterministic")
            errs.setdefault("flash_attention_bwd_dq", {})[lab] = max(err["dq"], dr_err)
            errs.setdefault("flash_attention_bwd_dkdv", {})[lab] = max(err["dk"], err["dv"])
    del q, k, v, o, lse, do, delta, got, again, want

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
    bwd = bwd_times(fsets, B, H, K, S, D, randn, FA, ref, cuda_ms, F)
    # K1 at hymba's prefill, windowed and global layers; SDPA's yardstick
    # takes the window as a boolean mask (causal and within the window)
    hB, hH, hK, hS = 4, 25, 5, 1536
    hsets = [flash_inputs(hB, hH, hK, hS, D, bf) for _ in range(4)]
    pos = torch.arange(hS, device=dev)
    for w in (1024, None):
        h_ms = cuda_ms(lambda q, k, v: FA.flash_attention(q, k, v, window=w), hsets)
        h_plain = cuda_ms(lambda q, k, v: ref.naive_attention(q, k, v, window=w), hsets,
                          iters=5)
        if w:
            mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < w)
            h_lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), hsets)
            pairs = w * (w + 1) / 2 + (hS - w) * w
        else:
            h_lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), hsets)
            pairs = hS * hS / 2
        # the (query, key) pairs the mask admits, 4D FLOP each
        h_bound, h_by = bound_ms(4 * hB * hH * pairs * D,
                                 2 * (2 * hB * hH * hS * D + 2 * hB * hK * hS * D))
        print(f"[kernels] flash_attention bf16 B{hB} H{hH} K{hK} S{hS} D{D} window={w}: "
              f"{h_ms * 1e3:.1f} us, plain {h_plain * 1e3:.1f} us, sdpa {h_lib * 1e3:.1f} us, "
              f"bound {h_bound * 1e3:.2f} us ({h_by})", flush=True)
    del hsets
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

    # K4 and K5 at hymba's serving shape, q/k the mixer's head-broadcast
    # views: each set (v, the projection row, lg) is 40 MB, four of them
    # 160 MB, more than the L2
    B, S, H, N, P, C = G_SHAPE
    nc = S // C
    glsets = [gla_inputs(B, S, H, N, P, bf, True) for _ in range(4)]
    k4_ms = cuda_ms(lambda q, k, v, lg: GC.gla_chunk(q, k, v, lg, chunk=C), glsets)
    k4_plain = cuda_ms(lambda q, k, v, lg: ref.chunked_gla(q, k, v, lg, chunk=C), glsets,
                       iters=4)
    ka_ms = cuda_ms(lambda q, k, v, lg: GC.gla_phase_a(q, k, v, lg, chunk=C), glsets)
    ka_plain = cuda_ms(lambda q, k, v, lg: ref.gla_phase_a(q, k, v, lg, chunk=C), glsets,
                       iters=4)
    k5_ms = cuda_ms(lambda q, k, v, lg: GC.gla_chunk_parallel(q, k, v, lg, chunk=C), glsets)
    blsets = []
    for q, k, v, lg in glsets:
        y_intra, g, d = ref.gla_phase_a(q, k, v, lg, chunk=C)
        blsets.append((q, lg, ref.gla_scan(g, d)[0], y_intra))
    kb_ms = cuda_ms(lambda q, lg, st, yi: GC.gla_phase_b(q, lg, st, yi, chunk=C), blsets)
    kb_plain = cuda_ms(lambda q, lg, st, yi: ref.gla_phase_b(q, lg, st, yi, chunk=C),
                       blsets, iters=4)
    # bytes: each position's q and k row once (they are one row shared by
    # the heads), v and y in bf16, lg in float32, states and deltas in
    # float32. Operations: the causal intra-chunk products c(c+1)/2 pairs x
    # 2(N+P), the inter read and the state delta 2cNP each, per (b, h, chunk)
    qk_bytes, v_bytes, lg_bytes = 2 * 2 * B * S * N, 2 * B * S * H * P, 4 * B * S * H
    st_bytes = 4 * B * H * nc * N * P
    intra_ops, np_ops = B * H * nc * C * (C + 1) * (N + P), B * H * nc * 2 * C * N * P
    k4_bound, k4_by = bound_ms(intra_ops + 2 * np_ops,
                               qk_bytes + 2 * v_bytes + lg_bytes + 4 * B * H * N * P)
    ka_bound, ka_by = bound_ms(intra_ops + np_ops,
                               qk_bytes + 2 * v_bytes + lg_bytes + st_bytes + 4 * B * H * nc)
    kb_bound, kb_by = bound_ms(np_ops, qk_bytes // 2 + 2 * v_bytes + lg_bytes + st_bytes)
    # the profiler's device time per call of each GLA kernel: one K4 per
    # chunk-schedule call, one of each phase per parallel-schedule call
    # (the scan between them is plain torch)
    gla_us = {}
    for name, fn, kernels in (
            ("K4", lambda q, k, v, lg: GC.gla_chunk(q, k, v, lg, chunk=C), ("gla_chunk",)),
            ("K5", lambda q, k, v, lg: GC.gla_chunk_parallel(q, k, v, lg, chunk=C),
             ("gla_phase_a", "gla_phase_b"))):
        us = {key: t for key, t in kernel_us(fn, glsets, iters=20).items() if "gla_" in key}
        for kname in kernels:
            hits = [t for key, t in us.items() if kname + "_kernel" in key]
            if len(hits) != 1 or len(us) != len(kernels):
                raise AssertionError(f"{name}: the profiler saw GLA kernels {list(us)}")
            gla_us[kname] = hits[0]
    gla_line = (f"K4 gla_chunk {k4_ms * 1e3:.1f} us (profiler {gla_us['gla_chunk']:.1f} us; "
                f"plain {k4_plain * 1e3:.1f} us, bound {k4_bound * 1e3:.2f} us {k4_by}); "
                f"K5 phase A {ka_ms * 1e3:.1f} us (profiler {gla_us['gla_phase_a']:.1f} us; "
                f"plain {ka_plain * 1e3:.1f} us, bound {ka_bound * 1e3:.2f} us {ka_by}), "
                f"phase B {kb_ms * 1e3:.1f} us (profiler {gla_us['gla_phase_b']:.1f} us; plain "
                f"{kb_plain * 1e3:.1f} us, bound {kb_bound * 1e3:.2f} us {kb_by}), A + scan + "
                f"B {k5_ms * 1e3:.1f} us")
    print(f"[kernels] bf16 B{B} S{S} H{H} N{N} P{P} chunk {C}, head-stride-0 q/k: "
          f"{gla_line}; no PyTorch call computes GLA", flush=True)
    del glsets, blsets, y_intra, g, d

    # K2 over hymba's 1024-slot ring at the serving decode's last step: each
    # set's K/V rings are 5.2 MB, 16 sets 84 MB; the yardstick is SDPA over
    # each set's window gathered beforehand (no PyTorch call takes a ring)
    B, H, K, D, W, pos = 4, 25, 5, 64, 1024, 1567
    rsets = [(randn(B, H, D, dtype=bf), randn(B, W, K, D, dtype=bf),
              randn(B, W, K, D, dtype=bf)) for _ in range(16)]
    r_ms = cuda_ms(lambda q, k, v: DA.ring_decode_attention(q, k, v, pos, window=W), rsets,
                   iters=40)
    r_plain = cuda_ms(lambda q, k, v: ref.naive_ring_decode_attention(q, k, v, pos, window=W),
                      rsets)
    idx = (torch.arange(pos + 1 - W, pos + 1, device=dev) % W)
    rgsets = [(q, k[:, idx].transpose(1, 2), v[:, idx].transpose(1, 2)) for q, k, v in rsets]
    r_lib = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q[:, :, None], k, v, enable_gqa=True), rgsets, iters=40)
    # the window's K/V rows, q read and o written once
    r_bound, r_by = bound_ms(4 * B * H * W * D, 2 * (2 * B * H * D + 2 * B * W * K * D))
    print(f"[kernels] decode_attention_ring bf16 B{B} H{H} K{K} D{D} ring {W} window {W} "
          f"pos {pos}: {r_ms * 1e3:.1f} us, plain {r_plain * 1e3:.1f} us, sdpa over the "
          f"gathered window (yardstick) {r_lib * 1e3:.1f} us, bound {r_bound * 1e3:.2f} us "
          f"({r_by})", flush=True)
    del rsets, rgsets

    # the decode kernels' device time per call, from the profiler: one
    # kernel each (the last split block of a row and KV head combines)
    for name, fn, sets in (
            ("decode_attention", lambda q, k, v: DA.decode_attention(q, k, v, length), dsets),
            ("paged_decode_attention",
             lambda q, kp, vp, t, ln: PA.paged_decode_attention(q, kp, vp, t, ln), psets)):
        us = kernel_us(fn, sets)
        if len(us) != 1:
            raise AssertionError(f"{name}: the profiler saw {len(us)} kernels per call: {us}")
        (kname, kus), = us.items()
        print(f"[kernels] {name} profiler device time per call: {kus:.2f} us "
              f"({kname[:72]}, one kernel)", flush=True)
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

    tokens = torch.as_tensor(prompts, device=dev)
    if not hold_to_plain("serve", cfg, srv.model, srv.params, tokens, [first] + toks[:3],
                         dev)[0]:
        raise AssertionError("serve: kernel path disagrees with the plain path")
    del logits
    decode_idle("serve", srv.model, srv.params, tokens, first, dt / n_gen * 1e3, dev)
    params = srv.params
    del srv, tokens
    torch.cuda.empty_cache()

    # -- ckpt. snapshot mid-decode, restore under another flavor --------------
    ckpt_phase(cfg, params, prompts, 16, card, dev, DA, FA)

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
        srv.caches, srv.pos, srv.max_len = srv.model.alloc_caches(1, n, dev), 0, n
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
    base = {s: eng.stream(s) for s in sids}
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
    del eng, srv, p32
    torch.cuda.empty_cache()

    # -- recover. the supervised recovery plane on phase 5's fleet -------------
    recover_phase(cfg, params, fleet_prompts, max_len, base, prompts, stream, card, dev,
                  FA, DA, PA)
    del params
    torch.cuda.empty_cache()

    # -- 6. full-width hymba-1.5b Server ---------------------------------------
    hcfg = get_config("hymba-1.5b")
    n_prompt, n_gen, batch = G_SHAPE[1], 32, G_SHAPE[0]
    n_global = len(hcfg.global_layers)
    n_window = hcfg.n_layers - n_global
    hprompts = np.random.default_rng(2).integers(0, hcfg.vocab_size, (batch, n_prompt))

    def counts():
        return {"flash_attention": FA.launches, "gla_chunk": GC.launches,
                "gla_phase_a": GC.launches_a, "gla_phase_b": GC.launches_b,
                "decode_attention": DA.launches, "decode_attention_ring": DA.ring_launches,
                "paged_decode_attention": PA.launches}

    def zero_counts():
        FA.launches = GC.launches = GC.launches_a = GC.launches_b = 0
        DA.launches = DA.ring_launches = PA.launches = 0

    def expect(got, **want):
        want = {k: want.get(k, 0) for k in got}
        if got != want:
            raise AssertionError(f"hymba main path launch counts {got} != {want}")
        return got

    def timed_prefill(server):
        server.prefill(hprompts[:, :64], pad_to=64)      # warm-up: cuBLAS, kernel load
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        lg = server.prefill(hprompts, pad_to=n_prompt + n_gen)
        torch.cuda.synchronize()
        return lg, (time.perf_counter() - t0) * 1e3, counts()

    srv = Server(hcfg, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    h_logits, h_prefill_ms, got = timed_prefill(srv)
    h_prefill = expect(got, flash_attention=hcfg.n_layers, gla_chunk=hcfg.n_layers)
    h_first = torch.argmax(h_logits[:, : hcfg.vocab_size], dim=-1).cpu().numpy()
    zero_counts()
    h_toks, h_dt = srv.decode(n_gen, h_first)
    h_decode = expect(counts(), decode_attention=n_global * n_gen,
                      decode_attention_ring=n_window * n_gen)
    h_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the chunk-parallel schedule on the same weights
    srv_p = Server(hcfg, params=srv.params, device="cuda", gla_schedule="parallel")
    p_logits, p_prefill_ms, got = timed_prefill(srv_p)
    h_parallel = expect(got, flash_attention=hcfg.n_layers, gla_phase_a=hcfg.n_layers,
                        gla_phase_b=hcfg.n_layers)
    p_first = torch.argmax(p_logits[:, : hcfg.vocab_size], dim=-1).cpu().numpy()
    r_sched = rel(p_logits, h_logits)
    del srv_p
    print(f"[hymba] hymba-1.5b {hcfg.param_count() / 1e9:.3f}B params bf16, "
          f"{hcfg.n_layers} layers ({n_global} global, {n_window} with window "
          f"{hcfg.window}), SSD {hcfg.ssm.n_ssm_heads}x{hcfg.ssm.head_dim} N{hcfg.ssm.d_state} "
          f"chunk {hcfg.ssm.chunk}; prefill {batch}x{n_prompt}: {h_prefill_ms:.1f} ms "
          f"(chunk schedule), {p_prefill_ms:.1f} ms (parallel schedule); decode {n_gen} "
          f"steps x {batch}: {n_gen * batch / h_dt:.1f} tok/s ({h_dt / n_gen * 1e3:.2f} "
          f"ms/step); peak memory {h_peak_gb:.2f} GB; card {card}", flush=True)
    print(f"[hymba] launches: chunk prefill {h_prefill}; {n_gen} decode steps {h_decode}; "
          f"parallel prefill {h_parallel}", flush=True)
    print(f"[hymba] CUDA-graph times at this shape (phase 3): {gla_line}", flush=True)
    # the GLA kernels' share of each prefill, at their phase-3 times
    k4_total, k5_total = hcfg.n_layers * k4_ms, hcfg.n_layers * k5_ms
    print(f"[hymba] GLA share of the prefill: chunk schedule {hcfg.n_layers} x K4 = "
          f"{k4_total:.2f} ms of {h_prefill_ms:.1f} ms ({k4_total / h_prefill_ms:.1%}); "
          f"parallel schedule {hcfg.n_layers} x (A + scan + B) = {k5_total:.2f} ms of "
          f"{p_prefill_ms:.1f} ms ({k5_total / p_prefill_ms:.1%})", flush=True)
    stream = np.stack(h_toks, axis=1)
    if stream.shape != (batch, n_gen) or stream.min() < 0 or stream.max() >= hcfg.vocab_size:
        raise AssertionError(f"hymba: bad token stream {stream.shape}")
    if not (torch.isfinite(h_logits).all() and torch.isfinite(p_logits).all()):
        raise AssertionError("hymba: non-finite prefill logits")
    htokens = torch.as_tensor(hprompts, device=dev)
    held_plain, plain_f32 = hold_to_plain("hymba", hcfg, srv.model, srv.params, htokens,
                                          [h_first] + h_toks[:3], dev, noisy=True)
    # the schedules differ only in where the SSD output is rounded to bf16
    # (K5 also rounds its intra-chunk part), so they are held to each other
    # as the kernel path is held to float32: within F32_DIST_RATIO times
    # the plain bf16 path's distance from the float32 copy; and with equal
    # first tokens on every row that is not a bf16 tie in either schedule
    # (on a tie the argmax follows rounding noise), at least MIN_HELD_SHARE
    # of the rows held (hold_to_plain also holds both schedules' float32
    # first tokens to the float32 plain path's on every row)
    sched_tol = F32_DIST_RATIO * plain_f32[0]
    ties = bf16_ties(h_logits[:, : hcfg.vocab_size]) | bf16_ties(p_logits[:, : hcfg.vocab_size])
    held = ~ties
    sched_ok = (r_sched <= sched_tol and held.mean() >= MIN_HELD_SHARE
                and np.array_equal(p_first[held], h_first[held]))
    print(f"[hymba] parallel vs chunk schedule: last-position logits max|a-b|/max|b| "
          f"{r_sched:.3e} (tol {F32_DIST_RATIO:g} x plain-f32 = {sched_tol:.3e}); first "
          f"tokens {p_first.tolist()} vs {h_first.tolist()}, held at rows "
          f"{np.nonzero(held)[0].tolist()} (at least {MIN_HELD_SHARE:.0%} of the rows), "
          f"bf16 ties (top-2 within {TIE_ULPS} ulp) at rows {np.nonzero(ties)[0].tolist()} "
          f"{'ok' if sched_ok else 'FAIL'}", flush=True)
    if not held_plain:
        raise AssertionError("hymba: kernel path disagrees with the plain path")
    if not sched_ok:
        raise AssertionError("hymba: the two GLA schedules disagree")
    del p_logits, h_logits
    decode_idle("hymba", srv.model, srv.params, htokens, h_first, h_dt / n_gen * 1e3, dev)
    del srv, htokens
    torch.cuda.empty_cache()

    # -- train. full-width granite-3-2b through the port's Trainer -------------
    # (last before the CLI: the Trainer turns on deterministic algorithms for
    # the process)
    train_launches = train_phase(card, dev)

    # -- 7. the CLI -------------------------------------------------------------
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli") as ck:
        cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                              "--device", "cuda", "--steps", "8", "--ckpt-every", "4",
                              "--kill-rank-at", "6", "--restart-backend", "exampi",
                              "--batch-size", "2", "--seq-len", "64", "--ckpt-dir", ck],
                             env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    lines = [ln for ln in cli.stdout.splitlines() if ln.startswith(("!!", "done:"))]
    print(f"[cli] train --device cuda --kill-rank-at 6 --restart-backend exampi: rc "
          f"{cli.returncode}: {' | '.join(lines)}", flush=True)
    if cli.returncode != 0 or not any(ln.startswith("!! recovered from step_00000004")
                                      for ln in lines) \
            or not any(ln.startswith("done: loss ") for ln in lines):
        raise AssertionError(f"train CLI failed:\n{cli.stdout}\n{cli.stderr}")
    for extra in ([], ["--arch", "hymba-1.5b"],
                  ["--arch", "hymba-1.5b", "--gla-schedule", "parallel"]):
        cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                              "--device", "cuda", "--batch", "2", "--prompt-len", "16",
                              "--gen", "8", *extra], env=env, capture_output=True,
                             text=True, timeout=300, cwd=ROOT)
        print(f"[cli] {' '.join(extra) or 'granite-3-2b'}: rc {cli.returncode}: "
              f"{cli.stdout.strip()}", flush=True)
        if cli.returncode != 0:
            raise AssertionError(f"CLI failed:\n{cli.stderr}")

    src = "src/repro_torch/csrc/"
    record = {"kernels": [
        {"name": "flash_attention", "route": "cuda", "source": src + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:45",
         "launches": launches["flash_attention"],
         "max_abs_err": max(errs["flash_attention"][lab] for lab in F_MAIN),
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": f_lib},
        {"name": "decode_attention", "route": "cuda", "source": src + "decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:61",
         "launches": launches["decode_attention"],
         "max_abs_err": max(errs["decode_attention"][lab] for lab in D_MAIN),
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound, "bound_by": d_by,
         "library_ms": d_lib},
        {"name": "decode_attention_ring", "route": "cuda", "source": src + "decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:61",
         "launches": h_decode["decode_attention_ring"],
         "max_abs_err": errs["decode_attention_ring"][R_MAIN],
         "ms": r_ms, "plain_ms": r_plain, "bound_ms": r_bound, "bound_by": r_by,
         "library_ms": r_lib},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": src + "paged_decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:137",
         "launches": fleet_launches["paged_decode_attention"],
         "max_abs_err": errs["paged_decode_attention"][P_MAIN],
         "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": p_lib},
        {"name": "gla_chunk", "route": "cuda", "source": src + "gla_chunk.cu",
         "replaces": "src/repro/kernels/mlstm_chunk.py:65",
         "launches": h_prefill["gla_chunk"], "max_abs_err": errs["gla_chunk"][G_MAIN],
         "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": None},
        {"name": "gla_phase_a", "route": "cuda", "source": src + "gla_chunk.cu",
         "replaces": "src/repro/kernels/mlstm_chunk.py:85",
         "launches": h_parallel["gla_phase_a"], "max_abs_err": errs["gla_phase_a"][G_MAIN],
         "ms": ka_ms, "plain_ms": ka_plain, "bound_ms": ka_bound, "bound_by": ka_by,
         "library_ms": None},
        {"name": "gla_phase_b", "route": "cuda", "source": src + "gla_chunk.cu",
         "replaces": "src/repro/kernels/mlstm_chunk.py:97",
         "launches": h_parallel["gla_phase_b"], "max_abs_err": errs["gla_phase_b"][G_MAIN],
         "ms": kb_ms, "plain_ms": kb_plain, "bound_ms": kb_bound, "bound_by": kb_by,
         "library_ms": None},
    ] + [
        {"name": name, "route": "cuda", "source": src + "flash_attention_bwd.cu",
         "replaces": "none: the port's own kernel (the reference differentiates "
                     "src/repro/models/layers.py:91 chunked_attention)",
         "launches": train_launches[name], "max_abs_err": errs[name][B_MAIN],
         "ms": bwd[name][0], "plain_ms": bwd[name][1], "bound_ms": bwd[name][2],
         "bound_by": bwd[name][3], "library_ms": None,
         "library_note": "no PyTorch call computes this part alone; SDPA's whole "
                         "backward is library_ms of flash_attention_bwd"}
        for name in BWD_PARTS] + [
        # the two kernels as one backward (one call of the wrapper, which
        # launches each once): SDPA's backward computes the same function
        {"name": "flash_attention_bwd", "route": "cuda", "source": src + "flash_attention_bwd.cu",
         "replaces": "none: the port's own kernel (the reference differentiates "
                     "src/repro/models/layers.py:91 chunked_attention)",
         "launches": train_launches["flash_attention_bwd_dkdv"],
         "max_abs_err": max(errs[name][B_MAIN] for name in BWD_PARTS),
         "ms": bwd["whole"][0], "plain_ms": bwd["whole"][1], "bound_ms": bwd["whole"][2],
         "bound_by": bwd["whole"][3], "library_ms": bwd["whole"][4]}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
