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
     the contiguous decode bit for bit (with each B = 1 lane against its
     batched row, at G 3, 4, 5 and 7); then the kernel's, the plain
     version's and the library call's times beside the kernel's bound (K1
     at granite's and at hymba's two prefill shapes), and the profiler's
     device time per call of the decode kernels and of the GLA kernels (one
     K4, or one of each K5 phase, per call);
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
     float32 copy's streams (at GRANITE_F32_FLEET_LAYERS layers) are held
     to the float32 Server's exactly;
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
  minicpm: full-width minicpm-2b (bf16, seeded random weights; MHA, 36
     heads over 36 KV heads) prefills 4 x 1024 and decodes 32 tokens as
     phase 4 does (40 K1 launches a prefill, 40 K2 a step), held to the
     plain path and a float32 copy as granite's;
  qwen: full-width qwen2.5-14b (bf16, 48 layers, head dim 128, 40/8 heads,
     q/k/v biases) the same (48 and 48 launches); its bf16 logits held to
     the plain bf16 path at full depth, and the float32 distances at
     QWEN_F32_LAYERS layers of the same weights (a float32 copy of all 48
     does not fit beside the bf16 one);
  qwen_fleet: phase 5's fleet traffic on qwen's weights at full depth (48
     K1 launches per non-empty prefill, 48 K3 per decoded token, no K2, a
     swap), first tokens against the Server's B=1 ones, and the float32
     streams against the float32 Server's at QWEN_F32_LAYERS layers;
  llava: full-width llava-next-34b (bf16, 60 layers, 56/8 heads of 128, G =
     7), nothing else on the card: 4 x 1024 prompts whose first 576
     positions are an image (seeded patch embeddings through mm_proj), 32
     greedy steps (60 and 60 launches); its bf16 logits held to the plain
     bf16 path at full depth, then, the whole model freed, the float32
     distances at LLAVA_F32_LAYERS layers of the same weights;
  moe: full-depth granite-moe-3b-a800m (bf16, 32 layers, 40 experts of 512,
     top 8, G = 3) the same (32 and 32 launches; the float32 copy at full
     depth), and its MoE layers' share of a prefill and a decode step;
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
  train_hymba: the same for full-width hymba-1.5b, batch 4 x 1536 (the
     hymba serving cell's shape): every SSD layer runs K4 (which also
     writes each chunk's start state) and the GLA backward kernel (K4b),
     every attention layer K1's forward and backward (3 global layers
     causal, 29 with window 1024); step 1 held to a float64 copy on the
     plain path: in float32 the kernel path's distance from it within
     twice the float32 plain path's (this holds the float32 kernels at
     model level; the bf16 kernels that the Trainer runs rest on phase 3's
     holds at these shapes), the launch counts checked per step (K1 and K4 twice a layer, each
     backward kernel once: K4b's four bf16 kernels, one in float32), and the GLA kernels' shares of the profiled
     step beside K1's (K4b's four launches by name) and its count of
     device kernels; the C/R part at 4 layers with global layers 0 and
     3;
  train_minicpm, train_qwen: the train phase for minicpm-2b at
     MINICPM_TRAIN_LAYERS layers (a cut for the time limit) and for
     qwen2.5-14b at QWEN_TRAIN_LAYERS layers (its full depth's training
     state does not fit the card; the peak must leave 10 GB free), without
     the C/R part;
  train_llava, train_moe: the same for llava-next-34b at LLAVA_TRAIN_LAYERS
     layers (its batches carry the pipeline's patch embeddings) and for
     full-depth granite-moe-3b-a800m, whose ``mfu`` counts the experts at
     top_k of n_experts (the active params);
  minicpm3, minicpm3_fleet, train_minicpm3: full-width minicpm3-4b (MLA:
     62 layers, 40 heads, the prefill's K1 at qk head dim 96 beside V at
     its 64 columns, the absorbed decode over one latent row of 288 a
     position, its first 256 the value) through the Server as phase
     ``minicpm`` (62 K1 launches a prefill, 62 latent decodes a step; the
     float32 copy at full depth), phase 5's fleet traffic on its weights
     (62 paged latent decodes per decoded token; the float32 streams at
     MINICPM3_F32_FLEET_LAYERS layers), and the train phase at
     MINICPM3_TRAIN_LAYERS layers, its ``mfu`` counting MLA's attention at
     qk 96 and v 64;
  xlstm, xlstm_fleet: full-width xlstm-350m (bf16, seeded random weights:
     24 layers as 12 mLSTM + sLSTM pairs, d_model 1024, 4 heads, the mLSTM
     at inner width 2048, the sLSTM at head 256) through the Server (4 x
     1024 prefill, 32 greedy steps; the sLSTM scan kernel once an sLSTM
     layer a prefill and a decode step, 12 and 384; the holds as hymba's:
     the bf16 paths within the plain path's own distance from a float32
     copy, and the float32 kernel path within 1% of that distance from the
     float32 plain path with equal first tokens; peak memory, a decode
     step's idle share), then phase 5's fleet traffic on its weights (the
     sessions' recurrent blocks on the card; the scan once an sLSTM layer
     per non-empty prefill and per decoded token, a swap; first tokens
     against the Server's B=1 ones; the float32 streams at
     XLSTM_F32_FLEET_LAYERS layers against the float32 Server's; a
     profiled tick's idle share);
  train_xlstm: the train phase for full-width, full-depth xlstm-350m (4 x
     1024, as granite's): every sLSTM layer runs the scan's serving kernel
     in the checkpoint's first pass, its training forward in the recompute
     and its backward kernel once (12 + 12 + 12 launches a step), the mLSTM in plain
     torch under autograd; step 1 held as train_hymba's, to a float64 copy
     on the plain path, at XLSTM_HOLD_LAYERS layers (the plain path steps
     every position of every sLSTM layer from Python); its ``mfu`` counts
     r_gates among the matmul params and the mLSTM's chunk products forward
     and backward; the profiled step's sLSTM kernels' share; the C/R part at
     4 layers;
  7. cli: ``repro_torch.launch.serve`` at smoke size on the card, granite,
     hymba (both GLA schedules), minicpm, qwen, llava, granite-moe and
     xlstm (the Server and ``--fleet``), and
     ``repro_torch.launch.train`` at smoke size, granite, hymba, minicpm,
     qwen and xlstm, with a rank killed and the restart under exampi.
Phase 3 also holds K1's logsumexp output and its backward kernels (dQ,
which also writes the row sums rowsum(dO o), then dK/dV) and those row
sums to their plain versions at granite's training shape, at a ragged S,
with a window and at hymba's training shape (window 1024 and none), in
bf16 and float32 (two runs equal bit for bit, the prefill's output
unchanged with the logsumexp write on), and times the backward beside its
bound, its plain version and SDPA's backward at granite's shape and at
hymba's. It holds K4's chunk start states and the GLA backward (K4b) to
``ref.chunked_gla(..., starts=True)`` and ``ref.gla_bwd`` at hymba's
training shape with head-stride-0 q/k (bf16 also under steep decays), a
ragged length, the smoke shape and per-head q/k, in bf16 and float32 (two
runs equal bit for bit, K4's prefill output unchanged with the
chunk-start write on), with head-broadcast q/k also through the
shared-row route (q and k as [B,S,N] rows, dq and dk the heads' sum) and
in bf16 each launch to its plain part (the reversed state pass's dS to
``ref.gla_bwd_states``, the dq and dk/dv launches' per-head q.dq and
k.dk rows); it times K4b as the whole call (its four bf16 launches, each
once a call by the profiler, with their times) beside its bound and its
plain version (no PyTorch call computes GLA or its gradient: library
time null).
Phase 3 also holds K1 (with and without the logsumexp), its backward (two
runs bit-equal), K2 and K3 at the attention families' shapes: qwen2.5-14b's
at head dim 128 (G = 5; a ragged S, a window; K3 over layer 24 of a
48-layer store, and bit-equal to K2 over in-order pages), minicpm-2b's G =
1, llava-next-34b's G = 7 at head dim 128 and granite-moe-3b-a800m's G = 3,
in bf16 and float32, and times them (CUDA-graph replay and the profiler's
time per call, each with the kernel nodes of a captured call) beside their
plain versions, SDPA (or its backward) and the bound.
Phase 3 also holds MLA's kernels, in bf16 and float32: K1 and its
backward at qk head dim 96 (on head dim 128's kernels and tiles), the
latent decode contiguous and through a page table (a strided 62-layer
store, a shuffled table), the paged one over in-order pages bit-equal to
the contiguous one (each B = 1 lane to its batched row), and times them
beside their plain versions, the bound and SDPA (for the latent decode
with q at 288, V the latent's first 256 columns and the scale passed in,
and the backend that served it named). It holds K4's bf16 output at
hymba's shape over GLA_SWEEP seeds, each within the kernel's error bound
(``gla_error_bound``), and prints the spread.
Each phase ends with a ``[time]`` line; the last names the total.
Phase 3 also holds the sLSTM recurrence's kernel (xlstm-350m's 4 heads of
256) to its plain version at the prefill's B4 S1024, a decode step's B4 S1
and a fleet lane's B1 S1, in bf16 and float32 from a prefill's state,
checks its bit-equalities (two runs; S + 1 positions against S then 1 from
its final state; each row at B = 4 against it alone) and one kernel node a
call, and times each bf16 row beside its plain version, its bytes bound and
its latency floor (the launch's S + 1 cluster barriers alone). It holds
the scan's training kernels (``slstm_bwd_rows``): the training forward's
hs and final state bit-equal to the serving launch's, its saved gates and
states and the backward kernel against ``ref.slstm_scan(..., states=True)``
and ``ref.slstm_scan_bwd`` at the training shape B4 S1024, a ragged B2
S300 and B1 S64 (the last two from a prefill's state, the start state's
gradient too), in bf16 and float32, fed by the training forward's tensors
and by the plain forward's; two backward runs bit-equal, each row at B = 4
equal to that row alone; one kernel node a call of each; and times both
at B4 S1024 beside their plain versions, bytes bound and latency floor.
Phase 3 also holds the GLA kernels (K4; K5's phases apart and together)
and the ring-window decode to their plain versions: the GLA at the
serving shape with the mixer's head-broadcast q/k (in bf16 also under
steep decays), a smoke shape, one 16-row tile a chunk, lengths the chunk
does not divide and head-stride-0 views; the ring below, at and far past
its width, wider and narrower than the window. Phase 6 prints the GLA
kernels' share of each hymba prefill.
Wherever phase 3 times K1's forward (granite's, hymba's, minicpm-2b's and
qwen2.5-14b's prefill) or its backward (granite's, hymba's and qwen's
training shapes), it also captures one call in a CUDA graph and checks its
kernel nodes (``graph_launches``, no tracer): one, the route's kernel
(``kernels.flash_attention.fwd_kernel``: ``flash_ws_kernel`` at head dims
64 and 128), for the forward with and without the logsumexp; dQ
(``dq_d128_kernel`` at head dim 128) then dK/dV for the backward. So does
every decode row it times (K2, K2 over hymba's ring, K3): one node, the
kernel ``kernels.decode_attention.kernel`` names for its (dtype, D, G):
``decode_mma_kernel`` in bf16 at every G > 1 and at head dim 128,
``decode_g1_kernel`` at G = 1 and head dim 64.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
SDPA's backward, the yardstick of K1's, is read by CUDA events over warmed
calls and by the profiler in one fresh child process for every training
shape, ``python3 chip_smoke.py --sdpa-bwd-profile B,H,K,S,D;B,H,K,S,D;...``,
which prints only those readings, one JSON object.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
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
# ragged S, with a window at a smoke shape, at hymba's training shape
# (G = 5 over S 1536: its 29 window-1024 layers and its 3 global ones), and
# at the dense families' (below)
BWD_SHAPES = ((4, 32, 8, 1024, 64, None), (4, 32, 8, 1000, 64, None),
              (2, 4, 2, 200, 32, 50), (4, 25, 5, 1536, 64, 1024),
              (4, 25, 5, 1536, 64, None),
              # qwen2.5-14b's training shape (D 128, G 5), ragged, a window;
              # minicpm-2b's (G 1)
              (4, 40, 8, 1024, 128, None), (4, 40, 8, 1000, 128, None),
              (2, 10, 2, 300, 128, 100), (4, 36, 36, 1024, 64, None),
              # llava-next-34b's (D 128, G 7) and granite-moe-3b-a800m's (D 64, G 3)
              (4, 56, 8, 1024, 128, None), (4, 24, 8, 1024, 64, None))
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
# the train_hymba phase: hymba's serving cell's 4 x 1536 (PERF.md), ten
# timed steps, the C/R part as granite's with hymba's global layers cut to
# the first and the last of CR_LAYERS. Its step 1 is held as phase 6 holds
# hymba's serving, against a more precise copy: this random-weight model's
# step-1 gradient is noise-bound at full depth, the float32 plain path's
# own leaves 0.6% (median) to 1.5% from a float64 copy's and the bf16
# paths' ~100% (tools/hymba_precision.py step1), so no fixed bound between
# two float32 paths, nor granite's bf16 bounds, can hold it. A float64 copy
# on the plain path is the yardstick; in float32 the kernel path's
# distance from it (loss, grad_norm, each leaf's ||a - f64|| / ||f64||)
# must sit within F32_DIST_RATIO times the float32 plain path's, plus a
# floor (1e-6, 1e-5, 1e-4). This holds the float32 kernels (K4b's and K1's
# float32 paths) at model level, not the bf16 kernels that the Trainer
# runs: both bf16 paths sit ~100% from float64, so a bf16 hold of this kind
# cannot fail, and the bf16 kernels rest on phase 3's holds, one by one at
# these shapes. A dropped dlg zeroes a_log's gradient and a dS not carried
# across chunks moves every SSD leaf's by order 1
# (tools/train_fault_witness.py --arch hymba-1.5b)
HYMBA_B, HYMBA_S = 4, 1536
HYMBA_F32_FLOOR = (1e-6, 1e-5, 1e-4)
# the GLA backward (K4b) against ref.gla_bwd, max |a - b| / max |b| per
# gradient: bf16 2e-2 (dv's products take the decayed q.k rounded to bf16,
# as K4 rounds its probabilities, and dv is bf16 on output; dq and dk stay
# float32 to about 16 bits through the hi/lo split), float32 1e-4 (exact
# scalar products in another order; dlg is a difference of per-row dots
# summed over up to S positions)
GLA_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# K4b's bf16 launches, in order: each runs once a call
GLA_BWD_KERNELS = ("gla_bwd_state_kernel", "gla_bwd_dq_kernel", "gla_bwd_dkdv_kernel",
                   "gla_bwd_finish_kernel")
# the fleet: page size, lanes, pool pages, new tokens per session, the
# sessions' prompt lengths and the later high-priority arrival's (PERF.md)
FLEET_PAGE, FLEET_LANES, FLEET_PAGES, FLEET_NEW = 16, 4, 120, 32
FLEET_PROMPTS, FLEET_LATE, FLEET_LATE_AT = (1024, 0, 640, 900, 256, 96), 512, 4
# the dense families' shapes in phase 3 (the JSON record's errors):
# qwen2.5-14b's prefill, last decode step and fleet decode at head dim 128
# (G = 5), its training shape; minicpm-2b's prefill and last decode step (MHA,
# G = 1)
Q_F_MAIN = "bfloat16 B4 H40 K8 S1024 D128 window=None"
Q_D_MAIN = "bfloat16 B4 H40 K8 S1056 D128 length=1056 window=None"
Q_P_MAIN = "bfloat16 B1 H40 K8 D128 layer 24/48 lengths=[1056] window=None"
M_F_MAIN = "bfloat16 B4 H36 K36 S1024 D64 window=None"
M_D_MAIN = "bfloat16 B4 H36 K36 S1056 D64 length=1056 window=None"
# qwen2.5-14b's cut depths (PERF.md section 4): the float32 copies of the
# serving holds and the fleet (the float32 weights at 48 layers, 59 GB, do
# not fit beside the bf16 ones), and the trainer (bf16 weights, float32
# AdamW state and bf16 gradients at 48 layers, ~180 GB, do not fit the card;
# QWEN_TRAIN_LAYERS is the deepest whose measured peak leaves 10 GB free)
QWEN_F32_LAYERS, QWEN_TRAIN_LAYERS = 12, 14
# the new families' shapes in phase 3 (the JSON record's errors): llava-next-34b's
# prefill and last decode step (G = 7, head dim 128) and granite-moe-3b-a800m's
# (G = 3, head dim 64)
L_F_MAIN = "bfloat16 B4 H56 K8 S1024 D128 window=None"
L_D_MAIN = "bfloat16 B4 H56 K8 S1056 D128 length=1056 window=None"
E_F_MAIN = "bfloat16 B4 H24 K8 S1024 D64 window=None"
E_D_MAIN = "bfloat16 B4 H24 K8 S1056 D64 length=1056 window=None"
# llava-next-34b's cut depths (PERF.md section 4): its bf16 weights (68.8 GB)
# leave no room for a float32 copy, so the float32 holds run at
# LLAVA_F32_LAYERS layers after the full-depth weights are freed; the trainer
# (6.69 GB a layer of bf16 weights and gradients and float32 AdamW state,
# and AdamW's two float32 temporaries of the stacked MLP leaf, beside 11.1 GB
# for the embedding, the head and mm_proj) at LLAVA_TRAIN_LAYERS, the deepest
# whose measured peak leaves 10 GB free (8 layers peaked at 75.13 GB of an
# 85.02 GB NVIDIA H100 80GB HBM3)
LLAVA_F32_LAYERS, LLAVA_TRAIN_LAYERS = 12, 7
# minicpm3-4b's shapes in phase 3 (the JSON record's errors): the prefill's
# K1 at qk head dim 96 (MHA, G = 1), its training shape, the absorbed decode
# (H40 over one latent row of 288, its first 256 the value) and one fleet
# lane's through a 62-layer strided store
C_F_MAIN = "bfloat16 B4 H40 K40 S1024 D96 window=None"
C_D_MAIN = "bfloat16 B4 H40 S1056 Dk288 Dv256 length=1056"
C_P_MAIN = "bfloat16 B1 H40 Dk288 Dv256 layer 31/62 lengths=[1056]"
# MLA's score scale, 1/sqrt(qk_nope + qk_rope), and its qk and v head dims
C_SCALE, C_DQK, C_DV = 1 / math.sqrt(96), 96, 64
# minicpm3-4b's depths (PERF.md section 4): its float32 Server copy at full
# depth (17.0 GB beside the 8.5 GB bf16 one); the float32 fleet streams at
# MINICPM3_F32_FLEET_LAYERS, as qwen's; the trainer at MINICPM3_TRAIN_LAYERS
# of 62 (a cut for the time limit: at full depth it took 60.4 s of the
# script, and phase 3 holds K1 and its backward at its training shape)
MINICPM3_F32_FLEET_LAYERS, MINICPM3_TRAIN_LAYERS = 12, 24
# K1's backward at qk head dim 96: minicpm3-4b's training shape (V at its
# 64 columns) and a ragged S with a window
C_BWD_SHAPES = ((4, 40, 40, 1024, C_DQK, None), (2, 8, 8, 300, C_DQK, 100))
# depth cuts that keep chip_smoke.py inside its time limit (PERF.md section
# 4), each of a path whose kernel shapes phase 3 holds one by one: granite's
# float32 fleet streams, and minicpm-2b's trainer (its K1 backward at G = 1
# is held at its training shape in BWD_SHAPES)
GRANITE_F32_FLEET_LAYERS, MINICPM_TRAIN_LAYERS = 12, 10
# xlstm-350m's sLSTM recurrence (H 4, dh 256) in phase 3: the kernel held to
# its plain version at these (B, S): the prefill's, a decode step's, a
# fleet lane's; the tolerance is the GLA kernels' (a recurrence over up to
# 1024 steps whose float32 sums run in another order, and in bf16 a one-ulp
# change of a rounded gate moves the exp gates by about 1%)
SLSTM_HEADS, SLSTM_DH = 4, 256
SLSTM_ROWS = ((4, 1024), (4, 1), (1, 1))
# its training kernels in phase 3 at these (B, S, from a prefill's state):
# the training shape from state0, a ragged length and one short row from a
# prefill's state (the start state's gradient too)
SLSTM_BWD_ROWS = ((4, 1024, False), (2, 300, True), (1, 64, True))
# xlstm-350m's float32 fleet streams at this many of its 24 layers (6 pairs),
# as the other fleets' (a cut for the time limit)
XLSTM_F32_FLEET_LAYERS = 12
# train_xlstm's step 1 is held to a float64 copy on the plain path at this
# many layers (2 pairs) at the full 4 x 1024: the plain path steps every
# position of every sLSTM layer from Python, forward and backward
XLSTM_HOLD_LAYERS = 4
# K4's bf16 hold at hymba's serving shape over this many seeds, each within
# the kernel's error bound (gla_error_bound)
GLA_SWEEP = 16


def phase_time(phase, t0):
    """Print the phase's ``[time]`` line (seconds since ``t0``); returns now."""
    now = time.perf_counter()
    print(f"[time] {phase} {now - t0:.1f} s", flush=True)
    return now


def gla_error_bound(ref, q, k, v, lg, y, chunk):
    """K4's bf16 error bound against its plain version ``y`` (float32),
    elementwise. Beyond its float32 sums the kernel rounds two things to
    bf16, each within a relative 2^-8: each decayed score p_ij = (q_i.k_j)
    exp(cum_i - cum_j), the A fragment of its P V product, and y on output.
    So |y_kernel - y| <= 2^-8 (sum_j |p_ij| |v_j| + |y|), and sum_j |p_ij|
    |v_j| is at most the recurrence on |q|, |k|, |v|, whose every term is
    nonnegative (computed by the plain version in float32). The inter term
    and the state take the float32 operand as a bf16 hi/lo pair (about 2^-16),
    and the float32 sums run in another order: 1% on top covers both."""
    a = ref.chunked_gla(q.abs().float(), k.abs().float(), v.abs().float(), lg, chunk=chunk)[0]
    return 2.0 ** -8 * (a.float() + y.abs()) * 1.01 + 1e-6


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


def kernel_us(fn, sets, iters=40, counts=False, once=False):
    """Device microseconds per call of each CUDA kernel ``fn`` launches, by
    name, from the profiler over ``iters`` calls cycling through ``sets``
    (the profiler reads each kernel's device time, so the host's pace does
    not enter); with ``counts`` also each kernel's launches in those calls.
    A warm-up step comes first: the tracer may drop the records of the
    first launches after it starts. ``once``: each kernel runs once a call
    (as a captured call's kernel nodes show), so its time a call is the
    mean over the launches the tracer recorded, which a dropped record
    does not bias (it drops more of them in a process whose card has
    idled, as while the SDPA yardsticks' child processes run)."""
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
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    us = {e.key: e.self_device_time_total / (e.count if once else iters) for e in ev}
    return (us, {e.key: e.count for e in ev}) if counts else us


def graph_launches(label, fn, want):
    """The kernels one ``fn()`` call launches, read from the kernel nodes of
    a CUDA graph captured around it (``timing.graph_kernels``; no tracer,
    whose records can drop): raise unless they are one node each of the
    names in ``want``, in order. Returns the nodes' names."""
    from repro_torch.kernels.timing import graph_kernels
    nodes = [name for name, _, _ in graph_kernels(fn)]
    if len(nodes) != len(want) or not all(w in n for w, n in zip(want, nodes)):
        raise AssertionError(f"{label}: a captured call is the kernel nodes {nodes}; "
                             f"expected one each of {list(want)}")
    print(f"[kernels] {label}: one call is {len(nodes)} kernel node(s) of a captured CUDA "
          f"graph: {', '.join(want)}", flush=True)
    return nodes


def sdpa_backend(names) -> str:
    """Which of SDPA's backends ran, from its forward's or backward's kernel
    names."""
    low = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("fmha_cutlass", "efficient"),
                         ("flash", "flash")):
        if key in low:
            return backend
    return "math"


def _sdpa_bwd_sets(B, H, K, S, D, Dv=None, n=4):
    """SDPA's causal GQA forward on seeded bf16 inputs laid out as the
    model's [B,S,H,D] projections seen as [B,H,S,D] (v at ``Dv`` columns,
    default D, the scale 1/sqrt(D)), each with a dO: (out, (q, k, v), dO)
    for ``torch.autograd.grad``."""
    import torch
    import torch.nn.functional as F
    Dv = Dv or D
    gen = torch.Generator(device="cuda").manual_seed(B * S + H)
    sets = []
    for _ in range(n):
        ins = tuple(torch.randn(B, S, m, d, generator=gen, device="cuda").bfloat16()
                    .transpose(1, 2).requires_grad_() for m, d in ((H, D), (K, D), (K, Dv)))
        out = F.scaled_dot_product_attention(*ins, is_causal=True, enable_gqa=True)
        sets.append((out, ins, torch.randn(B, H, S, Dv, generator=gen, device="cuda")
                     .bfloat16()))
    return sets


def _sdpa_bwd(out, ins, do):
    import torch
    return torch.autograd.grad(out, ins, do, retain_graph=True)


def events_ms(fn, sets, iters=20):
    """Mean ms of one ``fn(*s)`` call between two CUDA events over ``iters``
    warmed calls cycling through ``sets``: for a call whose device time
    well exceeds the host's cost (an autograd backward of a layer), which
    cannot be captured in a CUDA graph."""
    import torch
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: SDPA's backward by the profiler in the child process, by (B, H, K, S, D)
SDPA_BWD = {}


def sdpa_bwd_child(shapes) -> int:
    """``chip_smoke.py --sdpa-bwd-profile B,H,K,S,D[,Dv];B,H,K,S,D;...``:
    SDPA's backward at each shape (v at Dv columns where given) in turn in a
    process whose card has not idled, by the profiler (each kernel's device
    time per call, summed), printed as one JSON line keyed by the shapes."""
    import torch
    out = {}
    for shape in shapes.split(";"):
        sets = _sdpa_bwd_sets(*(int(x) for x in shape.split(",")))
        us, counts = kernel_us(_sdpa_bwd, sets, iters=20, counts=True)
        out[shape] = {"us": sum(us.values()), "kernels": us, "counts": counts,
                      "backend": sdpa_backend(us)}
        del sets
        torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


def sdpa_bwd_profiles(shapes):
    """Every SDPA backward yardstick's profiler reading, in one fresh child
    process (its start and its CUDA context paid once), into ``SDPA_BWD``:
    (B, H, K, S, D), or (B, H, K, S, D, Dv) with v narrower than q."""
    shapes = [tuple(sh[:5]) + tuple(x for x in sh[5:] if x != sh[4]) for sh in shapes]
    arg = ";".join(",".join(str(x) for x in sh) for sh in shapes)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--sdpa-bwd-profile",
                          arg], capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"SDPA backward profile child failed:\n{out.stderr[-3000:]}")
    for key, reading in json.loads(out.stdout.strip().splitlines()[-1]).items():
        SDPA_BWD[tuple(int(x) for x in key.split(","))] = reading
    print(f"[kernels] SDPA backward yardsticks by the profiler, {len(shapes)} shapes in one "
          f"child process: {time.perf_counter() - t0:.1f} s", flush=True)


def sdpa_bwd_yardstick(B, H, K, S, D, Dv=None, iters=20):
    """SDPA's backward at a causal GQA training shape (bf16; v at ``Dv``
    columns, default D), the library
    yardstick of K1's backward, read two ways: the profiler's summed device
    time per call in a fresh child process (the tracer keeps every record
    in a process whose card has not idled; ``sdpa_bwd_profiles`` read every
    shape there beforehand), and CUDA events over warmed calls here; with
    the backend SDPA chose (from its kernel names) and each backend's
    events time when forced. Returns (events ms, profiler ms, backend,
    {forced backend: ms or None})."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    shape = (B, H, K, S, D) + ((Dv,) if Dv and Dv != D else ())
    child = SDPA_BWD[shape]
    forced = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # why a backend refuses: printed as refused
                sets = _sdpa_bwd_sets(*shape)
            forced[name.lower()] = events_ms(_sdpa_bwd, sets, iters)
        except (RuntimeError, AttributeError):
            forced[name.lower()] = None
        sets = None
    sets = _sdpa_bwd_sets(*shape)
    ev = events_ms(_sdpa_bwd, sets, iters)
    del sets
    torch.cuda.synchronize()
    top = sorted(child["kernels"].items(), key=lambda kv: -kv[1])[:4]
    print(f"[kernels] sdpa backward bf16 B{B} H{H} K{K} S{S} D{D}"
          + (f" Dv{shape[5]}" if len(shape) > 5 else "") + " causal GQA (yardstick): "
          f"CUDA events over {iters} warmed calls {ev * 1e3:.1f} us; profiler in a fresh "
          f"process {child['us']:.1f} us a call; backend {child['backend']} ("
          + ", ".join(f"{k[:60]} {t:.1f} us x{child['counts'][k] / 20:g}" for k, t in top)
          + "); each backend forced (events): " + ", ".join(
              f"{n} " + (f"{t * 1e3:.1f} us" if t is not None else "refused")
              for n, t in forced.items()), flush=True)
    return ev, child["us"] / 1e3, child["backend"], forced


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


def hold_to_plain(tag, cfg, model, params, tokens, feed, dev, *, noisy=False, f32=True,
                  ties=False, patch_embeds=None):
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

    ``f32=False`` (qwen2.5-14b at full depth, whose float32 copy does not fit
    beside the bf16 weights): only kernel-plain within LOGIT_REL_TOL and
    equal first tokens; the caller holds the float32 distances at a cut
    depth. ``ties=True`` (qwen2.5-14b and llava-next-34b, whose random-weight
    top two logits fall within one bf16 ulp on some rows): the first tokens
    are held equal on every row that is not a bf16 tie (TIE_ULPS) in either
    path, at least MIN_HELD_SHARE of the rows, as phase 6 holds hymba's two
    schedules.
    ``patch_embeds`` (llava's image) go into every path's prefill.

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
        lg, caches = m.prefill(p, tokens, max_len=n_prompt + len(feed),
                               patch_embeds=patch_embeds)
        out = [lg]
        for i, t in enumerate(feed):
            lg, caches = m.decode_step(p, torch.as_tensor(t, device=dev).long(),
                                       n_prompt + i, caches)
            out.append(lg)
        return out

    def firsts(label, a, b):
        fa, fb = (torch.argmax(x[0][:, :V], dim=-1).cpu().numpy() for x in (a, b))
        top2 = torch.topk(b[0][:, :V], 2, dim=-1).values
        held = np.ones(len(fa), dtype=bool)
        if ties:
            held = ~(bf16_ties(a[0][:, :V]) | bf16_ties(b[0][:, :V]))
        print(f"[{tag}] {label} first token kernel {fa.tolist()} plain {fb.tolist()} "
              f"(plain top-2 margin {(top2[:, 0] - top2[:, 1]).tolist()})"
              + (f"; held at rows {np.nonzero(held)[0].tolist()}, bf16 ties (top-2 within "
                 f"{TIE_ULPS} ulp) at rows {np.nonzero(~held)[0].tolist()}" if ties else ""),
              flush=True)
        return held.mean() >= MIN_HELD_SHARE and np.array_equal(fa[held], fb[held])

    def step(i):
        return "prefill" if i == 0 else f"decode step {i}"

    got = run(model, params)
    want = run(dataclasses.replace(model, force="ref"), params)
    if not f32:
        ok = True
        for i, (a, b) in enumerate(zip(got, want)):
            r_kp = rel(a, b)
            good = math.isfinite(r_kp) and r_kp <= LOGIT_REL_TOL
            ok = ok and good
            print(f"[{tag}] {step(i)} logits, max|a-b|/max|b|: kernel-plain {r_kp:.3e} "
                  f"(tol {LOGIT_REL_TOL:.3e}) {'ok' if good else 'FAIL'}", flush=True)
        return firsts(str(cfg.compute_dtype), got, want) and ok, []
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
        # hymba's float32 kernel path under each GLA schedule; another
        # model's (xLSTM's) once
        for schedule in ("chunk", "parallel") if cfg.block == "hymba" else (None,):
            k32 = run(dataclasses.replace(model, cfg=cfg32, force=None,
                                          gla_schedule=schedule or "chunk"), p32)
            path = f" ({schedule} schedule)" if schedule else ""
            for i, (a, t) in enumerate(zip(k32, truth)):
                r, tol = rel(a, t), F32_NOISE_SHARE * plain_f32[i]
                good = math.isfinite(r) and r <= tol
                ok = ok and good
                print(f"[{tag}] float32 kernel path{path} {step(i)} logits "
                      f"vs float32 plain path: max|a-b|/max|b| {r:.3e} (tol "
                      f"{F32_NOISE_SHARE:g} x plain-f32 = {tol:.3e}) {'ok' if good else 'FAIL'}")
            ok = firsts(f"float32{path}", k32, truth) and ok
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


def bwd_times(fsets, B, H, K, S, D, randn, FA, ref, cuda_ms,
              label="the train path's shape", dv=None):
    """K1's backward at a training shape (granite's; qwen2.5-14b's), bf16, on the forward's
    own output and logsumexp: the whole backward's CUDA-graph time against
    its operations bound (five products of the forward's size), the plain
    version's, and SDPA's backward as a yardstick (``torch.autograd.grad``
    of its causal GQA forward, which no CUDA graph captures: CUDA events
    over warmed calls, beside the profiler's summed device time per call in
    a fresh process, ``sdpa_bwd_yardstick``); then each of the two kernels' profiler
    time per call beside its own bound and its plain version's CUDA-graph
    time (the dQ kernel's with the row sums it writes). ``dv``: the width of
    V's, O's and dO's columns (MLA's 64 beside q's 96), at which the inputs
    are drawn and by which the bound counts dP, dV and the bytes of v, o and
    dO.
    SDPA's yardstick with v at ``dv`` columns is read also with v as wide
    as q (MLA's V zero-padded, as the reference pads it), and the faster by
    the profiler is the row's. Returns {kernel: (ms, plain_ms, bound_ms,
    bound_by)}."""
    import torch
    bf = torch.bfloat16
    Dv = dv or D
    bsets, dsets = [], []
    for q, k, v in fsets:
        o, lse = FA.flash_attention(q, k, v, lse=True)
        do = randn(B, H, S, Dv, dtype=bf)
        bsets.append((q, k, v, o, lse, do))
        dsets.append((q, k, v, lse, do, ref.attention_bwd_delta(o, do)))
    ms = cuda_ms(lambda *a: FA.flash_attention_bwd(*a), bsets)
    plain = cuda_ms(lambda *a: ref.flash_attention_bwd(*a), bsets, iters=5)
    forms = {f"V at {w}": sdpa_bwd_yardstick(B, H, K, S, D, w) for w in sorted({Dv, D})}
    form = min(forms, key=lambda f: forms[f][1])
    lib, lib_prof, backend, _ = forms[form]
    if len(forms) > 1:
        backend = f"{backend}, {form}"
    n_q, n_kv, rows, pairs = B * H * S * D, B * K * S * D, B * H * S, S * S / 2
    n_qv, n_kvv = B * H * S * Dv, B * K * S * Dv
    # q, k, v, o, dO and the logsumexp read once, dq, dk, dv written once;
    # S, dK and dQ over D columns, dP and dV over Dv
    bound, by = bound_ms(2 * B * H * pairs * (3 * D + 2 * Dv),
                         2 * (2 * n_q + 2 * n_qv + 2 * n_kv + 2 * n_kvv) + 4 * rows)
    us = kernel_us(lambda *a: FA.flash_attention_bwd(*a), bsets, iters=20, once=True)
    if len(us) != 2:
        # the tracer dropped every record of a kernel in its window (it drops
        # more in a process whose card idled, as while the SDPA yardsticks'
        # child processes ran): read a second window
        print(f"[kernels] flash_attention_bwd B{B} H{H} K{K} S{S} D{D}: the profiler saw "
              f"{list(us)}; reading a second window", flush=True)
        us = kernel_us(lambda *a: FA.flash_attention_bwd(*a), bsets, iters=20, once=True)
    dq_name = "dq_d128_kernel" if D > 64 else "dq_bf16_kernel"
    graph_launches(f"flash_attention_bwd bf16 B{B} H{H} K{K} S{S} D{D} ({label})",
                   lambda: FA.flash_attention_bwd(*bsets[0]), (dq_name, "dkdv_bf16_kernel"))

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
            one(dq_name),
            cuda_ms(plain_dq, bsets, iters=5),
            *bound_ms(2 * B * H * pairs * (2 * D + Dv)
                      + 2 * n_qv * PEAK_BF16_FLOPS / PEAK_F32_FLOPS,
                      2 * (2 * n_q + 2 * n_qv + n_kv + n_kvv) + 8 * rows)),
        # S, dP, dV, dK: four products; q, k, v, dO, lse, Dr read, dk, dv written
        "flash_attention_bwd_dkdv": (
            one("dkdv_bf16_kernel"),
            cuda_ms(lambda *a: ref.attention_bwd_dkdv(*a), dsets, iters=5),
            *bound_ms(2 * B * H * pairs * (2 * D + 2 * Dv),
                      2 * (n_q + n_qv + 2 * n_kv + 2 * n_kvv) + 8 * rows)),
    }
    print(f"[kernels] flash_attention_bwd bf16 B{B} H{H} K{K} S{S} D{D} causal ({label}): "
          f"{ms * 1e3:.1f} us (dQ + dK/dV), plain "
          f"{plain * 1e3:.1f} us, sdpa backward (yardstick, {backend}) {lib * 1e3:.1f} us by "
          f"CUDA events ({lib_prof * 1e3:.1f} us by the profiler in a fresh process), bound "
          f"{bound * 1e3:.2f} us ({by}: 5 products of the forward's size"
          + (f", dP and dV over V's {Dv} columns" if Dv != D else "") + "); per kernel "
          f"(profiler): " + "; ".join(
              f"{n[20:]} {t[0] * 1e3:.1f} us (plain {t[1] * 1e3:.1f} us, bound "
              f"{t[2] * 1e3:.2f} us {t[3]})" for n, t in out.items()), flush=True)
    out["whole"] = (ms, plain, bound, by, lib)
    return out


def f64_step1_hold(tag, cfg, params, batch, names_, rel_norm, counts):
    """The train_hymba and train_xlstm phases' step 1, held as phase 6 holds
    hymba's serving: a float64 copy of the model on the plain path is the
    yardstick, and the float32 kernel path's distance from it (loss,
    grad_norm, each leaf's ||a - f64|| / ||f64||) must sit within
    F32_DIST_RATIO times the float32 plain path's, plus HYMBA_F32_FLOOR.
    ``counts()``: the phase's launch counters, as a dict. Returns (ok, the
    kernel run's launch counts)."""
    import dataclasses

    import torch

    from repro_torch import steps as ST
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import global_norm

    def run(dtype, force):
        c = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
        p = tree_map(lambda t: t.to(getattr(torch, dtype)), params)
        n0 = counts()
        g, _, loss, _ = ST.loss_and_grads(Model(c, force=force), p, batch)
        n = {k: v - n0[k] for k, v in counts().items()}
        gn = global_norm(g).item()
        leaves = [t.float() for t in tree_leaves(g)]
        ok = all(torch.isfinite(t).all().item() for t in leaves)
        return leaves, loss.item(), gn, n, ok

    lf, gf, ef = HYMBA_F32_FLOOR
    g_t, loss_t, gn_t, _, _ = run("float64", "ref")
    g_k, loss_k, gn_k, n_k, fin = run("float32", None)
    dk = [rel_norm(a, t) for a, t in zip(g_k, g_t)]
    del g_k
    g_p, loss_p, gn_p, n_p, _ = run("float32", "ref")
    dp = [rel_norm(a, t) for a, t in zip(g_p, g_t)]
    del g_p, g_t
    d = {"loss": (abs(loss_k - loss_t) / abs(loss_t), abs(loss_p - loss_t) / abs(loss_t), lf),
         "grad_norm": (abs(gn_k - gn_t) / gn_t, abs(gn_p - gn_t) / gn_t, gf)}
    ok = fin and not any(n_p.values()) and all(
        k <= F32_DIST_RATIO * p + fl for k, p, fl in d.values()) and all(
        k <= F32_DIST_RATIO * p + ef for k, p in zip(dk, dp))
    ratio = sorted(k / max(p, 1e-30) for k, p in zip(dk, dp))
    w = max(range(len(dk)), key=lambda i: dk[i] - F32_DIST_RATIO * dp[i])
    print(f"[{tag}] step 1 in float32 at {cfg.n_layers} layers (the float32 kernels; the bf16 "
          f"ones are held in phase 3), distances from the float64 plain path (kernel path within "
          f"{F32_DIST_RATIO:g} x the float32 plain path's + floor): loss {loss_k:.9f} / "
          f"plain {loss_p:.9f} / f64 {loss_t:.9f}: kernel {d['loss'][0]:.3e}, plain "
          f"{d['loss'][1]:.3e} (floor {lf:g}); grad_norm {gn_k:.6f} / {gn_p:.6f} / "
          f"{gn_t:.6f}: kernel {d['grad_norm'][0]:.3e}, plain {d['grad_norm'][1]:.3e} "
          f"(floor {gf:g}); per-leaf ||a-f64||/||f64|| kernel max {max(dk):.3e} median "
          f"{sorted(dk)[len(dk) // 2]:.3e}, plain max {max(dp):.3e} median "
          f"{sorted(dp)[len(dp) // 2]:.3e}, kernel/plain median "
          f"{ratio[len(ratio) // 2]:.3f} max {ratio[-1]:.3f}; tightest leaf {names_[w]} "
          f"kernel {dk[w]:.3e} vs plain {dp[w]:.3e} (floor {ef:g}); launches {n_k} (plain "
          f"path {n_p}) {'ok' if ok else 'FAIL'}", flush=True)
    return ok, n_k


TRAIN_TAGS = {"granite-3-2b": "train", "hymba-1.5b": "train_hymba",
              "minicpm-2b": "train_minicpm", "qwen2.5-14b": "train_qwen",
              "llava-next-34b": "train_llava", "granite-moe-3b-a800m": "train_moe",
              "minicpm3-4b": "train_minicpm3", "xlstm-350m": "train_xlstm"}


def train_phase(card, dev, arch="granite-3-2b", n_layers=None, cr=True):
    """Full-width granite-3-2b (phase ``train``), hymba-1.5b
    (``train_hymba``), minicpm-2b (``train_minicpm``), granite-moe-3b-a800m
    (``train_moe``), xlstm-350m (``train_xlstm``), or qwen2.5-14b or
    llava-next-34b at ``n_layers`` layers (``train_qwen``, ``train_llava``)
    through the port's Trainer (see the module docstring); ``cr=False``
    leaves the C/R part out. Returns the launch counts over the ten timed
    steps."""
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
    from repro_torch.kernels import gla_chunk as GC
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.launch.train import Trainer
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import global_norm

    hymba = arch == "hymba-1.5b"
    xlstm = arch == "xlstm-350m"
    tag = TRAIN_TAGS[arch]
    B_, S_ = (HYMBA_B, HYMBA_S) if hymba else (TRAIN_B, TRAIN_S)
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    L, hd = cfg.n_layers, cfg.resolved_head_dim

    def counts():
        if xlstm:   # no attention
            return {"slstm_scan": SL.launches, "slstm_scan_train": SL.train_launches,
                    "slstm_scan_bwd": SL.bwd_launches}
        c = {"flash_attention": FA.launches, "flash_attention_bwd_dq": FA.bwd_dq_launches,
             "flash_attention_bwd_dkdv": FA.bwd_dkdv_launches}
        if hymba:
            c.update(gla_chunk=GC.launches, gla_chunk_bwd=GC.bwd_launches)
        return c

    def zero_counts():
        FA.launches = FA.bwd_dq_launches = FA.bwd_dkdv_launches = 0
        GC.launches = GC.bwd_launches = 0
        SL.launches = SL.train_launches = SL.bwd_launches = 0

    def expect(label, got, n_steps, n_layers=L, k4b=GC.BWD_LAUNCHES):
        # remat runs each layer's forward twice a step, the backward once;
        # a K4b call launches ``k4b`` kernels (four in bf16, one in float32);
        # xLSTM's sLSTM layers are one a pair, their checkpoint's first pass
        # on the serving kernel and the recompute on the training forward
        per = {"flash_attention": 2, "gla_chunk": 2, "gla_chunk_bwd": k4b,
               "slstm_scan": 1, "slstm_scan_train": 1}
        n_layers = n_layers // 2 if xlstm else n_layers
        want = {k: per.get(k, 1) * n_layers * n_steps for k in got}
        if got != want:
            raise AssertionError(f"{tag}: {label} launch counts {got} != {want}")
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

    def fresh_state():
        """The seeded params and a zeroed AdamW state, the old ones freed
        first (at qwen's cut depth both together do not fit)."""
        tr.params = tr.opt_state = None
        gc.collect()
        torch.cuda.empty_cache()
        tr.init_state()

    t_phase = time.perf_counter()
    # a Trainer sits in a reference cycle (its runtime providers close over
    # it), so an earlier phase's trainers and their device state live until
    # the collector runs: collect them before this phase allocates and reads
    # its peak memory
    gc.collect()
    torch.cuda.empty_cache()
    tr = Trainer(cfg, batch_size=B_, seq_len=S_, world_size=2, backend="mpich",
                 total_steps=TRAIN_STEPS, device=dev)
    if not torch.are_deterministic_algorithms_enabled():
        raise AssertionError(f"{tag}: the Trainer did not turn on deterministic algorithms")
    tr.init_state()
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves({"p": tr.params, "o": tr.opt_state})) / 1e9
    # the pipeline's first batch, from its seed, for the holds below
    batch = tr._device_batch(synth_batch(cfg, B_, S_, tr.pipeline.seed, 0))
    leaf = names(tr.params)

    # step 1's loss and gradients: the kernel path against the plain path
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb_label = "forward and backward alone, step 1"
    if hymba or xlstm:
        fb_label = "the float32 step-1 hold, its float64 copy included"
        tr.opt_state = None      # room for the float64 copy; init_state below restores it
        # xLSTM's at XLSTM_HOLD_LAYERS (2 pairs): the plain path steps every
        # position of every sLSTM layer from Python
        n_hold = XLSTM_HOLD_LAYERS if xlstm else L
        c_hold = dataclasses.replace(cfg, n_layers=n_hold)
        p_hold = cut_layers(tr.params, n_hold // 2) if xlstm else tr.params
        ok, step1 = f64_step1_hold(tag, c_hold, p_hold, batch, leaf, rel_norm, counts)
        del p_hold
        fb_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fresh_state()
        expect("step 1 (float32 copy)", step1, 1, n_layers=n_hold, k4b=1)
        if not ok:
            raise AssertionError(f"{tag}: step 1 on the kernel path disagrees with the "
                                 "plain path")
    else:
        if n_layers is not None:
            # two gradient trees beside the AdamW state do not fit at the cut
            # depth: set the state aside (init_state below restores it)
            tr.opt_state = None
            fb_label += ", the AdamW state set aside"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        g_k, _, loss_k, _ = ST.loss_and_grads(tr.model, tr.params, batch)
        torch.cuda.synchronize()
        fb_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step1 = expect("step 1", counts(), 1)
        gn_k = global_norm(g_k).item()
        g_p, _, loss_p, _ = ST.loss_and_grads(Model(cfg, force="ref"), tr.params, batch)
        if counts() != step1:
            raise AssertionError(f"{tag}: the plain path launched a kernel")
        gn_p = global_norm(g_p).item()
        errs = [rel_norm(a, b) for a, b in zip(tree_leaves(g_k), tree_leaves(g_p))]
        finite = all(torch.isfinite(t).all().item() for t in tree_leaves(g_k))
        del g_k, g_p
        if tr.opt_state is None:
            fresh_state()
        worst = max(range(len(errs)), key=errs.__getitem__)
        r_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        r_gn = abs(gn_k - gn_p) / gn_p
        ok = (finite and r_loss <= TRAIN_LOSS_TOL and r_gn <= TRAIN_GNORM_TOL
              and max(errs) <= TRAIN_GRAD_TOL)
        print(f"[{tag}] step 1 (batch 0 from the pipeline's seed), kernel path vs plain "
              f"attention path under autograd: loss {loss_k.item():.6f} vs {loss_p.item():.6f} "
              f"(rel {r_loss:.3e}, tol {TRAIN_LOSS_TOL:g}); grad_norm {gn_k:.6f} vs {gn_p:.6f} "
              f"(rel {r_gn:.3e}, tol {TRAIN_GNORM_TOL:g}); per-leaf gradient ||a-b||/||b|| "
              f"max {max(errs):.3e} at {leaf[worst]}, median {statistics.median(errs):.3e} "
              f"over {len(errs)} leaves (tol {TRAIN_GRAD_TOL:g}); launches {step1} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{tag}: step 1 on the kernel path disagrees with the plain "
                                 "path")

    # the same step from the same state, twice: equal bytes (step index 1,
    # whose learning rate is past the warm-up's 0)
    # (the step updates tr's params and state in place and returns them; the
    # first run's params are kept on the host)
    head0 = tr.params["head"].clone()
    m1 = tr.train_step(tr.params, tr.opt_state, batch, 1)[2]
    snap = [t.cpu() for t in tree_leaves(tr.params)]
    moved = not torch.equal(tr.params["head"], head0)
    first = (m1["loss"].item(), m1["grad_norm"].item())
    del m1, head0
    fresh_state()
    m2 = tr.train_step(tr.params, tr.opt_state, batch, 1)[2]
    same = all(torch.equal(a, b.cpu()) for a, b in zip(snap, tree_leaves(tr.params))) \
        and (m2["loss"].item(), m2["grad_norm"].item()) == first
    del snap, m2
    print(f"[{tag}] the same step from the same state twice: params equal byte for byte "
          f"{same}, loss and grad_norm equal {same}; the step moved the params {moved}",
          flush=True)
    if not (same and moved):
        raise AssertionError(f"{tag}: a repeated step differs (or moved nothing)")

    # ten steps through step_once: the pipeline, the update, the metrics
    # allreduce on the MANA plane and the heartbeats
    fresh_state()
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
        raise AssertionError(f"{tag}: bad metrics {hist}")
    if n_layers is not None:
        total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
        free_gb = total_gb - max(peak_gb, fb_peak_gb)
        print(f"[{tag}] depth {L} of {get_config(arch).n_layers} layers: peak "
              f"{max(peak_gb, fb_peak_gb):.2f} GB of the card's {total_gb:.2f} GB, "
              f"{free_gb:.2f} GB free (at least 10 GB must be) "
              f"{'ok' if free_gb >= 10 else 'FAIL'}", flush=True)
        if free_gb < 10:
            raise AssertionError(f"{tag}: the cut depth leaves {free_gb:.2f} GB free")
    step_ms = statistics.median(times[2:]) * 1e3
    tokens = B_ * S_
    # model FLOPs: 6 N per token for the matmul params a token passes
    # through (the embedding table is a lookup; of the experts top_k of
    # n_experts, as the reference's active_param_count counts them, the
    # router whole; llava's mm_proj at the image's positions only), the
    # attention's 6 products (forward 2, backward 4) of the (query, key)
    # pairs each layer's mask admits, and for hymba the GLA's intra-chunk
    # and inter products forward and backward; remat's recompute not counted
    n_matmul = n_params - cfg.padded_vocab * cfg.d_model
    if cfg.moe is not None:
        mo = cfg.moe
        n_matmul -= L * (mo.n_experts - mo.top_k) * 3 * cfg.d_model * mo.expert_d_ff
    mm_flops = 0
    if cfg.img_tokens:
        n_mm = tr.params["mm_proj"].numel()
        n_matmul -= n_mm
        mm_flops = 6 * n_mm * B_ * cfg.img_tokens
    if xlstm:
        # no attention; the mLSTM's chunk products as hymba's GLA: per (row,
        # head, chunk) c(c+1)(N+P) + 4cNP forward and twice that backward
        attn_flops = 0
        xc = cfg.xlstm
        c, N = xc.chunk, int(cfg.d_model * xc.m_proj_factor) // xc.n_heads
        gla_flops = (3 * B_ * xc.n_heads * (S_ // c) * (L // 2)
                     * (c * (c + 1) * 2 * N + 4 * c * N * N))
    elif hymba:
        w = cfg.window
        pairs = sum(S_ * (S_ + 1) / 2 if i in cfg.global_layers
                    else w * (w + 1) / 2 + (S_ - w) * w for i in range(L))
        attn_flops = 12 * B_ * cfg.n_heads * hd * pairs
        sm = cfg.ssm
        c, N, P = sm.chunk, sm.d_state, sm.head_dim
        # forward c(c+1)(N+P) + 4cNP, backward c(c+1)(3N+2P) + 8cNP a chunk
        gla_flops = (B_ * sm.n_ssm_heads * (S_ // c) * L
                     * (c * (c + 1) * (4 * N + 3 * P) + 12 * c * N * P))
    elif cfg.mla is not None:
        # MLA: S = Q K^T, dS's products into dQ and dK over qk_nope + qk_rope
        # columns, P V, dP and dV over v_head_dim (the model's work, not V's
        # zero padding), each over the S^2 / 2 causal pairs
        m = cfg.mla
        attn_flops = 3 * B_ * cfg.n_heads * S_ * S_ * (
            m.qk_nope_dim + m.qk_rope_dim + m.v_head_dim) * L
        gla_flops = 0
    else:
        attn_flops = 6 * B_ * cfg.n_heads * S_ * S_ * hd * L
        gla_flops = 0
    mfu = ((6 * n_matmul * tokens + attn_flops + gla_flops + mm_flops) / (step_ms / 1e3)
           / PEAK_BF16_FLOPS)
    extra = (f" + {gla_flops / 1e12:.2f} TFLOP GLA" if hymba else
             f" + {gla_flops / 1e12:.2f} TFLOP mLSTM chunk products" if xlstm else "")
    if mm_flops:
        extra += f" + {mm_flops / 1e12:.3f} TFLOP mm_proj over {cfg.img_tokens} positions a row"
    print(f"[{tag}] {arch} {n_params / 1e9:.3f}B params {cfg.param_dtype}, {L} layers"
          f"{'' if n_layers in (None, get_config(arch).n_layers) else ' (cut depth)'}, AdamW "
          f"float32 state, remat on, batch {B_} x {S_} tokens ({card}): "
          f"{TRAIN_STEPS} steps, step ms {[round(t * 1e3, 1) for t in times]}; median of "
          f"steps 3-{TRAIN_STEPS} {step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tok/s, "
          f"mfu {mfu:.3f} (6 x {n_matmul / 1e9:.3f}B "
          f"{'active ' if cfg.moe is not None else ''}matmul params x {tokens} tokens + "
          f"{attn_flops / 1e12:.2f} TFLOP attention{extra}, over 989 TFLOP/s); params + "
          f"AdamW state {state_gb:.2f} GB, peak memory {peak_gb:.2f} GB ({fb_label}: "
          f"{fb_peak_gb:.2f} GB)", flush=True)
    per_step = "; ".join(f"{k} {v // TRAIN_STEPS}" for k, v in main.items())
    print(f"[{tag}] losses {[round(h[0], 4) for h in hist]}; grad_norm "
          f"{[round(h[1], 3) for h in hist]}; world_loss equals loss; launches {main} "
          f"(a step: {per_step})", flush=True)

    # one profiled step after a warm-up one: the device's busy and idle
    # share and the hand-written kernels' shares of the step
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

    def dev_ms(name):
        return sum(e.self_device_time_total for e in kern if name in e.key) / 1e3
    fwd = dev_ms("flash_bf16_kernel") + dev_ms("flash_ws_kernel")
    bwd = {"dq": dev_ms("dq_bf16_kernel") + dev_ms("dq_d128_kernel"),
           "dkdv": dev_ms("dkdv_bf16_kernel")}
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    if busy <= 0:
        print(f"[{tag}] profiled step: device busy time not measured (the profiler saw no "
              "CUDA kernels)", flush=True)
    else:
        g4b = {n: dev_ms(n) for n in GLA_BWD_KERNELS}
        gla = (f"; GLA forward (K4) {dev_ms('gla_chunk_kernel'):.2f} ms "
               f"({dev_ms('gla_chunk_kernel') / prof_ms:.1%}, {2 * L} launches), backward "
               f"(K4b) {sum(g4b.values()):.2f} ms ({sum(g4b.values()) / prof_ms:.1%}, {L} "
               "calls of four launches: " + ", ".join(f"{n} {t:.2f}" for n, t in g4b.items())
               + " ms)") if hymba else ""
        if xlstm:
            # slstm_mma_kernel<256, STATES>: the serving launch (the first
            # pass) is STATES false, the training forward true (demangled
            # or mangled names)
            def sl_ms(states):
                tag_ = (", true>", "Lb1E") if states else (", false>", "Lb0E")
                return sum(e.self_device_time_total for e in kern if "slstm_mma_kernel" in e.key
                           and any(t in e.key for t in tag_)) / 1e3
            sl_s, sl_f, sl_b = sl_ms(False), sl_ms(True), dev_ms("slstm_bwd_mma_kernel")
            sl_all = sl_s + sl_f + sl_b
            gla = (f"; sLSTM serving forward (the checkpoint's first pass) {sl_s:.2f} ms "
                   f"({sl_s / prof_ms:.1%}, {L // 2} launches), training forward {sl_f:.2f} ms "
                   f"({sl_f / prof_ms:.1%}, {L // 2} launches), backward {sl_b:.2f} ms "
                   f"({sl_b / prof_ms:.1%}, {L // 2} launches), together {sl_all:.2f} ms, "
                   f"{sl_all / prof_ms:.1%} of the step")
        gla += f"; {sum(e.count for e in kern)} device kernels in the step"
        k1 = "" if xlstm else (
            f"; K1 forward {fwd:.2f} ms ({fwd / prof_ms:.1%} of the step, {2 * L} launches), "
            f"backward {sum(bwd.values()):.2f} ms ({sum(bwd.values()) / prof_ms:.1%}: dQ "
            f"{bwd['dq']:.2f}, dK/dV {bwd['dkdv']:.2f} ms)")
        print(f"[{tag}] one profiled step ({card}): {prof_ms:.1f} ms on the host clock, "
              f"device busy {busy:.1f} ms ({1 - busy / prof_ms:.1%} idle){k1}{gla}; top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                          for e in top), flush=True)
    tr.pipeline.stop()
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    full_s = time.perf_counter() - t_phase
    if not cr:
        print(f"[{tag}] phase seconds: {full_s:.1f} s (no C/R part)", flush=True)
        return main

    # the C/R plane at the arch's widths and CR_LAYERS layers (hymba's
    # global layers cut with the depth: the first and the last)
    t_cr = time.perf_counter()
    cfg_cr = dataclasses.replace(cfg, n_layers=CR_LAYERS)
    if hymba:
        cfg_cr = dataclasses.replace(cfg_cr, global_layers=(0, CR_LAYERS - 1))
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))

    def trainer(name):
        return Trainer(cfg_cr, batch_size=B_, seq_len=S_, world_size=2,
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
        print(f"[{tag}] C/R at {CR_LAYERS} layers ({cr_gb:.2f} GB of params and AdamW "
              f"state; {card}): {CR_STEPS} steps, a checkpoint every {CR_EVERY} (codec "
              f"none), rank 1 killed at step {CR_KILL_AT}, restarted under {backend_b}: "
              f"params and optimizer state equal the uninterrupted run's byte for byte "
              f"{same_b}; loss trace {[round(v, 6) for _, v in losses_b]} (steps "
              f"{[s for s, _ in losses_b]}) equal {trace_b}", flush=True)
        print(f"[{tag}] the first checkpoint's blocking window ({card}): "
              f"{first['blocking_ms']} ms = drain {first['drain_ms']} ms, snapshot "
              f"{first['snapshot_ms']} ms (side-stream copies "
              f"{first.get('device_copy_ms')} ms), enqueue {first['enqueue_ms']} ms; "
              f"persist {first.get('persist_ms')} ms; "
              f"the next ones blocking "
              f"{[r.timings['blocking_ms'] for r in reqs[1:]]} ms, persist "
              f"{[r.timings.get('persist_ms') for r in reqs[1:]]} ms; the restart's "
              f"phases {rt_b}", flush=True)
        if not (same_b and trace_b and backend_b == "exampi"):
            raise AssertionError(f"{tag}: the recovered run differs from the uninterrupted one")

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
        print(f"[{tag}] supervised at {CR_LAYERS} layers ({card}): {inc.kind} rank "
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
            raise AssertionError(f"{tag}: the supervised recovery differs")
    finally:
        shutil.rmtree(base, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[{tag}] phase seconds: full width {full_s:.1f} s, C/R "
          f"{time.perf_counter() - t_cr:.1f} s", flush=True)
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


def run_fleet(model_cfg, model_params, prompts, max_len):
    """The fleet's traffic through a fresh engine: the sessions, then after
    FLEET_LATE_AT ticks the high-priority arrival (the last prompt),
    drained. Returns the engine, the session ids, the main path's launch
    counts and seconds."""
    import torch

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import latent_decode_attention as LA
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.serving.engine import ServeEngine
    eng = ServeEngine(model_cfg, params=model_params, device="cuda", max_len=max_len,
                      page_size=FLEET_PAGE, n_pages=FLEET_PAGES, max_running=FLEET_LANES)
    torch.cuda.synchronize()
    FA.launches = DA.launches = PA.launches = LA.launches = LA.paged_launches = 0
    SL.launches = 0
    t0 = time.perf_counter()
    sids = [eng.submit(p, max_new_tokens=FLEET_NEW) for p in prompts[:-1]]
    for _ in range(FLEET_LATE_AT):
        eng.step_once()
    sids.append(eng.submit(prompts[-1], max_new_tokens=FLEET_NEW, priority=5))
    eng.run_until_drained()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return eng, sids, {"flash_attention": FA.launches, "decode_attention": DA.launches,
                       "paged_decode_attention": PA.launches,
                       "latent_decode_attention": LA.launches,
                       "paged_latent_decode_attention": LA.paged_launches,
                       "slstm_scan": SL.launches}, secs


def server_stream(srv, prompt, n, dev):
    """The port Server's B=1 greedy stream of ``n`` tokens; an empty prompt
    decodes from first token 0 at position 0, as the fleet's does."""
    import numpy as np
    import torch
    V = srv.cfg.vocab_size
    if len(prompt):
        lg = srv.prefill(prompt[None, :], pad_to=len(prompt) + n)
        first = int(torch.argmax(lg[0, :V]))
        toks, _ = srv.decode(n - 1, np.array([first]))
        return [first] + [int(t[0]) for t in toks]
    srv.caches, srv.pos, srv.max_len = srv.model.alloc_caches(1, n, dev), 0, n
    toks, _ = srv.decode(n, np.array([0]))
    return [int(t[0]) for t in toks]


def check_fleet(eng, sids, got, label, model_cfg, prompts, tag="fleet"):
    """The main path's launch counts (K1 a layer per non-empty prefill, K3 a
    layer per decoded token, or MLA's paged latent decode, no contiguous
    decode; xLSTM's sLSTM scan once an sLSTM layer per non-empty prefill
    and per decoded token, nothing else), the tickets and the streams'
    shape."""
    L = model_cfg.n_layers
    n_full = sum(1 for p in prompts if len(p))
    decoded = sum(len(eng.stream(s)) for s in sids) - n_full
    paged = "paged_latent_decode_attention" if model_cfg.mla is not None \
        else "paged_decode_attention"
    want = dict.fromkeys(got, 0)
    if model_cfg.block == "xlstm":
        want["slstm_scan"] = L // 2 * (n_full + decoded)
    else:
        want.update({"flash_attention": L * n_full, paged: L * decoded})
    swapped = [s for s in sids if eng.sched.tickets[s].preemptions]
    per = L // 2 if model_cfg.block == "xlstm" else L
    print(f"[{tag}] {label}: launches {got} (expected {want}: {n_full} non-empty "
          f"prefills x {per}, {decoded} decoded tokens x {per}); "
          f"preempted and readmitted: {swapped}; ticks {eng.tick}", flush=True)
    if got != want:
        raise AssertionError(f"{tag} main path launch counts {got} != {want}")
    if not swapped or any(eng.sched.state(s) != "DONE" for s in sids):
        raise AssertionError(f"{tag}: no session was preempted and readmitted")
    for s in sids:
        st = eng.stream(s)
        if len(st) != FLEET_NEW or min(st) < 0 or max(st) >= model_cfg.vocab_size:
            raise AssertionError(f"{tag}: bad stream for {s}: {st}")
    return swapped


def cut_layers(params, n):
    """The first ``n`` stacked entries of a one-segment model's params
    (views): layers, or xLSTM's pairs."""
    from repro_torch.models.params import tree_map
    return {**params, "segments": [tree_map(lambda t: t[:n], params["segments"][0])]}


SERVE_TAGS = {"minicpm-2b": "minicpm", "qwen2.5-14b": "qwen", "llava-next-34b": "llava",
              "minicpm3-4b": "minicpm3", "xlstm-350m": "xlstm",
              "granite-moe-3b-a800m": "moe"}


def moe_share(tag, model, params, tokens, first, dev):
    """The MoE layers' share of a prefill and of a decode step. Unprofiled,
    each ``layers.moe_apply`` call runs between two CUDA events (its span
    on the device's clock, from its first launch to its last, its idle
    gaps included), summed over the layers beside the call's host-clock
    time; profiled, each runs under a range whose kernels' device time is
    summed beside the device busy time (the profiler's own cost inflates
    both)."""
    import torch

    from repro_torch.models import layers as L
    spans, orig = [], L.moe_apply

    def timed(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.profiler.record_function("moe_apply"):
            start.record()
            out = orig(*a, **kw)
            end.record()
        spans.append((start, end))
        return out

    n_prompt = tokens.shape[1]
    tok = torch.as_tensor(first, device=dev).long()
    _, caches = model.prefill(params, tokens, max_len=n_prompt + 2)
    model.decode_step(params, tok, n_prompt, caches)                  # warm-up
    L.moe_apply = timed
    try:
        for what, fn in (("prefill", lambda: model.prefill(params, tokens, max_len=n_prompt + 2)),
                         ("decode step", lambda: model.decode_step(params, tok, n_prompt + 1,
                                                                   caches))):
            torch.cuda.synchronize()
            spans.clear()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            n_spans, span_ms = len(spans), sum(a.elapsed_time(b) for a, b in spans)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            ev = prof.key_averages()
            # the range's own record on the device (its span there) is no kernel
            kern = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.key != "moe_apply"]
            busy = sum(e.self_device_time_total for e in kern) / 1e3
            moe_dev = sum(e.device_time_total for e in ev if e.key == "moe_apply"
                          and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
            top = sorted(kern, key=lambda e: -e.self_device_time_total)[:3]
            share = (f"their kernels' device time {moe_dev:.2f} ms of {busy:.2f} ms device "
                     f"busy ({moe_dev / busy:.1%})" if busy > 0 and moe_dev > 0 else
                     "their kernels' device time not measured (the profiler attributed no "
                     "kernels to the range)")
            print(f"[{tag}] the MoE layers' share of one {what}: {n_spans} layers span "
                  f"{span_ms:.2f} ms of {host_ms:.2f} ms on the host clock "
                  f"({span_ms / host_ms:.1%}); profiled, {share}; top: " + "; ".join(
                      f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                      for e in top), flush=True)
    finally:
        L.moe_apply = orig


def dense_serve_phase(arch, card, dev, seed_prompts, f32_layers=None, keep=False,
                      ties=False):
    """An attention family's Server at full width and depth (see the module
    docstring): 4 x 1024 prefill (llava's first 576 positions its image,
    seeded patch embeddings drawn after the prompts), 32 greedy steps, the
    launch counts, the holds (with ``f32_layers`` the float32 copy's at
    that cut depth; without ``keep`` on copies of the first layers made
    after the whole model is freed, as llava's float32 copy fits beside no
    more than 2 of its bf16 layers), and for MoE its layers' share of a prefill and a
    decode step. ``ties``: the first tokens held on the rows that are not
    bf16 ties (``hold_to_plain``), as at the cut depths. Returns the params
    (``keep``; else None) and the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import latent_decode_attention as LA
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.serving.engine import Server

    t_phase = time.perf_counter()
    tag = SERVE_TAGS[arch]
    cfg = get_config(arch)
    L = cfg.n_layers
    n_prompt, n_gen, batch = 1024, 32, 4
    rng = np.random.default_rng(seed_prompts)
    prompts = rng.integers(0, cfg.vocab_size, (batch, n_prompt))
    pe = rng.standard_normal((batch, cfg.img_tokens, 1024)).astype(np.float32) \
        if cfg.img_tokens else None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    srv = Server(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    srv.prefill(prompts[:, :64], pad_to=64)          # warm-up: cuBLAS, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = DA.launches = PA.launches = LA.launches = LA.paged_launches = 0
    t0 = time.perf_counter()
    logits = srv.prefill(prompts, pe, pad_to=n_prompt + n_gen)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = (FA.launches, DA.launches + LA.launches)
    first = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).cpu().numpy()
    toks, dt = srv.decode(n_gen, first)
    launches = {"flash_attention": FA.launches, "decode_attention": DA.launches,
                "paged_decode_attention": PA.launches, "latent_decode_attention": LA.launches,
                "paged_latent_decode_attention": LA.paged_launches}
    # MLA's decode is the latent decode; every other family's K2
    decoder = "latent_decode_attention" if cfg.mla is not None else "decode_attention"
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attention": L, decoder: L * n_gen})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    extra = f", the first {cfg.img_tokens} positions an image" if cfg.img_tokens else ""
    if cfg.mla is not None:
        m = cfg.mla
        extra += (f", MLA: q_lora {m.q_lora_rank}, kv_lora {m.kv_lora_rank}, qk "
                  f"{m.qk_nope_dim} + {m.qk_rope_dim}, v {m.v_head_dim}, one latent row of "
                  f"{cfg.kv_cache_width} a position")
    if cfg.moe is not None:
        mo = cfg.moe
        extra += (f", {mo.n_experts} experts of {mo.expert_d_ff} top {mo.top_k} (capacity "
                  f"factor {mo.capacity_factor:g}, groups of {mo.group_size}), "
                  f"{cfg.active_param_count() / 1e9:.3f}B active")
    n_params = sum(t.numel() for t in tree_leaves(srv.params))
    print(f"[{tag}] {arch} {n_params / 1e9:.3f}B params bf16 (seeded init "
          f"{init_s:.1f} s), {L} layers, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}{', q/k/v biases' if cfg.qkv_bias else ''}{extra}; prefill "
          f"{batch}x{n_prompt}: {prefill_ms:.1f} ms; decode {n_gen} steps x {batch}: "
          f"{n_gen * batch / dt:.1f} tok/s ({dt / n_gen * 1e3:.2f} ms/step); peak memory "
          f"{peak_gb:.2f} GB; card {card}", flush=True)
    print(f"[{tag}] launches after prefill {after_prefill}, after decode {launches} "
          f"(expected {L} K1, {L * n_gen} {decoder})", flush=True)
    if after_prefill != (L, 0) or launches != want:
        raise AssertionError(f"{tag}: main path launch counts {after_prefill} / {launches}")
    stream = np.stack(toks, axis=1)
    if stream.shape != (batch, n_gen) or stream.min() < 0 or stream.max() >= cfg.vocab_size:
        raise AssertionError(f"{tag}: bad token stream {stream.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{tag}: non-finite prefill logits")
    del logits
    tokens = torch.as_tensor(prompts, device=dev)
    tpe = None if pe is None else torch.from_numpy(pe).to(dev)
    feed = [first] + toks[:3]
    if f32_layers is None:
        ok = hold_to_plain(tag, cfg, srv.model, srv.params, tokens, feed, dev,
                           ties=ties, patch_embeds=tpe)[0]
    else:
        # the bf16 paths at full depth; the float32 distances at a cut depth
        ok = hold_to_plain(tag, cfg, srv.model, srv.params, tokens, feed, dev, f32=False,
                           ties=True, patch_embeds=tpe)[0]
    decode_idle(tag, srv.model, srv.params, tokens, first, dt / n_gen * 1e3, dev)
    if cfg.moe is not None:
        moe_share(tag, srv.model, srv.params, tokens, first, dev)
    model, params = srv.model, srv.params
    del srv
    if f32_layers is not None:
        cut_params = cut_layers(params, f32_layers)
        if not keep:
            # the first layers alone, through the host: the whole model is
            # freed before their copy comes back
            cut_params = tree_map(lambda t: t.cpu(), cut_params)
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            cut_params = tree_map(lambda t: t.to(dev), cut_params)
        cut = dataclasses.replace(cfg, n_layers=f32_layers)
        print(f"[{tag}] the holds with a float32 copy at a cut depth of {f32_layers} of {L} "
              "layers (the same weights' first layers)", flush=True)
        ok = hold_to_plain(f"{tag} {f32_layers} layers", cut, dataclasses.replace(model, cfg=cut),
                           cut_params, tokens, feed, dev, ties=True, patch_embeds=tpe)[0] and ok
        del cut_params
    if not ok:
        raise AssertionError(f"{tag}: kernel path disagrees with the plain path")
    if not keep:
        params = None
    del tokens, tpe
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] phase seconds: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return params, launches


def fleet_phase(cfg, params, card, dev, f32_layers, seed, idle=False):
    """A family's fleet at full depth on its Server phase's weights
    (qwen2.5-14b's, minicpm3-4b's, xlstm-350m's), with granite's fleet
    traffic; its float32 streams held to the float32 Server's at
    ``f32_layers`` layers. With ``idle`` also a profiled tick's idle share
    (``fleet_tick_idle``). Returns the bf16 run's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models.params import tree_map
    from repro_torch.serving.engine import Server

    t_phase = time.perf_counter()
    tag = SERVE_TAGS[cfg.name] + "_fleet"
    all_prompts = FLEET_PROMPTS + (FLEET_LATE,)
    prompts = [np.random.default_rng(seed).integers(0, cfg.vocab_size, n) for n in all_prompts]
    max_len = max(all_prompts) + FLEET_NEW
    eng, sids, launches, secs = run_fleet(cfg, params, prompts, max_len)
    n_tok = sum(len(eng.stream(s)) for s in sids)
    if cfg.block == "xlstm":
        # no token rows: each session's recurrent blocks, on the card
        blk = sum(int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
                  for _, shape, dt in eng._leaf_specs)
        cache = f"no token rows; {blk / 1e6:.1f} MB of recurrent blocks a session on the card"
    else:
        # bf16 cache bytes a token: K and V rows, or MLA's one latent row
        row_bytes = cfg.n_layers * cfg.kv_cache_width * 2 * (1 if cfg.mla is not None else 2)
        cache = (f"{row_bytes} bytes of cache a token, "
                 f"{FLEET_PAGES * FLEET_PAGE * row_bytes / 1e6:.1f} MB")
    print(f"[{tag}] {cfg.name} bf16, {cfg.n_layers} layers; {len(sids)} sessions, prompts "
          f"{list(all_prompts)}, {FLEET_NEW} new tokens each; pool {FLEET_PAGES} pages x "
          f"{FLEET_PAGE} ({cache}), {FLEET_LANES} lanes: "
          f"{n_tok} tokens in {secs:.2f} s: {n_tok / secs:.1f} tok/s, "
          f"{secs / eng.tick * 1e3:.1f} ms/tick over {eng.tick} ticks; card {card}", flush=True)
    check_fleet(eng, sids, launches, "bf16", cfg, prompts, tag)
    srv = Server(cfg, params=params, device="cuda")
    firsts = [(server_stream(srv, p, 1, dev)[0], eng.stream(s)[0]) for p, s in zip(prompts, sids)]
    print(f"[{tag}] bf16 first tokens, Server B=1 vs fleet: {firsts}", flush=True)
    if any(a != b for a, b in firsts):
        raise AssertionError(f"{tag}: first tokens disagree with the Server's")
    del eng, srv
    gc.collect()
    torch.cuda.empty_cache()
    if idle:
        fleet_tick_idle(tag, cfg, params, prompts, max_len)
    cfg32 = dataclasses.replace(cfg, n_layers=f32_layers, param_dtype="float32",
                                compute_dtype="float32", cache_dtype="float32")
    # xLSTM stacks its layers in pairs
    stacked = f32_layers // 2 if cfg.block == "xlstm" else f32_layers
    p32 = tree_map(lambda t: t.float(), cut_layers(params, stacked))
    eng, sids, got32, secs32 = run_fleet(cfg32, p32, prompts, max_len)
    check_fleet(eng, sids, got32, f"float32, {f32_layers} layers", cfg32, prompts, tag)
    srv = Server(cfg32, params=p32, device="cuda")
    same = [server_stream(srv, p, FLEET_NEW, dev) == eng.stream(s) for p, s in zip(prompts, sids)]
    print(f"[{tag}] float32, {f32_layers} of {cfg.n_layers} layers: {sum(same)}/"
          f"{len(same)} streams equal the float32 Server's B=1 greedy streams exactly "
          f"({secs32:.2f} s)", flush=True)
    if not all(same):
        raise AssertionError(f"{tag}: float32 fleet streams differ from the Server's: {same}")
    del eng, srv, p32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] phase seconds: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def fleet_tick_idle(tag, cfg, params, prompts, max_len):
    """Where one fleet tick's time goes: a fresh engine takes the fleet's
    first sessions and FLEET_LATE_AT ticks (their prefills), then one tick
    of decode on its running lanes is profiled: its device busy time
    against the same tick's host-clock time, unprofiled, just before."""
    import torch

    from repro_torch.serving.engine import ServeEngine
    eng = ServeEngine(cfg, params=params, device="cuda", max_len=max_len,
                      page_size=FLEET_PAGE, n_pages=FLEET_PAGES, max_running=FLEET_LANES)
    for p in prompts[:-1]:
        eng.submit(p, max_new_tokens=FLEET_NEW)
    for _ in range(FLEET_LATE_AT):
        eng.step_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_once()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e3
    lanes = len(eng.sched.running)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.step_once()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms > 0:
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[{tag}] one tick of {lanes} decoding lanes: device busy {busy_ms:.3f} ms of "
              f"{tick_ms:.2f} ms ({1 - busy_ms / tick_ms:.1%} idle); top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                          for e in top), flush=True)
    else:
        print(f"[{tag}] one tick: device busy time not measured (the profiler saw no CUDA "
              "kernels)", flush=True)
    del eng


def slstm_rows(card, dev):
    """Phase 3's sLSTM recurrence (xlstm-350m's SLSTM_HEADS heads of
    SLSTM_DH): the kernel held to its plain version at each of SLSTM_ROWS in
    bf16 and float32 from a prefill's state (GLA_TOL: hs and h absolutely,
    |h| <= 1; c, n and m relative to their largest entries); its
    bit-equalities at the prefill's shape (two runs; S + 1 positions
    against S then 1 from its final state; each row at B = 4 against that
    row alone); one kernel node a call; and each bf16 row timed (CUDA-graph
    replay over inputs rotated past the L2, and the profiler's time a call)
    beside its plain version, its bound and its latency floor (the S + 1
    cluster barriers of its grid, alone, timed alike). Returns {(B, S):
    row} for the JSON record."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.kernels.timing import cuda_ms
    H, dh = SLSTM_HEADS, SLSTM_DH
    gen = torch.Generator(device=dev).manual_seed(350)

    def inputs(B, S, dtype):
        """wx ~ N(0, 1) (the hoisted projection's scale) and r ~ N(0, 1/dh)
        (50 times the model's init: a recurrence that matters), and the
        state after 8 positions of a prefill; S positions are left."""
        wx = torch.randn(B, S + 8, 4 * H * dh, generator=gen, device=dev).to(dtype)
        r = (torch.randn(H, dh, 4 * dh, generator=gen, device=dev) / dh ** 0.5).to(dtype)
        start = ref.slstm_scan(wx[:, :8].contiguous(), r, ref.slstm_state0(B, H, dh, dev))[1]
        return wx[:, 8:].contiguous(), r, start

    def same(a, b):
        return torch.equal(a[0], b[0]) and all(torch.equal(u, v) for u, v in zip(a[1], b[1]))

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        tol = GLA_TOL[name]
        for B, S in SLSTM_ROWS:
            x, r, start = inputs(B, S, dtype)
            (hs, st), (hs_w, st_w) = SL.slstm_scan(x, r, start), ref.slstm_scan(x, r, start)
            err = max((hs.float() - hs_w.float()).abs().max().item(),
                      (st[3] - st_w[3]).abs().max().item())
            rels = [rel(a, b) for a, b in zip(st[:3], st_w[:3])]
            ok = math.isfinite(err) and err <= tol and max(rels) <= tol
            errs[(name, B, S)] = err
            print(f"[kernels] slstm_scan {name} B{B} S{S} H{H} dh{dh} from a prefill's state: "
                  f"max|a-b| of hs and h {err:.3e}, c n m max|a-b|/max|b| "
                  + ", ".join(f"{v:.2e}" for v in rels) + f" (tol {tol:g}) "
                  + ("ok" if ok else "FAIL"), flush=True)
            if not ok:
                raise AssertionError(f"slstm_scan {name} B{B} S{S} disagrees with its plain "
                                     "version")
        B, S = SLSTM_ROWS[0]
        x, r, st0 = inputs(B, S + 1, dtype)
        whole = SL.slstm_scan(x, r, st0)
        two = same(whole, SL.slstm_scan(x, r, st0))
        part = SL.slstm_scan(x[:, :S].contiguous(), r, st0)
        last = SL.slstm_scan(x[:, S:].contiguous(), r, part[1])
        split = same((torch.cat([part[0], last[0]], 1), last[1]), whole)
        lane = all(same(SL.slstm_scan(x[b:b + 1].contiguous(), r,
                                      tuple(t[b:b + 1].contiguous() for t in st0)),
                        (whole[0][b:b + 1], tuple(t[b:b + 1] for t in whole[1])))
                   for b in range(B))
        print(f"[kernels] slstm_scan {name} B{B} S{S + 1} bit for bit: two runs {two}, S + 1 "
              f"against S then 1 from its final state {split}, each row at B = {B} against "
              f"it alone {lane}", flush=True)
        if not (two and split and lane):
            raise AssertionError(f"slstm_scan {name}: a bit-equality failed")
        del x, r, st0, whole, part, last
    rows = {}
    bf = torch.bfloat16
    for B, S in SLSTM_ROWS:
        # each prefill set is 36 MB (two pass the L2); a decode step's reads
        # R (2 MB) above all, so 32 sets, as 12 layers' own R would
        sets = [inputs(B, S, bf) for _ in range(2 if S > 1 else 32)]
        label = f"slstm_scan bf16 B{B} S{S} H{H} dh{dh}"
        graph_launches(label, lambda: SL.slstm_scan(*sets[0]), (SL.kernel(bf),))
        ms = cuda_ms(SL.slstm_scan, sets, iters=10 if S > 1 else 40)
        prof = sum(kernel_us(SL.slstm_scan, sets, iters=10 if S > 1 else 20, once=True).values())
        plain = cuda_ms(ref.slstm_scan, sets, iters=2 if S > 1 else 20)
        floor = cuda_ms(lambda *_: SL.barrier(B, S, H, dh, dev), sets[:1],
                        iters=10 if S > 1 else 40)
        # bytes: wx read and hs written in bf16, R read, the float32 state
        # read and written; operations: the product, 2 dh FLOP a (row,
        # gate column, position)
        nbytes = 2 * (B * S * 4 * H * dh + B * S * H * dh + H * dh * 4 * dh) + 8 * 4 * B * H * dh
        bound, by = bound_ms(2 * B * S * 4 * H * dh * dh, nbytes)
        rows[(B, S)] = {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                        "latency_floor_ms": floor, "max_abs_err": errs[("bfloat16", B, S)]}
        print(f"[kernels] {label}: {ms * 1e3:.1f} us (profiler {prof:.1f} us a call), plain "
              f"{plain * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}; {nbytes / 1e6:.1f} "
              f"MB), latency floor {floor * 1e3:.1f} us ({S + 1} cluster barriers on the "
              f"kernel's grid); no PyTorch call computes the sLSTM recurrence; {card}",
              flush=True)
        del sets
    return rows


def slstm_bwd_rows(card, dev):
    """Phase 3's sLSTM training kernels (xlstm-350m's SLSTM_HEADS heads of
    SLSTM_DH): the training forward's hs and final state bit-equal to the
    serving launch's and its saved gates and states held to the plain
    ones; the backward kernel held to ``ref.slstm_scan_bwd`` (dwx, dR, and
    from a prefill's state the start state's dc, dn, dm, dh) at each of
    SLSTM_BWD_ROWS in bf16 and float32 (GLA_TOL, max |a - b| / max |b| a
    gradient), fed by the training forward's saved tensors and, as a second
    case, by the plain forward's; two runs bit-equal and each row at B = 4
    equal to that row alone; one kernel node a call of each; and at the
    training shape both timed in bf16 (CUDA-graph replay over inputs
    rotated past the L2, the backward alone and with its dR product) beside
    their plain versions, their bytes bound and their latency floor (the
    S + 1 cluster barriers of the grid). Returns {"slt": row, "slb": row}
    for the JSON record."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.kernels.timing import cuda_ms
    H, dh = SLSTM_HEADS, SLSTM_DH
    gen = torch.Generator(device=dev).manual_seed(351)

    def inputs(B, S, dtype, warm):
        """slstm_rows' inputs, from state0 (the training path's start) or
        from a prefill's state of 8 positions (``warm``), and a gradient of
        hs ~ N(0, 1)."""
        wx = torch.randn(B, S + 8, 4 * H * dh, generator=gen, device=dev).to(dtype)
        r = (torch.randn(H, dh, 4 * dh, generator=gen, device=dev) / dh ** 0.5).to(dtype)
        st0 = ref.slstm_state0(B, H, dh, dev)
        if warm:
            st0 = ref.slstm_scan(wx[:, :8].contiguous(), r, st0)[1]
        dhs = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dtype)
        return wx[:, 8:].contiguous(), r, st0, dhs

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        tol = GLA_TOL[name]
        for B, S, warm in SLSTM_BWD_ROWS:
            x, r, st0, dhs = inputs(B, S, dtype, warm)
            hs, fin = SL.slstm_scan(x, r, st0)
            hs_t, fin_t, saved = SL.slstm_scan(x, r, st0, states=True)
            bits = torch.equal(hs, hs_t) and same(fin, fin_t)
            hs_w, _, saved_w = ref.slstm_scan(x, r, st0, states=True)
            e_saved = [rel(a, b) for a, b in zip(saved, saved_w)]
            cases = {}
            for case, (h_, sv) in (("kernel's", (hs_t, saved)), ("plain", (hs_w, saved_w))):
                got = SL.slstm_scan_bwd(r, st0, h_, sv, dhs, dstate=warm)
                want = ref.slstm_scan_bwd(r, st0, h_, sv, dhs, dstate=warm)
                e = [rel(got[0], want[0]), rel(got[1], want[1])]
                if warm:
                    e += [rel(a, b) for a, b in zip(got[2], want[2])]
                cases[case] = e
            ok = bits and max(e_saved) <= tol and all(
                math.isfinite(v) and v <= tol for e in cases.values() for v in e)
            errs[(name, B, S)] = max(max(e) for e in cases.values())
            print(f"[kernels] slstm_scan_bwd {name} B{B} S{S} H{H} dh{dh} from "
                  f"{'a prefill' if warm else 'state0'}: training forward's hs and final state "
                  f"equal the serving launch's bit for bit {bits}, its gates c n m vs plain "
                  + ", ".join(f"{v:.2e}" for v in e_saved) + "; backward max|a-b|/max|b| "
                  + "; ".join(f"on the {c} forward's tensors dwx dR"
                              + (" dc dn dm dh" if warm else "") + " "
                              + ", ".join(f"{v:.2e}" for v in e) for c, e in cases.items())
                  + f" (tol {tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"slstm_scan_bwd {name} B{B} S{S} disagrees with its "
                                     "plain version")
        B, S, _ = SLSTM_BWD_ROWS[0]
        x, r, st0, dhs = inputs(B, S, dtype, True)
        hs, _, saved = SL.slstm_scan(x, r, st0, states=True)
        a = SL.slstm_scan_bwd(r, st0, hs, saved, dhs, dstate=True)
        two = same(a[:2], SL.slstm_scan_bwd(r, st0, hs, saved, dhs, dstate=True)[:2])
        lane = True
        for b in range(B):
            sb = tuple(t[b:b + 1].contiguous() for t in st0)
            hb, _, sv = SL.slstm_scan(x[b:b + 1].contiguous(), r, sb, states=True)
            one = SL.slstm_scan_bwd(r, sb, hb, sv, dhs[b:b + 1].contiguous(), dstate=True)
            lane &= torch.equal(one[0], a[0][b:b + 1]) and same(
                one[2], tuple(t[b:b + 1] for t in a[2]))
        print(f"[kernels] slstm_scan_bwd {name} B{B} S{S} bit for bit: two runs {two}, each "
              f"row at B = {B} (dwx and the start state's gradient) against it alone {lane}",
              flush=True)
        if not (two and lane):
            raise AssertionError(f"slstm_scan_bwd {name}: a bit-equality failed")
        del x, r, st0, dhs, hs, saved, a
    bf = torch.bfloat16
    B, S, _ = SLSTM_BWD_ROWS[0]
    # two sets of 128 MB each pass the L2
    fsets, bsets = [], []
    for _ in range(2):
        x, r, st0, dhs = inputs(B, S, bf, False)
        hs, _, saved = SL.slstm_scan(x, r, st0, states=True)
        fsets.append((x, r, st0))
        bsets.append((r, st0, hs, saved, dhs))
    label = f"bf16 B{B} S{S} H{H} dh{dh}"
    graph_launches(f"slstm_scan training forward {label}",
                   lambda: SL.slstm_scan(*fsets[0], states=True), (SL.kernel(bf),))
    graph_launches(f"slstm_scan_bwd {label}", lambda: SL._bwd(*bsets[0]),
                   (SL.kernel(bf, bwd=True),))

    def train_fwd(*a):
        return SL.slstm_scan(*a, states=True)

    def plain_fwd(*a):
        return ref.slstm_scan(*a, states=True)
    t_fwd = cuda_ms(train_fwd, fsets, iters=10)
    t_serve = cuda_ms(SL.slstm_scan, fsets, iters=10)
    t_bwd = cuda_ms(SL._bwd, bsets, iters=10)
    t_bwd_dr = cuda_ms(SL.slstm_scan_bwd, bsets, iters=10)
    p_fwd = cuda_ms(plain_fwd, fsets, iters=2)
    p_bwd = cuda_ms(ref.slstm_scan_bwd, bsets, iters=2)
    floor = cuda_ms(lambda *_: SL.barrier(B, S, H, dh, dev), fsets[:1], iters=10)
    # bytes, each input read once and each output written once: the
    # training forward reads wx (bf16) and R and the float32 start state,
    # writes hs and the gates (bf16), c, n, m a position and the final state
    # (float32); the backward reads R, the gates and dhs (bf16), c, n, m a
    # position and c, n, m of the start (float32), writes dwx (bf16) and the
    # start state's dc, dn, dh (float32). Operations: the product, 2 dh FLOP
    # a (row, gate column, position), in each
    pos, st = B * S * H * dh, B * H * dh
    rb = 2 * H * dh * 4 * dh
    f_bytes = 2 * 4 * pos + rb + 4 * 4 * st + 2 * pos + 2 * 4 * pos + 3 * 4 * pos + 4 * 4 * st
    b_bytes = rb + 2 * 4 * pos + 2 * pos + 3 * 4 * pos + 3 * 4 * st + 2 * 4 * pos + 3 * 4 * st
    flops = 2 * B * S * 4 * H * dh * dh
    out = {}
    for key, ms, plain, nbytes, what in (
            ("slt", t_fwd, p_fwd, f_bytes, "training forward"),
            ("slb", t_bwd, p_bwd, b_bytes, "backward")):
        bound, by = bound_ms(flops, nbytes)
        out[key] = {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                    "latency_floor_ms": floor, "max_abs_err": errs[("bfloat16", B, S)]}
        extra = (f" (the serving launch {t_serve * 1e3:.1f} us, {t_serve * 1e3 / S:.3f} a step)"
                 if key == "slt" else f" (with its dR product {t_bwd_dr * 1e3:.1f} us, "
                 f"{t_bwd_dr * 1e3 / S:.3f} a step)")
        print(f"[kernels] slstm_scan {what} {label}: {ms * 1e3:.1f} us, {ms * 1e3 / S:.3f} us a "
              f"step{extra}, plain {plain * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), latency floor "
              f"{floor * 1e3:.1f} us, {floor * 1e3 / (S + 1):.3f} a step ({S + 1} cluster "
              f"barriers on the kernel's grid); no PyTorch call computes the sLSTM recurrence "
              f"or its gradient; {card}", flush=True)
    out["slb"]["dr_ms"] = t_bwd_dr
    out["slt"]["serving_ms"] = t_serve
    return out


def xlstm_phase(card, dev):
    """xlstm-350m's Server at full width and depth (the module docstring's
    ``xlstm``): 4 x 1024 prefill and 32 greedy steps, the sLSTM scan's
    launches (once an sLSTM layer a prefill and a step), the holds
    (``hold_to_plain``'s noisy form: the float32 kernel path against the
    float32 plain path), peak memory and a decode step's idle share.
    Returns the params and the launch counts of the prefill and the
    decode."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.engine import Server

    t_phase = time.perf_counter()
    cfg = get_config("xlstm-350m")
    L = cfg.n_layers // 2          # sLSTM layers: one a pair
    n_prompt, n_gen, batch = 1024, 32, 4
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size, (batch, n_prompt))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    srv = Server(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    srv.prefill(prompts[:, :256])                 # warm-up: cuBLAS, the kernel's load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SL.launches = 0
    t0 = time.perf_counter()
    logits = srv.prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = {"prefill": SL.launches}
    first = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).cpu().numpy()
    toks, dt = srv.decode(n_gen, first)
    launches["decode"] = SL.launches - launches["prefill"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    x = cfg.xlstm
    n_params = sum(t.numel() for t in tree_leaves(srv.params))
    print(f"[xlstm] xlstm-350m {n_params / 1e9:.3f}B params bf16 (seeded init {init_s:.1f} s), "
          f"{cfg.n_layers} layers as {L} mLSTM + sLSTM pairs, d_model {cfg.d_model}, {x.n_heads} "
          f"heads (mLSTM inner {int(cfg.d_model * x.m_proj_factor)}, sLSTM head "
          f"{cfg.d_model // x.n_heads}), chunk {x.chunk}; prefill {batch}x{n_prompt}: "
          f"{prefill_ms:.1f} ms; decode {n_gen} steps x {batch}: {n_gen * batch / dt:.1f} tok/s "
          f"({dt / n_gen * 1e3:.2f} ms/step); peak memory {peak_gb:.2f} GB; card {card}",
          flush=True)
    want = {"prefill": L, "decode": L * n_gen}
    print(f"[xlstm] sLSTM scan launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"xlstm: main path launch counts {launches} != {want}")
    stream = np.stack(toks, axis=1)
    if stream.shape != (batch, n_gen) or stream.min() < 0 or stream.max() >= cfg.vocab_size:
        raise AssertionError(f"xlstm: bad token stream {stream.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError("xlstm: non-finite prefill logits")
    del logits
    tokens = torch.as_tensor(prompts, device=dev)
    ok = hold_to_plain("xlstm", cfg, srv.model, srv.params, tokens, [first] + toks[:3], dev,
                       noisy=True)[0]
    decode_idle("xlstm", srv.model, srv.params, tokens, first, dt / n_gen * 1e3, dev)
    if not ok:
        raise AssertionError("xlstm: kernel path disagrees with the plain path")
    params = srv.params
    del srv, tokens
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[xlstm] phase seconds: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return params, launches


def main() -> int:
    t_start = time.perf_counter()
    # the caching allocator maps its segments' pages on demand: after
    # llava's 68.8 GB of weights come and go, whole-segment reuse left 9.6
    # GiB reserved but unusable and qwen's trainer ran out of memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--sdpa-bwd-profile":
        return sdpa_bwd_child(sys.argv[2])
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gla_chunk as GC
    from repro_torch.kernels import latent_decode_attention as LA
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels.timing import cuda_ms
    from repro_torch.models.params import tree_map
    from repro_torch.serving.engine import Server

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
    t_mark = phase_time("build", t_start)
    # SDPA's backward at every training shape phase 3 times K1's backward at
    # (granite, qwen, llava, granite-moe, minicpm3 with V at its 64 columns
    # and zero-padded to 96), in one child process
    sdpa_bwd_profiles(((4, 32, 8, 1024, 64), (4, 40, 8, 1024, 128), (4, 56, 8, 1024, 128),
                       (4, 24, 8, 1024, 64), (4, 40, 40, 1024, C_DQK, C_DV),
                       (4, 40, 40, 1024, C_DQK)))

    # -- 3. each kernel against its plain version ----------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[kernels] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device=dev).manual_seed(0)
    # MLA's shapes draw from a generator of their own, so that the earlier
    # shapes' inputs (and the holds that read them) are the ones they were
    mla_gen = torch.Generator(device=dev).manual_seed(96)

    def randn(*shape, dtype, g=None):
        return torch.randn(shape, generator=g or gen, device=dev).to(dtype)

    def flash_inputs(B, H, K, S, D, dtype, g=None):
        # the model's [B,S,H,D] projections, seen as [B,H,S,D] views; at
        # MLA's qk head dim 96, V at its own 64 columns as the model lays it
        # out
        q, k, v = (randn(B, S, n, d, dtype=dtype, g=g).transpose(1, 2)
                   for n, d in ((H, D), (K, D), (K, C_DV if D == C_DQK else D)))
        return q, k, v

    def latent_pages(B, lengths, dtype, layer=31, n_layers=62, H=40, stores=1):
        """q, then layer ``layer``'s strided [P, page, 288] view of a stacked
        latent pool store [P, page, n_layers*288] (the fleet's layout), a
        table of distinct shuffled pages with the entries past each length
        set to 0, and the int32 lengths."""
        n = max(-(-max(lengths) // FLEET_PAGE), 1)
        P = B * n + 3
        st = randn(P, FLEET_PAGE, n_layers * LA.DK, dtype=dtype, g=mla_gen)
        pages = st.view(P, FLEET_PAGE, n_layers, LA.DK)[:, :, layer]
        order = torch.randperm(P, generator=torch.Generator().manual_seed(P * B))
        table = order[: B * n].view(B, n).to(torch.int32)
        for b, L in enumerate(lengths):
            table[b, -(-L // FLEET_PAGE):] = 0
        return (randn(B, H, LA.DK, dtype=dtype, g=mla_gen), pages, table.to(dev),
                torch.tensor(lengths, dtype=torch.int32, device=dev))

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

    def gla_inputs(B, S, H, N, P, dtype, bcast, steep=False, g=None):
        """tests/test_kernels.py's GLA distributions. ``bcast``: q and k as
        the SSD mixer passes them, head-broadcast views (head stride 0) of
        the C and B columns of a projection row [B, S, H*P + 2N]. ``steep``:
        log decays uniform in [-20, 0] a step (hymba's -exp(a_log) dt can
        reach them), so a chunk's cum falls to about -2500."""
        v = randn(B, S, H, P, dtype=dtype, g=g)
        lg = -F.softplus(randn(B, S, H, dtype=torch.float32, g=g)) * 0.3
        if steep:
            lg = -20 * torch.rand(B, S, H, generator=g or gen, device=dev)
        if not bcast:
            return (randn(B, S, H, N, dtype=dtype, g=g),
                    (randn(B, S, H, N, dtype=torch.float32, g=g) * 0.3).to(dtype), v, lg)
        row = randn(B, S, H * P + 2 * N, dtype=torch.float32, g=g)
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
                                 (2, 4, 2, 24, 32, None),
                                 # qwen2.5-14b (D 128, G 5): prefill, ragged, a
                                 # window; minicpm-2b (G 1)
                                 (4, 40, 8, 1024, 128, None), (4, 40, 8, 1000, 128, None),
                                 (2, 10, 2, 300, 128, 100), (4, 36, 36, 1024, 64, None),
                                 # llava-next-34b (D 128, G 7), granite-moe-3b-a800m
                                 # (D 64, G 3)
                                 (4, 56, 8, 1024, 128, None), (4, 24, 8, 1024, 64, None)):
            q, k, v = flash_inputs(B, H, K, S, D, dtype)
            held("flash_attention", f"{dn} B{B} H{H} K{K} S{S} D{D} window={w}",
                 FA.flash_attention(q, k, v, window=w),
                 ref.naive_attention(q, k, v, window=w), dtype)
        for B, H, K, S, D, length, w in ((4, 32, 8, 1056, 64, 1, None),
                                         (4, 32, 8, 1056, 64, DA.split_len(64), None),
                                         (4, 32, 8, 1056, 64, 1056, None),
                                         (4, 32, 8, 1056, 64, 1056, 300),
                                         (4, 25, 5, 1568, 64, 1537, None),
                                         (4, 25, 5, 1568, 64, 1568, None),
                                         (2, 4, 2, 24, 32, 17, None),
                                         (4, 40, 8, 1056, 128, 1, None),
                                         (4, 40, 8, 1056, 128, DA.split_len(128), None),
                                         (4, 40, 8, 1056, 128, DA.split_len(128) + 1, None),
                                         (4, 40, 8, 1056, 128, 1056, None),
                                         (4, 40, 8, 1056, 128, 1056, 300),
                                         (4, 36, 36, 1056, 64, 1056, None),
                                         (4, 56, 8, 1056, 128, 577, None),
                                         (4, 56, 8, 1056, 128, 1056, None),
                                         (4, 24, 8, 1056, 64, 1056, None)):
            q, k, v = decode_inputs(B, H, K, S, D, dtype)
            held("decode_attention", f"{dn} B{B} H{H} K{K} S{S} D{D} length={length} "
                 f"window={w}", DA.decode_attention(q, k, v, length, window=w),
                 ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                            length, window=w), dtype)
        # the fleet's decode: one lane (and four), granite's 40-layer pool store
        # seen as layer 20's strided view, a shuffled table; lengths 1, a page
        # edge, a split edge and the full 1056
        for B, lengths, w in ((1, [1], None), (1, [FLEET_PAGE], None),
                              (1, [DA.split_len(64)], None), (1, [1056], None),
                              (1, [1056], 300),
                              (4, [1, FLEET_PAGE, DA.split_len(64), 1056], None)):
            q, kp, vp, table, lens = paged_inputs(B, lengths, dtype)
            held("paged_decode_attention", f"{dn} B{B} H32 K8 D64 layer 20/40 "
                 f"lengths={lengths} window={w}",
                 PA.paged_decode_attention(q, kp, vp, table, lens, window=w),
                 ref.naive_paged_decode_attention(q, kp, vp, table, lens, window=w), dtype)
        # qwen2.5-14b's fleet decode: D 128, G 5, its 48-layer store seen as
        # layer 24's strided view
        for B, lengths, w in ((1, [1], None), (1, [DA.split_len(128)], None),
                              (1, [1056], None), (1, [1056], 300),
                              (4, [1, FLEET_PAGE, DA.split_len(128) + 1, 1056], None)):
            q, kp, vp, table, lens = paged_inputs(B, lengths, dtype, layer=24, n_layers=48,
                                                  H=40, K=8, D=128)
            held("paged_decode_attention", f"{dn} B{B} H40 K8 D128 layer 24/48 "
                 f"lengths={lengths} window={w}",
                 PA.paged_decode_attention(q, kp, vp, table, lens, window=w),
                 ref.naive_paged_decode_attention(q, kp, vp, table, lens, window=w), dtype)
        # over pages that lie in order, the paged decode runs the contiguous
        # decode's splits on the same rows: expected equal bit for bit; and
        # so are a row decoded alone (B = 1, a fleet lane) and the same row
        # of the batch, and two launches (granite G 4, qwen G 5, granite-moe
        # G 3, llava G 7)
        n = 1056 // FLEET_PAGE
        table = torch.arange(4 * n, dtype=torch.int32, device=dev).view(4, n)
        # G 3 and 7 draw from a generator of their own, so that the later
        # phases' inputs are the ones they were drawn before these shapes
        # joined (a hold near its tolerance, GLA's, reads them)
        side = torch.Generator(device=dev).manual_seed(7)
        for H, K, D in ((32, 8, 64), (40, 8, 128), (24, 8, 64), (56, 8, 128)):
            if H // K in (3, 7):
                q, k, v = (torch.randn(sh, generator=side, device=dev).to(dtype)
                           for sh in ((4, H, D), (4, 1056, K, D), (4, 1056, K, D)))
            else:
                q, k, v = decode_inputs(4, H, K, 1056, D, dtype)
            for length in (1, 500, 1056):
                lens = torch.full((4,), length, dtype=torch.int32, device=dev)
                a = PA.paged_decode_attention(q, k.view(4 * n, FLEET_PAGE, K, D),
                                              v.view(4 * n, FLEET_PAGE, K, D), table, lens)
                b = DA.decode_attention(q, k, v, length)
                same = torch.equal(a, b)
                lane = all(torch.equal(DA.decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                           length), b[i:i + 1])
                           for i in range(4))
                again = torch.equal(DA.decode_attention(q, k, v, length), b)
                bitwise[f"{dn} H{H} K{K} D{D} length={length}"] = same and lane and again
                print(f"[kernels] paged_decode_attention over in-order pages vs "
                      f"decode_attention {dn} B4 H{H} K{K} S1056 D{D} length={length}: "
                      + ("equal bit for bit" if same else
                         f"NOT bit-equal, max |diff| "
                         f"{(a.float() - b.float()).abs().max().item():.3e}")
                      + f"; each B = 1 lane equals its batched row {lane}; two launches "
                      f"agree {again}", flush=True)
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
                                      (2, 4, 2, 32, 36, 32, 45),
                                      # head dim 128 through the shared template
                                      (2, 10, 2, 128, 300, 256, 1000)):
            q = randn(B, H, D, dtype=dtype)
            k, v = randn(B, W, K, D, dtype=dtype), randn(B, W, K, D, dtype=dtype)
            held("decode_attention_ring", f"{dn} B{B} H{H} K{K} D{D} W_ring={W} "
                 f"window={w} pos={pos}", DA.ring_decode_attention(q, k, v, pos, window=w),
                 ref.naive_ring_decode_attention(q, k, v, pos, window=w), dtype)
        # MLA (minicpm3-4b): K1 at qk head dim 96, its prefill shape (MHA, V
        # at its 64 columns) and a ragged S with a window; the latent
        # decode (lengths 1, a block's edge either side, the full 1056; 48
        # heads, the most a launch takes) contiguous, and through layer 31 of
        # a 62-layer strided store with a shuffled table (one lane, four)
        for B, H, S, w in ((4, 40, 1024, None), (2, 8, 300, 100)):
            q, k, v = flash_inputs(B, H, H, S, C_DQK, dtype, g=mla_gen)
            held("flash_attention", f"{dn} B{B} H{H} K{H} S{S} D{C_DQK} window={w}",
                 FA.flash_attention(q, k, v, window=w), ref.naive_attention(q, k, v, window=w),
                 dtype)
        for B, H, S, length in ((4, 40, 1056, 1), (4, 40, 1056, LA.CHUNK),
                                (4, 40, 1056, LA.CHUNK + 1), (4, 40, 1056, 1056),
                                (2, 48, 300, 257)):
            q, lat = (randn(B, n, LA.DK, dtype=dtype, g=mla_gen) for n in (H, S))
            held("latent_decode_attention", f"{dn} B{B} H{H} S{S} Dk{LA.DK} Dv{LA.DV} "
                 f"length={length}", LA.latent_decode_attention(q, lat, length, v_dim=LA.DV,
                                                                scale=C_SCALE),
                 ref.naive_latent_decode_attention(q, lat, length, v_dim=LA.DV, scale=C_SCALE),
                 dtype)
        for B, lengths in ((1, [1]), (1, [1056]), (4, [1, FLEET_PAGE, LA.CHUNK + 1, 1056])):
            q, pages, table, lens = latent_pages(B, lengths, dtype)
            held("paged_latent_decode_attention", f"{dn} B{B} H40 Dk{LA.DK} Dv{LA.DV} layer "
                 f"31/62 lengths={lengths}",
                 LA.paged_latent_decode_attention(q, pages, table, lens, v_dim=LA.DV,
                                                  scale=C_SCALE),
                 ref.naive_paged_latent_decode_attention(q, pages, table, lens, v_dim=LA.DV,
                                                         scale=C_SCALE), dtype)
        # over pages in order the paged latent decode runs the contiguous
        # one's blocks on the same rows: equal bit for bit, and so are each
        # B = 1 lane and its batched row, and two launches; and since a
        # row's plan depends on its length alone, a cache of 2048 positions
        # and a table twice as wide give the exact fit's bits
        n = 1056 // FLEET_PAGE
        table = torch.arange(4 * n, dtype=torch.int32, device=dev).view(4, n)
        q, lat = (randn(4, m, LA.DK, dtype=dtype, g=mla_gen) for m in (40, 1056))
        wide_lat = torch.zeros(4, 2048, LA.DK, dtype=dtype, device=dev)
        wide_lat[:, :1056] = lat
        wide_tab = torch.cat([table, torch.zeros_like(table)], 1)
        for length in (1, 64, 65, 500, 1056):
            lens = torch.full((4,), length, dtype=torch.int32, device=dev)
            kw = dict(v_dim=LA.DV, scale=C_SCALE)
            pages = lat.view(4 * n, FLEET_PAGE, LA.DK)
            a = LA.paged_latent_decode_attention(q, pages, table, lens, **kw)
            b = LA.latent_decode_attention(q, lat, length, **kw)
            same = torch.equal(a, b)
            lane = all(torch.equal(LA.paged_latent_decode_attention(
                q[i:i + 1], lat[i].view(n, FLEET_PAGE, LA.DK), table[:1], lens[:1], **kw),
                b[i:i + 1]) for i in range(4))
            again = torch.equal(LA.latent_decode_attention(q, lat, length, **kw), b)
            cap = (torch.equal(LA.latent_decode_attention(q, wide_lat, length, **kw), b)
                   and torch.equal(LA.paged_latent_decode_attention(q, pages, wide_tab, lens,
                                                                    **kw), a))
            bitwise[f"{dn} latent H40 length={length}"] = same and lane and again and cap
            print(f"[kernels] paged_latent_decode_attention over in-order pages vs "
                  f"latent_decode_attention {dn} B4 H40 S1056 length={length}: "
                  + ("equal bit for bit" if same else
                     f"NOT bit-equal, max |diff| {(a.float() - b.float()).abs().max().item():.3e}")
                  + f"; each B = 1 lane equals its batched row {lane}; two launches agree "
                  f"{again}; a cache of 2048 and a table of {2 * n} pages give the exact "
                  f"fit's bits {cap}", flush=True)
        del wide_lat
    if not all(bitwise.values()):
        raise AssertionError(f"the paged decode over in-order pages differs from the "
                             f"contiguous decode, or a lane from its batched row: {bitwise}")
    del q, k, v, kp, vp, a, b, lg, yn, yc, y4, ya, pa, pd, d, start, y5   # phase 4's peak
    del lat, pages

    # K4's bf16 hold at hymba's serving shape (head-stride-0 q/k) over
    # GLA_SWEEP seeds, each input drawn from a generator of its own, each
    # held elementwise to the kernel's error bound (gla_error_bound)
    sweep = []
    for seed in range(GLA_SWEEP):
        sg = torch.Generator(device=dev).manual_seed(1000 + seed)
        q, k, v, lg = gla_inputs(*G_SHAPE[:5], torch.bfloat16, True, g=sg)
        y4 = GC.gla_chunk(q, k, v, lg, chunk=G_SHAPE[5])[0]
        yc = ref.chunked_gla(q, k, v, lg, chunk=G_SHAPE[5])[0].float()
        bound = gla_error_bound(ref, q, k, v, lg, yc, G_SHAPE[5])
        diff = (y4.float() - yc).abs()
        sweep.append(((diff / bound).max().item(), (diff / (1 + yc.abs())).max().item(),
                      diff.max().item()))
    del q, k, v, lg, y4, yc, bound, diff
    worst = [max(x[i] for x in sweep) for i in range(3)]
    ok = all(math.isfinite(x[0]) and x[0] <= 1 for x in sweep)
    print(f"[kernels] gla_chunk {G_MAIN} over {GLA_SWEEP} seeds: max |a-b| / the kernel's error "
          f"bound min {min(x[0] for x in sweep):.3f} median "
          f"{sorted(x[0] for x in sweep)[GLA_SWEEP // 2]:.3f} max {worst[0]:.3f} (tol 1); "
          f"max |a-b|/(1+|b|) min {min(x[1] for x in sweep):.3e} max {worst[1]:.3e}; "
          f"max_abs_err max {worst[2]:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("gla_chunk: a seed's bf16 output exceeds the kernel's error bound")

    # K1's logsumexp and the backward's two kernels, the train phase's
    # path: the prefill's output with the logsumexp write on equals it
    # without bit for bit, the row sums the dQ launch writes hold to the
    # plain ones, and two backward runs agree bit for bit
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for B, H, K, S, D, w in BWD_SHAPES + C_BWD_SHAPES:
            lab = f"{dn} B{B} H{H} K{K} S{S} D{D} window={w}"
            g = mla_gen if D == C_DQK else None
            q, k, v = flash_inputs(B, H, K, S, D, dtype, g=g)
            o, lse = FA.flash_attention(q, k, v, window=w, lse=True)
            same = torch.equal(o, FA.flash_attention(q, k, v, window=w))
            lse_err = (lse - ref.naive_attention_lse(q, k, window=w)).abs().max().item()
            do = randn(B, H, S, v.shape[-1], dtype=dtype, g=g)
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

    # K4's chunk start states and the GLA backward (K4b), the train_hymba
    # phase's path: hymba's training shape with the mixer's head-broadcast
    # q/k (in bf16 also under steep decays), a length the chunk does not
    # divide (1000 with 256 halves down to 8), the smoke shape and per-head
    # q/k; the prefill's K4 output with the chunk-start write on equals it
    # without bit for bit, and two backward runs agree bit for bit (float32
    # not under steep decays, as the GLA holds above)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for B, S, H, N, P, chunk, bcast, steep in (
                G_SHAPE + (True, False), G_SHAPE + (True, True),
                (2, 1000, 4, 16, 64, 256, True, False), (2, 40, 2, 8, 32, 8, True, False),
                (2, 48, 3, 8, 32, 16, False, False)):
            if steep and dtype != torch.bfloat16:
                continue
            q, k, v, lg = gla_inputs(B, S, H, N, P, dtype, bcast, steep)
            lab = (f"{dn} B{B} S{S} H{H} N{N} P{P} chunk={chunk}"
                   + (" head-stride-0 q/k" if bcast else "") + (" steep" if steep else ""))
            y, fin, st = GC.gla_chunk(q, k, v, lg, chunk=chunk, starts=True)
            y0, fin0 = GC.gla_chunk(q, k, v, lg, chunk=chunk)
            same = torch.equal(y, y0) and torch.equal(fin, fin0)
            held("gla_chunk", lab + " chunk start states", st,
                 ref.chunked_gla(q, k, v, lg, chunk=chunk, starts=True)[2], dtype, gla=True)
            dy = randn(B, S, H, P, dtype=dtype)
            want = ref.gla_bwd(q, k, v, lg, dy, st, chunk=chunk)
            names = ("dq", "dk", "dv", "dlg")
            routes = [("per-head q/k", (q, k), want)]
            if bcast:
                # the shared-row route, as GLAChunk takes the SSD mixer's C_t
                # and B_t: dq and dk come back as the rows, the heads' sum
                routes.append(("shared rows", (q[:, :, 0], k[:, :, 0]),
                               (want[0].float().sum(2), want[1].float().sum(2)) + want[2:]))
            for route, qk, wnt in routes:
                got = GC._bwd(*qk, v, lg, dy, st, chunk=chunk)
                again = GC._bwd(*qk, v, lg, dy, st, chunk=chunk)
                bits = all(torch.equal(a, b) for a, b in zip(got[:4], again[:4]))
                r = {n: rel(a.float(), b.float()) for n, a, b in zip(names, got, wnt)}
                err = {n: (a.float() - b.float()).abs().max().item()
                       for n, a, b in zip(names, got, wnt)}
                scr = got[4]
                if scr:   # bf16: each launch held to its plain part
                    r["state pass dS"] = rel(scr["dstate"],
                                             ref.gla_bwd_states(q, lg, dy, chunk=chunk))
                    r["dq launch q.dq"] = rel(scr["rq"], (q.float() * want[0].float()).sum(
                        -1).transpose(1, 2))
                    r["dk/dv launch k.dk"] = rel(scr["rk"], (k.float() * want[1].float()).sum(
                        -1).transpose(1, 2))
                ok = (same and bits and all(torch.isfinite(a).all().item() for a in got[:4])
                      and all(math.isfinite(x) and x <= GLA_BWD_TOL[dn] for x in r.values()))
                print(f"[kernels] gla_chunk_bwd {lab}, {route}: max|a-b|/max|b| "
                      + " ".join(f"{n} {x:.3e}" for n, x in r.items())
                      + f" (tol {GLA_BWD_TOL[dn]:g}); two runs equal bit for bit {bits}; K4's "
                      f"output with the chunk-start write equals the prefill's bit for bit "
                      f"{same} {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"gla_chunk_bwd {lab} ({route}) disagrees with its "
                                         "plain version or is not deterministic")
                errs.setdefault("gla_chunk_bwd", {})[f"{lab}, {route}"] = max(err.values())
    del q, k, v, lg, y, y0, st, dy, got, again, want, wnt, scr

    # times at the serving paths' shapes, bf16
    B, H, K, S, D, bf = 4, 32, 8, 1024, 64, torch.bfloat16
    fsets = [flash_inputs(B, H, K, S, D, bf) for _ in range(4)]
    for lse in (False, True):
        graph_launches(f"flash_attention bf16 B{B} H{H} K{K} S{S} D{D} lse={lse}",
                       lambda: FA.flash_attention(*fsets[0], lse=lse),
                       (FA.fwd_kernel(bf, D, H // K),))
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
    bwd = bwd_times(fsets, B, H, K, S, D, randn, FA, ref, cuda_ms)
    # K1 at hymba's prefill, windowed and global layers; SDPA's yardstick
    # takes the window as a boolean mask (causal and within the window)
    hB, hH, hK, hS = 4, 25, 5, 1536
    hsets = [flash_inputs(hB, hH, hK, hS, D, bf) for _ in range(4)]
    pos = torch.arange(hS, device=dev)
    for w in (1024, None):
        graph_launches(f"flash_attention bf16 B{hB} H{hH} K{hK} S{hS} D{D} window={w}",
                       lambda: FA.flash_attention(*hsets[0], window=w),
                       (FA.fwd_kernel(bf, D, hH // hK, w),))
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
    # K1's backward at hymba's training shape, each mask: the whole
    # backward's CUDA-graph time, its plain version's, SDPA's backward
    # (the profiler's device time per call; the window as a boolean mask),
    # and the bound: five products over the pairs the mask admits
    for w in (1024, None):
        hb = []
        for q, k, v in hsets:
            o, lse = FA.flash_attention(q, k, v, window=w, lse=True)
            hb.append((q, k, v, o, lse, randn(hB, hH, hS, D, dtype=bf)))
        graph_launches(f"flash_attention_bwd bf16 B{hB} H{hH} K{hK} S{hS} D{D} window={w}",
                       lambda: FA.flash_attention_bwd(*hb[0], window=w),
                       ("dq_bf16_kernel", "dkdv_bf16_kernel"))
        hb_ms = cuda_ms(lambda *a: FA.flash_attention_bwd(*a, window=w), hb)
        hb_plain = cuda_ms(lambda *a: ref.flash_attention_bwd(*a, window=w), hb, iters=3)
        lib_sets = []
        for q, k, v, _, _, do in hb:
            ins = tuple(x.detach().requires_grad_() for x in (q, k, v))
            if w:
                mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < w)
                out = F.scaled_dot_product_attention(*ins, attn_mask=mask, enable_gqa=True)
            else:
                out = F.scaled_dot_product_attention(*ins, is_causal=True, enable_gqa=True)
            lib_sets.append((out, ins, do))
        hb_lib = sum(kernel_us(lambda out, ins, do: torch.autograd.grad(
            out, ins, do, retain_graph=True), lib_sets, iters=10).values()) / 1e3
        del lib_sets
        pairs = w * (w + 1) / 2 + (hS - w) * w if w else hS * hS / 2
        n_q, n_kv, rows = hB * hH * hS * D, hB * hK * hS * D, hB * hH * hS
        hb_bound, hb_by = bound_ms(5 * 2 * hB * hH * pairs * D,
                                   2 * (4 * n_q + 4 * n_kv) + 4 * rows)
        print(f"[kernels] flash_attention_bwd bf16 B{hB} H{hH} K{hK} S{hS} D{D} window={w} "
              f"(the train_hymba path's shape): {hb_ms * 1e3:.1f} us (dQ + dK/dV), plain "
              f"{hb_plain * 1e3:.1f} us, sdpa backward (yardstick, profiler) "
              f"{hb_lib * 1e3:.1f} us, bound {hb_bound * 1e3:.2f} us ({hb_by}: 5 products over "
              f"the mask's pairs)", flush=True)
        del hb
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

    # the dense families: K1 at qwen2.5-14b's prefill (D 128, G 5) and
    # minicpm-2b's (G 1), K1's backward at qwen's training shape, K2 at both
    # decode shapes, K3 over qwen's 48-layer strided store. Each time is a
    # CUDA graph's replay beside the profiler's device time per call
    t_dense = time.perf_counter()
    dense, backends = {}, {}

    def dense_row(key, label, fn, sets, plain_fn, lib_fn, flops, nbytes, plain_iters=5,
                  kernel=None, backend=False, lib_forms=None):
        # lib_forms: {form: SDPA on the same function's inputs in another
        # form}; the row's library time is the fastest form's
        if kernel:
            graph_launches(label, lambda: fn(*sets[0]), (kernel,))
        ms = cuda_ms(fn, sets, iters=40)
        us = kernel_us(fn, sets, iters=20, once=True)
        prof = sum(us.values())
        plain = cuda_ms(plain_fn, sets, iters=plain_iters)
        forms = {"": lib_fn, **(lib_forms or {})}
        libs = {f: cuda_ms(g, sets, iters=40) for f, g in forms.items()}
        form = min(libs, key=libs.get)
        lib, lib_fn = libs[form], forms[form]
        served = ""
        if backend:   # the SDPA backend that served lib_fn, from its kernels' names
            backends[key] = sdpa_backend(kernel_us(lib_fn, sets[:2], iters=4))
            if lib_forms:
                backends[key] += f", {form or 'as the kernel takes them'}"
            served = f" ({backends[key]} backend)"
        if lib_forms:
            served += " [" + ", ".join(f"{f or 'as the kernel takes them'} {t * 1e3:.1f} us"
                                       for f, t in libs.items()) + "]"
        bound, by = bound_ms(flops, nbytes)
        dense[key] = (ms, plain, bound, by, lib)
        print(f"[kernels] {label}: {ms * 1e3:.1f} us (profiler {prof:.1f} us a call), plain "
              f"{plain * 1e3:.1f} us, sdpa{served} {lib * 1e3:.1f} us, bound "
              f"{bound * 1e3:.2f} us ({by}); {card}", flush=True)

    fam_bwd = {}
    for arch, (B, H, K, S, D) in (("qwen2.5-14b", (4, 40, 8, 1024, 128)),
                                  ("minicpm-2b", (4, 36, 36, 1024, 64)),
                                  ("llava-next-34b", (4, 56, 8, 1024, 128)),
                                  ("granite-moe-3b-a800m", (4, 24, 8, 1024, 64))):
        sets = [flash_inputs(B, H, K, S, D, bf) for _ in range(4)]
        dense_row(f"flash {arch}", f"flash_attention bf16 B{B} H{H} K{K} S{S} D{D} ({arch}'s "
                  "prefill)", lambda q, k, v: FA.flash_attention(q, k, v), sets,
                  lambda q, k, v: ref.naive_attention(q, k, v),
                  lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True),
                  4 * B * H * S * S * D / 2, 2 * (2 * B * H * S * D + 2 * B * K * S * D),
                  kernel=FA.fwd_kernel(bf, D, H // K))
        if arch != "minicpm-2b":
            fam_bwd[arch] = bwd_times(sets, B, H, K, S, D, randn, FA, ref, cuda_ms,
                                      label=f"{arch}'s training shape")
        del sets
    qbwd = fam_bwd["qwen2.5-14b"]
    for arch, (B, H, K, D) in (("qwen2.5-14b", (4, 40, 8, 128)), ("minicpm-2b", (4, 36, 36, 64)),
                               ("llava-next-34b", (4, 56, 8, 128)),
                               ("granite-moe-3b-a800m", (4, 24, 8, 64))):
        sets = [decode_inputs(B, H, K, Smax, D, bf) for _ in range(8)]
        dense_row(f"decode {arch}", f"decode_attention bf16 B{B} H{H} K{K} S{Smax} len{length} "
                  f"D{D} ({arch}'s last decode step)",
                  lambda q, k, v: DA.decode_attention(q, k, v, length), sets,
                  lambda q, k, v: ref.naive_decode_attention(
                      q, k.transpose(1, 2), v.transpose(1, 2), length),
                  lambda q, k, v: F.scaled_dot_product_attention(
                      q[:, :, None], k[:, :length].transpose(1, 2),
                      v[:, :length].transpose(1, 2), enable_gqa=True),
                  4 * B * H * length * D, 2 * (2 * B * H * D + 2 * B * length * K * D), 20,
                  kernel=DA.kernel(bf, D, H // K))
        del sets
    # K3 at qwen's fleet decode: one lane at length 1056, each call another
    # layer's strided view of the 48-layer stores (104 MB of K/V rows each);
    # the yardstick SDPA over each set's cache gathered beforehand
    H, K, D = 40, 8, 128
    qstores = [randn(P, FLEET_PAGE, 48 * K * D, dtype=bf).view(P, FLEET_PAGE, 48, K, D)
               for _ in range(2)]
    sets = [(randn(1, H, D, dtype=bf), qstores[0][:, :, i], qstores[1][:, :, i], table, lens)
            for i in range(48)]
    gathered = {id(s_[1]): (s_[1][table[0].long()].reshape(1, n * FLEET_PAGE, K, D)
                            .transpose(1, 2),
                            s_[2][table[0].long()].reshape(1, n * FLEET_PAGE, K, D)
                            .transpose(1, 2)) for s_ in sets}
    dense_row("paged qwen2.5-14b", f"paged_decode_attention bf16 B1 H{H} K{K} len{length} "
              f"D{D} page {FLEET_PAGE}, 48-layer strided pool (qwen2.5-14b's fleet decode)",
              lambda q, kp, vp, t, ln: PA.paged_decode_attention(q, kp, vp, t, ln), sets,
              lambda q, kp, vp, t, ln: ref.naive_paged_decode_attention(q, kp, vp, t, ln),
              lambda q, kp, vp, t, ln: F.scaled_dot_product_attention(
                  q[:, :, None], *gathered[id(kp)], enable_gqa=True),
              4 * H * length * D, 2 * (2 * H * D + 2 * length * K * D) + 4 * (n + 1), 20,
              kernel=DA.kernel(bf, D, H // K))
    del sets, gathered, qstores
    # minicpm3-4b (MLA): K1 at qk head dim 96 and its backward at the prefill's
    # and the training's shape (B4 H40 K40 S1024; the bound counts V and O at
    # their 64 columns, not the zero padding), the latent decode at the last
    # decode step (B4 H40 over 1056 latent rows of 288, the first 256 the
    # value), and one fleet lane through a 62-layer strided store: each call
    # another layer of one of two stores (74 MB of rows in all). SDPA's
    # yardstick of the decode takes q at 288, V the latent's first 256
    # columns and the scale passed in; for the paged one, over each set's
    # gathered cache
    def mrandn(*shape, dtype):
        return randn(*shape, dtype=dtype, g=mla_gen)
    B, H, S = 4, 40, 1024
    sets = [flash_inputs(B, H, H, S, C_DQK, bf, g=mla_gen) for _ in range(4)]
    vpad = {id(s_[2]): F.pad(s_[2], (0, C_DQK - C_DV)) for s_ in sets}
    pairs = S * S / 2
    dense_row("flash minicpm3-4b", f"flash_attention bf16 B{B} H{H} K{H} S{S} D{C_DQK} "
              f"Dv{C_DV} (minicpm3-4b's prefill)",
              lambda q, k, v: FA.flash_attention(q, k, v), sets,
              lambda q, k, v: ref.naive_attention(q, k, v),
              lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True),
              2 * B * H * pairs * (C_DQK + C_DV),
              2 * (2 * B * H * S * C_DQK + 2 * B * H * S * C_DV),
              kernel=FA.fwd_kernel(bf, C_DQK, 1), backend=True,
              lib_forms={f"V zero-padded to {C_DQK}": lambda q, k, v: (
                  F.scaled_dot_product_attention(q, k, vpad[id(v)], is_causal=True))})
    fam_bwd["minicpm3-4b"] = bwd_times(sets, B, H, H, S, C_DQK, mrandn, FA, ref, cuda_ms,
                                       label="minicpm3-4b's training shape", dv=C_DV)
    del sets, vpad
    length = Smax
    sets = [tuple(mrandn(B, n, LA.DK, dtype=bf) for n in (H, Smax)) for _ in range(8)]
    dense_row("latent minicpm3-4b", f"latent_decode_attention bf16 B{B} H{H} S{Smax} "
              f"len{length} Dk{LA.DK} Dv{LA.DV} (minicpm3-4b's last decode step)",
              lambda q, lat: LA.latent_decode_attention(q, lat, length, v_dim=LA.DV,
                                                        scale=C_SCALE), sets,
              lambda q, lat: ref.naive_latent_decode_attention(q, lat, length, v_dim=LA.DV,
                                                               scale=C_SCALE),
              lambda q, lat: F.scaled_dot_product_attention(
                  q[:, :, None], lat[:, None, :length], lat[:, None, :length, :LA.DV],
                  scale=C_SCALE, enable_gqa=True),
              2 * B * H * length * (LA.DK + LA.DV),
              2 * (B * length * LA.DK + B * H * LA.DK + B * H * LA.DV), 20,
              kernel="latent_mma_kernel", backend=True)
    del sets
    n = length // FLEET_PAGE
    P = n + 3
    lstores = [mrandn(P, FLEET_PAGE, 62 * LA.DK, dtype=bf).view(P, FLEET_PAGE, 62, LA.DK)
               for _ in range(2)]
    table = torch.randperm(P, generator=torch.Generator().manual_seed(P))[:n]
    table = table.view(1, n).to(torch.int32).to(dev)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    sets = [(mrandn(1, H, LA.DK, dtype=bf), lstores[i % 2][:, :, i // 2], table, lens)
            for i in range(124)]
    gathered = {id(s_[1]): s_[1][table[0].long()].reshape(1, 1, n * FLEET_PAGE, LA.DK)
                for s_ in sets}
    dense_row("paged latent minicpm3-4b", f"paged_latent_decode_attention bf16 B1 H{H} "
              f"len{length} Dk{LA.DK} Dv{LA.DV} page {FLEET_PAGE}, 62-layer strided pool "
              "(minicpm3-4b's fleet decode)",
              lambda q, pg, t, ln: LA.paged_latent_decode_attention(q, pg, t, ln, v_dim=LA.DV,
                                                                    scale=C_SCALE), sets,
              lambda q, pg, t, ln: ref.naive_paged_latent_decode_attention(
                  q, pg, t, ln, v_dim=LA.DV, scale=C_SCALE),
              lambda q, pg, t, ln: F.scaled_dot_product_attention(
                  q[:, :, None], gathered[id(pg)], gathered[id(pg)][..., :LA.DV],
                  scale=C_SCALE, enable_gqa=True),
              2 * H * length * (LA.DK + LA.DV),
              2 * (length * LA.DK + H * LA.DK + H * LA.DV) + 4 * (n + 1), 20,
              kernel="latent_mma_kernel", backend=True)
    del sets, gathered, lstores
    print(f"[kernels] the attention families' timings: {time.perf_counter() - t_dense:.1f} s",
          flush=True)

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
        us = {key: t for key, t in kernel_us(fn, glsets, iters=20, once=True).items()
              if "gla_" in key}
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
    # K4 with its chunk start states and K4b on them, the training path: each
    # set adds dy and the states (22 MB), so four of them still pass the L2;
    # K4b takes q and k as the rows the heads share, as GLAChunk does.
    # K4b's bytes are what its function needs: the q and k rows read and
    # their gradients written as the same shared rows in q's dtype, v and dy
    # read and dv written (bf16), lg read and dlg written (float32), the
    # states read; its operations: the causal pairs' five products, q.k and
    # dy.v (N + P) and dq, dk, dv (2N + P), and four state products a chunk
    # (S_z into dq, dS into dk and dv, the dS increment). The design's own
    # scratch (the dS states, each chunk's cum, the heads' q.dq and k.dk,
    # the head groups' dq and dk) is its traffic, not the function's
    g4s_ms = cuda_ms(lambda q, k, v, lg: GC.gla_chunk(q, k, v, lg, chunk=C, starts=True),
                     glsets)
    g4bsets = []
    for q, k, v, lg in glsets:
        st = GC.gla_chunk(q, k, v, lg, chunk=C, starts=True)[2]
        g4bsets.append((q[:, :, 0], k[:, :, 0], v, lg, randn(B, S, H, P, dtype=bf), st))
    g4b_ms = cuda_ms(lambda q, k, v, lg, dy, st: GC.gla_chunk_bwd(q, k, v, lg, dy, st,
                                                                  chunk=C), g4bsets)
    g4b_plain = cuda_ms(lambda q, k, v, lg, dy, st: ref.gla_bwd(q, k, v, lg, dy, st, chunk=C),
                        g4bsets, iters=2)
    g4b_bound, g4b_by = bound_ms(
        B * H * nc * (C * (C + 1) * (3 * N + 2 * P) + 8 * C * N * P),
        2 * qk_bytes + 3 * v_bytes + 2 * lg_bytes + st_bytes)
    ng = -(-H // GC.head_group(B, S, H, C))
    g4b_extra_mb = (st_bytes + 3 * 4 * B * H * S + 2 * 4 * ng * B * S * N) / 1e6
    # one call is the four kernels once each, in order: the kernel nodes of a
    # captured call (no tracer); their device times from the profiler, each
    # the mean over the calls it recorded (its tracer can drop records)
    graph_launches(f"gla_chunk_bwd bf16 B{B} S{S} H{H} N{N} P{P} chunk {C}, shared rows",
                   lambda: GC.gla_chunk_bwd(*g4bsets[0], chunk=C), GLA_BWD_KERNELS)
    iters = 20
    us, counts = kernel_us(
        lambda q, k, v, lg, dy, st: GC.gla_chunk_bwd(q, k, v, lg, dy, st, chunk=C), g4bsets,
        iters=iters, counts=True, once=True)
    us = {key: t for key, t in us.items() if "gla_" in key}
    g4b_us = {}
    for kname in GLA_BWD_KERNELS:
        hits = [key for key in us if kname + "<" in key]
        if len(hits) != 1 or len(us) != len(GLA_BWD_KERNELS):
            raise AssertionError(f"gla_chunk_bwd: the profiler saw GLA kernels {list(us)}")
        g4b_us[kname] = us[hits[0]]
    if any(counts[k] != iters for k in us):
        print(f"[kernels] gla_chunk_bwd: the profiler recorded {[counts[k] for k in us]} of "
              f"{iters} launches of each kernel (the tracer dropped the rest; each time "
              "below is the mean over the recorded ones)", flush=True)
    print(f"[kernels] GLA backward (K4b) bf16 B{B} S{S} H{H} N{N} P{P} chunk {C}, q/k the "
          f"rows the heads share ({card}): {g4b_ms * 1e3:.1f} us (profiler per call, each "
          f"kernel once: " + ", ".join(f"{n} {t:.1f} us" for n, t in g4b_us.items())
          + f"; sum {sum(g4b_us.values()):.1f} us), plain {g4b_plain * 1e3:.1f} us, bound "
          f"{g4b_bound * 1e3:.2f} us ({g4b_by}; the design's scratch, {g4b_extra_mb:.1f} MB "
          f"written and read, is not counted); K4 with the chunk start states "
          f"{g4s_ms * 1e3:.1f} us (without {k4_ms * 1e3:.1f} us); no PyTorch call computes "
          "GLA or its gradient", flush=True)
    del glsets, blsets, y_intra, g, d, g4bsets

    # K2 over hymba's 1024-slot ring at the serving decode's last step: each
    # set's K/V rings are 5.2 MB, 16 sets 84 MB; the yardstick is SDPA over
    # each set's window gathered beforehand (no PyTorch call takes a ring)
    B, H, K, D, W, pos = 4, 25, 5, 64, 1024, 1567
    rsets = [(randn(B, H, D, dtype=bf), randn(B, W, K, D, dtype=bf),
              randn(B, W, K, D, dtype=bf)) for _ in range(16)]
    graph_launches(f"decode_attention_ring bf16 B{B} H{H} K{K} D{D} ring {W} (hymba-1.5b)",
                   lambda: DA.ring_decode_attention(*rsets[0], pos, window=W),
                   (DA.kernel(bf, D, H // K),))
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

    # the decode kernels: one call is one kernel node of a captured CUDA
    # graph, the route's kernel (the last block of a row and KV head
    # combines); beside the CUDA-graph times above, the profiler's device
    # time per call (the mean over the launches its tracer recorded)
    for name, fn, sets in (
            ("decode_attention", lambda q, k, v: DA.decode_attention(q, k, v, length), dsets),
            ("paged_decode_attention",
             lambda q, kp, vp, t, ln: PA.paged_decode_attention(q, kp, vp, t, ln), psets)):
        graph_launches(f"{name} bf16 B{sets[0][0].shape[0]} H32 K8 D64 (granite-3-2b)",
                       lambda: fn(*sets[0]), (DA.kernel(bf, 64, 4),))
        us = kernel_us(fn, sets, once=True)
        print(f"[kernels] {name} profiler device time per call: "
              + (", ".join(f"{t:.2f} us ({k[:72]})" for k, t in us.items()) or
                 "no record (the tracer dropped them)"), flush=True)
    del fsets, dsets, psets, gsets, stores

    # the sLSTM recurrence at xlstm-350m's shapes, then its training forward
    # and backward
    sl_rows = slstm_rows(card, dev)
    sl_train = slstm_bwd_rows(card, dev)

    t_mark = phase_time("kernels", t_mark)

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

    t_mark = phase_time("serve", t_mark)

    # -- ckpt. snapshot mid-decode, restore under another flavor --------------
    ckpt_phase(cfg, params, prompts, 16, card, dev, DA, FA)
    t_mark = phase_time("ckpt", t_mark)

    # -- 5. the continuous-batching fleet on a device page pool -----------------
    all_prompts = FLEET_PROMPTS + (FLEET_LATE,)
    fleet_prompts = [np.random.default_rng(1).integers(0, cfg.vocab_size, n)
                     for n in all_prompts]
    max_len = max(all_prompts) + FLEET_NEW

    eng, sids, fleet_launches, secs = run_fleet(cfg, params, fleet_prompts, max_len)
    base = {s: eng.stream(s) for s in sids}
    n_tok = sum(len(eng.stream(s)) for s in sids)
    fleet_ticks = eng.tick
    print(f"[fleet] granite-3-2b bf16, {cfg.n_layers} layers; {len(sids)} sessions, "
          f"prompts {list(all_prompts)}, {FLEET_NEW} new tokens each; pool "
          f"{FLEET_PAGES} pages x {FLEET_PAGE}, {FLEET_LANES} lanes: {n_tok} tokens in "
          f"{secs:.2f} s: {n_tok / secs:.1f} tok/s, {secs / fleet_ticks * 1e3:.1f} ms/tick "
          f"over {fleet_ticks} ticks; card {card}", flush=True)
    check_fleet(eng, sids, fleet_launches, "bf16", cfg, fleet_prompts)
    srv = Server(cfg, params=params, device="cuda")
    firsts = [(server_stream(srv, p, 1, dev)[0], eng.stream(s)[0])
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
    # (at GRANITE_F32_FLEET_LAYERS of its 40 layers: the float32 kernels at
    # these shapes are held one by one in phase 3)
    cfg32 = dataclasses.replace(cfg, n_layers=GRANITE_F32_FLEET_LAYERS, param_dtype="float32",
                                compute_dtype="float32", cache_dtype="float32")
    p32 = tree_map(lambda t: t.float(), cut_layers(params, GRANITE_F32_FLEET_LAYERS))
    eng, sids, got32, secs32 = run_fleet(cfg32, p32, fleet_prompts, max_len)
    check_fleet(eng, sids, got32, "float32", cfg32, fleet_prompts)
    srv = Server(cfg32, params=p32, device="cuda")
    same = [server_stream(srv, p, FLEET_NEW, dev) == eng.stream(s)
            for p, s in zip(fleet_prompts, sids)]
    print(f"[fleet] float32, {cfg32.n_layers} layers: {sum(same)}/{len(same)} streams "
          f"equal the float32 Server's B=1 greedy streams exactly ({secs32:.2f} s)",
          flush=True)
    if not all(same):
        raise AssertionError(f"float32 fleet streams differ from the Server's: {same}")
    del eng, srv, p32
    torch.cuda.empty_cache()

    t_mark = phase_time("fleet", t_mark)

    # -- recover. the supervised recovery plane on phase 5's fleet -------------
    recover_phase(cfg, params, fleet_prompts, max_len, base, prompts, stream, card, dev,
                  FA, DA, PA)
    del params
    torch.cuda.empty_cache()
    t_mark = phase_time("recover", t_mark)

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
    t_mark = phase_time("hymba", t_mark)

    # -- minicpm. full-width minicpm-2b Server -----------------------------------
    m_serve = dense_serve_phase("minicpm-2b", card, dev, 3)[1]
    t_mark = phase_time("minicpm", t_mark)

    # -- qwen. full-width qwen2.5-14b Server, then its fleet ------------------------
    qparams, q_serve = dense_serve_phase("qwen2.5-14b", card, dev, 5,
                                         f32_layers=QWEN_F32_LAYERS, keep=True)
    t_mark = phase_time("qwen", t_mark)
    q_fleet = fleet_phase(get_config("qwen2.5-14b"), qparams, card, dev, QWEN_F32_LAYERS, 4)
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    t_mark = phase_time("qwen_fleet", t_mark)

    # -- llava. full-width llava-next-34b Server, nothing else on the card ----------
    l_serve = dense_serve_phase("llava-next-34b", card, dev, 6, f32_layers=LLAVA_F32_LAYERS)[1]
    t_mark = phase_time("llava", t_mark)

    # -- moe. full-depth granite-moe-3b-a800m Server --------------------------------
    e_serve = dense_serve_phase("granite-moe-3b-a800m", card, dev, 7)[1]
    t_mark = phase_time("moe", t_mark)

    # -- minicpm3. full-width minicpm3-4b (MLA) Server, then its fleet ---------------
    cparams, c_serve = dense_serve_phase("minicpm3-4b", card, dev, 8, keep=True, ties=True)
    t_mark = phase_time("minicpm3", t_mark)
    c_fleet = fleet_phase(get_config("minicpm3-4b"), cparams, card, dev,
                          MINICPM3_F32_FLEET_LAYERS, 9)
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    t_mark = phase_time("minicpm3_fleet", t_mark)

    # -- xlstm. full-width xlstm-350m Server, then its fleet ------------------------
    xparams, x_serve = xlstm_phase(card, dev)
    t_mark = phase_time("xlstm", t_mark)
    xcfg = get_config("xlstm-350m")
    x_fleet = fleet_phase(xcfg, xparams, card, dev, XLSTM_F32_FLEET_LAYERS, 11, idle=True)
    del xparams
    gc.collect()
    torch.cuda.empty_cache()
    t_mark = phase_time("xlstm_fleet", t_mark)

    # -- train. full-width granite-3-2b through the port's Trainer -------------
    # (last before the CLI: the Trainer turns on deterministic algorithms for
    # the process)
    train_launches = train_phase(card, dev)
    t_mark = phase_time("train", t_mark)

    # -- train_hymba. full-width hymba-1.5b through the port's Trainer -----------
    hymba_launches = train_phase(card, dev, "hymba-1.5b")
    t_mark = phase_time("train_hymba", t_mark)

    # -- train_minicpm, train_qwen. the dense families through the Trainer ---------
    # (minicpm-2b at MINICPM_TRAIN_LAYERS, qwen2.5-14b at QWEN_TRAIN_LAYERS; no
    # C/R part)
    m_train = train_phase(card, dev, "minicpm-2b", n_layers=MINICPM_TRAIN_LAYERS, cr=False)
    t_mark = phase_time("train_minicpm", t_mark)
    q_train = train_phase(card, dev, "qwen2.5-14b", n_layers=QWEN_TRAIN_LAYERS, cr=False)
    t_mark = phase_time("train_qwen", t_mark)

    # -- train_llava, train_moe. llava-next-34b at LLAVA_TRAIN_LAYERS (its batches
    # carry the patch embeddings), granite-moe-3b-a800m at full depth --------------
    l_train = train_phase(card, dev, "llava-next-34b", n_layers=LLAVA_TRAIN_LAYERS, cr=False)
    t_mark = phase_time("train_llava", t_mark)
    e_train = train_phase(card, dev, "granite-moe-3b-a800m", cr=False)
    t_mark = phase_time("train_moe", t_mark)

    # -- train_minicpm3. minicpm3-4b (MLA) at MINICPM3_TRAIN_LAYERS --------------
    c_train = train_phase(card, dev, "minicpm3-4b", n_layers=MINICPM3_TRAIN_LAYERS, cr=False)
    t_mark = phase_time("train_minicpm3", t_mark)

    # -- train_xlstm. full-width xlstm-350m through the port's Trainer -----------
    x_train = train_phase(card, dev, "xlstm-350m")
    t_mark = phase_time("train_xlstm", t_mark)

    # -- 7. the CLI: its smoke-size runs in parallel, six at a time (each its
    # own process on the card and its own checkpoint directory)
    env = dict(os.environ, PYTHONPATH=str(SRC))

    def run_cli(args):
        return subprocess.run([sys.executable, "-m", *args], env=env, capture_output=True,
                              text=True, timeout=300, cwd=ROOT)
    serve_extras = ([], ["--arch", "hymba-1.5b"],
                    ["--arch", "hymba-1.5b", "--gla-schedule", "parallel"],
                    ["--arch", "minicpm-2b"], ["--arch", "qwen2.5-14b"],
                    ["--arch", "llava-next-34b"], ["--arch", "granite-moe-3b-a800m"],
                    ["--arch", "xlstm-350m"], ["--arch", "xlstm-350m", "--fleet"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli") as ck, \
            ThreadPoolExecutor(max_workers=6) as pool:
        trains = {arch: pool.submit(run_cli, [
            "repro_torch.launch.train", *([] if arch == "granite-3-2b" else ["--arch", arch]),
            "--device", "cuda", "--steps", "8", "--ckpt-every", "4", "--kill-rank-at", "6",
            "--restart-backend", "exampi", "--batch-size", "2", "--seq-len", "64",
            "--ckpt-dir", os.path.join(ck, arch)])
            for arch in ("granite-3-2b", "hymba-1.5b", "minicpm-2b", "qwen2.5-14b",
                         "xlstm-350m")}
        serves = [(extra, pool.submit(run_cli, [
            "repro_torch.launch.serve", "--device", "cuda", "--batch", "2", "--prompt-len",
            "16", "--gen", "8", *extra])) for extra in serve_extras]
        for arch, fut in trains.items():
            cli = fut.result()
            lines = [ln for ln in cli.stdout.splitlines() if ln.startswith(("!!", "done:"))]
            print(f"[cli] train --arch {arch} --device cuda --kill-rank-at 6 --restart-backend "
                  f"exampi: rc {cli.returncode}: {' | '.join(lines)}", flush=True)
            if cli.returncode != 0 or not any(ln.startswith("!! recovered from step_00000004")
                                              for ln in lines) \
                    or not any(ln.startswith("done: loss ") for ln in lines):
                raise AssertionError(f"{arch} train CLI failed:\n{cli.stdout}\n{cli.stderr}")
        for extra, fut in serves:
            cli = fut.result()
            print(f"[cli] {' '.join(extra) or 'granite-3-2b'}: rc {cli.returncode}: "
                  f"{cli.stdout.strip()}", flush=True)
            if cli.returncode != 0:
                raise AssertionError(f"CLI failed:\n{cli.stderr}")
    t_mark = phase_time("cli", t_mark)

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
        {"name": "gla_chunk_bwd", "route": "cuda", "source": src + "gla_chunk.cu",
         "replaces": "none: the port's own kernel (the reference differentiates "
                     "src/repro/models/ssm.py:24 chunked_gla)",
         "launches": hymba_launches["gla_chunk_bwd"],
         "max_abs_err": errs["gla_chunk_bwd"][G_MAIN + ", shared rows"],
         "ms": g4b_ms, "plain_ms": g4b_plain, "bound_ms": g4b_bound, "bound_by": g4b_by,
         "library_ms": None,
         "library_note": "no PyTorch call computes GLA or its gradient",
         "parts_us": g4b_us},
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
    # the dense families' shapes: head dim 128 (qwen2.5-14b) and G = 1
    # (minicpm-2b), the same kernels' other instantiations
    for name, shape, file, site, launches_, lab, t in (
            ("flash_attention_d128", "qwen2.5-14b prefill B4 H40 K8 S1024 D128",
             "flash_attention.cu", "flash_attention.py:45", q_serve["flash_attention"],
             Q_F_MAIN, dense["flash qwen2.5-14b"]),
            ("flash_attention_g1", "minicpm-2b prefill B4 H36 K36 S1024 D64",
             "flash_attention.cu", "flash_attention.py:45", m_serve["flash_attention"],
             M_F_MAIN, dense["flash minicpm-2b"]),
            ("decode_attention_d128", "qwen2.5-14b decode B4 H40 K8 length 1056 D128",
             "decode_attention.cu", "decode_attention.py:61", q_serve["decode_attention"],
             Q_D_MAIN, dense["decode qwen2.5-14b"]),
            ("decode_attention_g1", "minicpm-2b decode B4 H36 K36 length 1056 D64",
             "decode_attention.cu", "decode_attention.py:61", m_serve["decode_attention"],
             M_D_MAIN, dense["decode minicpm-2b"]),
            ("paged_decode_attention_d128", "qwen2.5-14b fleet decode B1 H40 K8 length "
             "1056 D128, 48-layer strided pool", "paged_decode_attention.cu",
             "decode_attention.py:137", q_fleet["paged_decode_attention"], Q_P_MAIN,
             dense["paged qwen2.5-14b"])):
        record["kernels"].append(
            {"name": name, "shape": shape, "route": "cuda", "source": src + file,
             "replaces": "src/repro/kernels/" + site, "launches": launches_,
             "max_abs_err": errs[name.rsplit("_", 1)[0]][lab], "ms": t[0], "plain_ms": t[1],
             "bound_ms": t[2], "bound_by": t[3], "library_ms": t[4]})
    bwd_site = ("none: the port's own kernel (the reference differentiates "
                "src/repro/models/layers.py:91 chunked_attention)")
    for name in BWD_PARTS:
        record["kernels"].append(
            {"name": name + "_d128", "shape": "qwen2.5-14b training B4 H40 K8 S1024 D128",
             "route": "cuda", "source": src + "flash_attention_bwd.cu", "replaces": bwd_site,
             "launches": q_train[name], "max_abs_err": errs[name][Q_F_MAIN],
             "ms": qbwd[name][0], "plain_ms": qbwd[name][1], "bound_ms": qbwd[name][2],
             "bound_by": qbwd[name][3], "library_ms": None,
             "library_note": "no PyTorch call computes this part alone; SDPA's whole "
                             "backward is library_ms of flash_attention_bwd_d128"})
    record["kernels"].append(
        {"name": "flash_attention_bwd_d128", "shape": "qwen2.5-14b training B4 H40 K8 S1024 D128",
         "route": "cuda", "source": src + "flash_attention_bwd.cu", "replaces": bwd_site,
         "launches": q_train["flash_attention_bwd_dkdv"],
         "max_abs_err": max(errs[name][Q_F_MAIN] for name in BWD_PARTS),
         "ms": qbwd["whole"][0], "plain_ms": qbwd["whole"][1], "bound_ms": qbwd["whole"][2],
         "bound_by": qbwd["whole"][3], "library_ms": qbwd["whole"][4]})
    # the new families' shapes: G = 7 at head dim 128 (llava-next-34b) and G = 3
    # at head dim 64 (granite-moe-3b-a800m)
    for g, arch, sh, serve, train, f_lab, d_lab in (
            ("g7", "llava-next-34b", "B4 H56 K8", l_serve, l_train, L_F_MAIN, L_D_MAIN),
            ("g3", "granite-moe-3b-a800m", "B4 H24 K8", e_serve, e_train, E_F_MAIN,
             E_D_MAIN)):
        D = 128 if g == "g7" else 64
        fb = fam_bwd[arch]
        for name, shape, file, site, launches_, lab, t in (
                (f"flash_attention_{g}", f"{arch} prefill {sh} S1024 D{D}", "flash_attention.cu",
                 "flash_attention.py:45", serve["flash_attention"], f_lab, dense[f"flash {arch}"]),
                (f"decode_attention_{g}", f"{arch} decode {sh} length 1056 D{D}",
                 "decode_attention.cu", "decode_attention.py:61", serve["decode_attention"],
                 d_lab, dense[f"decode {arch}"])):
            record["kernels"].append(
                {"name": name, "shape": shape, "route": "cuda", "source": src + file,
                 "replaces": "src/repro/kernels/" + site, "launches": launches_,
                 "max_abs_err": errs[name.rsplit("_", 1)[0]][lab], "ms": t[0],
                 "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3], "library_ms": t[4]})
        for name in BWD_PARTS:
            record["kernels"].append(
                {"name": f"{name}_{g}", "shape": f"{arch} training {sh} S1024 D{D}",
                 "route": "cuda", "source": src + "flash_attention_bwd.cu", "replaces": bwd_site,
                 "launches": train[name], "max_abs_err": errs[name][f_lab],
                 "ms": fb[name][0], "plain_ms": fb[name][1], "bound_ms": fb[name][2],
                 "bound_by": fb[name][3], "library_ms": None,
                 "library_note": "no PyTorch call computes this part alone; SDPA's whole "
                                 f"backward is library_ms of flash_attention_bwd_{g}"})
        record["kernels"].append(
            {"name": f"flash_attention_bwd_{g}", "shape": f"{arch} training {sh} S1024 D{D}",
             "route": "cuda", "source": src + "flash_attention_bwd.cu", "replaces": bwd_site,
             "launches": train["flash_attention_bwd_dkdv"],
             "max_abs_err": max(errs[name][f_lab] for name in BWD_PARTS),
             "ms": fb["whole"][0], "plain_ms": fb["whole"][1], "bound_ms": fb["whole"][2],
             "bound_by": fb["whole"][3], "library_ms": fb["whole"][4]})
    # minicpm3-4b (MLA): K1 and its backward at qk head dim 96, the latent
    # decode and its paged form through the fleet's page table
    cb = fam_bwd["minicpm3-4b"]
    latent_note = "q at 288, V the latent's first 256 columns, the scale passed in"
    for name, shape, file, site, launches_, err_key, lab, t, note in (
            ("flash_attention_d96", "minicpm3-4b prefill B4 H40 K40 S1024 D96, V at its 64 "
             "columns", "flash_attention.cu", "flash_attention.py:45",
             c_serve["flash_attention"], "flash_attention", C_F_MAIN,
             dense["flash minicpm3-4b"],
             f"SDPA ({backends.get('flash minicpm3-4b')} backend), the faster of V at 64 and "
             "V zero-padded to 96"),
            ("latent_decode_attention", "minicpm3-4b decode B4 H40 length 1056, one latent "
             "head Dk 288 Dv 256", "latent_decode_attention.cu", "decode_attention.py:61",
             c_serve["latent_decode_attention"], "latent_decode_attention", C_D_MAIN,
             dense["latent minicpm3-4b"],
             f"SDPA ({backends.get('latent minicpm3-4b')} backend), {latent_note}"),
            ("paged_latent_decode_attention", "minicpm3-4b fleet decode B1 H40 length 1056, "
             "62-layer strided pool", "latent_decode_attention.cu", "decode_attention.py:137",
             c_fleet["paged_latent_decode_attention"], "paged_latent_decode_attention",
             C_P_MAIN, dense["paged latent minicpm3-4b"],
             f"SDPA ({backends.get('paged latent minicpm3-4b')} backend), {latent_note}")):
        row = {"name": name, "shape": shape, "route": "cuda", "source": src + file,
               "replaces": "src/repro/kernels/" + site, "launches": launches_,
               "max_abs_err": errs[err_key][lab], "ms": t[0], "plain_ms": t[1],
               "bound_ms": t[2], "bound_by": t[3], "library_ms": t[4], "library_note": note}
        record["kernels"].append(row)
    for name in BWD_PARTS:
        record["kernels"].append(
            {"name": name + "_d96", "shape": "minicpm3-4b training B4 H40 K40 S1024 D96 Dv64",
             "route": "cuda", "source": src + "flash_attention_bwd.cu", "replaces": bwd_site,
             "launches": c_train[name], "max_abs_err": errs[name][C_F_MAIN],
             "ms": cb[name][0], "plain_ms": cb[name][1], "bound_ms": cb[name][2],
             "bound_by": cb[name][3], "library_ms": None,
             "library_note": "no PyTorch call computes this part alone; SDPA's whole "
                             "backward is library_ms of flash_attention_bwd_d96"})
    record["kernels"].append(
        {"name": "flash_attention_bwd_d96", "shape": "minicpm3-4b training B4 H40 K40 S1024 D96 Dv64",
         "route": "cuda", "source": src + "flash_attention_bwd.cu", "replaces": bwd_site,
         "launches": c_train["flash_attention_bwd_dkdv"],
         "max_abs_err": max(errs[name][C_F_MAIN] for name in BWD_PARTS),
         "ms": cb["whole"][0], "plain_ms": cb["whole"][1], "bound_ms": cb["whole"][2],
         "bound_by": cb["whole"][3], "library_ms": cb["whole"][4]})
    # xlstm-350m: the sLSTM recurrence at its prefill, its decode step and a
    # fleet lane's token; launches from the xlstm and xlstm_fleet phases
    for (B, S), shape, launches_ in (
            ((4, 1024), "xlstm-350m prefill B4 S1024 H4 dh256", x_serve["prefill"]),
            ((4, 1), "xlstm-350m decode step B4 S1 H4 dh256", x_serve["decode"]),
            ((1, 1), "xlstm-350m fleet lane B1 S1 H4 dh256", x_fleet["slstm_scan"])):
        record["kernels"].append(
            {"name": f"slstm_scan_b{B}_s{S}", "shape": shape, "route": "cuda",
             "source": src + "slstm_scan.cu",
             "replaces": "none: the port's own kernel (the reference runs "
                         "src/repro/models/xlstm.py:145 run_scan as a jax.lax.scan)",
             "launches": launches_, **sl_rows[(B, S)], "library_ms": None,
             "library_note": "no PyTorch call computes the sLSTM recurrence"})
    # its training kernels at the training shape; launches from train_xlstm's
    # ten timed steps
    for name, key, file, launches_, replaces in (
            ("slstm_scan_train", "slt", "slstm_scan.cu", x_train["slstm_scan_train"],
             "none: the port's own kernel (the reference runs src/repro/models/xlstm.py:145 "
             "run_scan as a jax.lax.scan)"),
            ("slstm_scan_bwd", "slb", "slstm_scan_bwd.cu", x_train["slstm_scan_bwd"],
             "none: the port's own kernel (the reference differentiates "
             "src/repro/models/xlstm.py:145 run_scan's jax.lax.scan)")):
        record["kernels"].append(
            {"name": name, "shape": "xlstm-350m training B4 S1024 H4 dh256", "route": "cuda",
             "source": src + file, "replaces": replaces, "launches": launches_,
             **sl_train[key], "library_ms": None,
             "library_note": "no PyTorch call computes the sLSTM recurrence or its gradient"})
    print(f"[time] chip_smoke.py total {time.perf_counter() - t_start:.1f} s ({card})",
          flush=True)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
