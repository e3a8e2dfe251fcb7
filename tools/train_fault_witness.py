#!/usr/bin/env python3
"""Would the train phases' step-1 holds catch a wrong backward kernel?

    python3 tools/train_fault_witness.py                      # K1's, granite
    python3 tools/train_fault_witness.py --arch qwen2.5-14b   # K1's at head dim 128
    python3 tools/train_fault_witness.py --arch hymba-1.5b    # the GLA's, hymba

Computes ``chip_smoke.py``'s train-phase step 1 (full-width granite-3-2b,
bf16, seed 0, the pipeline's first batch of 4 x 1024 tokens, the
deterministic mode the ``Trainer`` sets; with ``--arch qwen2.5-14b`` the
train_qwen phase's step 1: qwen2.5-14b's widths at ``chip_smoke.py``'s cut
depth ``QWEN_TRAIN_LAYERS``, head dim 128, G = 5) on the plain attention path, on
the kernel path, and on the kernel path with a fault planted at run time
through the backward's entry point ``flash_attention_bwd`` (no source is
edited):

- ``no_delta``: the row sums D = rowsum(dO * O) zero for both kernels (the
  dQ launch computes them from an O of zeros and hands them to dK/dV), so
  dS = P * dP (the D term dropped);
- ``no_gqa_sum``: dK and dV from the first query head of each KV head's
  group alone (the other G - 1 terms of the sum dropped).

For each it prints the three readings ``chip_smoke.py`` holds step 1 to
(loss and grad_norm relative to the plain path's, and each leaf's
||a - b|| / ||b||) beside that script's tolerances, and whether the hold
would pass.

``--arch hymba-1.5b`` runs the train_hymba phase's step 1 (full-width
hymba-1.5b, bf16 params, seed 0, the pipeline's first batch of 4 x 1536)
through ``chip_smoke.hymba_step1_hold`` (the float64 yardstick and the
float32 paths, so the faults act on the float32 kernel's output; the
bf16 kernel is held in ``chip_smoke.py``'s phase 3) clean and with two
faults planted at run time through the GLA backward's entry point
``gla_chunk_bwd``:

- ``no_dlg``: dlg zeroed (a_log's gradient comes only through it, dt's
  partly);
- ``no_carry``: dS not carried across chunks (each chunk's backward
  called alone, so the later chunks' state gradient never reaches its dk
  and dv; dlg's suffix sums still run across the chunks).

The SSD mixer hands ``gla_chunk_bwd`` C_t and B_t as the [B,S,N] rows the
heads share, so dq and dk come back as such rows (the heads' sum; the
float32 route adds its per-head rows in head order) and the faults keep
that shape: ``no_carry`` cuts q, k, v, lg and dy along the positions and
joins each chunk's rows again.

Needs one CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def hymba() -> int:
    """The GLA backward's faults against the train_hymba phase's step-1
    hold."""
    import torch
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.data import synth_batch
    from repro_torch.kernels import gla_chunk as GC
    from repro_torch.launch.train import set_deterministic
    from repro_torch.models import Model

    dev = torch.device("cuda")
    set_deterministic(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.card_line(), flush=True)
    cfg = get_config("hymba-1.5b")
    state = types.SimpleNamespace(params=Model(cfg).init(0, dev))
    host = synth_batch(cfg, CS.HYMBA_B, CS.HYMBA_S, 1, 0)
    batch = {k: torch.from_numpy(host[k]).to(dev, torch.int64) for k in ("tokens", "targets")}

    def names(tree, path=""):
        if isinstance(tree, dict):
            return [n for k in sorted(tree) for n in names(tree[k], f"{path}/{k}")]
        if isinstance(tree, list):
            return [n for i, t in enumerate(tree) for n in names(t, f"{path}/{i}")]
        return [path[1:]]

    def rel_norm(a, b):
        return (torch.linalg.vector_norm(a.float() - b.float())
                / torch.linalg.vector_norm(b.float())).item()

    real_bwd = GC.gla_chunk_bwd

    def no_dlg(q, k, v, lg, dy, starts, *, chunk):
        dq, dk, dv, dlg = real_bwd(q, k, v, lg, dy, starts, chunk=chunk)
        return dq, dk, dv, torch.zeros_like(dlg)

    def no_carry(q, k, v, lg, dy, starts, *, chunk):
        c = GC.chunk_len(q.shape[1], chunk)
        parts = [real_bwd(*(x[:, z * c:(z + 1) * c] for x in (q, k, v, lg, dy)),
                          starts[:, :, z:z + 1].contiguous(), chunk=c)
                 for z in range(q.shape[1] // c)]
        dlg, carry = [], 0
        for p in reversed(parts):    # the later chunks' sums, as the kernel carries them
            dlg.insert(0, p[3] + carry)
            carry = carry + p[3][:, :1]
        return (*(torch.cat([p[i] for p in parts], dim=1) for i in range(3)),
                torch.cat(dlg, dim=1))

    leaf = names(state.params)
    for name, fault in (("clean", None), ("no_dlg", no_dlg), ("no_carry", no_carry)):
        if fault is not None:
            GC.gla_chunk_bwd = fault
        try:
            ok = CS.hymba_step1_hold(cfg, state, batch, leaf, rel_norm)[0]
        finally:
            GC.gla_chunk_bwd = real_bwd
        print(f"[witness] hymba {name}: the hold {'passes' if ok else 'fails'}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=["granite-3-2b", "qwen2.5-14b", "hymba-1.5b"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_fault_witness: no CUDA device", file=sys.stderr)
        return 1
    if args.arch == "hymba-1.5b":
        return hymba()
    import chip_smoke as CS
    from repro_torch import steps as ST
    from repro_torch.configs import get_config
    from repro_torch.data import synth_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import set_deterministic
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import global_norm

    dev = torch.device("cuda")
    set_deterministic(dev)
    print(CS.card_line(), flush=True)
    cfg = get_config(args.arch)
    if args.arch == "qwen2.5-14b":
        cfg = dataclasses.replace(cfg, n_layers=CS.QWEN_TRAIN_LAYERS)
    print(f"[witness] {args.arch}, {cfg.n_layers} layers, head dim {cfg.resolved_head_dim}, "
          f"G {cfg.n_heads // cfg.n_kv_heads}", flush=True)
    model = Model(cfg)
    params = model.init(0, dev)
    host = synth_batch(cfg, CS.TRAIN_B, CS.TRAIN_S, 1, 0)
    batch = {k: torch.from_numpy(host[k]).to(dev, torch.int64) for k in ("tokens", "targets")}

    def names(tree, path=""):
        if isinstance(tree, dict):
            return [n for k in sorted(tree) for n in names(tree[k], f"{path}/{k}")]
        if isinstance(tree, list):
            return [n for i, t in enumerate(tree) for n in names(t, f"{path}/{i}")]
        return [path[1:]]

    leaf = names(params)
    g_p, _, loss_p, _ = ST.loss_and_grads(Model(cfg, force="ref"), params, batch)
    loss_p, gn_p = loss_p.item(), global_norm(g_p).item()

    real_bwd = FA.flash_attention_bwd

    def no_delta(q, k, v, o, lse, do, *, window=None):
        # o enters the backward only through its row sums
        return real_bwd(q, k, v, torch.zeros_like(o), lse, do, window=window)

    def no_gqa_sum(q, k, v, o, lse, do, *, window=None):
        dq = real_bwd(q, k, v, o, lse, do, window=window)[0]
        G = q.shape[1] // k.shape[1]
        q1, o1, lse1, do1 = (x[:, ::G].contiguous() for x in (q, o, lse, do))
        _, dk, dv = real_bwd(q1, k, v, o1, lse1, do1, window=window)
        return dq, dk, dv

    for name, fault in (("clean", None), ("no_delta", no_delta), ("no_gqa_sum", no_gqa_sum)):
        if fault is not None:
            FA.flash_attention_bwd = fault
        try:
            g_k, _, loss_k, _ = ST.loss_and_grads(model, params, batch)
        finally:
            FA.flash_attention_bwd = real_bwd
        gn_k = global_norm(g_k).item()
        errs = [(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float())).item()
                for a, b in zip(tree_leaves(g_k), tree_leaves(g_p))]
        del g_k
        r_loss = abs(loss_k.item() - loss_p) / abs(loss_p)
        r_gn = abs(gn_k - gn_p) / gn_p
        worst = max(range(len(errs)), key=errs.__getitem__)
        held = (r_loss <= CS.TRAIN_LOSS_TOL, r_gn <= CS.TRAIN_GNORM_TOL,
                max(errs) <= CS.TRAIN_GRAD_TOL)
        print(f"[witness] {name}: loss rel {r_loss:.3e} (tol {CS.TRAIN_LOSS_TOL:g}, "
              f"{'held' if held[0] else 'caught'}); grad_norm {gn_k:.6f} vs {gn_p:.6f} rel "
              f"{r_gn:.3e} (tol {CS.TRAIN_GNORM_TOL:g}, {'held' if held[1] else 'caught'}); "
              f"per-leaf max {max(errs):.3e} at {leaf[worst]}, median "
              f"{statistics.median(errs):.3e}, {sum(e > CS.TRAIN_GRAD_TOL for e in errs)} of "
              f"{len(errs)} leaves over tol {CS.TRAIN_GRAD_TOL:g} "
              f"({'held' if held[2] else 'caught'}); the hold "
              f"{'passes' if all(held) else 'fails'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
