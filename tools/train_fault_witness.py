#!/usr/bin/env python3
"""Would the train phase's step-1 hold catch a wrong K1 backward?

    python3 tools/train_fault_witness.py

Computes ``chip_smoke.py``'s train-phase step 1 (full-width granite-3-2b,
bf16, seed 0, the pipeline's first batch of 4 x 1024 tokens, the
deterministic mode the ``Trainer`` sets) on the plain attention path, on
the kernel path, and on the kernel path with a fault planted at run time
in the backward's Python wrappers (no source is edited):

- ``no_delta``: the preprocess's row sums D = rowsum(dO * O) replaced by
  zeros, so dS = P * dP (the D term dropped);
- ``no_gqa_sum``: dK and dV from the first query head of each KV head's
  group alone (the other G - 1 terms of the sum dropped).

For each it prints the three readings ``chip_smoke.py`` holds step 1 to
(loss and grad_norm relative to the plain path's, and each leaf's
||a - b|| / ||b||) beside that script's tolerances, and whether the hold
would pass. Needs one CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_fault_witness: no CUDA device", file=sys.stderr)
        return 1
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
    cfg = get_config("granite-3-2b")
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

    real_delta, real_bwd = FA.bwd_delta, FA.flash_attention_bwd

    def no_delta(o, do):
        return torch.zeros_like(real_delta(o, do))

    def no_gqa_sum(q, k, v, o, lse, do, *, window=None):
        dq = real_bwd(q, k, v, o, lse, do, window=window)[0]
        G = q.shape[1] // k.shape[1]
        q1, o1, lse1, do1 = (x[:, ::G].contiguous() for x in (q, o, lse, do))
        _, dk, dv = real_bwd(q1, k, v, o1, lse1, do1, window=window)
        return dq, dk, dv

    for name, patch in (("clean", {}), ("no_delta", {"bwd_delta": no_delta}),
                        ("no_gqa_sum", {"flash_attention_bwd": no_gqa_sum})):
        for attr, fn in patch.items():
            setattr(FA, attr, fn)
        try:
            g_k, _, loss_k, _ = ST.loss_and_grads(model, params, batch)
        finally:
            FA.bwd_delta, FA.flash_attention_bwd = real_delta, real_bwd
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
