#!/usr/bin/env python3
"""How far hymba-1.5b's training numbers can agree in float32 and bf16.

    python3 tools/hymba_precision.py step1        # one CUDA device
    PYTHONPATH=src python3 tools/hymba_precision.py trajectory [--lr 3e-3]

``step1``: full-width hymba-1.5b (seed 0, the pipeline's first batch of
4 x 1536, deterministic mode), step 1's gradient on the plain path in
float64 (the yardstick), then each leaf's ||a - f64|| / ||f64|| for the
float32 plain path, the float32 kernel path, the float32 path with K1's
kernels and the plain GLA, and with the GLA kernels and the plain
attention, and the bf16 plain and kernel paths: the noise floor that
``chip_smoke.py``'s train_hymba hold is built on. Imports nothing of JAX.

``trajectory``: on the CPU, hymba's smoke config at batch 2 x 48, ten
steps from the same params of the JAX package's Trainer in float32 and in
float64 (``jax_enable_x64``, with the reference's model modules computing
in float64 where they name float32; the learning-rate schedule stays
float32 in both packages) and of the port's Trainer in float32 and in
float64 (the JAX package needed): each step's loss and grad_norm relative
to the port's float64 run. The JAX float64 run is a witness independent of
the port: where it stays next to the port's float64 run while both float32
runs leave it, the float32 trajectories part by rounding, not by a
difference between the packages.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _names(tree, path=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree) for n in _names(t, f"{path}/{i}")]
    return [path[1:]]


def step1() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hymba_precision step1: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import steps as ST
    from repro_torch.configs import get_config
    from repro_torch.data import synth_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import set_deterministic
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves, tree_map

    dev = torch.device("cuda")
    set_deterministic(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b")
    params = Model(cfg).init(0, dev)
    host = synth_batch(cfg, 4, 1536, 1, 0)
    batch = {k: torch.from_numpy(host[k]).to(dev, torch.int64) for k in ("tokens", "targets")}
    names = _names(params)

    def grads(dtype, force=None):
        c = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
        p = tree_map(lambda t: t.to(getattr(torch, dtype)), params)
        t0 = time.time()
        g, _, loss, _ = ST.loss_and_grads(Model(c, force=force), p, batch)
        torch.cuda.synchronize()
        print(f"{dtype} force={force}: loss {loss.item():.9f} ({time.time() - t0:.1f} s)",
              flush=True)
        return [x.float() for x in tree_leaves(g)]

    g64 = grads("float64", "ref")

    def report(tag, g):
        d = [(torch.linalg.vector_norm(a - t) / torch.linalg.vector_norm(t)).item()
             for a, t in zip(g, g64)]
        w = max(range(len(d)), key=d.__getitem__)
        print(f"{tag}: ||a - f64|| / ||f64|| per leaf max {max(d):.3e} at {names[w]}, "
              f"median {sorted(d)[len(d) // 2]:.3e}", flush=True)
        return d

    dp = report("float32 plain path", grads("float32", "ref"))
    dk = report("float32 kernel path", grads("float32"))
    real_gla, real_fa = ops.gla, ops.flash_attention
    ops.gla = lambda *a, **kw: real_gla(*a, **{**kw, "force": "ref"})
    try:
        d1 = report("float32, K1's kernels and the plain GLA", grads("float32"))
    finally:
        ops.gla = real_gla
    ops.flash_attention = lambda *a, **kw: real_fa(*a, **{**kw, "force": "ref"})
    try:
        d4 = report("float32, the GLA kernels and the plain attention", grads("float32"))
    finally:
        ops.flash_attention = real_fa
    for i in sorted(range(len(names)), key=lambda i: -dk[i])[:10]:
        print(f"  {names[i]:32s} plain {dp[i]:.3e} kernel {dk[i]:.3e} K1 only {d1[i]:.3e} "
              f"GLA only {d4[i]:.3e}")
    report("bf16 plain path", grads("bfloat16", "ref"))
    report("bf16 kernel path", grads("bfloat16"))
    return 0


class _Float64Names:
    """``jax.numpy`` with ``float32`` standing for ``float64``."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(self._jnp, name)


def _jax_run(arch, steps, lr, p0, dtype):
    """``steps`` metrics of the JAX package's Trainer from the params ``p0``
    (numpy), its model computing in ``dtype``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import smoke_config as jax_smoke_config
    from repro.launch.train import Trainer as JaxTrainer
    from repro.models import layers, ssm, transformer

    cfg = jax_smoke_config(arch)
    mods = (layers, ssm, transformer)
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype,
                                  opt_state_dtype=dtype)
        for m in mods:
            m.jnp = _Float64Names(jnp)
    try:
        jt = JaxTrainer(cfg, batch_size=2, seq_len=48, world_size=2, total_steps=steps,
                        mesh=None, lr=lr)
        jt.init_state()
        jt.params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, dtype)), p0)
        jt.opt_state = jt.optimizer.init(jt.params)
        out = [{k: float(v) for k, v in jt.step_once().items()} for _ in range(steps)]
        jt.pipeline.stop()
    finally:
        for m in mods:
            m.jnp = jnp
        jax.config.update("jax_enable_x64", False)
    return [(m["loss"], m["grad_norm"]) for m in out]


def trajectory(lr: float) -> int:
    import jax
    import numpy as np
    import torch
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import Model as JaxModel
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import Trainer
    from repro_torch.models.params import from_jax_params, tree_map

    arch, steps = "hymba-1.5b", 10
    p0 = jax.tree.map(np.asarray, JaxModel(jax_smoke_config(arch)).init(jax.random.key(0)))
    runs = {f"JAX {dt}": _jax_run(arch, steps, lr, p0, dt) for dt in ("float32", "float64")}
    cfg = smoke_config(arch)
    for dt in ("float32", "float64"):
        c = dataclasses.replace(cfg, param_dtype=dt, compute_dtype=dt, opt_state_dtype=dt)
        tr = Trainer(c, batch_size=2, seq_len=48, world_size=2, total_steps=steps,
                     device="cpu", lr=lr)
        tr.init_state(tree_map(lambda t: t.to(getattr(torch, dt)),
                               from_jax_params(p0, cfg, "cpu")))
        runs[f"port {dt}"] = [(float(m["loss"]), float(m["grad_norm"]))
                              for m in (tr.step_once() for _ in range(steps))]
        tr.pipeline.stop()
    ref = runs["port float64"]
    print(f"hymba-1.5b smoke, batch 2 x 48, lr {lr:g}: |a - b| / b per step, b the port's "
          "float64 run unless named")
    for i in range(steps):
        b = ref[i]
        cols = [f"{name} loss {abs(r[i][0] - b[0]) / b[0]:.1e} grad_norm "
                f"{abs(r[i][1] - b[1]) / b[1]:.1e}"
                for name, r in runs.items() if name != "port float64"]
        a, j = runs["port float32"][i][1], runs["JAX float32"][i][1]
        print(f"step {i + 1}: " + "; ".join(cols)
              + f"; grad_norm port f32 vs JAX f32 {abs(a - j) / j:.1e}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["step1", "trajectory"])
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args()
    return step1() if args.what == "step1" else trajectory(args.lr)


if __name__ == "__main__":
    sys.exit(main())
