"""Parameter specs and init: shapes + logical axes, declared once.

Param trees are nested dicts and lists of tensors with the JAX package's
layout: einsum weights are ``[in, out]`` and a scanned segment's leaves
are stacked ``[n_layers, ...]``. Leaves are visited in the JAX package's
flatten order (dict keys sorted, lists in order).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple            # logical axis names, same length as shape (None entries ok)
    init: str = "normal"   # normal | zeros | ones | embed
    scale: float = 0.0     # 0 -> 1/sqrt(fan_in)


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists (specs are leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in flatten order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def stack_spec(spec_tree, n: int):
    """Add a leading scanned-layers axis to every spec in the tree."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), ("layers", *s.axes), s.init, s.scale),
        spec_tree)


def _scale(spec: ParamSpec) -> float:
    """The normal init's scale: ``spec.scale``, or 1/sqrt(fan_in), the
    product of all dims but the last, ignoring a leading layers axis."""
    if spec.scale:
        return spec.scale
    dims = [d for d, a in zip(spec.shape, spec.axes) if a != "layers"]
    fan_in = int(np.prod(dims[:-1])) if len(dims) > 1 else dims[0]
    return 1.0 / math.sqrt(max(fan_in, 1))


#: elements of the largest leaf drawn whole (16 GiB as float32)
WHOLE_DRAW_MAX = 1 << 32


def _init_one(gen: torch.Generator, spec: ParamSpec, dtype, device):
    """One leaf, drawn from ``gen``. A stacked leaf of more than
    ``WHOLE_DRAW_MAX`` elements is drawn one layer slice at a time into the
    preallocated leaf, so its float32 draw never exceeds one layer (llava's
    stacked MLP leaves, 8.8e9 elements, would be a 35 GB transient beside
    68.8 GB of bf16 weights); a smaller leaf is drawn whole, so the seeded
    weights of the models that ran before stay what they were."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    scale = 0.02 if spec.init == "embed" else _scale(spec)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    sliced = spec.axes[:1] == ("layers",) and out.numel() > WHOLE_DRAW_MAX
    for part in (out.unbind(0) if sliced else (out,)):
        x = torch.randn(part.shape, generator=gen, dtype=torch.float32, device=device)
        part.copy_(x * scale)
    return out


def tree_unflatten(tree, leaves: list):
    """Rebuild ``tree``'s structure with ``leaves`` given in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)
    return build(tree)


def init_params(spec_tree, dtype, *, seed: int, device):
    """Deterministic init: leaf ``i`` (flatten order) draws from a generator
    seeded with ``(seed, i)``, as the JAX package folds ``i`` into its key.
    The numbers differ from the JAX package's: torch generators cannot
    reproduce threefry."""
    gen = torch.Generator(device=device)
    out = []
    for i, spec in enumerate(tree_leaves(spec_tree)):
        gen.manual_seed(seed * 1_000_003 + i)
        out.append(_init_one(gen, spec, dtype, device))
    return tree_unflatten(spec_tree, out)


def from_jax_params(tree, cfg, device):
    """The JAX package's params (the nested dict/list ``Model.init`` returns,
    leaves as numpy arrays) as this package's tensors on ``device``.

    No leaf is transposed: both packages keep ``[in, out]`` weights and
    stacked ``[n_layers, ...]`` leaves. Leaves arrive in any float type
    (bfloat16 numpy arrays included) and are cast to ``cfg.param_dtype``;
    a shape that differs from this package's spec raises."""
    from repro_torch.models.transformer import model_specs
    dtype = getattr(torch, cfg.param_dtype)

    def one(spec, x):
        a = np.asarray(x)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"param shape {a.shape} != spec {spec.shape}")
        # through float32: lossless for bf16/f16/f32 leaves, and numpy's
        # bfloat16 (ml_dtypes) has no torch counterpart to share memory with
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)
    return tree_map(one, model_specs(cfg), tree)
