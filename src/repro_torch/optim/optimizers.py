"""Optimizers (the JAX package's ``optim/optimizers.py``): AdamW for the
standard archs; Adafactor (factored second moment, no first moment) for
those whose full Adam state would not fit. Both take an ``opt_state_dtype``
to trade state precision for memory.

The state is a tree shaped like the params (``{"m": tree, "v": tree}``, or
``{"f": tree}`` of per-leaf dicts), so a checkpoint's ``opt`` section is
the reference's. The arithmetic is the reference's, in float32 and in its
order. AdamW updates the params and its state in place, leaf by leaf (the
reference returns new trees): a stacked ``[40, 2048, 8192]`` MLP leaf has
671M elements, so each float32 temporary is 2.7 GB, and a leaf's update
holds at most two of them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_map

_F = np.float32


class Optimizer(NamedTuple):
    init: Callable      # params -> state
    # (grads, state, params, step, gnorm=None) -> (new_params, new_state);
    # gnorm: the grads' global norm where the caller has it (AdamW clips by
    # it and computes it when None; Adafactor does not use it)
    update: Callable
    name: str


def _sq_sum(x):
    """sum(x.float() ** 2) with one float32 temporary."""
    xf = x.float()
    return (xf.square_() if xf is not x else xf.square()).sum()


def global_norm(tree):
    """sqrt of the sum, in flatten order, of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(_sq_sum(x) for x in tree_leaves(tree)))


def adamw(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          state_dtype=torch.float32, grad_clip=1.0):
    def init(params):
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device),
                         params)
        return {"m": zeros, "v": tree_map(torch.zeros_like, zeros)}

    @torch.no_grad()
    def update(grads, state, params, step, gnorm=None):
        """Clip by the global norm, then per leaf (float32): m = b1 m +
        (1 - b1) g, v = b2 v + (1 - b2) g^2, p -= lr ((m / bc1) / (sqrt(v /
        bc2) + eps) + wd p) with bc = 1 - b^t; in place. Returns the same
        (params, state) objects."""
        lr = float(schedule(step))
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        t = _F(step + 1)
        bc1, bc2 = float(_F(1) - _F(b1) ** t), float(_F(1) - _F(b2) ** t)
        for p, g, m, v in zip(*(tree_leaves(x) for x in (params, grads, state["m"],
                                                        state["v"]))):
            _adamw_leaf(p, g, m, v, scale, lr, bc1, bc2, b1, b2, eps, weight_decay)
        return params, state

    return Optimizer(init, update, "adamw")


def _adamw_leaf(p, g, m, v, scale, lr, bc1, bc2, b1, b2, eps, weight_decay):
    """One leaf's AdamW step in place; its float32 temporaries die on return."""
    gf = g.float() * scale
    mf, vf = m.float(), v.float()
    mf.mul_(b1).add_(gf, alpha=1 - b1)
    vf.mul_(b2).addcmul_(gf, gf, value=1 - b2)
    den = torch.div(vf, bc2).sqrt_().add_(eps)
    u = torch.div(mf, bc1, out=gf).div_(den)     # gf is spent: reuse it
    del den
    pf = p.float()
    u.add_(pf, alpha=weight_decay)
    if pf is p:
        p.sub_(u, alpha=lr)
    else:
        p.copy_(pf.sub_(u, alpha=lr))
    for s, sf in ((m, mf), (v, vf)):
        if sf is not s:
            s.copy_(sf)


def adafactor(schedule, decay=0.8, eps=1e-30, clip_threshold=1.0,
              state_dtype=torch.float32, min_dim_factored=128):
    """Factored second-moment estimator (Shazeer & Stern). Matrices with both
    trailing dims >= min_dim_factored store row/col stats only."""

    def factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_factored \
            and p.shape[-2] >= min_dim_factored

    def init(params):
        def one(p):
            def z(shape):
                return torch.zeros(shape, dtype=state_dtype, device=p.device)
            if factored(p):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"f": tree_map(one, params)}

    @torch.no_grad()
    def update(grads, state, params, step, gnorm=None):
        lr = float(schedule(step))
        beta = float(_F(1) - _F(step + 1) ** _F(-decay))

        def upd(p, g, s):
            g = g.float()
            g2 = g * g + eps
            if factored(p):
                vr = beta * s["vr"].float() + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"].float() + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                    vr.mean(-1)[..., None, None], min=eps)
                u = g * torch.rsqrt(denom + eps)
                ns = {"vr": vr.to(state_dtype), "vc": vc.to(state_dtype)}
            else:
                v = beta * s["v"].float() + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                ns = {"v": v.to(state_dtype)}
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            return (p.float() - lr * u).to(p.dtype), ns

        out = tree_map(upd, params, grads, state["f"])
        is_pair = (lambda x: isinstance(x, tuple))
        return (_unzip(out, 0, is_pair), {"f": _unzip(out, 1, is_pair)})

    return Optimizer(init, update, "adafactor")


def _unzip(tree, i, is_pair):
    """Element ``i`` of each (params, state) pair at the leaves of ``tree``."""
    if is_pair(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _unzip(x, i, is_pair) for k, x in tree.items()}
    return [_unzip(x, i, is_pair) for x in tree]


def make_optimizer(cfg, schedule):
    sd = getattr(torch, cfg.opt_state_dtype)
    if cfg.optimizer == "adafactor":
        return adafactor(schedule, state_dtype=sd)
    return adamw(schedule, state_dtype=sd)
