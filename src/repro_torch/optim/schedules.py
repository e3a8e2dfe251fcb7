"""LR schedules (the JAX package's ``optim/schedules.py``). WSD
(warmup-stable-decay) is minicpm-2b's schedule [arXiv:2404.06395]: linear
warmup, long stable plateau, sharp decay tail.

Each maps a host step to a float32 learning rate, computed in numpy
float32 as the reference computes it in ``jnp.float32``; the optimizers
take it as a Python float (exactly that float32 value)."""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(lr):
    return lambda step: _F(lr)


def cosine(lr, warmup, total, final_frac=0.1):
    def fn(step):
        s = _F(step)
        if s < warmup:
            return _F(lr) * s / _F(max(warmup, 1))
        prog = np.clip((s - _F(warmup)) / _F(max(total - warmup, 1)), _F(0), _F(1))
        cos = _F(lr) * (_F(final_frac) + _F(1 - final_frac) * _F(0.5)
                        * (_F(1) + np.cos(_F(np.pi) * prog)))
        return _F(cos)
    return fn


def wsd(lr, warmup, total, decay_frac=0.1, final_frac=0.01):
    """Warmup-Stable-Decay: stable at `lr` until the last decay_frac of training,
    then decays exponentially to final_frac * lr."""
    decay_start = total * (1.0 - decay_frac)

    def fn(step):
        s = _F(step)
        if s < warmup:
            return _F(lr) * s / _F(max(warmup, 1))
        if s < decay_start:
            return _F(lr)
        prog = np.clip((s - _F(decay_start)) / _F(max(total - decay_start, 1)),
                       _F(0), _F(1))
        return _F(_F(lr) * np.exp(np.log(_F(final_frac)) * prog))
    return fn
