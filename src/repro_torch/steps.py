"""Step functions: the training step (loss, gradients, optimizer update)
the trainer calls, what the serving engine calls per request, and the
metrics allreduce over the MANA plane (the JAX package's ``steps.py``)."""
from __future__ import annotations

import torch

from repro_torch.models import Model
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim.optimizers import global_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(cfg, logits, targets):
    """logits: [B,S,Vp] float32; targets: [B,S] int. Padded-vocab logits are
    masked out of the logsumexp (set to ``NEG_INF``), as the reference does."""
    Vp, V = cfg.padded_vocab, cfg.vocab_size
    B, S = logits.shape[0], logits.shape[1]
    lg = logits.reshape(B, S, Vp)
    pad = torch.arange(Vp, device=lg.device) >= V
    lg = lg.masked_fill(pad, NEG_INF)
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - tgt)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def loss_and_grads(model: Model, params, batch):
    """-> (grads, total, loss, aux): the gradient of loss + aux with respect
    to every param leaf (a tree shaped like ``params``) and the three
    scalars, detached. ``params`` are plain tensors: the gradient is taken
    through views of them that require it, so nothing is copied."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tracked = tree_unflatten(params, leaves)
    with torch.enable_grad():
        logits, aux = model.train_logits(tracked, batch)
        loss = lm_loss(model.cfg, logits, batch["targets"])
        del logits
        total = loss + aux
        grads = torch.autograd.grad(total, leaves)
    return (tree_unflatten(params, list(grads)), total.detach(), loss.detach(),
            aux.detach())


def make_train_step(model: Model, optimizer):
    def train_step(params, opt_state, batch, step):
        """params, opt_state: trees of tensors, updated (in place, for
        AdamW) and returned; step: host int. Metrics are 0-d tensors on the
        params' device, ``step`` a host int."""
        grads, total, loss, aux = loss_and_grads(model, params, batch)
        gnorm = global_norm(grads)
        params, opt_state = optimizer.update(grads, opt_state, params, step,
                                             gnorm=gnorm)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": total,
                   "grad_norm": gnorm, "step": step + 1}
        return params, opt_state, metrics

    return train_step


class AllreduceHandle:
    """Late-wait half of :func:`host_allreduce_async`; ``wait()`` returns
    the folded scalar (the rank-0 copy, identical on every rank)."""

    def __init__(self, coll_handle):
        self._h = coll_handle

    @property
    def done(self) -> bool:
        return self._h.done

    def wait(self):
        return self._h.wait()[0]


def host_allreduce_async(cluster, value, op: str = "MPI_SUM", *,
                         timeout: float = 30.0) -> AllreduceHandle:
    """Async-start/late-wait split of :func:`host_allreduce`: the rank
    threads enter the collective NOW, the caller keeps dispatching device
    work, and ``handle.wait()`` lands when the result is needed.

    The overlap trick: pass ``value`` as a callable ``rank -> scalar``
    closing over a device tensor (e.g. ``lambda r: float(metrics["loss"])``
    right after the step's launches) — each rank thread then blocks on the
    device transfer INSIDE the collective pool while the main thread (and
    the device) keep going.  Exactly one allreduce may be in flight per
    cluster; wait before starting the next collective."""
    def one(m):
        v = value(m.rank) if callable(value) else value
        return m.allreduce(m.comm_world(), v, m.op_handles[op])
    return AllreduceHandle(cluster.run_collective_async(one, timeout=timeout))


def host_allreduce(cluster, value, op: str = "MPI_SUM", *,
                   timeout: float = 30.0):
    """World allreduce of a host scalar over the MANA plane — the training
    step's collective hot path (every live rank enters
    ``allreduce(comm_world(), value, op)`` through the interposition
    layer; capability-gated native vs derived per backend flavor).

    ``value`` may be a plain scalar (same contribution everywhere) or a
    callable ``rank -> scalar``.  Returns the rank-order fold, identical
    on every rank (the rank-0 copy)."""
    return host_allreduce_async(cluster, value, op, timeout=timeout).wait()


def make_prefill_step(model: Model):
    def prefill_step(params, tokens, max_len=None, patch_embeds=None):
        return model.prefill(params, tokens, max_len=max_len, patch_embeds=patch_embeds)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, token, pos, caches):
        return model.decode_step(params, token, pos, caches)
    return decode_step


def make_paged_decode_step(model: Model):
    def paged_decode_step(params, token, pos, pool_views, pages):
        return model.decode_step_paged(params, token, pos, pool_views, pages)
    return paged_decode_step
