"""K1 with V at its own width, MLA's (q and k at 96 beside v at 64), on the
CPU: the port's plain route (what a CPU tensor takes, and what the kernels
are held to on the card) against the JAX package's attention on V
zero-padded to 96 and O sliced back, as the reference's ``mla_apply`` runs
it: ``models/layers.chunked_attention``, the Pallas ``flash_attention`` in
interpret mode, and ``jax.vjp`` of the padded function for the backward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)
D, DV = 96, 64
# float32 on both sides: the sums' order only (the Pallas kernel's blocks
# another order again)
TOL, TOL_PALLAS = 1e-5, 2e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(B, H, K, S, seed):
    """q, k [B,S,n,96], v [B,S,K,64], dO [B,S,H,64] float32 from a seed."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, DV)).astype(np.float32)
    do = rng.standard_normal((B, S, H, DV)).astype(np.float32)
    return q, k, v, do


def _ctx():
    return ShardingCtx(None, rules_for(jconfigs.smoke_config("minicpm3-4b"), "train"))


def _t(x):
    """A [B,S,n,w] array as the port's [B,n,S,w] view."""
    return torch.from_numpy(x).transpose(1, 2)


CASES = [(1, 4, 4, 48, None), (2, 4, 4, 24, None), (1, 6, 2, 32, None), (2, 4, 4, 32, 8)]


@pytest.mark.parametrize("B,H,K,S,window", CASES)
def test_plain_route_at_96_64_matches_chunked_attention_on_padded_v(B, H, K, S, window):
    """ops.flash_attention on CPU tensors at (96, 64) against the
    reference's chunked_attention with V zero-padded to 96 (GQA heads
    repeated, as its attn_apply passes them), its O's first 64 columns; the
    padded columns of the reference's O are zeros."""
    q, k, v, _ = _inputs(B, H, K, S, seed=S + H)
    vpad = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, D - DV)))
    G = H // K
    want = JL.chunked_attention(_ctx(), jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=2),
                                jnp.repeat(jnp.asarray(vpad), G, axis=2), window=window,
                                q_chunk=16, kv_chunk=16)
    assert np.abs(np.asarray(want)[..., DV:]).max() == 0.0
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window)
    assert got.shape == (B, H, S, DV)
    assert _rel(got.transpose(1, 2).numpy(), np.asarray(want)[..., :DV]) <= TOL


@pytest.mark.parametrize("B,H,K,S,window", CASES)
def test_plain_route_at_96_64_matches_pallas_flash_on_padded_v(B, H, K, S, window):
    """The same against the Pallas kernel (interpret mode, as the JAX
    package's tests run it on the CPU) on V zero-padded to 96."""
    q, k, v, _ = _inputs(B, H, K, S, seed=2 * S + H)
    vpad = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, D - DV)))
    blk = 16 if S % 16 == 0 else S
    want = pallas_flash(*(jnp.asarray(np.moveaxis(x, 1, 2)) for x in (q, k, vpad)),
                        window=window, q_block=blk, kv_block=blk, interpret=True)
    got = ref.naive_attention(_t(q), _t(k), _t(v), window=window)
    assert _rel(got.numpy(), np.asarray(want)[..., :DV]) <= TOL_PALLAS


@pytest.mark.parametrize("B,H,K,S,window", CASES)
def test_plain_backward_at_96_64_matches_jax_vjp_of_the_padded_function(B, H, K, S, window):
    """ref.flash_attention_bwd at (96, 64), from the plain forward's output
    and logsumexp, against jax.vjp of chunked_attention on V zero-padded to
    96 with O sliced back to 64: dQ and dK equal, dV the padded gradient's
    first 64 columns (its padding takes none)."""
    q, k, v, do = _inputs(B, H, K, S, seed=3 * S + H)
    G = H // K

    def f(q_, k_, v_):
        vp = jnp.pad(v_, ((0, 0), (0, 0), (0, 0), (0, D - DV)))
        o = JL.chunked_attention(_ctx(), q_, jnp.repeat(k_, G, axis=2),
                                 jnp.repeat(vp, G, axis=2), window=window, q_chunk=16,
                                 kv_chunk=16)
        return o[..., :DV]
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    o = ref.naive_attention(tq, tk, tv, window=window)
    lse = ref.naive_attention_lse(tq, tk, window=window)
    got = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, window=window)
    assert [tuple(x.shape) for x in got] == [(B, H, S, D), (B, K, S, D), (B, K, S, DV)]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a.transpose(1, 2).numpy(), b) <= TOL, name
    # the padded function's own dV: its first 64 columns are the port's
    _, vjp_pad = jax.vjp(lambda v_: JL.chunked_attention(
        _ctx(), jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=2),
        jnp.repeat(v_, G, axis=2), window=window, q_chunk=16, kv_chunk=16),
        jnp.asarray(np.pad(v, ((0, 0), (0, 0), (0, 0), (0, D - DV)))))
    dv_pad = vjp_pad(jnp.asarray(np.pad(do, ((0, 0), (0, 0), (0, 0), (0, D - DV)))))[0]
    assert _rel(got[2].transpose(1, 2).numpy(), np.asarray(dv_pad)[..., :DV]) <= TOL


def test_autograd_of_the_plain_route_takes_v_at_its_width():
    """ops.flash_attention's plain route under autograd at (96, 64): the
    gradients come back at their inputs' widths and equal the plain
    backward's."""
    q, k, v, do = _inputs(1, 4, 4, 24, seed=5)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, window=9)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    o = ref.naive_attention(*(x.detach() for x in (tq, tk, tv)), window=9)
    lse = ref.naive_attention_lse(tq.detach(), tk.detach(), window=9)
    want = ref.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), o, lse, _t(do),
                                   window=9)
    for a, b in zip(grads, want):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b.numpy()) <= TOL


@pytest.mark.parametrize("Dv,ok", [(64, True), (96, True), (32, False), (128, False)])
def test_kernel_route_takes_exactly_the_paired_widths(Dv, ok):
    """The wrapper's pair rule at q's 96: v at 64 or 96; on CPU tensors the
    kernel route raises before any launch in either case, a refused pair on
    its widths."""
    assert FA.pair_ok(D, Dv) == ok
    q, k = (torch.zeros(1, 2, 8, D) for _ in range(2))
    v = torch.zeros(1, 2, 8, Dv)
    with pytest.raises((RuntimeError, ValueError)):
        ops.flash_attention(q, k, v, force="kernel")
    if ok:
        assert ops.flash_attention(q, k, v).shape == (1, 2, 8, Dv)
