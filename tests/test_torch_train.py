"""The port's training path against the JAX package's, on the CPU at the
granite smoke config (float32): the key stream's fold_in, the loss, the
train-mode logits, the attention backward's plain version against
``jax.vjp`` of the reference's ``chunked_attention``, one step's gradients
against ``jax.grad``, and ten steps of the port's ``Trainer`` against the
JAX ``Trainer`` from the same params and batches.

Tolerances (max |a - b| / max |b|): the loss and the logits 1e-5, the
attention backward 1e-5 (float32, another summation order); one step's
gradients per leaf, and each step's loss and grad_norm over ten steps,
1e-4 (float32 through 3 layers and the optimizer's feedback)."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import steps as JST  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.train import Trainer as JaxTrainer  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch import steps as ST  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import runtime_state as RS  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves  # noqa: E402

torch.set_num_threads(1)
ARCH = "granite-3-2b"
B, S, STEPS = 2, 32, 10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _tbatch(batch):
    return {k: torch.from_numpy(batch[k]).long() for k in ("tokens", "targets")}


@pytest.fixture(scope="module")
def jax_run():
    """One JAX Trainer's ten steps: its initial params and per-step metrics."""
    tr = JaxTrainer(jax_smoke_config(ARCH), batch_size=B, seq_len=S, world_size=2,
                    total_steps=STEPS, mesh=None)
    tr.init_state()
    p0 = jax.tree.map(np.asarray, tr.params)
    metrics = [{k: float(v) for k, v in tr.step_once().items()} for _ in range(STEPS)]
    tr.pipeline.stop()
    return p0, metrics


@pytest.mark.parametrize("seed,data", [(0, 0), (2, 0), (2, 5), (7, 2 ** 31 + 3)])
def test_threefry_fold_in_equals_jax(seed, data):
    want = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.key(seed), data)))
    got = RS.threefry_fold_in(RS.threefry_key(seed), data)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


def test_lm_loss_matches_jax():
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((B, S, cfg.padded_vocab)) * 3).astype(np.float32)
    # the padded columns would dominate if they were not masked
    logits[..., cfg.vocab_size:] = 50.0
    targets = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    want = float(JST.lm_loss(jcfg, jnp.asarray(logits), jnp.asarray(targets)))
    got = ST.lm_loss(cfg, torch.from_numpy(logits), torch.from_numpy(targets)).item()
    assert abs(got - want) <= 1e-5 * abs(want)


def _pair():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.key(0))
    return jcfg, jm, jp, cfg, from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")


def test_train_logits_match_jax():
    jcfg, jm, jp, cfg, tp = _pair()
    batch = synth_batch(cfg, B, S, 1, 0)
    ctx = ShardingCtx(None, rules_for(jcfg, "train"))
    want, _ = jm.train_logits(ctx, jp, jax.tree.map(jnp.asarray, batch))
    got, aux = Model(cfg).train_logits(tp, _tbatch(batch))
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.padded_vocab)
    assert aux.item() == 0.0
    assert _rel(got.detach().numpy(), want) <= 1e-5


# (window, S, G, q_chunk, kv_chunk): the first two at a smoke size, the
# rest at the backward kernels' edges (a block owns 128 rows, a streamed
# tile is 64: S of 127 to 200, windows narrower and wider than a tile, G of
# 1 and 4); chunked_attention halves a chunk until it divides S, so those
# take one chunk of S rows
BWD_VJP_CASES = {"None": (None, 40, 2, 16, 8), "9": (9, 40, 2, 16, 8),
                 "S127-G1": (None, 127, 1, 127, 127), "S128-G4": (None, 128, 4, 128, 128),
                 "S129-G1": (None, 129, 1, 129, 129), "S200-G4": (None, 200, 4, 200, 200),
                 "S129-w9-G4": (9, 129, 4, 129, 129), "S200-w64-G1": (64, 200, 1, 200, 200),
                 "S127-w100-G4": (100, 127, 4, 127, 127),
                 "S200-w100-G1": (100, 200, 1, 200, 200)}


@pytest.mark.parametrize("window,Sq,G,q_chunk,kv_chunk", list(BWD_VJP_CASES.values()),
                         ids=list(BWD_VJP_CASES))
def test_attention_backward_plain_version_matches_jax_vjp(window, Sq, G, q_chunk, kv_chunk):
    """ref.flash_attention_bwd from the plain forward's output and
    logsumexp against jax.vjp of chunked_attention (GQA heads repeated, as
    the reference's attn_apply passes them)."""
    Bq, K, D = 2, 2, 16
    H = K * G
    rng = np.random.default_rng(3)
    q = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, Sq, K, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    ctx = ShardingCtx(None, rules_for(jax_smoke_config(ARCH), "train"))

    def f(q_, k_, v_):
        return JL.chunked_attention(ctx, q_, jnp.repeat(k_, H // K, axis=2),
                                    jnp.repeat(v_, H // K, axis=2), window=window,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk)
    o_j, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v, do))
    o = ref.naive_attention(tq, tk, tv, window=window)
    assert _rel(o.transpose(1, 2).numpy(), o_j) <= 1e-5
    lse = ref.naive_attention_lse(tq, tk, window=window)
    assert lse.shape == (Bq, H, Sq) and lse.dtype == torch.float32
    got = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a.transpose(1, 2).numpy(), b) <= 1e-5, name


class _PlainFlash(torch.autograd.Function):
    """The kernels' function and gradient in their plain versions: the
    forward and its logsumexp, and ``ref.flash_attention_bwd`` as the
    backward (the formula the backward kernels compute)."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o = ref.naive_attention(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, o, ref.naive_attention_lse(q, k, window=window))
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ref.flash_attention_bwd(q, k, v, o, lse, do, window=ctx.window), None)


@pytest.mark.parametrize("window", [None, 3])
def test_attention_backward_formula_passes_gradcheck_in_float64(window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 7, 4, generator=g, dtype=torch.float64, requires_grad=True)
    k, v = (torch.randn(1, 2, 7, 4, generator=g, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    assert torch.autograd.gradcheck(lambda a, b, c: _PlainFlash.apply(a, b, c, window),
                                    (q, k, v))


def test_ops_flash_attention_is_differentiable_on_the_cpu():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, n, 9, 8, generator=g, requires_grad=True) for n in (4, 2, 2))
    do = torch.randn(1, 4, 9, 8, generator=g)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, window=4), (q, k, v), do)
    o = ref.naive_attention(q, k, v, window=4)
    want = ref.flash_attention_bwd(q, k, v, o, ref.naive_attention_lse(q, k, window=4),
                                   do, window=4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_one_step_gradients_match_jax_grad():
    jcfg, jm, jp, cfg, tp = _pair()
    batch = synth_batch(cfg, B, S, 1, 0)
    ctx = ShardingCtx(None, rules_for(jcfg, "train"))
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        logits, aux = jm.train_logits(ctx, p, jb)
        return JST.lm_loss(jcfg, logits, jb["targets"]) + aux
    jloss, jgrads = jax.value_and_grad(loss_fn)(jp)
    grads, total, loss, aux = ST.loss_and_grads(Model(cfg), tp, _tbatch(batch))
    assert abs(total.item() - float(jloss)) <= 1e-5 * float(jloss)
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == b.shape and _rel(a.numpy(), b) <= 1e-4, i


def test_remat_on_and_off_give_equal_gradients():
    cfg = smoke_config(ARCH)
    assert cfg.remat
    tp = Model(cfg).init(0, "cpu")
    batch = _tbatch(synth_batch(cfg, B, S, 1, 3))
    on = ST.loss_and_grads(Model(cfg), tp, batch)[0]
    off = ST.loss_and_grads(Model(replace(cfg, remat=False)), tp, batch)[0]
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)


def test_ten_steps_match_the_jax_trainer(jax_run):
    p0, want = jax_run
    cfg = smoke_config(ARCH)
    tr = Trainer(cfg, batch_size=B, seq_len=S, world_size=2, total_steps=STEPS,
                 device="cpu")
    tr.init_state(from_jax_params(p0, cfg, "cpu"))
    try:
        got = [tr.step_once() for _ in range(STEPS)]
    finally:
        tr.pipeline.stop()
    assert tr.step == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"] == i + 1
        for k in ("loss", "grad_norm", "world_loss"):
            assert abs(float(g[k]) - w[k]) <= 1e-4 * abs(w[k]), (i, k, float(g[k]), w[k])
    # the key stream advanced by fold_in exactly as the reference's
    key = jax.random.key(2)
    for s in range(STEPS):
        key = jax.random.fold_in(key, s)
    assert np.array_equal(tr.rng_key, np.asarray(jax.random.key_data(key)))


def test_trainer_refuses_what_it_cannot_train():
    with pytest.raises(NotImplementedError, match="granite-only"):
        Trainer(smoke_config("hymba-1.5b"), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        Trainer(smoke_config(ARCH), device="cpu", mesh=object())


def test_trainer_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(smoke_config(ARCH))
