"""The dense families minicpm-2b and qwen2.5-14b in the port against the JAX
package, on the CPU, from the same params and numpy inputs.

Three variants, each a case of the same tests: minicpm-2b's smoke config
(MHA, G = 1, head dim 32), qwen2.5-14b's (GQA G = 2, q/k/v biases, head dim
32) and qwen's at **head dim 128** (``dataclasses.replace`` in both
packages), the D the port's kernels take for qwen on the card. Both qwen
variants run with non-zero ``bq``/``bk``/``bv`` (the spec initialises them
to zeros, which would hide a bias dropped on either side).

Covered: the config copies, the param specs, ``from_jax_params`` with the
biases, prefill and decode logits and caches, the ``Server``'s greedy
stream, one step's gradients against ``jax.grad`` leaf by leaf, ten
``Trainer`` steps against the JAX ``Trainer`` and checkpoints moved between
the two trainers both ways; and the kernels' plain versions at D = 128
against the JAX package's Pallas kernels in interpret mode (the forward,
the contiguous and the paged decode) and against ``jax.vjp`` of the
reference's ``chunked_attention`` (the backward, which has no Pallas
kernel).

Tolerances, all float32 on both sides with the sums in another order:
logits and caches 1e-4 (tests/conftest.py ``assert_close``, 3 layers);
gradients per leaf, and each step's loss and grad_norm over ten steps,
1e-4 of the largest magnitude (tests/test_torch_train.py); the kernels'
plain versions 1e-5 against the jnp oracles and the vjp, 2e-5 against the
Pallas kernels (tests/test_torch_kernels.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from conftest import assert_close  # noqa: E402
from repro import steps as JST  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention import paged_decode_attention as pallas_paged  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.launch.train import Trainer as JaxTrainer  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import Server as JaxServer  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import steps as ST  # noqa: E402
from repro_torch.core.restore import load_manifest  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("minicpm-2b", "qwen2.5-14b")
VARIANTS = ("minicpm-2b", "qwen2.5-14b", "qwen2.5-14b-d128")
B, S, STEPS, EVERY = 2, 32, 10, 3
BIASES = ("bq", "bk", "bv")


def _configs(variant):
    """(JAX config, port config) of a variant: an arch's smoke config, or
    qwen's at head dim 128."""
    arch = variant.removesuffix("-d128")
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    if variant.endswith("-d128"):
        jcfg, cfg = (dataclasses.replace(c, head_dim=128) for c in (jcfg, cfg))
    return jcfg, cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _with_biases(tree, cfg, seed=11):
    """The numpy param tree with non-zero q/k/v biases (of the size the
    weights' outputs have) where the config has them."""
    if not cfg.qkv_bias:
        return tree
    rng = np.random.default_rng(seed)
    attn = tree["segments"][0]["attn"]
    for name in BIASES:
        attn[name] = (0.5 * rng.standard_normal(attn[name].shape)).astype(np.float32)
    return tree


def _pair(variant):
    """The JAX model and params (with non-zero biases), and the port's copy."""
    jcfg, cfg = _configs(variant)
    jm = JaxModel(jcfg)
    tree = _with_biases(jax.tree.map(np.asarray, jm.init(jax.random.key(0))), cfg)
    return jcfg, jm, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, "cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(batch[k]).long() for k in ("tokens", "targets")}


# -- configs, specs and params -----------------------------------------------------

@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_equals_jax_config(arch, fn):
    got, want = getattr(configs, fn)(arch), getattr(jconfigs, fn)(arch)
    assert arch in configs.ARCH_IDS
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.kv_cache_width, got.param_count()) == \
        (want.padded_vocab, want.kv_cache_width, want.param_count())


@pytest.mark.parametrize("variant", VARIANTS + ("minicpm-2b-full", "qwen2.5-14b-full"))
def test_model_specs_match_jax(variant):
    if variant.endswith("-full"):
        arch = variant.removesuffix("-full")
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    else:
        jcfg, cfg = _configs(variant)
    got = tree_leaves(T.model_specs(cfg))
    want = jax.tree.leaves(JT.model_specs(jcfg),
                           is_leaf=lambda x: type(x).__name__ == "ParamSpec")
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    attn = T.model_specs(cfg)["segments"][0]["attn"]
    assert (set(BIASES) <= set(attn)) == cfg.qkv_bias


@pytest.mark.parametrize("variant", ["qwen2.5-14b", "qwen2.5-14b-d128"])
def test_from_jax_params_carries_the_biases(variant):
    _, _, jp, cfg, tp = _pair(variant)
    for name in BIASES:
        want = np.asarray(jp["segments"][0]["attn"][name])
        got = tp["segments"][0]["attn"][name]
        assert got.shape == (cfg.n_layers, want.shape[-1]) and np.abs(want).min() > 0
        np.testing.assert_array_equal(got.numpy(), want)


# -- serving ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match_jax_model(variant):
    jcfg, jm, jp, cfg, tp = _pair(variant)
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 11), dtype=np.int32)
    n_dec = 4
    jlogits, jcaches = jm.prefill(ctx, jp, {"tokens": jnp.asarray(tokens)})
    m = Model(cfg)
    logits, caches = m.prefill(tp, torch.from_numpy(tokens).long())
    assert logits.shape == (2, cfg.padded_vocab)
    assert_close(logits, jlogits)
    for k in ("k", "v"):
        assert caches[0]["attn"][k].shape == jcaches[0]["attn"][k].shape
        assert_close(caches[0]["attn"][k], jcaches[0]["attn"][k])
    _, caches = m.prefill(tp, torch.from_numpy(tokens).long(), max_len=11 + n_dec)
    jcaches = jax.tree.map(lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, n_dec), (0, 0))),
                           jcaches)
    tok = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    for i in range(n_dec):
        jlogits, jcaches = jm.decode_step(ctx, jp, jnp.asarray(tok), jnp.int32(11 + i),
                                          jcaches)
        logits, caches = m.decode_step(tp, torch.from_numpy(tok).long(), 11 + i, caches)
        assert_close(logits, jlogits, msg=f"decode step {i}")
        tok = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    for k in ("k", "v"):
        assert_close(caches[0]["attn"][k], jcaches[0]["attn"][k])


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_stream_matches_jax_server(variant):
    from repro_torch.serving.engine import Server
    jcfg, cfg = _configs(variant)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9), dtype=np.int32)
    n = 8
    jsrv = JaxServer(jcfg, backend="mpich", seed=0)
    tree = _with_biases(jax.tree.map(np.asarray, jsrv.params), cfg)
    jsrv.params = jax.tree.map(jnp.asarray, tree)
    jlogits = jsrv.prefill(prompt, pad_to=prompt.shape[1] + n)
    jfirst = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    jtoks, _ = jsrv.decode(n - 1, jfirst)
    want = np.stack([jfirst] + [np.asarray(t) for t in jtoks], axis=1)

    srv = Server(cfg, device="cpu", params=from_jax_params(tree, cfg, "cpu"))
    logits = srv.prefill(prompt, pad_to=prompt.shape[1] + n)
    assert_close(logits, jlogits)
    first = np.argmax(logits[:, : cfg.vocab_size].numpy(), -1).astype(np.int32)
    toks, _ = srv.decode(n - 1, first)
    np.testing.assert_array_equal(np.stack([first] + toks, axis=1), want)


# -- training --------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_one_step_gradients_match_jax_grad(variant):
    jcfg, jm, jp, cfg, tp = _pair(variant)
    batch = synth_batch(cfg, B, S, 1, 0)
    ctx = ShardingCtx(None, rules_for(jcfg, "train"))
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        logits, aux = jm.train_logits(ctx, p, jb)
        return JST.lm_loss(jcfg, logits, jb["targets"]) + aux
    jloss, jgrads = jax.value_and_grad(loss_fn)(jp)
    grads, total, _, _ = ST.loss_and_grads(Model(cfg), tp, _tbatch(batch))
    assert abs(total.item() - float(jloss)) <= 1e-5 * float(jloss)
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == b.shape and _rel(a.numpy(), b) <= 1e-4, i
    if cfg.qkv_bias:   # the biases take a gradient on both sides
        g = grads["segments"][0]["attn"]
        assert all(g[n].abs().max() > 0 for n in BIASES)


@pytest.fixture(scope="module", params=VARIANTS)
def jax_run(request, tmp_path_factory):
    """The module's JAX Trainer per variant (non-zero biases set after its
    init; AdamW's state does not depend on the values): ten steps with a
    checkpoint every 3; its variant, initial params, per-step metrics and
    the trainer."""
    variant = request.param
    jcfg, cfg = _configs(variant)
    tr = JaxTrainer(jcfg, batch_size=B, seq_len=S, world_size=2, total_steps=STEPS,
                    mesh=None, ckpt_dir=tmp_path_factory.mktemp("jax") / "ck")
    tr.init_state()
    p0 = _with_biases(jax.tree.map(np.asarray, tr.params), cfg)
    tr.params = jax.tree.map(jnp.asarray, p0)
    metrics = []
    for _ in range(STEPS):
        metrics.append({k: float(v) for k, v in tr.step_once().items()})
        if tr.step % EVERY == 0:
            tr.checkpoint()
    tr.cluster.writer.wait_idle()
    yield variant, p0, metrics, tr
    tr.pipeline.stop()
    tr.cluster.writer.close()


def _port_trainer(cfg, **kw):
    return Trainer(cfg, batch_size=B, seq_len=S, world_size=2, total_steps=STEPS,
                   device="cpu", **kw)


def _stop(tr):
    tr.pipeline.stop()
    if tr.cluster.writer is not None:
        tr.cluster.writer.close()


def test_ten_steps_match_the_jax_trainer(jax_run):
    variant, p0, want, _ = jax_run
    cfg = _configs(variant)[1]
    tr = _port_trainer(cfg)
    tr.init_state(from_jax_params(p0, cfg, "cpu"))
    try:
        got = [tr.step_once() for _ in range(STEPS)]
    finally:
        _stop(tr)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"] == i + 1
        for k in ("loss", "grad_norm", "world_loss"):
            assert abs(float(g[k]) - w[k]) <= 1e-4 * abs(w[k]), (i, k, float(g[k]), w[k])


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    variant, _, want, jtr = jax_run
    cfg = _configs(variant)[1]
    tr = _port_trainer(cfg, ckpt_dir=tmp_path / "ck")
    tr.init_state()
    try:
        tr.restore(jtr.cluster.writer.base / "step_00000006", new_backend="exampi")
        assert tr.step == 6 and tr.pipeline.state()["next_index"] == 6
        assert tr.cluster.backend_name == "exampi"
        got = [float(tr.step_once()["loss"]) for _ in range(3)]
    finally:
        _stop(tr)
    for g, w in zip(got, want[6:9]):
        assert abs(g - w["loss"]) <= 1e-4 * abs(w["loss"]), (got, want[6:9])


def test_port_checkpoint_resumes_in_the_jax_trainer(jax_run, tmp_path):
    variant, p0, want, jtr = jax_run
    cfg = _configs(variant)[1]
    tr = _port_trainer(cfg, ckpt_dir=tmp_path / "ck")
    tr.init_state(from_jax_params(p0, cfg, "cpu"))
    try:
        for _ in range(6):
            tr.step_once()
        tr.checkpoint()
        tr.cluster.writer.wait_idle()
        ck = tr.cluster.writer.latest()
        assert ck.name == "step_00000006" and load_manifest(ck)["step"] == 6
    finally:
        _stop(tr)
    jtr.restore(ck, new_backend="fabric")
    assert jtr.step == 6 and jtr.pipeline.state()["next_index"] == 6
    got = [float(jtr.step_once()["loss"]) for _ in range(3)]
    for g, w in zip(got, want[6:9]):
        assert abs(g - w["loss"]) <= 1e-4 * abs(w["loss"]), (got, want[6:9])


# -- the kernels' plain versions at head dim 128 -----------------------------------

def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B_,H,K,S_,window", [(1, 10, 2, 40, None), (1, 4, 4, 33, None),
                                              (2, 4, 2, 32, 8)])
def test_naive_attention_at_head_dim_128_matches_jax_and_pallas(B_, H, K, S_, window):
    rng = np.random.default_rng(S_ + H)
    q = rng.standard_normal((B_, H, S_, 128), dtype=np.float32)
    k, v = (rng.standard_normal((B_, K, S_, 128), dtype=np.float32) for _ in range(2))
    got = ref.naive_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=window)
    _close(got, jref.naive_attention(*(jnp.asarray(x) for x in (q, k, v)), window=window),
           1e-5)
    blk = 16 if S_ % 16 == 0 else S_
    _close(got, pallas_flash(*(jnp.asarray(x) for x in (q, k, v)), window=window,
                             q_block=blk, kv_block=blk, interpret=True), 2e-5)


@pytest.mark.parametrize("window,G", [(None, 5), (None, 1), (9, 5)])
def test_attention_backward_plain_version_at_head_dim_128_matches_jax_vjp(window, G):
    """ref.flash_attention_bwd from the plain forward's output and
    logsumexp against jax.vjp of the reference's chunked_attention (GQA heads
    repeated, as its attn_apply passes them), D = 128."""
    Bq, K, Sq, D = 1, 2, 40, 128
    H = K * G
    rng = np.random.default_rng(G + (window or 0))
    q = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, Sq, K, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    ctx = ShardingCtx(None, rules_for(jconfigs.smoke_config("qwen2.5-14b"), "train"))

    def f(q_, k_, v_):
        return JL.chunked_attention(ctx, q_, jnp.repeat(k_, G, axis=2),
                                    jnp.repeat(v_, G, axis=2), window=window,
                                    q_chunk=8, kv_chunk=8)
    o_j, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v, do))
    o = ref.naive_attention(tq, tk, tv, window=window)
    assert _rel(o.transpose(1, 2).numpy(), o_j) <= 1e-5
    lse = ref.naive_attention_lse(tq, tk, window=window)
    got = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a.transpose(1, 2).numpy(), b) <= 1e-5, name


@pytest.mark.parametrize("length", [1, 21, 64])
@pytest.mark.parametrize("H,K,window", [(10, 2, None), (4, 4, None), (10, 2, 16)])
def test_naive_decode_attention_at_head_dim_128_matches_jax_and_pallas(H, K, window, length):
    B_, S_, D = 2, 64, 128
    rng = np.random.default_rng(length + H)
    q = rng.standard_normal((B_, H, D), dtype=np.float32)
    k, v = (rng.standard_normal((B_, S_, K, D), dtype=np.float32) for _ in range(2))
    got = ref.naive_decode_attention(torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
                                     torch.from_numpy(v).transpose(1, 2), length,
                                     window=window)
    _close(got, jref.naive_decode_attention(
        jnp.asarray(q), jnp.moveaxis(jnp.asarray(k), 1, 2),
        jnp.moveaxis(jnp.asarray(v), 1, 2), length, window=window), 1e-5)
    _close(got, pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length,
                              n_splits=8, window=window, interpret=True), 2e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_naive_paged_decode_attention_at_head_dim_128_matches_pallas(window):
    """A shuffled pool, table entries past each length 0, qwen's G = 5."""
    B_, H, K, D, page, n_pages = 2, 10, 2, 128, 16, 4
    n_pool = B_ * n_pages + 3
    rng = np.random.default_rng(13)
    q = rng.standard_normal((B_, H, D), dtype=np.float32)
    kp, vp = (rng.standard_normal((n_pool, page, K, D), dtype=np.float32) for _ in range(2))
    pt = rng.permutation(n_pool)[:B_ * n_pages].reshape(B_, n_pages).astype(np.int32)
    lengths = np.array([page * n_pages - 5, 2 * page - 3], np.int32)
    for b in range(B_):
        pt[b, (lengths[b] + page - 1) // page:] = 0
    got = ref.naive_paged_decode_attention(*(torch.from_numpy(x) for x in
                                             (q, kp, vp, pt, lengths)), window=window)
    _close(got, pallas_paged(*(jnp.asarray(x) for x in (q, kp, vp, pt, lengths)),
                             window=window, interpret=True), 1e-5)
