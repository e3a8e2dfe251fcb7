"""llava-next-34b's backbone in the port against the JAX package, on the
CPU, from the same params and numpy inputs, always with non-zero patch
embeddings over the first ``img_tokens`` positions.

Two variants, each a case of the same tests: llava's smoke config (GQA G
= 2, head dim 32, 8 image positions) and llava's at **G = 7, head dim 128**
(14 query heads over 2 KV heads; ``dataclasses.replace`` in both
packages), the grouping and head dim the port's kernels take for llava on
the card.

Covered: the config copy, the param specs (``mm_proj`` between ``head``
and ``segments`` in the flatten order), prefill and decode logits and
caches, the reference's decode-vs-prefill and cached-generation checks
(``tests/test_models_smoke.py``), the ``Server``'s greedy stream and the
serving CLI's, one step's gradients per leaf against ``jax.grad``
(``mm_proj``'s through the patch embeddings), ten ``Trainer`` steps
against the JAX ``Trainer`` (the pipeline's batches carry the patch
embeddings), checkpoints moved between the two trainers both ways, the
refusal of a prompt shorter than the image, and the kernels' plain
versions at G = 7 and head dim 128 against the Pallas kernels in
interpret mode.

Tolerances, float32 on both sides with the sums in another order: logits
and caches 1e-4 (tests/conftest.py ``assert_close``, 3 layers); gradients
per leaf, and each step's loss and grad_norm over ten steps, 1e-4 of the
largest magnitude (tests/test_torch_train.py); the reference's
decode-vs-prefill bound 2e-2 and exact cached greedy tokens; the kernels'
plain versions 2e-5 against the Pallas kernels (tests/test_torch_kernels.py).
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
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention import paged_decode_attention as pallas_paged  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.launch.train import Trainer as JaxTrainer  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import Server as JaxServer  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import steps as ST  # noqa: E402
from repro_torch.core.restore import load_manifest  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)
ARCH = "llava-next-34b"
VARIANTS = ("llava", "llava-g7-d128")
B, S, STEPS, EVERY = 2, 32, 10, 3


def _configs(variant):
    """(JAX config, port config) of a variant: the smoke config, or at 14
    query heads over 2 KV heads of 128."""
    jcfg, cfg = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
    if variant.endswith("-g7-d128"):
        jcfg, cfg = (dataclasses.replace(c, n_heads=14, n_kv_heads=2, head_dim=128)
                     for c in (jcfg, cfg))
    return jcfg, cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _pair(variant):
    """The JAX model and params, and the port's copy."""
    jcfg, cfg = _configs(variant)
    jm = JaxModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jcfg, jm, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, "cpu")


def _patches(cfg, batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.img_tokens, T.VISION_DIM)).astype(np.float32)


def _tbatch(batch):
    out = {k: torch.from_numpy(batch[k]).long() for k in ("tokens", "targets")}
    out["patch_embeds"] = torch.from_numpy(batch["patch_embeds"])
    return out


# -- configs, specs and params -----------------------------------------------------

@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
def test_config_copy_equals_jax_config(fn):
    got, want = getattr(configs, fn)(ARCH), getattr(jconfigs, fn)(ARCH)
    assert ARCH in configs.ARCH_IDS
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.kv_cache_width, got.param_count()) == \
        (want.padded_vocab, want.kv_cache_width, want.param_count())


@pytest.mark.parametrize("variant", VARIANTS + ("llava-full",))
def test_model_specs_match_jax(variant):
    jcfg, cfg = (jconfigs.get_config(ARCH), configs.get_config(ARCH)) \
        if variant.endswith("-full") else _configs(variant)
    specs = T.model_specs(cfg)
    got = tree_leaves(specs)
    want = jax.tree.leaves(JT.model_specs(jcfg),
                           is_leaf=lambda x: type(x).__name__ == "ParamSpec")
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert specs["mm_proj"].shape == (T.VISION_DIM, cfg.d_model)
    order = sorted(specs)
    assert order.index("mm_proj") == order.index("head") + 1 == order.index("segments") - 1


def test_oversized_stacked_leaves_are_drawn_a_layer_at_a_time(monkeypatch):
    """Past ``WHOLE_DRAW_MAX`` elements a stacked leaf is drawn one layer
    slice at a time (llava's MLP leaves at full size, 8.8e9 elements):
    seeded and deterministic, each layer its own draw, at the init's
    scale; an unstacked leaf is drawn whole as before."""
    cfg = configs.smoke_config(ARCH)
    whole = Model(cfg).init(0, "cpu")
    monkeypatch.setattr(P, "WHOLE_DRAW_MAX", 1000)
    a, b = Model(cfg).init(0, "cpu"), Model(cfg).init(0, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    wi = a["segments"][0]["ffn"]["wi"]
    assert wi.numel() > P.WHOLE_DRAW_MAX and not torch.equal(wi[0], wi[1])
    assert abs(wi.std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    assert torch.equal(a["embed"], whole["embed"]) and torch.equal(a["mm_proj"],
                                                                   whole["mm_proj"])


# -- serving ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match_jax_model(variant):
    jcfg, jm, jp, cfg, tp = _pair(variant)
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 13), dtype=np.int32)
    pe = _patches(cfg, 2, 6)
    n_dec = 4
    jlogits, jcaches = jm.prefill(ctx, jp, {"tokens": jnp.asarray(tokens),
                                            "patch_embeds": jnp.asarray(pe)})
    m = Model(cfg)
    tt, tpe = torch.from_numpy(tokens).long(), torch.from_numpy(pe)
    logits, caches = m.prefill(tp, tt, patch_embeds=tpe)
    assert logits.shape == (2, cfg.padded_vocab)
    assert_close(logits, jlogits)
    # the image moves the logits: the patch embeddings are not dropped
    assert _rel(m.prefill(tp, tt)[0].numpy(), np.asarray(jlogits)) > 1e-2
    for k in ("k", "v"):
        assert caches[0]["attn"][k].shape == jcaches[0]["attn"][k].shape
        assert_close(caches[0]["attn"][k], jcaches[0]["attn"][k])
    _, caches = m.prefill(tp, tt, max_len=13 + n_dec, patch_embeds=tpe)
    jcaches = jax.tree.map(lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, n_dec), (0, 0))),
                           jcaches)
    tok = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    for i in range(n_dec):
        jlogits, jcaches = jm.decode_step(ctx, jp, jnp.asarray(tok), jnp.int32(13 + i),
                                          jcaches)
        logits, caches = m.decode_step(tp, torch.from_numpy(tok).long(), 13 + i, caches)
        assert_close(logits, jlogits, msg=f"decode step {i}")
        tok = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    for k in ("k", "v"):
        assert_close(caches[0]["attn"][k], jcaches[0]["attn"][k])


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_matches_prefill(variant):
    """tests/test_models_smoke.py::test_smoke_decode_matches_prefill on the
    port, with the image: the decode of token S after a prefill of S
    tokens gives the logits of a prefill of S + 1."""
    _, _, _, cfg, tp = _pair(variant)
    m = Model(cfg)
    full = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 17)))
    pe = torch.from_numpy(_patches(cfg, 2, 9))
    want, _ = m.prefill(tp, full, patch_embeds=pe)
    _, caches = m.prefill(tp, full[:, :16], max_len=17, patch_embeds=pe)
    got, _ = m.decode_step(tp, full[:, 16], 16, caches)
    assert (got - want).abs().max() / want.abs().max() < 2e-2


def test_generation_with_cache_matches_reprefill():
    """tests/test_models_smoke.py::test_smoke_generation_with_cache on the
    port (2 layers, the image over the first 8 positions): greedy tokens
    through the cache equal those of re-prefilling the growing prefix."""
    cfg = dataclasses.replace(configs.smoke_config(ARCH), n_layers=2)
    m = Model(cfg)
    tp = m.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10)))
    pe = torch.from_numpy(_patches(cfg, 2, 3))
    logits, caches = m.prefill(tp, toks, max_len=14, patch_embeds=pe)
    cached, tok = [], torch.argmax(logits[:, : cfg.vocab_size], -1)
    for i in range(4):
        cached.append(tok)
        logits, caches = m.decode_step(tp, tok, 10 + i, caches)
        tok = torch.argmax(logits[:, : cfg.vocab_size], -1)
    cached.append(tok)
    prefix = toks
    for i, want in enumerate(cached):
        got = torch.argmax(m.prefill(tp, prefix, patch_embeds=pe)[0][:, : cfg.vocab_size], -1)
        assert torch.equal(got, want), f"cached decode diverged at step {i}"
        prefix = torch.cat([prefix, want[:, None]], dim=1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_stream_matches_jax_server(variant):
    jcfg, cfg = _configs(variant)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    pe = _patches(cfg, 2, 8)
    n = 8
    jsrv = JaxServer(jcfg, backend="mpich", seed=0)
    jlogits = jsrv.prefill(prompt, pe, pad_to=prompt.shape[1] + n)
    jfirst = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    jtoks, _ = jsrv.decode(n - 1, jfirst)
    want = np.stack([jfirst] + [np.asarray(t) for t in jtoks], axis=1)

    tree = jax.tree.map(np.asarray, jsrv.params)
    srv = Server(cfg, device="cpu", params=from_jax_params(tree, cfg, "cpu"))
    logits = srv.prefill(prompt, pe, pad_to=prompt.shape[1] + n)
    assert_close(logits, jlogits)
    first = np.argmax(logits[:, : cfg.vocab_size].numpy(), -1).astype(np.int32)
    toks, _ = srv.decode(n - 1, first)
    np.testing.assert_array_equal(np.stack([first] + toks, axis=1), want)


def test_serving_cli_passes_the_image():
    """The CLI draws the patch embeddings after the prompts from the same
    rng, as the JAX package's does: its stream equals a Server's given
    those draws."""
    got = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "12", "--gen", "4"])
    cfg = configs.smoke_config(ARCH)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    pe = rng.standard_normal((2, cfg.img_tokens, T.VISION_DIM)).astype(np.float32)
    srv = Server(cfg, device="cpu")
    first = np.argmax(srv.prefill(prompts, pe, pad_to=16)[:, : cfg.vocab_size].numpy(), -1)
    want, _ = srv.decode(4, first.astype(np.int32))
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_prompt_shorter_than_the_image_raises():
    """The reference splices the image over the first img_tokens positions
    with a concatenate that makes a shorter prompt's sequence longer than
    the prompt; the port refuses such a prompt, and a misshapen image."""
    cfg = configs.smoke_config(ARCH)
    srv = Server(cfg, device="cpu")
    n = cfg.img_tokens
    pe = _patches(cfg, 1, 0)
    with pytest.raises(ValueError, match="shorter"):
        srv.prefill(np.arange(n - 1)[None], pe)
    with pytest.raises(ValueError, match="patch_embeds"):
        srv.prefill(np.arange(n + 4)[None], pe[:, :-1])
    assert srv.prefill(np.arange(n)[None], pe).shape == (1, cfg.padded_vocab)
    assert srv.prefill(np.arange(3)[None]).shape == (1, cfg.padded_vocab)   # no image


# -- training --------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_one_step_gradients_match_jax_grad(variant):
    jcfg, jm, jp, cfg, tp = _pair(variant)
    batch = synth_batch(cfg, B, S, 1, 0)
    assert batch["patch_embeds"].shape == (B, cfg.img_tokens, T.VISION_DIM)
    ctx = ShardingCtx(None, rules_for(jcfg, "train"))
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        logits, aux = jm.train_logits(ctx, p, jb)
        return JST.lm_loss(jcfg, logits, jb["targets"]) + aux
    jloss, jgrads = jax.value_and_grad(loss_fn)(jp)
    grads, total, _, aux = ST.loss_and_grads(Model(cfg), tp, _tbatch(batch))
    assert aux.item() == 0.0
    assert abs(total.item() - float(jloss)) <= 1e-5 * float(jloss)
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == b.shape and _rel(a.numpy(), b) <= 1e-4, i
    assert grads["mm_proj"].abs().max() > 0
    assert _rel(grads["mm_proj"].numpy(), jgrads["mm_proj"]) <= 1e-4


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The module's JAX Trainer: ten steps with a checkpoint every 3; its
    initial params, per-step metrics and the trainer."""
    jcfg, _ = _configs("llava")
    tr = JaxTrainer(jcfg, batch_size=B, seq_len=S, world_size=2, total_steps=STEPS,
                    mesh=None, ckpt_dir=tmp_path_factory.mktemp("jax") / "ck")
    tr.init_state()
    p0 = jax.tree.map(np.asarray, tr.params)
    metrics = []
    for _ in range(STEPS):
        metrics.append({k: float(v) for k, v in tr.step_once().items()})
        if tr.step % EVERY == 0:
            tr.checkpoint()
    tr.cluster.writer.wait_idle()
    yield p0, metrics, tr
    tr.pipeline.stop()
    tr.cluster.writer.close()


def _port_trainer(**kw):
    return Trainer(_configs("llava")[1], batch_size=B, seq_len=S, world_size=2,
                   total_steps=STEPS, device="cpu", **kw)


def _stop(tr):
    tr.pipeline.stop()
    if tr.cluster.writer is not None:
        tr.cluster.writer.close()


def test_ten_steps_match_the_jax_trainer(jax_run):
    p0, want, _ = jax_run
    tr = _port_trainer()
    tr.init_state(from_jax_params(p0, tr.cfg, "cpu"))
    try:
        got = [tr.step_once() for _ in range(STEPS)]
    finally:
        _stop(tr)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"] == i + 1
        for k in ("loss", "grad_norm", "world_loss"):
            assert abs(float(g[k]) - w[k]) <= 1e-4 * abs(w[k]), (i, k, float(g[k]), w[k])


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    _, want, jtr = jax_run
    tr = _port_trainer(ckpt_dir=tmp_path / "ck")
    tr.init_state()
    try:
        tr.restore(jtr.cluster.writer.base / "step_00000006", new_backend="exampi")
        assert tr.step == 6 and tr.pipeline.state()["next_index"] == 6
        got = [float(tr.step_once()["loss"]) for _ in range(3)]
    finally:
        _stop(tr)
    for g, w in zip(got, want[6:9]):
        assert abs(g - w["loss"]) <= 1e-4 * abs(w["loss"]), (got, want[6:9])


def test_port_checkpoint_resumes_in_the_jax_trainer(jax_run, tmp_path):
    p0, want, jtr = jax_run
    tr = _port_trainer(ckpt_dir=tmp_path / "ck")
    tr.init_state(from_jax_params(p0, tr.cfg, "cpu"))
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


# -- the kernels' plain versions at llava's G = 7, head dim 128 ---------------------

def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S_", [32, 40])
def test_naive_attention_at_g7_d128_matches_pallas(S_):
    rng = np.random.default_rng(S_)
    q = rng.standard_normal((1, 14, S_, 128), dtype=np.float32)
    k, v = (rng.standard_normal((1, 2, S_, 128), dtype=np.float32) for _ in range(2))
    got = ref.naive_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    blk = 16 if S_ % 16 == 0 else 8
    _close(got, pallas_flash(*(jnp.asarray(x) for x in (q, k, v)), q_block=blk, kv_block=blk,
                             interpret=True), 2e-5)


@pytest.mark.parametrize("length", [1, 37, 64])
def test_naive_decode_attention_at_g7_d128_matches_pallas(length):
    rng = np.random.default_rng(length)
    q = rng.standard_normal((2, 14, 128), dtype=np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 128), dtype=np.float32) for _ in range(2))
    got = ref.naive_decode_attention(torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
                                     torch.from_numpy(v).transpose(1, 2), length)
    _close(got, pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length,
                              n_splits=8, interpret=True), 2e-5)


def test_naive_paged_decode_attention_at_g7_d128_matches_pallas():
    B_, H, K, D, page, n_pages = 2, 14, 2, 128, 16, 4
    n_pool = B_ * n_pages + 3
    rng = np.random.default_rng(19)
    q = rng.standard_normal((B_, H, D), dtype=np.float32)
    kp, vp = (rng.standard_normal((n_pool, page, K, D), dtype=np.float32) for _ in range(2))
    pt = rng.permutation(n_pool)[:B_ * n_pages].reshape(B_, n_pages).astype(np.int32)
    lengths = np.array([page * n_pages - 5, 2 * page - 3], np.int32)
    for b in range(B_):
        pt[b, (lengths[b] + page - 1) // page:] = 0
    got = ref.naive_paged_decode_attention(*(torch.from_numpy(x) for x in
                                             (q, kp, vp, pt, lengths)))
    _close(got, pallas_paged(*(jnp.asarray(x) for x in (q, kp, vp, pt, lengths)),
                             interpret=True), 2e-5)
