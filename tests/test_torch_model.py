"""The port's model against the JAX package's: config copy, param specs and
conversion, seeded init, and prefill + decode logits and caches from the
same params and tokens (granite smoke config, float32). Tolerance 1e-4
(tests/conftest.py assert_close): float32 on both sides, different
matmul/reduction order over 3 layers."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from conftest import assert_close  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves  # noqa: E402

torch.set_num_threads(1)
ARCH = "granite-3-2b"


@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
def test_config_copy_equals_jax_config(fn):
    got = getattr(configs, fn)(ARCH)
    want = getattr(jconfigs, fn)(ARCH)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.kv_cache_width, got.param_count()) == \
        (want.padded_vocab, want.kv_cache_width, want.param_count())


def test_model_specs_match_jax():
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    got = tree_leaves(T.model_specs(cfg))
    want = jax.tree.leaves(JT.model_specs(jcfg),
                           is_leaf=lambda x: type(x).__name__ == "ParamSpec")
    assert [tuple(s) for s in got] == [tuple(s) for s in want]


def test_unported_blocks_raise():
    # hymba, sliding-window attention, MoE, llava's vision prefix, MLA and
    # xLSTM are ported; the multi-codebook frontend is not yet
    cfg = configs.smoke_config(ARCH)
    for change in ({"n_codebooks": 2},):
        with pytest.raises(NotImplementedError):
            T.plan_segments(dataclasses.replace(cfg, **change))


def test_seeded_init_is_deterministic_with_jax_distributions():
    cfg = configs.smoke_config(ARCH)
    m = Model(cfg)
    a, b, c = m.init(0, "cpu"), m.init(0, "cpu"), m.init(1, "cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a["head"], c["head"])
    seg = a["segments"][0]
    hd = cfg.resolved_head_dim
    assert seg["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * hd)
    assert torch.equal(seg["ln1"], torch.ones_like(seg["ln1"]))
    # normal x 1/sqrt(fan_in), fan_in ignoring the layers axis; embed x 0.02
    for w, scale in ((seg["ffn"]["wo"], cfg.d_ff ** -0.5), (a["head"], cfg.d_model ** -0.5),
                     (a["embed"], 0.02)):
        assert abs(w.std().item() / scale - 1) < 0.05


def _jax_pair(seed=0):
    jcfg = jconfigs.smoke_config(ARCH)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.key(seed))
    cfg = configs.smoke_config(ARCH)
    return jcfg, jm, jp, cfg, from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")


def test_from_jax_params_keeps_layout_and_values():
    _, _, jp, cfg, tp = _jax_pair()
    jl = jax.tree.leaves(jp)
    tl = tree_leaves(tp)
    assert len(jl) == len(tl)
    for x, y in zip(jl, tl):
        assert tuple(x.shape) == tuple(y.shape) and y.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    bad = jax.tree.map(np.asarray, jp)
    bad["head"] = bad["head"].T
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(bad, cfg, "cpu")


def test_prefill_and_decode_match_jax_model():
    jcfg, jm, jp, cfg, tp = _jax_pair()
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 11), dtype=np.int32)
    S, n_dec = tokens.shape[1], 4
    jlogits, jcaches = jm.prefill(ctx, jp, {"tokens": jnp.asarray(tokens)})
    m = Model(cfg)
    logits, caches = m.prefill(tp, torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.padded_vocab)
    assert_close(logits, jlogits)
    for k in ("k", "v"):
        assert caches[0]["attn"][k].shape == jcaches[0]["attn"][k].shape
        assert_close(caches[0]["attn"][k], jcaches[0]["attn"][k])

    # decode from caches allocated at S + n_dec (the JAX caches padded to it)
    _, caches = m.prefill(tp, torch.from_numpy(tokens).long(), max_len=S + n_dec)
    jcaches = jax.tree.map(lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, n_dec), (0, 0))),
                           jcaches)
    tok = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    for i in range(n_dec):
        jlogits, jcaches = jm.decode_step(ctx, jp, jnp.asarray(tok), jnp.int32(S + i),
                                          jcaches)
        logits, caches = m.decode_step(tp, torch.from_numpy(tok).long(), S + i, caches)
        assert_close(logits, jlogits, msg=f"decode step {i}")
        tok = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    for k in ("k", "v"):
        assert_close(caches[0]["attn"][k], jcaches[0]["attn"][k])


def test_sliding_window_dense_model_matches_jax_ring_cache():
    """granite's smoke config with a 16-token window: every layer keeps a
    ring-buffer cache, as the reference's ``use_ring`` path does; a 24-token
    prompt rolls the ring by 8 and the decode wraps it."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), window=16)
    cfg = dataclasses.replace(configs.smoke_config(ARCH), window=16)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.key(2))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    jlogits, jcaches = jm.prefill(ctx, jp, {"tokens": jnp.asarray(tokens)})
    m = Model(cfg)
    logits, caches = m.prefill(tp, torch.from_numpy(tokens).long(), max_len=40)
    assert_close(logits, jlogits)
    assert caches[0]["attn"]["k"].shape == jcaches[0]["attn"]["k"].shape == (3, 2, 16, 64)
    for i in range(10):
        tok = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
        jlogits, jcaches = jm.decode_step(ctx, jp, jnp.asarray(tok), jnp.int32(24 + i),
                                          jcaches)
        logits, caches = m.decode_step(tp, torch.from_numpy(tok).long(), 24 + i, caches)
        assert_close(logits, jlogits, msg=f"decode step {i}")
    for k in ("k", "v"):
        assert_close(caches[0]["attn"][k], jcaches[0]["attn"][k])
