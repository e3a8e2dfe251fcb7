"""The port's layers against the JAX package's on the same numpy inputs and
params (granite smoke config, float32). Tolerance 1e-4 (tests/conftest.py
assert_close): float32 on both sides, different matmul/reduction order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

torch.set_num_threads(1)
CFG, JCFG = smoke_config("granite-3-2b"), jax_smoke_config("granite-3-2b")
CTX = ShardingCtx(None, rules_for(JCFG, "decode"))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _params(spec_fn, seed):
    p = jax_init_params(spec_fn(JCFG), jax.random.key(seed), jnp.float32)
    return p, {k: _t(v) for k, v in p.items()}


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, CFG.d_model), dtype=np.float32) * 3
    w = rng.standard_normal((CFG.d_model,), dtype=np.float32)
    assert_close(L.rmsnorm(_t(x), _t(w)), JL.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    assert_close(L.rmsnorm(_t(x), _t(w), CFG.norm_eps),
                 JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), JCFG.norm_eps))


@pytest.mark.parametrize("shape,positions", [
    ((2, 7, 4, 32), np.arange(7)),                 # prefill [B,S,H,D]
    ((3, 4, 32), np.full((3,), 1000)),             # decode [B,H,D], per-row pos
])
def test_rope_matches_jax(shape, positions):
    x = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    got = L.rope(_t(x), torch.from_numpy(positions), CFG.rope_theta)
    want = JL.rope(jnp.asarray(x), jnp.asarray(positions), JCFG.rope_theta)
    assert_close(got, want)


def test_mlp_apply_matches_jax():
    jp, tp = _params(JL.mlp_specs, 2)
    x = np.random.default_rng(2).standard_normal((2, 5, CFG.d_model), dtype=np.float32)
    assert_close(L.mlp_apply(tp, _t(x)), JL.mlp_apply(CTX, jp, jnp.asarray(x)))


def test_attn_apply_prefill_and_decode_match_jax():
    jp, tp = _params(JL.attn_specs, 3)
    rng = np.random.default_rng(3)
    B, S, S_max = 2, 9, 12
    x = rng.standard_normal((B, S, CFG.d_model), dtype=np.float32)
    want, jcache = JL.attn_apply(CTX, JCFG, jp, jnp.asarray(x), mode="prefill")
    cache = {k: torch.zeros(B, S_max, CFG.kv_cache_width) for k in ("k", "v")}
    got, cache2 = L.attn_apply(CFG, tp, _t(x), mode="prefill", cache=cache)
    assert cache2["k"] is cache["k"]
    assert_close(got, want)
    for k in ("k", "v"):
        assert_close(cache[k][:, :S], jcache[k])
        assert not cache[k][:, S:].any()

    jc = {k: jnp.pad(v, ((0, 0), (0, S_max - S), (0, 0))) for k, v in jcache.items()}
    for pos in range(S, S_max):
        xd = rng.standard_normal((B, CFG.d_model), dtype=np.float32)
        want, jc = JL.attn_apply(CTX, JCFG, jp, jnp.asarray(xd), mode="decode",
                                 cache=jc, pos=jnp.int32(pos))
        got, cache = L.attn_apply(CFG, tp, _t(xd), mode="decode", cache=cache, pos=pos)
        assert_close(got, want)
        for k in ("k", "v"):
            assert_close(cache[k], jc[k])       # row written at pos, in place


def test_attn_apply_paged_decode_matches_jax_dense_decode():
    """One lane over a shuffled page pool, the layer's pages a strided view of
    a stacked store (3 layers, this one the middle): each decode writes its
    row into the page slot of ``pos`` and equals the JAX dense decode."""
    jp, tp = _params(JL.attn_specs, 5)
    rng = np.random.default_rng(5)
    K, hd, page, n_layers, S, S_max = CFG.n_kv_heads, CFG.resolved_head_dim, 4, 3, 5, 11
    x = rng.standard_normal((1, S, CFG.d_model), dtype=np.float32)
    _, jcache = JL.attn_apply(CTX, JCFG, jp, jnp.asarray(x), mode="prefill")
    jc = {k: jnp.pad(v, ((0, 0), (0, S_max - S), (0, 0))) for k, v in jcache.items()}
    pages = [5, 1, 3]                          # covers S_max = 11 positions
    stores = {k: torch.zeros(7, page, n_layers * K * hd) for k in "kv"}
    views = {k: st.view(7, page, n_layers, K, hd)[:, :, 1] for k, st in stores.items()}
    for k in "kv":
        rows = np.asarray(jcache[k])[0].reshape(S, K, hd)
        for t in range(S):
            views[k][pages[t // page], t % page] = _t(rows[t])
    for pos in range(S, S_max):
        xd = rng.standard_normal((1, CFG.d_model), dtype=np.float32)
        want, jc = JL.attn_apply(CTX, JCFG, jp, jnp.asarray(xd), mode="decode",
                                 cache=jc, pos=jnp.int32(pos))
        lane = {"table": torch.tensor([pages], dtype=torch.int32),
                "lengths": torch.tensor([pos + 1], dtype=torch.int32),
                "slot": (pages[pos // page], pos % page)}
        got, _ = L.attn_apply(CFG, tp, _t(xd), mode="paged_decode",
                              cache={**views, **lane}, pos=pos)
        assert_close(got, want)
        for k in "kv":
            assert_close(views[k][lane["slot"]], np.asarray(jc[k])[0, pos].reshape(K, hd))
    for k in "kv":                              # the other layers stay untouched
        assert not stores[k].view(7, page, n_layers, K, hd)[:, :, [0, 2]].any()
    with pytest.raises(ValueError, match="one lane"):
        L.attn_apply(CFG, tp, torch.zeros(2, CFG.d_model), mode="paged_decode",
                     cache={**views, **lane}, pos=S)


def test_attn_apply_rejects_unknown_mode():
    _, tp = _params(JL.attn_specs, 4)
    cache = {k: torch.zeros(1, 4, CFG.kv_cache_width) for k in ("k", "v")}
    with pytest.raises(ValueError, match="mode"):
        L.attn_apply(CFG, tp, torch.zeros(1, 4, CFG.d_model), mode="score", cache=cache)
    # 'train' is a mode since the port trains: the prefill's attention, no cache
    out, none = L.attn_apply(CFG, tp, torch.zeros(1, 4, CFG.d_model), mode="train",
                             cache=None)
    assert none is None and out.shape == (1, 4, CFG.d_model)
