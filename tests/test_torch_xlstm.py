"""The port's xLSTM (xlstm-350m) against the JAX package's: the config copy,
the spec trees, the mLSTM's chunked form and step, the sLSTM cell and its
scan's plain version, both blocks in prefill and decode, the model's
prefill and decode logits with every cache leaf through the ``Server``,
the reference's decode-vs-prefill and cached-generation checks, the
params' transfer and the CLI, from the same numpy inputs (the smoke config,
float32: 4 layers as 2 pairs, d_model 128, 2 heads, mLSTM chunk 8).

Tolerances: 1e-4 (tests/conftest.py assert_close) for float32 paths over
a few layers (another matmul and reduction order); 2e-5 for a single
function; bf16 functions 2e-2 (one rounding of an output near 1 is 2^-8,
and the two frameworks round bf16 products in their own order).

Prompt lengths avoid 2, 3 and 128, where the JAX ``Server``'s ``pad_to``
heuristic (it grows every leaf whose axis -2 equals the prompt's length)
would grow the sLSTM state (H = 2), the conv rows (3) or the mLSTM's C (N =
128), and the batch (m's axis -2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from conftest import assert_close  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving.engine import Server as JaxServer  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import slstm_scan as SL  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)
ARCH = "xlstm-350m"
CFG, JCFG = configs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
#: (prompt length, pad_to, decode steps)
CASES = [(20, 28, 6), (16, 16, 5), (9, 40, 8)]


def _is_spec(x):
    return type(x).__name__ == "ParamSpec"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def jparams():
    """The JAX model's seed-0 params at the smoke config, numpy leaves."""
    return jax.tree.map(np.asarray, JaxModel(JCFG).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def params(jparams):
    return from_jax_params(jparams, CFG, "cpu")


def _ctx(mode="decode"):
    return ShardingCtx(None, rules_for(JCFG, mode))


# -- config and specs ----------------------------------------------------------------

@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
def test_config_copy_equals_jax_config(fn):
    got, want = getattr(configs, fn)(ARCH), getattr(jconfigs, fn)(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.param_count(), got.subquadratic) == \
        (want.padded_vocab, want.param_count(), want.subquadratic)
    assert ARCH in configs.ARCH_IDS


@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
def test_model_specs_match_jax_leaf_for_leaf(fn):
    cfg, jcfg = getattr(configs, fn)(ARCH), getattr(jconfigs, fn)(ARCH)
    got = tree_leaves(T.model_specs(cfg))
    want = jax.tree.leaves(JT.model_specs(jcfg), is_leaf=_is_spec)
    assert [(tuple(s.shape), s.axes, s.init, s.scale) for s in got] == \
        [(tuple(s.shape), s.axes, s.init, s.scale) for s in want]
    assert [(s.kind, s.n, s.scanned, s.window) for s in T.plan_segments(cfg)] == \
        [(s.kind, s.n, s.scanned, s.window) for s in JT.plan_segments(jcfg)]


def test_full_width_plan_and_cache_geometry():
    """xlstm-350m: 12 stacked pairs; every cache leaf by its kind, none of
    which depends on max_len; r_gates [H, dh, 4dh]."""
    cfg = configs.get_config(ARCH)
    assert [(s.kind, s.n, s.scanned) for s in T.plan_segments(cfg)] == [("xlstm_pair", 12, True)]
    sp = T.model_specs(cfg)["segments"][0]
    assert sp["slstm"]["r_gates"].shape == (12, 4, 256, 1024)
    assert sp["mlstm"]["w_up"].shape == (12, 1024, 4096)
    assert sp["slstm"]["ff_w1"].shape == (12, 1024, 1408)
    a, b = (T.alloc_caches(cfg, 4, n, "meta") for n in (1056, 7))
    shapes = {"mlstm": {"C": (12, 4, 4, 512, 512), "n": (12, 4, 4, 512), "m": (12, 4, 4),
                        "conv": (12, 4, 3, 2048)},
              "slstm": {"c": (12, 4, 4, 256), "n": (12, 4, 4, 256), "m": (12, 4, 4, 256),
                        "h": (12, 4, 4, 256), "conv": (12, 4, 3, 1024)}}
    for blk, leaves in shapes.items():
        for k, shape in leaves.items():
            assert tuple(a[0][blk][k].shape) == tuple(b[0][blk][k].shape) == shape
            assert a[0][blk][k].dtype == (torch.bfloat16 if k == "conv" else torch.float32)
    assert T.cache_capacity(a) is None


def test_trainer_and_unported_modes_refuse_xlstm():
    """What the port still refuses: a multi-codebook frontend (musicgen's)
    in ``check_trainable``, a mode outside train/prefill/decode in both
    xLSTM blocks, an odd number of layers (no whole mLSTM + sLSTM pairs)."""
    T.check_trainable(CFG)
    with pytest.raises(NotImplementedError, match="ported so far"):
        T.check_trainable(dataclasses.replace(CFG, n_codebooks=4))
    for apply in (X.mlstm_apply, X.slstm_apply):
        with pytest.raises(NotImplementedError, match="mode 'paged_decode'"):
            apply(CFG, {}, torch.zeros(1, 4, CFG.d_model), mode="paged_decode", cache=None)
    with pytest.raises(NotImplementedError):
        T.plan_segments(dataclasses.replace(CFG, n_layers=3))


# -- the mLSTM -------------------------------------------------------------------------

def _mlstm_inputs(B, S, H, N, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32) for _ in range(3))
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) + 2).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("S,chunk", [(16, 8), (20, 8), (7, 8), (1, 8), (24, 256)])
def test_chunked_mlstm_matches_jax(S, chunk):
    # 20 shrinks the chunk to 4, 7 runs one chunk of 7
    ins = _mlstm_inputs(2, S, 2, 16, S)
    h, (C, n, m) = SSM.chunked_mlstm(*map(_t, ins), chunk=chunk)
    jh, (jC, jn, jm) = JS.chunked_mlstm(*map(jnp.asarray, ins), chunk=chunk)
    for a, b in ((h, jh), (C, jC), (n, jn), (m, jm)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-5, atol=2e-5)
    assert C.dtype == n.dtype == m.dtype == torch.float32


def test_mlstm_step_matches_jax():
    q, k, v, ig, fg = (a[:, 0] for a in _mlstm_inputs(2, 1, 2, 16, 5))
    rng = np.random.default_rng(6)
    state = (rng.standard_normal((2, 2, 16, 16)).astype(np.float32),
             rng.standard_normal((2, 2, 16)).astype(np.float32),
             rng.standard_normal((2, 2)).astype(np.float32))
    got = SSM.mlstm_step(*map(_t, (q, k, v, ig, fg)), tuple(map(_t, state)))
    want = JS.mlstm_step(*map(jnp.asarray, (q, k, v, ig, fg)), tuple(map(jnp.asarray, state)))
    for a, b in zip([got[0], *got[1]], jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-5, atol=2e-5)


def test_mlstm_steps_continue_the_chunked_state():
    """chunked(S) then steps equals chunked(S + n) (the decode's state is
    the prefill's), the port's own consistency."""
    q, k, v, ig, fg = map(_t, _mlstm_inputs(1, 12, 2, 16, 7))
    h_all, st_all = SSM.chunked_mlstm(q, k, v, ig, fg, chunk=4)
    h, st = SSM.chunked_mlstm(q[:, :8], k[:, :8], v[:, :8], ig[:, :8], fg[:, :8], chunk=4)
    for t in range(8, 12):
        ht, st = SSM.mlstm_step(q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t], st)
        assert_close(ht, h_all[:, t])
    for a, b in zip(st, st_all):
        assert_close(a, b)


# -- the sLSTM -------------------------------------------------------------------------

def _slstm_inputs(B, S, H, dh, seed, r_scale=None):
    rng = np.random.default_rng(seed)
    wx = rng.standard_normal((B, S, 4 * H * dh)).astype(np.float32)
    r = (rng.standard_normal((H, dh, 4 * dh)) * (r_scale or dh ** -0.5)).astype(np.float32)
    return wx, r


def _jax_run_scan(wx, r, H, dh):
    """The reference's ``run_scan`` (models/xlstm.py:145-161), its body
    copied as it stands there, over its own ``_slstm_cell``."""
    B = wx.shape[0]
    d = H * dh

    def body(state, w):
        rh = jnp.einsum("bhj,hjg->bhg", state[3].astype(w.dtype), r)
        gates = w + rh.reshape(B, 4 * d)
        new = JX._slstm_cell(gates, state, H, dh)
        return new, new[3]

    z0 = jnp.zeros((B, H, dh), jnp.float32)
    state0 = (z0, z0 + 1e-6, jnp.full((B, H, dh), -1e30, jnp.float32), z0)
    state, hs = jax.lax.scan(body, state0, jnp.moveaxis(wx, 1, 0))
    return jnp.moveaxis(hs, 0, 1).astype(wx.dtype), state


def test_slstm_cell_matches_jax():
    B, H, dh = 3, 2, 8
    rng = np.random.default_rng(8)
    gates = rng.standard_normal((B, 4 * H * dh)).astype(np.float32) * 3
    state = tuple(rng.standard_normal((B, H, dh)).astype(np.float32) for _ in range(4))
    state = (state[0], np.abs(state[1]), state[2], state[3])
    got = ref.slstm_cell(_t(gates), tuple(map(_t, state)), H, dh)
    want = JX._slstm_cell(jnp.asarray(gates), tuple(map(jnp.asarray, state)), H, dh)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dh", [(2, 17, 2, 64), (1, 40, 4, 32)])
def test_plain_slstm_scan_matches_jax_run_scan(B, S, H, dh, dtype):
    wx, r = _slstm_inputs(B, S, H, dh, S)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jhs, jst = _jax_run_scan(jnp.asarray(wx).astype(jt), jnp.asarray(r).astype(jt), H, dh)
    tt = getattr(torch, dtype)
    hs, st = ops.slstm_scan(_t(wx).to(tt), _t(r).to(tt), ref.slstm_state0(B, H, dh, "cpu"))
    assert hs.dtype == tt and tuple(hs.shape) == (B, S, H, dh)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(hs), np.asarray(jhs.astype(jnp.float32)), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(st[3]), np.asarray(jst[3]), rtol=tol, atol=tol)
    for a, b in zip(st[:3], jst[:3]):
        b = np.asarray(b)
        assert np.abs(_np(a) - b).max() <= tol * np.abs(b).max()


def test_plain_slstm_scan_splits_and_rows_are_independent():
    """The kernel's bit-equalities hold for its plain version on the CPU too
    (same inputs, same per-row order): scan(S + 1) is scan(S) then
    scan(1), and a row alone is its batched row."""
    wx, r = map(_t, _slstm_inputs(3, 9, 2, 32, 9))
    st0 = ref.slstm_state0(3, 2, 32, "cpu")
    hs, st = ref.slstm_scan(wx, r, st0)
    hs8, st8 = ref.slstm_scan(wx[:, :8], r, st0)
    hs1, st1 = ref.slstm_scan(wx[:, 8:], r, st8)
    assert_close(torch.cat([hs8, hs1], 1), hs)
    for a, b in zip(st1, st):
        assert_close(a, b)


def test_ops_slstm_scan_on_cpu_takes_the_plain_version_and_kernel_refuses_it():
    wx, r = map(_t, _slstm_inputs(1, 3, 2, 32, 1))
    st0 = ref.slstm_state0(1, 2, 32, "cpu")
    n0 = SL.launches
    got, want = ops.slstm_scan(wx, r, st0), ref.slstm_scan(wx, r, st0)
    assert torch.equal(got[0], want[0]) and SL.launches == n0
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.slstm_scan(wx, r, st0, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        SL.slstm_scan(wx, r, st0)


# -- the blocks ------------------------------------------------------------------------

def _block_params(jparams, blk):
    """Layer 1's ``blk`` params: numpy for JAX, tensors for the port."""
    jp = jax.tree.map(lambda a: a[1], jparams["segments"][0][blk])
    return jax.tree.map(jnp.asarray, jp), {k: _t(v) for k, v in jp.items()}


def _zero_cache(blk, B):
    return {k: torch.zeros((B, *shape), dtype=getattr(torch, dt))
            for k, (shape, dt) in X.cache_shapes(CFG)[blk].items()}


@pytest.mark.parametrize("blk", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match_jax(jparams, blk):
    B, S = 2, 13
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, S + 2, CFG.d_model)).astype(np.float32)
    jp, tp = _block_params(jparams, blk)
    japply = JX.mlstm_apply if blk == "mlstm" else JX.slstm_apply
    tapply = X.mlstm_apply if blk == "mlstm" else X.slstm_apply
    jout, jc = japply(_ctx("prefill"), JCFG, jp, jnp.asarray(x[:, :S]), mode="prefill")
    cache = _zero_cache(blk, B)
    out, _ = tapply(CFG, tp, _t(x[:, :S]), mode="prefill", cache=cache)
    assert_close(out, _t(jout))
    for k in cache:
        assert_close(cache[k], _t(jc[k]))
    for t in (S, S + 1):
        jout, jc = japply(_ctx(), JCFG, jp, jnp.asarray(x[:, t]), mode="decode", cache=jc)
        out, _ = tapply(CFG, tp, _t(x[:, t]), mode="decode", cache=cache)
        assert_close(out, _t(jout))
        for k in cache:
            assert_close(cache[k], _t(jc[k]))


def test_prefill_shorter_than_the_conv_raises(params):
    with pytest.raises(ValueError, match="d_conv"):
        Model(CFG).prefill(params, torch.zeros((1, 2), dtype=torch.int64))


# -- the model through the Server ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_server():
    return JaxServer(JCFG, seed=0)


@pytest.mark.parametrize("S,pad_to,steps", CASES)
def test_server_prefill_decode_and_caches_match_jax(jax_server, jparams, params, S, pad_to,
                                                    steps):
    """Prefill logits, every cache leaf after the prefill and after each
    decode step, and decode logits, against the JAX Server on the same
    params; then both Servers' greedy streams are equal. The port decodes
    past ``pad_to`` (no leaf grows with the sequence: no capacity)."""
    prompts = np.random.default_rng(S).integers(0, CFG.vocab_size, (2, S), dtype=np.int32)
    js = jax_server
    jl = js.prefill(prompts, pad_to=pad_to)
    srv = Server(CFG, device="cpu", params=params)
    tl = srv.prefill(prompts, pad_to=pad_to)
    assert srv.max_len is None
    assert_close(tl, _t(jl))
    for a, b in zip(tree_leaves(srv.caches), jax.tree.leaves(js.caches)):
        assert tuple(a.shape) == b.shape
        assert_close(a, _t(b))
    tok = np.argmax(np.asarray(jl)[:, : CFG.vocab_size], -1).astype(np.int32)
    for i in range(steps):
        jlog, js.caches = js.decode_fn(js.params, jnp.asarray(tok), jnp.int32(S + i), js.caches)
        tlog, srv.caches = srv.decode_fn(srv.params, torch.as_tensor(tok).long(), S + i,
                                         srv.caches)
        assert_close(tlog, _t(jlog))
        for a, b in zip(tree_leaves(srv.caches), jax.tree.leaves(js.caches)):
            assert_close(a, _t(b))
        tok = np.argmax(np.asarray(jlog)[:, : CFG.vocab_size], -1).astype(np.int32)
    first = np.argmax(np.asarray(jl)[:, : CFG.vocab_size], -1).astype(np.int32)
    js.prefill(prompts, pad_to=pad_to)
    srv.prefill(prompts, pad_to=pad_to)
    jt, _ = js.decode(steps + 4, first)
    tt, _ = srv.decode(steps + 4, first)
    np.testing.assert_array_equal(np.stack(tt), np.stack([np.asarray(t) for t in jt]))


def test_decode_matches_prefill(params):
    """tests/test_models_smoke.py::test_smoke_decode_matches_prefill on the
    port: a decode step after a prefill of S gives the prefill of S + 1's
    last logits (2e-2 as there; float32 agrees far closer)."""
    m = Model(CFG)
    B, S = 2, 16
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, CFG.vocab_size, (B, S + 1)))
    want, _ = m.prefill(params, toks)
    _, caches = m.prefill(params, toks[:, :S])
    got, _ = m.decode_step(params, toks[:, S], S, caches)
    assert (got - want).abs().max() / want.abs().max() < 2e-2
    assert_close(got, want)


def test_generation_with_cache_matches_reprefill(params):
    """tests/test_models_smoke.py::test_smoke_generation_with_cache on the
    port (2 layers): greedy tokens through the cache equal re-prefilling
    the growing prefix each step."""
    cfg = dataclasses.replace(CFG, n_layers=2)
    m = Model(cfg)
    p = {**params, "segments": [{k: v for k, v in
                                 jax.tree.map(lambda t: t[:1], params["segments"][0]).items()}]}
    B, S, N = 2, 10, 4
    prefix = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)))
    logits, caches = m.prefill(p, prefix)
    tok, cached = torch.argmax(logits[:, : cfg.vocab_size], -1), []
    for i in range(N):
        cached.append(tok)
        logits, caches = m.decode_step(p, tok, S + i, caches)
        tok = torch.argmax(logits[:, : cfg.vocab_size], -1)
    cached.append(tok)
    seq, fresh = prefix, []
    for _ in range(N + 1):
        lg, _ = m.prefill(p, seq)
        t = torch.argmax(lg[:, : cfg.vocab_size], -1)
        fresh.append(t)
        seq = torch.cat([seq, t[:, None]], 1)
    assert all(torch.equal(a, b) for a, b in zip(cached, fresh))


def test_from_jax_params_carries_every_xlstm_leaf(jparams, params):
    """Every leaf (r_gates [n, H, dh, 4dh] included) arrives unchanged, in
    float32 and from the JAX package's bfloat16 alike."""
    got, want = tree_leaves(params), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and torch.equal(a, _t(b))
    assert tuple(params["segments"][0]["slstm"]["r_gates"].shape) == (2, 2, 64, 256)
    cfg16 = dataclasses.replace(CFG, param_dtype="bfloat16")
    p16 = from_jax_params(jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), jparams),
                          cfg16, "cpu")
    r16 = p16["segments"][0]["slstm"]["r_gates"]
    assert r16.dtype == torch.bfloat16
    assert torch.equal(r16.float(), _t(jparams["segments"][0]["slstm"]["r_gates"]
                                      .astype(ml_dtypes.bfloat16).astype(np.float32)))


def _servers(jparams, n_layers, dtype):
    """The JAX and the port Server at ``n_layers`` in ``dtype`` (params,
    compute and caches), on the same params rounded to bfloat16."""
    cfg, jcfg = (dataclasses.replace(c, n_layers=n_layers, param_dtype=dtype,
                                     compute_dtype=dtype, cache_dtype=dtype) for c in (CFG, JCFG))
    jp = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16).astype(getattr(ml_dtypes, dtype)
                                                                     if dtype == "bfloat16"
                                                                     else np.float32), jparams)
    jp["segments"] = [jax.tree.map(lambda a: a[:n_layers // 2], jp["segments"][0])]
    js = JaxServer(jcfg, seed=0)
    js.params = jax.tree.map(jnp.asarray, jp)
    return js, Server(cfg, device="cpu", params=from_jax_params(jp, cfg, "cpu"))


def _logits(js, srv, prompts, n_steps):
    """Both Servers' prefill logits and ``n_steps`` teacher-forced decode
    steps' (the JAX stream's tokens fed to both), float32 numpy."""
    S = prompts.shape[1]
    jl, tl = js.prefill(prompts), srv.prefill(prompts)
    out = [(np.asarray(jl).astype(np.float32), _np(tl))]
    for i in range(n_steps):
        tok = np.argmax(out[-1][0][:, : CFG.vocab_size], -1).astype(np.int32)
        jl, js.caches = js.decode_fn(js.params, jnp.asarray(tok), jnp.int32(S + i), js.caches)
        tl, srv.caches = srv.decode_fn(srv.params, torch.as_tensor(tok).long(), S + i,
                                       srv.caches)
        out.append((np.asarray(jl).astype(np.float32), _np(tl)))
    return out


@pytest.mark.parametrize("n_layers", [2, 4])
def test_bf16_drift_is_the_models_not_the_ports(jparams, n_layers):
    """bf16 on both sides: the two frameworks round bf16 at the same places
    but fuse and order differently (XLA keeps some fused intermediates in
    float32), so the port is held to the JAX package's own bf16 distance
    from the float32 model on the same (bf16-rounded) params. Over the
    prefill and four decode steps, each step's distance (max |a - b| over
    max |b|) is below 0.1 on both sides, and the port's mean distance
    within 1.5 times JAX's: a step's distance swings between half and
    twice the other side's with the rounding, the mean does not."""
    prompts = np.random.default_rng(4).integers(0, CFG.vocab_size, (2, 12), dtype=np.int32)
    f32 = _logits(*_servers(jparams, n_layers, "float32"), prompts, 4)
    b16 = _logits(*_servers(jparams, n_layers, "bfloat16"), prompts, 4)
    drifts = []
    for (truth, port32), (jax16, port16) in zip(f32, b16):
        scale = np.abs(truth).max()
        assert np.abs(port32 - truth).max() <= 1e-4 * scale
        drifts.append((np.abs(jax16 - truth).max() / scale, np.abs(port16 - truth).max() / scale))
    jax_drift, port_drift = np.array(drifts).T
    assert (jax_drift > 0).all() and (np.array(drifts) < 0.1).all(), drifts
    assert port_drift.mean() <= 1.5 * jax_drift.mean(), drifts


def test_cli_serves_xlstm_on_cpu(capsys):
    toks = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "12", "--gen", "5"])
    assert len(toks) == 5 and all(t.shape == (2,) for t in toks)
    assert f"{ARCH}: generated 5 tokens x batch 2 on cpu" in capsys.readouterr().out


def test_cli_snapshot_and_resume_equal_an_uninterrupted_run(tmp_path, capsys):
    args = ["--arch", ARCH, "--device", "cpu", "--batch", "1", "--prompt-len", "6",
            "--gen", "10"]
    whole = serve_cli.main(args)
    head = serve_cli.main(args + ["--ckpt-dir", str(tmp_path), "--snapshot-at", "4"])
    out = capsys.readouterr().out
    assert "serving snapshot at pos 10 -> step_00000010" in out
    tail = serve_cli.main(args + ["--ckpt-dir", str(tmp_path), "--resume",
                                  "--restore-backend", "fabric"])
    assert "resumed step_00000010 mid-sequence at pos 10 under fabric; 6 tokens left" in \
        capsys.readouterr().out
    np.testing.assert_array_equal(np.stack(head), np.stack(whole))
    np.testing.assert_array_equal(np.stack(tail), np.stack(whole[4:]))
