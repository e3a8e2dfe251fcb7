"""The port's GLA, ring-window decode and SSD mixer against the JAX package's
on the same numpy inputs (hymba's smoke config, float32), and the no-fallback
rule of the new dispatchers.

Tolerances, float32 on both sides:
- 1e-5 between the port's plain GLA and the reference's ``chunked_gla``,
  ``gla_chunk`` or ``gla_chunk_parallel`` (interpret mode): the same chunked
  math, only the einsum and scan order differ, on outputs of magnitude ~10;
- in bf16, one bf16 ulp at the output's largest magnitude between the two
  chunk-parallel schedules: both round the intra part and the output to
  bf16 at the same points, so float32 noise can move a rounding by one ulp;
- 5e-4 against the step-by-step ``naive_gla``, tests/test_kernels.py's GLA
  tolerance: the chunked form sums exp(cum_i - cum_j)-weighted terms where
  the recurrence multiplies decays step by step;
- 1e-4 (tests/conftest.py assert_close) for the layers and the mixer,
  whose matmuls run in another order.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import mlstm_chunk  # noqa: E402
from repro.kernels.mlstm_chunk import gla_chunk as pallas_gla  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import gla_chunk as GC  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402

torch.set_num_threads(1)
CFG, JCFG = smoke_config("hymba-1.5b"), jax_smoke_config("hymba-1.5b")
CTX = ShardingCtx(None, rules_for(JCFG, "decode"))
TOL_CHUNKED = 1e-5
TOL_NAIVE = 5e-4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


def _gla_inputs(B, H, S, N, P, seed, broadcast=False):
    """tests/test_kernels.py's GLA input distributions, from numpy.
    ``broadcast``: one q and k row per position shared by every head, as
    the SSD mixer gives them."""
    rng = np.random.default_rng(seed)
    hq = 1 if broadcast else H
    q = rng.standard_normal((B, S, hq, N), dtype=np.float32)
    k = rng.standard_normal((B, S, hq, N), dtype=np.float32) * 0.3
    v = rng.standard_normal((B, S, H, P), dtype=np.float32)
    lg = -np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32))) * 0.3
    if broadcast:
        q, k = (np.broadcast_to(x, (B, S, H, N)) for x in (q, k))
    return q, k, v, lg.astype(np.float32)


GLA_SHAPES = [
    (2, 3, 64, 8, 32, 16, False),
    (1, 2, 40, 8, 32, 16, False),      # 40 % 16 != 0: chunk halved to 8
    (1, 2, 96, 16, 64, 64, True),      # 96 % 64 != 0: chunk 32; head-broadcast q/k
    (2, 2, 24, 16, 64, 256, False),    # chunk > S: one chunk of 24
]


@pytest.mark.parametrize("schedule", ["chunk", "parallel"])
@pytest.mark.parametrize("B,H,S,N,P,chunk,broadcast", GLA_SHAPES)
def test_plain_gla_matches_jax(B, H, S, N, P, chunk, broadcast, schedule):
    q, k, v, lg = _gla_inputs(B, H, S, N, P, S + N, broadcast)
    if broadcast:       # the mixer's head-stride-0 views
        tq, tk = (torch.from_numpy(np.array(x[:, :, :1])).expand(B, S, H, N)
                  for x in (q, k))
    else:
        tq, tk = (torch.from_numpy(x) for x in (q, k))
    y, state = ops.gla(tq, tk, _t(v), _t(lg), chunk=chunk, schedule=schedule)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, N, P)
    assert state.dtype == torch.float32
    jq, jk, jv, jlg = (jnp.asarray(x) for x in (q, k, v, lg))
    jy, jstate = JS.chunked_gla(jq, jk, jv, jlg, chunk=chunk)
    _close(y, jy, TOL_CHUNKED)
    _close(state, jstate, TOL_CHUNKED)
    _close(y, pallas_gla(jq, jk, jv, jlg, chunk=chunk, interpret=True), TOL_CHUNKED)
    ny, nh = jref.naive_gla(jq, jk, jv, jlg)
    _close(y, ny, TOL_NAIVE)
    _close(state, nh, TOL_NAIVE)                 # the final state
    oy, oh = ref.naive_gla(tq, tk, _t(v), _t(lg))
    _close(oy, ny, TOL_CHUNKED)
    _close(oh, nh, TOL_CHUNKED)


@pytest.fixture
def pallas_parallel(monkeypatch):
    """The reference's ``gla_chunk_parallel`` in interpret mode. It names
    ``pltpu.TPUCompilerParams``, which this jax calls ``CompilerParams``;
    the alias lives for this test only."""
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    return functools.partial(mlstm_chunk.gla_chunk_parallel, interpret=True)


PARALLEL_SHAPES = [
    (2, 3, 64, 8, 32, 16, False),
    (1, 2, 40, 8, 32, 16, False),      # chunk halved to 8
    (1, 2, 96, 16, 64, 64, True),      # chunk halved to 32; head-broadcast q/k
    (2, 2, 64, 16, 64, 32, False),
]


def _both(q, k, v, lg, broadcast, dtype):
    """The same numpy inputs as torch tensors (q/k as head-stride-0 views
    when ``broadcast``) and as jax arrays, q, k, v in ``dtype``."""
    B, S, H, N = q.shape
    if broadcast:
        tq, tk = (torch.from_numpy(np.array(x[:, :, :1])).expand(B, S, H, N) for x in (q, k))
    else:
        tq, tk = (torch.from_numpy(x) for x in (q, k))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ((tq.to(dtype), tk.to(dtype), _t(v).to(dtype), _t(lg)),
            tuple(jnp.asarray(x).astype(jdt) for x in (q, k, v)) + (jnp.asarray(lg),))


def _bf16_ulp(x):
    """One bf16 ulp at the largest magnitude of ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(x, np.float32)).max())) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,N,P,chunk,broadcast", PARALLEL_SHAPES)
def test_plain_parallel_schedule_matches_the_reference_one(pallas_parallel, B, H, S, N, P,
                                                           chunk, broadcast, dtype):
    """The port's plain K5 schedule (phase A, the scan in chunk order,
    phase B) against the reference's Pallas phases around its associative
    scan: float32 within TOL_CHUNKED; bf16, where both round the intra part
    and the output, within one bf16 ulp of the output's magnitude."""
    t, j = _both(*_gla_inputs(B, H, S, N, P, S + N + 2, broadcast), broadcast, dtype)
    y, final = ref.gla_chunk_parallel(*t, chunk=chunk)
    assert y.dtype == dtype and y.shape == (B, S, H, P) and final.shape == (B, H, N, P)
    want = np.asarray(pallas_parallel(*j, chunk=chunk).astype(jnp.float32))
    got = y.float().numpy()
    if dtype == torch.float32:
        _close(got, want, TOL_CHUNKED)
    else:
        assert np.abs(got - want).max() <= _bf16_ulp(want)


@pytest.mark.parametrize("B,H,S,N,P,chunk,broadcast", [PARALLEL_SHAPES[0], PARALLEL_SHAPES[2]])
def test_bf16_schedule_gap_is_the_references(pallas_parallel, B, H, S, N, P, chunk, broadcast):
    """Witness: in bf16 the port's two plain schedules sit no farther apart
    than twice the reference's own two Pallas schedules on the same inputs
    (the schedules differ in where they round to bf16, in both packages)."""
    t, j = _both(*_gla_inputs(B, H, S, N, P, S + N + 3, broadcast), broadcast, torch.bfloat16)
    port_gap = (ref.chunked_gla(*t, chunk=chunk)[0].float()
                - ref.gla_chunk_parallel(*t, chunk=chunk)[0].float()).abs().max().item()
    ref_gap = float(jnp.abs(pallas_gla(*j, chunk=chunk, interpret=True).astype(jnp.float32)
                            - pallas_parallel(*j, chunk=chunk).astype(jnp.float32)).max())
    print(f"bf16 chunk-vs-parallel gap: port {port_gap:.3e}, reference {ref_gap:.3e}")
    assert ref_gap > 0 and port_gap <= 2 * ref_gap


@pytest.mark.parametrize("S,chunk", [(64, 16), (40, 16), (96, 64), (24, 256), (1536, 256),
                                     (7, 4), (1, 8)])
def test_chunk_rule_is_the_reference_one(S, chunk):
    c = min(chunk, S)
    while S % c:
        c //= 2
    assert ref.chunk_len(S, chunk) == c
    assert GC.chunk_len(S, chunk) == c
    assert S % c == 0


@pytest.mark.parametrize("nc", [1, 3, 6])
def test_kernel_path_scan_equals_the_plain_scan(nc):
    # K5's scan (plain torch on the card's path) is its own copy of the
    # plain version's: the same chunk order, so equal bit for bit
    rng = np.random.default_rng(nc)
    g = torch.from_numpy(np.exp(-rng.random((2, 3, nc))).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((2, 3, nc, 8, 32)).astype(np.float32))
    start, final = GC.scan_chunks(g, d)
    want_start, want_final = ref.gla_scan(g, d)
    assert torch.equal(start, want_start) and torch.equal(final, want_final)


def test_parallel_phases_compose_to_the_chunked_schedule():
    q, k, v, lg = (_t(x) for x in _gla_inputs(2, 3, 64, 8, 32, 1))
    y_intra, g, d = ref.gla_phase_a(q, k, v, lg, chunk=16)
    assert g.shape == (2, 3, 4) and d.shape == (2, 3, 4, 8, 32)
    start, final = ref.gla_scan(g, d)
    assert not start[:, :, 0].any()
    # each chunk's start state is the chunked schedule's state after the
    # chunks before it
    for j in range(1, 4):
        _, s_j = ref.chunked_gla(q[:, :16 * j], k[:, :16 * j], v[:, :16 * j],
                                 lg[:, :16 * j], chunk=16)
        _close(start[:, :, j], s_j, TOL_CHUNKED)
    y = ref.gla_phase_b(q, lg, start, y_intra, chunk=16)
    yc, sc = ref.chunked_gla(q, k, v, lg, chunk=16)
    _close(y, yc, TOL_CHUNKED)
    _close(final, sc, TOL_CHUNKED)


@pytest.mark.parametrize("W,window,pos", [(16, 16, 5), (16, 16, 15), (16, 16, 100),
                                          (40, 32, 37), (40, 32, 90), (12, 32, 50)])
def test_ring_decode_matches_jax_window_decode(W, window, pos):
    B, H, K, D = 2, 4, 2, 32
    rng = np.random.default_rng(pos + W)
    q = rng.standard_normal((B, H * D), dtype=np.float32)
    kc = rng.standard_normal((B, W, K * D), dtype=np.float32)
    vc = rng.standard_normal((B, W, K * D), dtype=np.float32)
    want = JL.window_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.int32(pos), n_kv_heads=K, window=window)
    got = ops.window_decode_attention(_t(q).view(B, H, D), _t(kc).view(B, W, K, D),
                                      _t(vc).view(B, W, K, D), pos, window=window)
    _close(got.reshape(B, H * D), want, TOL_CHUNKED)
    np.testing.assert_array_equal(L.ring_slot_positions(pos, W).numpy(),
                                  np.asarray(JL.ring_slot_positions(jnp.int32(pos), W)))


def test_conv_and_groupnorm_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 80), dtype=np.float32)
    w = rng.standard_normal((4, 80), dtype=np.float32)
    assert_close(L.causal_conv1d(_t(x), _t(w)), JL.causal_conv1d(jnp.asarray(x),
                                                                   jnp.asarray(w)))
    st = rng.standard_normal((2, 3, 80), dtype=np.float32)
    out, new = L.causal_conv1d_step(_t(x[:, 0]), _t(st), _t(w))
    jout, jnew = JL.causal_conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(st), jnp.asarray(w))
    assert_close(out, jout)
    assert_close(new, jnew)
    g = rng.standard_normal((64,), dtype=np.float32)
    assert_close(L.rms_groupnorm(_t(x[..., :64]) * 3, _t(g), 2),
                 JL.rms_groupnorm(jnp.asarray(x[..., :64]) * 3, jnp.asarray(g), 2))


@pytest.fixture(scope="module")
def ssd_params():
    jp = jax_init_params(JS.ssd_specs(JCFG), jax.random.key(4), jnp.float32)
    # non-trivial decays and skips (the init leaves them zeros and ones)
    rng = np.random.default_rng(4)
    for name in ("a_log", "dt_bias", "d_skip"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape, dtype=np.float32) * 0.5)
    return jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("schedule", ["chunk", "parallel"])
@pytest.mark.parametrize("S", [20, 13])          # 13: the smoke chunk 8 halved to 1
def test_ssd_apply_prefill_and_decode_match_jax(ssd_params, schedule, S):
    jp, tp = ssd_params
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, CFG.d_model), dtype=np.float32)
    jout, jcache = JS.ssd_apply(CTX, JCFG, jp, jnp.asarray(x), mode="prefill")
    cache = {k: torch.zeros((2, *shape), dtype=getattr(torch, dt))
             for k, (shape, dt) in SSM.cache_shapes(CFG).items()}
    out, cache = SSM.ssd_apply(CFG, tp, _t(x), mode="prefill", cache=cache,
                               schedule=schedule)
    assert_close(out, jout)
    for name in ("state", "conv"):
        assert cache[name].shape == jcache[name].shape
        assert_close(cache[name], jcache[name], msg=name)
    assert cache["state"].dtype == torch.float32
    for i in range(3):
        xd = rng.standard_normal((2, CFG.d_model), dtype=np.float32)
        jout, jcache = JS.ssd_apply(CTX, JCFG, jp, jnp.asarray(xd), mode="decode",
                                    cache=jcache)
        out, cache = SSM.ssd_apply(CFG, tp, _t(xd), mode="decode", cache=cache)
        assert_close(out, jout, msg=f"decode step {i}")
        for name in ("state", "conv"):
            assert_close(cache[name], jcache[name], msg=f"{name} after step {i}")


def test_ssd_prefill_shorter_than_the_conv_raises(ssd_params):
    _, tp = ssd_params
    cache = {k: torch.zeros((1, *shape)) for k, (shape, _) in SSM.cache_shapes(CFG).items()}
    with pytest.raises(ValueError, match="d_conv - 1"):
        SSM.ssd_apply(CFG, tp, torch.zeros(1, CFG.ssm.d_conv - 2, CFG.d_model),
                      mode="prefill", cache=cache)


def test_gla_step_matches_jax():
    rng = np.random.default_rng(6)
    q, k = (rng.standard_normal((2, 3, 8), dtype=np.float32) for _ in range(2))
    v = rng.standard_normal((2, 3, 32), dtype=np.float32)
    lg = -np.abs(rng.standard_normal((2, 3), dtype=np.float32))
    st = rng.standard_normal((2, 3, 8, 32), dtype=np.float32)
    y, s = SSM.gla_step(*(_t(a) for a in (q, k, v, lg, st)))
    jy, js = JS.gla_step(*(jnp.asarray(a) for a in (q, k, v, lg, st)))
    assert_close(y, jy)
    assert_close(s, js)


def test_new_dispatch_cpu_takes_plain_version_and_never_falls_back():
    q, k, v, lg = (_t(x) for x in _gla_inputs(1, 2, 16, 8, 32, 3))
    before = (GC.launches, GC.launches_a, GC.launches_b, DA.ring_launches)
    y, s = ops.gla(q, k, v, lg, chunk=8)
    torch.testing.assert_close(y, ref.chunked_gla(q, k, v, lg, chunk=8)[0])
    y, s = ops.gla(q, k, v, lg, chunk=8, schedule="parallel", force="ref")
    torch.testing.assert_close(y, ref.gla_chunk_parallel(q, k, v, lg, chunk=8)[0])
    kr = torch.randn(1, 8, 2, 32)
    qd = torch.randn(1, 4, 32)
    torch.testing.assert_close(ops.window_decode_attention(qd, kr, kr, 11, window=4),
                               ref.naive_ring_decode_attention(qd, kr, kr, 11, window=4))
    assert (GC.launches, GC.launches_a, GC.launches_b, DA.ring_launches) == before
    for schedule in ("chunk", "parallel"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.gla(q, k, v, lg, chunk=8, schedule=schedule, force="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.window_decode_attention(qd, kr, kr, 11, window=4, force="kernel")
    with pytest.raises(ValueError, match="schedule"):
        ops.gla(q, k, v, lg, chunk=8, schedule="scan")


@pytest.mark.parametrize("fn", ["gla_chunk", "gla_phase_a", "gla_phase_b",
                                "ring_decode_attention"])
def test_new_kernel_wrappers_refuse_cpu_tensors(fn):
    q, k, v, lg = (_t(x) for x in _gla_inputs(1, 2, 16, 8, 32, 3))
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "gla_phase_b":
            GC.gla_phase_b(q, lg, torch.zeros(1, 2, 2, 8, 32), v, chunk=8)
        elif fn == "ring_decode_attention":
            DA.ring_decode_attention(torch.randn(1, 4, 32), torch.randn(1, 8, 2, 32),
                                     torch.randn(1, 8, 2, 32), 3, window=4)
        else:
            getattr(GC, fn)(q, k, v, lg, chunk=8)
