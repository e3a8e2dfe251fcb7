"""The port's hymba model, Server and CLI against the JAX package's: config
copy, param specs, prefill logits and every cache leaf, decode logits over
several steps, and greedy streams, from the same params and prompts
(hymba's smoke config, float32: 3 layers, global layer 1, window 32,
SSD chunk 8), under both GLA schedules.

The prompt lengths cover a prompt longer than the window (40: the ring
rolls by 8), and shorter ones grown by ``pad_to`` into a ring narrower
than the window (20 -> 24) and wider (30 -> 50, where the decode passes
the window). Decoding stops below ``pad_to``, where the global layers'
caches end (the reference's cache write would clamp past it). The
lengths avoid 3 and 8, where the JAX ``Server``'s ``pad_to`` heuristic
would also grow the conv cache or the SSD state.

Tolerance 1e-4 (tests/conftest.py assert_close): float32 on both sides,
different matmul and reduction order over 3 layers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from conftest import assert_close  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import Server as JaxServer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import gla_chunk as GC  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves  # noqa: E402
from repro_torch.serving.engine import ServeEngine, Server  # noqa: E402

torch.set_num_threads(1)
ARCH = "hymba-1.5b"
#: (prompt length, pad_to, decode steps)
CASES = [(40, 44, 4), (20, 24, 4), (30, 50, 6)]


def _is_spec(x):
    return type(x).__name__ == "ParamSpec"


@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
def test_config_copy_equals_jax_config(fn):
    got, want = getattr(configs, fn)(ARCH), getattr(jconfigs, fn)(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.kv_cache_width, got.param_count()) == \
        (want.padded_vocab, want.kv_cache_width, want.param_count())


@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
def test_model_specs_match_jax_leaf_for_leaf(fn):
    cfg, jcfg = getattr(configs, fn)(ARCH), getattr(jconfigs, fn)(ARCH)
    got = tree_leaves(T.model_specs(cfg))
    want = jax.tree.leaves(JT.model_specs(jcfg), is_leaf=_is_spec)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert [(s.kind, s.n, s.scanned, s.window) for s in T.plan_segments(cfg)] == \
        [(s.kind, s.n, s.scanned, s.window) for s in JT.plan_segments(jcfg)]


def test_full_width_plan_and_cache_geometry():
    cfg = configs.get_config(ARCH)
    segs = T.plan_segments(cfg)
    # global layers 0, 15, 31 unstacked; the windowed runs between stacked
    assert [(s.n, s.scanned, s.window) for s in segs] == [
        (1, False, None), (14, True, 1024), (1, False, None), (15, True, 1024),
        (1, False, None)]
    caches = T.alloc_caches(cfg, 4, 1568, "meta", prompt_len=1536)
    assert caches[0]["attn"]["k"].shape == (4, 1568, 320)          # global: max_len
    assert caches[1]["attn"]["k"].shape == (14, 4, 1024, 320)      # ring: the window
    assert caches[1]["ssd"]["state"].shape == (14, 4, 25, 16, 64)
    assert caches[1]["ssd"]["state"].dtype == torch.float32
    assert caches[1]["ssd"]["conv"].shape == (14, 4, 3, 1632)
    assert caches[1]["ssd"]["conv"].dtype == caches[1]["attn"]["k"].dtype == torch.bfloat16
    # a prompt no longer than the window: its rows grown to max_len
    assert T.alloc_caches(cfg, 1, 1100, "meta", prompt_len=1000)[1]["attn"]["k"].shape[2] \
        == 1100


@pytest.fixture(scope="module")
def jax_server():
    return JaxServer(jconfigs.smoke_config(ARCH), backend="mpich", seed=0)


@pytest.fixture(scope="module")
def params(jax_server):
    return from_jax_params(jax.tree.map(np.asarray, jax_server.params),
                           configs.smoke_config(ARCH), "cpu")


@pytest.fixture(scope="module")
def reference(jax_server):
    """Per case: the prompt, the JAX Server's prefill logits and caches
    (grown to pad_to by its heuristic), then teacher-forced decode logits
    and the caches after them, through its jitted decode step."""
    out = {}
    vocab = jax_server.cfg.vocab_size
    for S, pad_to, n in CASES:
        prompt = np.random.default_rng(S).integers(0, vocab, (2, S), dtype=np.int32)
        logits = [np.asarray(jax_server.prefill(prompt, pad_to=pad_to))]
        caches0 = [np.asarray(x) for x in jax.tree.leaves(jax_server.caches)]
        jc = jax_server.caches
        toks = []
        for i in range(n):
            tok = np.argmax(logits[-1][:, :vocab], -1).astype(np.int32)
            toks.append(tok)
            lg, jc = jax_server.decode_fn(jax_server.params, jnp.asarray(tok),
                                          jnp.int32(S + i), jc)
            logits.append(np.asarray(lg))
        out[S] = (prompt, logits, toks, caches0, [np.asarray(x) for x in jax.tree.leaves(jc)])
    return out


@pytest.mark.parametrize("schedule", ["chunk", "parallel"])
@pytest.mark.parametrize("S,pad_to,n", CASES)
def test_prefill_and_decode_match_jax_model(reference, params, S, pad_to, n, schedule):
    cfg = configs.smoke_config(ARCH)
    prompt, want, toks, caches0, caches_n = reference[S]
    m = Model(cfg, gla_schedule=schedule)
    logits, caches = m.prefill(params, torch.from_numpy(prompt).long(), max_len=pad_to)
    assert_close(logits, want[0], msg="prefill logits")
    leaves = tree_leaves(caches)
    assert [tuple(t.shape) for t in leaves] == [c.shape for c in caches0]
    assert [str(t.dtype) for t in leaves] == [f"torch.{c.dtype}" for c in caches0]
    for i, (t, c) in enumerate(zip(leaves, caches0)):
        assert_close(t, c, msg=f"prefill cache leaf {i} {c.shape}")
    for i, tok in enumerate(toks):
        logits, caches = m.decode_step(params, torch.from_numpy(tok).long(), S + i, caches)
        assert_close(logits, want[i + 1], msg=f"decode step {i}")
    for i, (t, c) in enumerate(zip(tree_leaves(caches), caches_n)):
        assert_close(t, c, msg=f"cache leaf {i} after {n} decode steps")


@pytest.mark.parametrize("schedule", ["chunk", "parallel"])
@pytest.mark.parametrize("S,pad_to", [(40, 48), (20, 28)])
def test_greedy_stream_matches_jax_server(jax_server, params, S, pad_to, schedule):
    cfg = configs.smoke_config(ARCH)
    prompt = np.random.default_rng(S + 1).integers(0, cfg.vocab_size, (2, S), dtype=np.int32)
    n = pad_to - S
    jlogits = jax_server.prefill(prompt, pad_to=pad_to)
    jfirst = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    jtoks, _ = jax_server.decode(n - 1, jfirst)
    want = np.stack([jfirst] + [np.asarray(t) for t in jtoks], axis=1)

    srv = Server(cfg, device="cpu", params=params, gla_schedule=schedule)
    logits = srv.prefill(prompt, pad_to=pad_to)
    first = np.argmax(logits[:, : cfg.vocab_size].numpy(), -1).astype(np.int32)
    toks, _ = srv.decode(n - 1, first)
    np.testing.assert_array_equal(np.stack([first] + toks, axis=1), want)
    assert srv.pos == pad_to - 1


def test_server_capacity_short_prompt_and_fleet_refusal(params):
    cfg = configs.smoke_config(ARCH)
    srv = Server(cfg, device="cpu", params=params)
    with pytest.raises(ValueError, match="d_conv - 1"):
        srv.prefill(np.arange(cfg.ssm.d_conv - 2)[None])
    # capacity comes from max_len, not from segment 0's leaf (hymba's first
    # segment is an unstacked global layer)
    srv.prefill(np.arange(36)[None], pad_to=38)
    srv.decode(2, np.array([1]))
    with pytest.raises(RuntimeError, match="cache full"):
        srv.step_once()
    with pytest.raises(NotImplementedError, match="single-stream Server"):
        ServeEngine(cfg, device="cpu", params=params, max_len=24)


@pytest.mark.parametrize("schedule", ["chunk", "parallel"])
def test_cli_serves_hymba_on_cpu(capsys, schedule):
    n = (GC.launches, GC.launches_a, DA.launches, DA.ring_launches)
    toks = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "36", "--gen", "4", "--gla-schedule", schedule])
    assert len(toks) == 4 and all(t.shape == (2,) for t in toks)
    assert "hymba-1.5b" in capsys.readouterr().out
    assert (GC.launches, GC.launches_a, DA.launches, DA.ring_launches) == n   # CPU: no kernel


def _rel_rows(a, b):
    """max |a - b| over max |b|, per row."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max(-1) / np.abs(b).max(-1)


def test_bf16_drift_is_the_models_not_the_ports():
    """bf16 rounding moves a deep random-weight hymba's logits far from
    float32, and chip_smoke.py's hymba phase holds its bf16 paths only to
    that drift. The witness that the drift is the model's: at the smoke
    widths with the full-width depth and layer plan (32 layers, global 0,
    15 and 31) and bf16 params, the JAX package drifts as far as the port's
    plain path on the same params. Per row of 8 prompts of 40 tokens,
    d = max|bf16 - f32| / max|f32| of the prefill logits; the medians of
    the two packages' d agree within 2x (chip_smoke.py's F32_DIST_RATIO),
    and the port's bf16 logits sit within 2x JAX's d of JAX's bf16 logits:
    two bf16 paths that round at different points differ by about as much
    as either differs from float32. Run with -s for the numbers."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", cache_dtype="bfloat16")
    f32 = dict(param_dtype="float32", compute_dtype="float32", cache_dtype="float32")
    deep = dict(n_layers=32, global_layers=(0, 15, 31))
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), **deep, **bf16)
    cfg = dataclasses.replace(configs.smoke_config(ARCH), **deep, **bf16)
    assert [(s.n, s.scanned) for s in T.plan_segments(cfg)] == \
        [(s.n, s.scanned) for s in T.plan_segments(configs.get_config(ARCH))]
    js = JaxServer(jcfg, backend="mpich", seed=0)
    js32 = JaxServer(dataclasses.replace(jcfg, **f32), backend="mpich", seed=0)
    p16 = js.params
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), p16)
    prompt = np.random.default_rng(14).integers(0, cfg.vocab_size, (8, 40), dtype=np.int32)
    batch = {"tokens": jnp.asarray(prompt)}
    j16 = np.asarray(js.prefill_fn(p16, batch)[0].astype(jnp.float32))
    j32 = np.asarray(js32.prefill_fn(p32, batch)[0])
    host = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), p16)
    tokens = torch.from_numpy(prompt).long()
    t16 = Model(cfg, force="ref").prefill(from_jax_params(host, cfg, "cpu"), tokens,
                                          max_len=40)[0].float().numpy()
    cfg32 = dataclasses.replace(cfg, **f32)
    t32 = Model(cfg32, force="ref").prefill(from_jax_params(host, cfg32, "cpu"), tokens,
                                            max_len=40)[0].numpy()
    d_jax, d_port, d_cross = (np.median(_rel_rows(a, b))
                              for a, b in ((j16, j32), (t16, t32), (t16, j16)))
    print(f"\nhymba smoke widths, 32 layers, bf16 params: median over 8 rows of "
          f"max|a-b|/max|b|: JAX bf16-f32 {d_jax:.3e}, port plain bf16-f32 {d_port:.3e}, "
          f"port-JAX bf16 {d_cross:.3e}, port-JAX f32 {np.median(_rel_rows(t32, j32)):.3e}")
    assert_close(t32, j32, msg="float32 logits")
    assert d_jax / 2 <= d_port <= 2 * d_jax
    assert d_cross <= 2 * d_jax
