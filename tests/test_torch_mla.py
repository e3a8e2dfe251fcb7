"""MLA (multi-head latent attention, minicpm3-4b) in the port against the JAX
package, on the CPU, from the same params and numpy inputs: the reference's
smoke config (q_lora 32, kv_lora 16, qk_nope 16, qk_rope 8, v 16) and a
variant with kv_lora_rank 48, where the latent row (48 + 8) is wider than
the qk head dim (16 + 8).

Covered: the config copy, the param specs and ``from_jax_params`` (the
reference's leaf names, ``[in, out]`` layouts and distributions), prefill
logits and the ``lat`` cache, the absorbed decode against the JAX decode,
the reference's decode-vs-prefill and cached-generation checks
(``tests/test_models_smoke.py``), one step's gradients per leaf against
``jax.grad``, ten ``Trainer`` steps against the JAX ``Trainer``, trainer
checkpoints, serving snapshots and fleet snapshots moved between the
packages both ways,
the ``Server``'s greedy stream and the fleet's streams against the JAX
engines', and the latent decode's plain versions against the Pallas decode
kernels in interpret mode.

The reference's absorbed decode scales its scores by 1/sqrt(kv_lora + rope)
(``src/repro/models/layers.py:162`` takes the latent query's width), its
prefill and training by 1/sqrt(qk_nope + rope): the same function only
where the two widths agree, as in its smoke config. The port scales both
by 1/sqrt(qk_nope + rope), its prefill's function everywhere; at
kv_lora_rank 48 the port's decode meets the JAX prefill of the next
position within the reference's own 2e-2, and the JAX decode does not
(ROADMAP queue 3, part C).

Tolerances, float32 on both sides with the sums in another order: logits
and caches 1e-4 (tests/conftest.py ``assert_close``, 3 layers); gradients
per leaf, and each step's loss and grad_norm over ten steps, 1e-4 of the
largest magnitude (tests/test_torch_train.py); the decode-vs-prefill bound
2e-2 and exact cached greedy tokens (tests/test_models_smoke.py); the
plain versions 2e-5 against the Pallas kernels (tests/test_torch_kernels.py).
"""
import dataclasses
import math

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
from repro.launch.train import Trainer as JaxTrainer  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serving.engine import Server as JaxServer  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import steps as ST  # noqa: E402
from repro_torch.core.restore import load_manifest  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)
ARCH = "minicpm3-4b"
WIDE = 48                      # the variant's kv_lora_rank
B, S, STEPS, EVERY = 2, 32, 10, 3


def _configs(kv_lora=None):
    """(JAX config, port config) of the smoke config, with ``kv_lora``
    replacing kv_lora_rank in both."""
    jcfg, cfg = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
    if kv_lora:
        jcfg, cfg = (dataclasses.replace(c, mla=dataclasses.replace(c.mla, kv_lora_rank=kv_lora))
                     for c in (jcfg, cfg))
    return jcfg, cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _pair(kv_lora=None, seed=0):
    """The JAX model and params, and the port's copy."""
    jcfg, cfg = _configs(kv_lora)
    jm = JaxModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jcfg, jm, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, "cpu")


def _tokens(seed, shape, cfg):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def _first(logits, vocab):
    return np.argmax(np.asarray(logits)[:, :vocab], -1).astype(np.int32)


# -- configs, specs and params -----------------------------------------------------------

@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
def test_config_copy_equals_jax_config(fn):
    got, want = getattr(configs, fn)(ARCH), getattr(jconfigs, fn)(ARCH)
    assert ARCH in configs.ARCH_IDS
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.kv_cache_width, got.param_count()) == \
        (want.padded_vocab, want.kv_cache_width, want.param_count())


def test_full_width_shapes():
    """minicpm3-4b at full width: 62 layers, K1 at qk head dim 96, the
    latent row of 288 (256 of it the value); 4.26B params in its specs."""
    cfg = configs.get_config(ARCH)
    m = cfg.mla
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.padded_vocab) == (62, 2560, 40, 73472)
    assert m.qk_nope_dim + m.qk_rope_dim == 96 and cfg.kv_cache_width == 288
    assert m.kv_lora_rank == 256 and m.v_head_dim == 64
    assert sum(math.prod(sp.shape) for sp in tree_leaves(T.model_specs(cfg))) == 4_262_025_728


@pytest.mark.parametrize("which", ["smoke", "wide", "full"])
def test_model_specs_match_jax(which):
    jcfg, cfg = (jconfigs.get_config(ARCH), configs.get_config(ARCH)) if which == "full" \
        else _configs(WIDE if which == "wide" else None)
    spec = T.model_specs(cfg)
    got = tree_leaves(spec)
    want = jax.tree.leaves(JT.model_specs(jcfg),
                           is_leaf=lambda x: type(x).__name__ == "ParamSpec")
    assert [(tuple(s.shape), s.axes, s.init) for s in got] == \
        [(tuple(s.shape), s.axes, s.init) for s in want]
    attn = spec["segments"][0]["attn"]
    assert sorted(attn) == ["kv_ln", "q_ln", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    m, n, H = cfg.mla, cfg.n_layers, cfg.n_heads
    assert attn["wkv_b"].shape == (n, m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim))
    assert attn["wkv_a"].shape == (n, cfg.d_model, m.kv_lora_rank + m.qk_rope_dim)


@pytest.mark.parametrize("kv_lora", [None, WIDE])
def test_from_jax_params_keeps_every_leaf(kv_lora):
    jcfg, _, jp, cfg, tp = _pair(kv_lora)
    got, want = tree_leaves(tp), jax.tree.leaves(jp)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the seeded init draws the reference's distributions: ones for the
    # norms, N(0, 1/fan_in) for the projections
    init = Model(cfg).init(0, "cpu")["segments"][0]["attn"]
    assert torch.equal(init["kv_ln"], torch.ones_like(init["kv_ln"]))
    std = init["wq_b"].std().item()
    assert abs(std - 1 / math.sqrt(cfg.mla.q_lora_rank)) < 0.1 / math.sqrt(cfg.mla.q_lora_rank)


# -- serving -------------------------------------------------------------------------

@pytest.mark.parametrize("kv_lora", [None, WIDE])
def test_prefill_logits_and_latent_cache_match_jax(kv_lora):
    jcfg, jm, jp, cfg, tp = _pair(kv_lora)
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    tokens = _tokens(5, (2, 11), cfg)
    jlogits, jcaches = jm.prefill(ctx, jp, {"tokens": jnp.asarray(tokens)})
    logits, caches = Model(cfg).prefill(tp, torch.from_numpy(tokens).long())
    assert_close(logits, jlogits)
    assert list(caches[0]["attn"]) == ["lat"] == list(jcaches[0]["attn"])
    assert caches[0]["attn"]["lat"].shape == (cfg.n_layers, 2, 11, cfg.kv_cache_width)
    assert_close(caches[0]["attn"]["lat"], jcaches[0]["attn"]["lat"])


def test_decode_matches_jax_decode():
    """At the reference's smoke config, where its decode's scale is its
    prefill's: four absorbed decode steps, logits and the latent cache."""
    jcfg, jm, jp, cfg, tp = _pair()
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    tokens = _tokens(6, (2, 11), cfg)
    n_dec = 4
    jlogits, jcaches = jm.prefill(ctx, jp, {"tokens": jnp.asarray(tokens)})
    jcaches = jax.tree.map(lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, n_dec), (0, 0))), jcaches)
    m = Model(cfg)
    _, caches = m.prefill(tp, torch.from_numpy(tokens).long(), max_len=11 + n_dec)
    tok = _first(jlogits, cfg.vocab_size)
    for i in range(n_dec):
        jlogits, jcaches = jm.decode_step(ctx, jp, jnp.asarray(tok), jnp.int32(11 + i), jcaches)
        logits, caches = m.decode_step(tp, torch.from_numpy(tok).long(), 11 + i, caches)
        assert_close(logits, jlogits, msg=f"decode step {i}")
        tok = _first(jlogits, cfg.vocab_size)
    assert_close(caches[0]["attn"]["lat"], jcaches[0]["attn"]["lat"])


def _decode_vs_prefill(kv_lora):
    """The port's and the JAX package's decode of token 16 after a prefill
    of 16, each against the JAX prefill of all 17 (relative max error)."""
    jcfg, jm, jp, cfg, tp = _pair(kv_lora)
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    full = _tokens(2, (2, 17), cfg)
    want, _ = jm.prefill(ctx, jp, {"tokens": jnp.asarray(full)})
    _, jc = jm.prefill(ctx, jp, {"tokens": jnp.asarray(full[:, :16])})
    jc = jax.tree.map(lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, 1), (0, 0))), jc)
    jgot, _ = jm.decode_step(ctx, jp, jnp.asarray(full[:, 16]), jnp.int32(16), jc)
    m = Model(cfg)
    _, caches = m.prefill(tp, torch.from_numpy(full[:, :16]).long(), max_len=17)
    got, _ = m.decode_step(tp, torch.from_numpy(full[:, 16]).long(), 16, caches)
    return _rel(got.numpy(), want), _rel(jgot, want)


@pytest.mark.parametrize("kv_lora", [None, WIDE])
def test_decode_matches_prefill(kv_lora):
    """tests/test_models_smoke.py::test_smoke_decode_matches_prefill: the
    port's decode of token S after a prefill of S gives the JAX prefill's
    logits of S + 1, within the reference's 2e-2; at kv_lora_rank 48 too."""
    port, _ = _decode_vs_prefill(kv_lora)
    assert port < 2e-2


def test_jax_decode_misses_its_prefill_where_the_scales_differ():
    """The reference's fault: at kv_lora_rank 48 its absorbed decode scales
    by 1/sqrt(48 + 8), its prefill by 1/sqrt(16 + 8), and the decode misses
    the prefill's logits by far more than 2e-2 (0.26 at seed 0); at the
    smoke config, where the widths agree, it meets them."""
    assert _decode_vs_prefill(None)[1] < 2e-2
    port, jax_decode = _decode_vs_prefill(WIDE)
    assert jax_decode > 0.1 > 5 * port


def test_generation_with_cache_matches_reprefill():
    """tests/test_models_smoke.py::test_smoke_generation_with_cache on the
    port: greedy tokens through the latent cache equal those of
    re-prefilling the growing prefix (2 layers)."""
    _, cfg = _configs()
    cfg = dataclasses.replace(cfg, n_layers=2)
    m = Model(cfg)
    tp = m.init(0, "cpu")
    toks = torch.from_numpy(_tokens(3, (2, 10), cfg)).long()
    logits, caches = m.prefill(tp, toks, max_len=14)
    cached, tok = [], torch.argmax(logits[:, : cfg.vocab_size], -1)
    for i in range(4):
        cached.append(tok)
        logits, caches = m.decode_step(tp, tok, 10 + i, caches)
        tok = torch.argmax(logits[:, : cfg.vocab_size], -1)
    cached.append(tok)
    prefix = toks
    for i, want in enumerate(cached):
        got = torch.argmax(m.prefill(tp, prefix)[0][:, : cfg.vocab_size], -1)
        assert torch.equal(got, want), f"cached decode diverged at step {i}"
        prefix = torch.cat([prefix, want[:, None]], dim=1)


def test_latent_decode_ops_plain_route_and_scale():
    """The layer's decode calls the latent op at 1/sqrt(qk_nope + rope), and
    the op's plain route equals the dense softmax over the latent rows."""
    _, cfg = _configs(WIDE)
    assert L.mla_scale(cfg) == 1 / math.sqrt(16 + 8)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 56), dtype=np.float32))
    lat = torch.from_numpy(rng.standard_normal((2, 9, 56), dtype=np.float32))
    got = ops.latent_decode_attention(q, lat, 7, v_dim=48, scale=0.2)
    p = torch.softmax(torch.einsum("bhd,bsd->bhs", q, lat[:, :7]) * 0.2, -1)
    torch.testing.assert_close(got, torch.einsum("bhs,bsv->bhv", p, lat[:, :7, :48]))
    with pytest.raises(RuntimeError):
        ops.latent_decode_attention(q, lat, 7, v_dim=48, scale=0.2, force="kernel")


def test_greedy_stream_matches_jax_server():
    jcfg, cfg = _configs()
    prompt = _tokens(7, (2, 9), cfg)
    n = 8
    jsrv = JaxServer(jcfg, backend="mpich", seed=0)
    jlogits = jsrv.prefill(prompt, pad_to=prompt.shape[1] + n)
    jfirst = _first(jlogits, cfg.vocab_size)
    jtoks, _ = jsrv.decode(n - 1, jfirst)
    want = np.stack([jfirst] + [np.asarray(t) for t in jtoks], axis=1)
    srv = Server(cfg, device="cpu",
                 params=from_jax_params(jax.tree.map(np.asarray, jsrv.params), cfg, "cpu"))
    logits = srv.prefill(prompt, pad_to=prompt.shape[1] + n)
    assert_close(logits, jlogits)
    first = _first(logits.numpy(), cfg.vocab_size)
    toks, _ = srv.decode(n - 1, first)
    np.testing.assert_array_equal(np.stack([first] + toks, axis=1), want)


def test_fleet_streams_match_jax_engine():
    """tests/test_torch_fleet.py's preemption traffic on MLA's one paged
    latent leaf: the high-priority arrival swaps the first session out, and
    the streams, tickets and ticks equal the JAX engine's."""
    jcfg, cfg = _configs()
    kw = dict(max_len=40, page_size=4, n_pages=10, max_running=2)
    jeng = JaxEngine(jcfg, backend="mpich", seed=0, **kw)
    eng = ServeEngine(cfg, device="cpu", **kw,
                      params=from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg, "cpu"))
    assert sorted(eng.pool.stores) == ["leaf000"]         # the latent rows alone
    out = []
    for e in (jeng, eng):
        rng = np.random.default_rng(1)
        a = e.submit(rng.integers(0, cfg.vocab_size, 20, dtype=np.int32), max_new_tokens=10)
        for _ in range(3):
            e.step_once()
        b = e.submit(rng.integers(0, cfg.vocab_size, 13), max_new_tokens=8, priority=5)
        c = e.submit([], max_new_tokens=6)
        ticks = e.run_until_drained(max_ticks=300)
        sids = [a, b, c]
        out.append(([e.stream(s) for s in sids],
                    [(e.sched.state(s), e.sched.tickets[s].preemptions) for s in sids], ticks))
    assert out[1] == out[0]
    assert out[1][1][0][1] >= 1
    assert [len(s) for s in out[1][0]] == [10, 8, 6]


def test_fleet_lane_equals_the_servers_stream():
    """A fleet lane decodes through the paged latent op and the page table,
    the Server through the contiguous cache: the same greedy tokens."""
    _, cfg = _configs()
    eng = ServeEngine(cfg, device="cpu", max_len=24, page_size=4, n_pages=16, max_running=2)
    srv = Server(cfg, device="cpu", params=eng.params)
    prompt = _tokens(9, (7,), cfg)
    sid = eng.submit(prompt, max_new_tokens=8)
    eng.run_until_drained()
    first = _first(srv.prefill(prompt[None], pad_to=7 + 8).numpy(), cfg.vocab_size)
    toks, _ = srv.decode(7, first)
    assert eng.stream(sid) == [int(first[0])] + [int(t[0]) for t in toks]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_serving_snapshot_moves_between_the_packages(tmp_path, direction):
    """A Server snapshot mid-decode (the ``lat`` leaves in the container)
    resumes in the other package's fresh Server, under another flavor, with
    the writer's greedy tail."""
    jcfg, cfg = _configs()
    prompt = _tokens(8, (2, 9), cfg)
    pad_to, k = 17, 3
    js = JaxServer(jcfg, backend="craympi", ckpt_dir=tmp_path / "jax", seed=0)
    params = from_jax_params(jax.tree.map(np.asarray, js.params), cfg, "cpu")
    ps = Server(cfg, device="cpu", params=params, backend="exampi", ckpt_dir=tmp_path / "port")
    writer, reader = (js, ps) if direction == "jax_to_torch" else (ps, js)
    head, _ = writer.decode(k, _first(np.asarray(writer.prefill(prompt, pad_to=pad_to)),
                                      cfg.vocab_size))
    writer.checkpoint().wait()
    tail, _ = writer.decode(pad_to - 9 - k - 1, head[-1])
    fresh = Server(cfg, device="cpu", params=params, backend="mpich") \
        if direction == "jax_to_torch" else JaxServer(jcfg, backend="fabric", seed=0)
    if direction == "torch_to_jax":
        fresh.params = js.params
    fresh.restore(writer.cluster.writer.latest(), new_backend="openmpi", rebuild=True)
    assert fresh.pos == 9 + k
    got, _ = fresh.decode(len(tail), fresh.resume_tok)
    np.testing.assert_array_equal(np.stack([np.asarray(t) for t in got], 1),
                                  np.stack([np.asarray(t) for t in tail], 1))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_fleet_snapshot_moves_between_the_packages(tmp_path, direction):
    """A fleet snapshot mid-traffic (the sessions' paged ``lat`` rows)
    resumes in the other package's fresh engine, under another flavor, and
    drains to the uninterrupted streams."""
    jcfg, cfg = _configs()
    kw = dict(max_len=24, page_size=4, n_pages=6, max_running=2)
    params = jax.tree.map(np.asarray, JaxEngine(jcfg, seed=0, **kw).params)

    def port(**more):
        return ServeEngine(cfg, params=from_jax_params(params, cfg, "cpu"), device="cpu",
                           **kw, **more)

    def traffic(eng, until=None):
        rng = np.random.default_rng(1)
        eng.submit(rng.integers(0, cfg.vocab_size, 6), sid="a", max_new_tokens=8)
        eng.submit(rng.integers(0, cfg.vocab_size, 3), sid="b", max_new_tokens=6)
        late = rng.integers(0, cfg.vocab_size, 8)
        while eng.sched.live() or eng.tick < 3:
            if eng.tick == 3 and "c" not in eng.sessions:
                eng.submit(late, sid="c", max_new_tokens=6, priority=5)
            eng.step_once()
            if eng.tick == until:
                return None
        return {s: eng.stream(s) for s in sorted(eng.sessions)}
    want = traffic(port())
    assert want == traffic(JaxEngine(jcfg, seed=0, **kw))
    writer = JaxEngine(jcfg, seed=0, ckpt_dir=tmp_path, **kw) \
        if direction == "jax_to_torch" else port(ckpt_dir=tmp_path)
    traffic(writer, until=5)
    writer.checkpoint().wait()
    reader = port(backend="fabric", ckpt_dir=tmp_path) if direction == "jax_to_torch" \
        else JaxEngine(jcfg, backend="fabric", seed=0, ckpt_dir=tmp_path, **kw)
    assert reader.resume_latest(new_backend="openmpi") is not None
    assert reader.tick == 5 and reader.last_runtime_restore["skipped"] == []
    reader.run_until_drained()
    assert {s: reader.stream(s) for s in sorted(reader.sessions)} == want


def test_cli_serves_minicpm3_on_the_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "6",
                    "--gen", "5"])
    assert f"{ARCH}: generated 5 tokens x batch 2" in capsys.readouterr().out


# -- training --------------------------------------------------------------------------

def _tbatch(batch):
    return {k: torch.from_numpy(batch[k]).long() for k in ("tokens", "targets")}


@pytest.mark.parametrize("kv_lora", [None, WIDE])
def test_one_step_gradients_match_jax_grad(kv_lora):
    """Per leaf within 1e-4: K1's plain version at qk head dim 24 with V
    zero-padded, as the reference pads it, differentiates to the JAX
    package's gradients, the padding's included (none reach wkv_b's value
    columns)."""
    jcfg, jm, jp, cfg, tp = _pair(kv_lora)
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
    assert grads["segments"][0]["attn"]["wkv_b"].abs().max() > 0


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer: ten steps with a checkpoint every 3; its initial
    params, per-step metrics and the trainer."""
    jcfg, _ = _configs()
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


def _port_trainer(cfg, **kw):
    return Trainer(cfg, batch_size=B, seq_len=S, world_size=2, total_steps=STEPS,
                   device="cpu", **kw)


def _stop(tr):
    tr.pipeline.stop()
    if tr.cluster.writer is not None:
        tr.cluster.writer.close()


def test_ten_steps_match_the_jax_trainer(jax_run):
    p0, want, _ = jax_run
    cfg = _configs()[1]
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
    _, want, jtr = jax_run
    cfg = _configs()[1]
    tr = _port_trainer(cfg, ckpt_dir=tmp_path / "ck")
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
    cfg = _configs()[1]
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


# -- the latent decode's plain versions against the Pallas kernels ---------------------

def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("length", [1, 37, 64])
def test_naive_latent_decode_matches_pallas(length):
    """The Pallas decode with K = 1 and the latent rows as both K and V,
    its output's first v_dim columns: the latent decode at the Pallas
    kernel's scale 1/sqrt(Dk)."""
    rng = np.random.default_rng(length)
    Dk, Dv = 24, 16
    q = rng.standard_normal((2, 4, Dk), dtype=np.float32)
    lat = rng.standard_normal((2, 64, Dk), dtype=np.float32)
    got = ref.naive_latent_decode_attention(torch.from_numpy(q), torch.from_numpy(lat), length,
                                            v_dim=Dv, scale=1 / math.sqrt(Dk))
    lat4 = jnp.asarray(lat[:, :, None])
    want = pallas_decode(jnp.asarray(q), lat4, lat4, length, n_splits=8, interpret=True)
    _close(got, np.asarray(want)[..., :Dv], 2e-5)


def test_naive_paged_latent_decode_matches_pallas():
    B_, H, Dk, Dv, page, n_pages = 2, 4, 24, 16, 16, 4
    n_pool = B_ * n_pages + 3
    rng = np.random.default_rng(17)
    q = rng.standard_normal((B_, H, Dk), dtype=np.float32)
    pages = rng.standard_normal((n_pool, page, Dk), dtype=np.float32)
    pt = rng.permutation(n_pool)[:B_ * n_pages].reshape(B_, n_pages).astype(np.int32)
    lengths = np.array([page * n_pages - 5, 2 * page - 3], np.int32)
    for b in range(B_):
        pt[b, (lengths[b] + page - 1) // page:] = 0
    got = ref.naive_paged_latent_decode_attention(
        *(torch.from_numpy(x) for x in (q, pages, pt, lengths)), v_dim=Dv,
        scale=1 / math.sqrt(Dk))
    p4 = jnp.asarray(pages[:, :, None])
    want = pallas_paged(jnp.asarray(q), p4, p4, jnp.asarray(pt), jnp.asarray(lengths),
                        interpret=True)
    _close(got, np.asarray(want)[..., :Dv], 2e-5)
    # a row of length 0 gives zeros
    zero = ref.naive_paged_latent_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pages), torch.from_numpy(pt),
        torch.zeros(B_, dtype=torch.int32), v_dim=Dv, scale=0.1)
    assert torch.equal(zero, torch.zeros_like(zero))
