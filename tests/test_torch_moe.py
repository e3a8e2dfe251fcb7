"""The MoE family in the port against the JAX package, on the CPU, from the
same params and numpy inputs: granite-moe-3b-a800m's smoke config (4
experts, top 2, GQA G = 2) and arctic-480b's (the same experts beside a
dense residual MLP, Adafactor).

Covered: the config copies, the param specs (the ``[n, E, d, f]`` expert
leaves), the MoE layer alone (output, aux loss and gradients against
``jax.grad``, also on the capacity path with drops), prefill and decode
logits and caches, the capacity path with drops through the whole model,
the reference's decode-vs-prefill and cached-generation checks
(``tests/test_models_smoke.py``), the ``Server``'s greedy stream and the
fleet's streams against the JAX ``ServeEngine``'s, one step's gradients
per leaf against ``jax.grad``, ten ``Trainer`` steps against the JAX
``Trainer``, checkpoints moved between the two trainers both ways, and the kernels' plain versions at granite-moe's G = 3
against the Pallas kernels in interpret mode.

Tolerances, float32 on both sides with the sums in another order: logits
and caches 1e-4 (tests/conftest.py ``assert_close``, 3 layers); the layer
alone 1e-5 of its output's largest magnitude; the aux loss 1e-5 relative;
gradients per leaf, and each step's loss and grad_norm over ten steps,
1e-4 of the largest magnitude (tests/test_torch_train.py); the reference's
decode-vs-prefill bound 2e-2 and exact cached greedy tokens; the kernels'
plain versions 2e-5 against the Pallas kernels
(tests/test_torch_kernels.py).
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
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serving.engine import Server as JaxServer  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import steps as ST  # noqa: E402
from repro_torch.core.restore import load_manifest  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("granite-moe-3b-a800m", "arctic-480b")
GMOE = ARCHS[0]
B, S, STEPS, EVERY = 2, 32, 10, 3


def _configs(arch, **moe):
    """(JAX config, port config) of an arch's smoke config, with ``moe``
    fields replaced in both."""
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    if moe:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
                     for c in (jcfg, cfg))
    return jcfg, cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _pair(arch, **moe):
    """The JAX model and params, and the port's copy."""
    jcfg, cfg = _configs(arch, **moe)
    jm = JaxModel(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jcfg, jm, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, "cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(batch[k]).long() for k in ("tokens", "targets")}


# -- configs and specs -------------------------------------------------------------

@pytest.mark.parametrize("fn", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_equals_jax_config(arch, fn):
    got, want = getattr(configs, fn)(arch), getattr(jconfigs, fn)(arch)
    assert arch in configs.ARCH_IDS
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.kv_cache_width, got.param_count(),
            got.active_param_count()) == (want.padded_vocab, want.kv_cache_width,
                                          want.param_count(), want.active_param_count())


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_match_jax(arch, full):
    jcfg, cfg = (jconfigs.get_config(arch), configs.get_config(arch)) if full \
        else _configs(arch)
    got = tree_leaves(T.model_specs(cfg))
    want = jax.tree.leaves(JT.model_specs(jcfg),
                           is_leaf=lambda x: type(x).__name__ == "ParamSpec")
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    ffn = T.model_specs(cfg)["segments"][0]["ffn"]
    mo, n = cfg.moe, cfg.n_layers
    assert ffn["wi"].shape == (n, mo.n_experts, cfg.d_model, mo.expert_d_ff)
    assert ffn["wo"].shape == (n, mo.n_experts, mo.expert_d_ff, cfg.d_model)
    assert ffn["router"].shape == (n, cfg.d_model, mo.n_experts)
    assert ("dense" in ffn) == mo.dense_residual


# -- the MoE layer alone -------------------------------------------------------------

def _layer_case(arch, Sx, cf, seed):
    """One MoE layer's params (the JAX init) and an input [2, Sx, d]."""
    jcfg, cfg = _configs(arch, capacity_factor=cf)
    jp = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.key(seed)))
    p = jax.tree.map(lambda a: a[0], jp["segments"][0]["ffn"])
    x = np.random.default_rng(seed).standard_normal((2, Sx, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, x


def _dropped(cfg, p, x):
    """The (token, slot) choices the port's dispatch drops for x."""
    mo = cfg.moe
    xt = torch.tensor(x)
    Sx = x.shape[1]
    gs = int(np.gcd(min(mo.group_size, Sx), Sx))
    C = max(1, int(np.ceil(gs * mo.top_k / mo.n_experts * mo.capacity_factor)))
    gates = torch.softmax(xt.reshape(-1, gs, x.shape[-1]) @ torch.tensor(p["router"]), -1)
    return int((~L._topk_dispatch(gates, mo.top_k, C)[1]).sum())


@pytest.mark.parametrize("Sx,cf,drops", [(32, 8.0, False), (40, 1.0, True), (24, 0.5, True),
                                         (7, 1.25, False)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax(arch, Sx, cf, drops):
    """Output, aux loss and the gradients of both (router included) at
    group sizes below S (8 at S 40 and 24) and capacities that drop
    tokens (C = 4 and 2 slots an expert for a group's 16 choices)."""
    jcfg, cfg, p, x = _layer_case(arch, Sx, cf, seed=Sx)
    ctx = ShardingCtx(None, rules_for(jcfg, "train"))
    probe = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def jf(p_, x_):
        y, aux = JL.moe_apply(ctx, jcfg, p_, x_, mode="train")
        return jnp.sum(y * probe) + 10.0 * aux, (y, aux)
    (_, (jy, jaux)), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = tree_map(lambda a: torch.tensor(a, requires_grad=True), p)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = L.moe_apply(cfg, tp, tx, mode="train")
    (torch.sum(y * torch.from_numpy(probe)) + 10.0 * aux).backward()
    assert _rel(y.detach().numpy(), jy) <= 1e-5
    assert abs(aux.item() - float(jaux)) <= 1e-5 * abs(float(jaux))
    assert _rel(tx.grad.numpy(), jg[1]) <= 1e-4
    got = tree_leaves(tree_map(lambda t: t.grad, tp))
    want = jax.tree.leaves(jg[0])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b) <= 1e-4
    assert tp["router"].grad.abs().max() > 0
    if drops:
        assert _dropped(cfg, p, x) > 0


def test_moe_decode_matches_jax():
    jcfg, cfg, p, x = _layer_case(GMOE, 1, 8.0, seed=3)
    x = x[:, 0]
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    jy, _ = JL.moe_apply(ctx, jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x), mode="decode")
    y, aux = L.moe_apply(cfg, tree_map(torch.tensor, p), torch.from_numpy(x),
                         mode="decode")
    assert aux is None and _rel(y.numpy(), jy) <= 1e-5


def test_topk_dispatch_fills_slots_in_argmax_order():
    """A hand-made group: the first maximum wins a tie, places count the
    earlier slots' tokens, and choices past the capacity are dropped."""
    gates = torch.tensor([[[0.4, 0.4, 0.2], [0.5, 0.3, 0.2], [0.1, 0.6, 0.3]]])
    dest, kept, w, first = L._topk_dispatch(gates, 2, 2)
    # slot 0: experts 0, 0, 1 at places 0, 1, 0; slot 1: experts 1, 1, 2 at
    # places 1, 2 (past C = 2: dropped), 0
    assert dest.tolist() == [[[0, 3], [1, 4], [2, 4]]]
    assert kept.tolist() == [[[True, True], [True, False], [True, True]]]
    torch.testing.assert_close(w[0, 1], torch.tensor([1.0, 0.0]))
    torch.testing.assert_close(w[0, 0], torch.tensor([0.5, 0.5]))
    assert first[0].argmax(-1).tolist() == [0, 0, 1]


# -- serving ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_model(arch):
    jcfg, jm, jp, cfg, tp = _pair(arch)
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 11), dtype=np.int32)
    n_dec = 4
    jlogits, jcaches = jm.prefill(ctx, jp, {"tokens": jnp.asarray(tokens)})
    m = Model(cfg)
    logits, caches = m.prefill(tp, torch.from_numpy(tokens).long())
    assert_close(logits, jlogits)
    for k in ("k", "v"):
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


@pytest.mark.parametrize("Sx", [40, 48])
def test_capacity_path_with_drops_matches_jax_prefill(Sx):
    """granite-moe at capacity factor 1 and S past the group size (gs = 8
    at S 40, 16 at 48): tokens are dropped in the first layer, and the
    prefill's logits and caches still equal the JAX package's."""
    jcfg, jm, jp, cfg, tp = _pair(GMOE, capacity_factor=1.0)
    ctx = ShardingCtx(None, rules_for(jcfg, "decode"))
    tokens = np.random.default_rng(Sx).integers(0, cfg.vocab_size, (2, Sx), dtype=np.int32)
    tt = torch.from_numpy(tokens).long()
    # the first layer's MoE input: the block's residual after attention, normed
    p0 = tree_map(lambda t: t[0], tp["segments"][0])
    e = tp["embed"][tt]
    x0 = e + L.attn_apply(cfg, p0["attn"], L.rmsnorm(e, p0["ln1"]), mode="train",
                          cache=None)[0]
    x0 = L.rmsnorm(x0, p0["ln2"]).numpy()
    assert _dropped(cfg, tree_map(lambda t: t.numpy(), p0["ffn"]), x0) > 0
    jlogits, jcaches = jm.prefill(ctx, jp, {"tokens": jnp.asarray(tokens)})
    logits, caches = Model(cfg).prefill(tp, tt)
    assert_close(logits, jlogits)
    for k in ("k", "v"):
        assert_close(caches[0]["attn"][k], jcaches[0]["attn"][k])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """tests/test_models_smoke.py::test_smoke_decode_matches_prefill on the
    port: the decode of token S after a prefill of S tokens gives the
    logits of a prefill of S + 1 (capacity factor 8: no drops)."""
    _, _, _, cfg, tp = _pair(arch)
    m = Model(cfg)
    full = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 17)))
    want, _ = m.prefill(tp, full)
    _, caches = m.prefill(tp, full[:, :16], max_len=17)
    got, _ = m.decode_step(tp, full[:, 16], 16, caches)
    assert (got - want).abs().max() / want.abs().max() < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_generation_with_cache_matches_reprefill(arch):
    """tests/test_models_smoke.py::test_smoke_generation_with_cache on the
    port: greedy tokens through the cache equal those of re-prefilling the
    growing prefix (2 layers)."""
    _, cfg = _configs(arch)
    cfg = dataclasses.replace(cfg, n_layers=2)
    m = Model(cfg)
    tp = m.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10)))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_stream_matches_jax_server(arch):
    jcfg, cfg = _configs(arch)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9), dtype=np.int32)
    n = 8
    jsrv = JaxServer(jcfg, backend="mpich", seed=0)
    jlogits = jsrv.prefill(prompt, pad_to=prompt.shape[1] + n)
    jfirst = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    jtoks, _ = jsrv.decode(n - 1, jfirst)
    want = np.stack([jfirst] + [np.asarray(t) for t in jtoks], axis=1)

    tree = jax.tree.map(np.asarray, jsrv.params)
    srv = Server(cfg, device="cpu", params=from_jax_params(tree, cfg, "cpu"))
    logits = srv.prefill(prompt, pad_to=prompt.shape[1] + n)
    assert_close(logits, jlogits)
    first = np.argmax(logits[:, : cfg.vocab_size].numpy(), -1).astype(np.int32)
    toks, _ = srv.decode(n - 1, first)
    np.testing.assert_array_equal(np.stack([first] + toks, axis=1), want)


def test_fleet_streams_match_jax_engine():
    """tests/test_torch_fleet.py's preemption traffic on granite-moe: the
    pool is too small for both sessions, the high-priority arrival swaps
    the first out, and the streams, tickets and ticks equal the JAX
    engine's."""
    jcfg, cfg = _configs(GMOE)
    kw = dict(max_len=40, page_size=4, n_pages=10, max_running=2)
    jeng = JaxEngine(jcfg, backend="mpich", seed=0, **kw)
    eng = ServeEngine(cfg, device="cpu", **kw,
                      params=from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg, "cpu"))
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
    assert out[1][1][0][1] >= 1            # a was preempted and came back
    assert [len(s) for s in out[1][0]] == [10, 8, 6]


# -- training --------------------------------------------------------------------

@pytest.mark.parametrize("cf", [None, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_gradients_match_jax_grad(arch, cf):
    """Per leaf within 1e-4 (the router's included), the aux loss within
    1e-5; ``cf`` 1.0 drops tokens (S 32 is one group of 32 at C = 16)."""
    jcfg, jm, jp, cfg, tp = _pair(arch, **({} if cf is None else {"capacity_factor": cf}))
    batch = synth_batch(cfg, B, S, 1, 0)
    ctx = ShardingCtx(None, rules_for(jcfg, "train"))
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        logits, aux = jm.train_logits(ctx, p, jb)
        return JST.lm_loss(jcfg, logits, jb["targets"]) + aux, aux
    (jloss, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    grads, total, _, aux = ST.loss_and_grads(Model(cfg), tp, _tbatch(batch))
    assert abs(total.item() - float(jloss)) <= 1e-5 * float(jloss)
    assert float(jaux) > 0 and abs(aux.item() - float(jaux)) <= 1e-5 * float(jaux)
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == b.shape and _rel(a.numpy(), b) <= 1e-4, i
    assert grads["segments"][0]["ffn"]["router"].abs().max() > 0


@pytest.fixture(scope="module", params=ARCHS)
def jax_run(request, tmp_path_factory):
    """The module's JAX Trainer per arch: ten steps with a checkpoint every
    3; its arch, initial params, per-step metrics and the trainer."""
    arch = request.param
    jcfg, _ = _configs(arch)
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
    yield arch, p0, metrics, tr
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
    arch, p0, want, _ = jax_run
    cfg = _configs(arch)[1]
    tr = _port_trainer(cfg)
    tr.init_state(from_jax_params(p0, cfg, "cpu"))
    try:
        got = [tr.step_once() for _ in range(STEPS)]
    finally:
        _stop(tr)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"] == i + 1
        for k in ("loss", "aux_loss", "grad_norm", "world_loss"):
            assert abs(float(g[k]) - w[k]) <= 1e-4 * abs(w[k]), (i, k, float(g[k]), w[k])


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    arch, _, want, jtr = jax_run
    cfg = _configs(arch)[1]
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
    arch, p0, want, jtr = jax_run
    cfg = _configs(arch)[1]
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


# -- the kernels' plain versions at granite-moe's G = 3 ------------------------------

def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S_", [32, 40])
def test_naive_attention_at_g3_matches_pallas(S_):
    rng = np.random.default_rng(S_)
    q = rng.standard_normal((1, 6, S_, 64), dtype=np.float32)
    k, v = (rng.standard_normal((1, 2, S_, 64), dtype=np.float32) for _ in range(2))
    got = ref.naive_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    blk = 16 if S_ % 16 == 0 else 8
    _close(got, pallas_flash(*(jnp.asarray(x) for x in (q, k, v)), q_block=blk, kv_block=blk,
                             interpret=True), 2e-5)


@pytest.mark.parametrize("length", [1, 37, 64])
def test_naive_decode_attention_at_g3_matches_pallas(length):
    rng = np.random.default_rng(length)
    q = rng.standard_normal((2, 6, 64), dtype=np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 64), dtype=np.float32) for _ in range(2))
    got = ref.naive_decode_attention(torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
                                     torch.from_numpy(v).transpose(1, 2), length)
    _close(got, pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length,
                              n_splits=8, interpret=True), 2e-5)


def test_naive_paged_decode_attention_at_g3_matches_pallas():
    B_, H, K, D, page, n_pages = 2, 6, 2, 64, 16, 4
    n_pool = B_ * n_pages + 3
    rng = np.random.default_rng(17)
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
