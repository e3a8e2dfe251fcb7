"""The port's xLSTM training (xlstm-350m) against the JAX package's, on the
CPU at the smoke config (float32: 4 layers as 2 pairs, d_model 128, 2
heads, sLSTM head 64, mLSTM chunk 8, S = 32): the sLSTM recurrence's plain
backward (``ref.slstm_scan_bwd``, the analytic reverse recurrence that the
backward kernel computes) against ``jax.vjp`` of the reference's
``run_scan`` body and against autograd and ``gradcheck`` in float64; the
stabilizer's gradient shown to cancel; both blocks' train mode against
``jax.vjp`` of the reference's blocks; and the port's ``Trainer`` over ten
steps against the JAX ``Trainer`` from the same params and batches (one
step's gradients and the logits are in tests/test_torch_train.py, whose
``ARCHS`` hold xlstm-350m; checkpoints and chaos in
tests/test_torch_train_cr.py).

Tolerances (max |a - b| / max |b| per gradient): the plain backward 2e-5
in float32 (another summation order; the reference's m terms cancel to
rounding) and 2e-2 in bf16 (a gate gradient near 1 rounds by 2^-8, and the
two frameworks round their bf16 products in their own order); in bf16 dR
is held to the reference's per-step cotangents of R summed in float32,
because ``jax.lax.scan`` accumulates a closed-over constant's cotangent in
its own dtype, bf16, over the S steps, which alone leaves the reference's
dR some 2e-2 from that sum at S = 32; the float64 checks 1e-10; the
blocks' gradients 1e-4 (float32 through the blocks' products); each step's
loss and grad_norm 1e-4: ten steps each from the JAX Trainer's state, four
run free in float32 (the two float32 trajectories part after that, as
hymba's do), and ten run free in float64 with the JAX Trainer under x64.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch.train import Trainer as JaxTrainer  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import slstm_scan as SL  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402

torch.set_num_threads(1)
ARCH = "xlstm-350m"
CFG, JCFG = configs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
B, S, STEPS = 2, 32, 10
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _rel(a, b):
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = b.detach().double().numpy() if isinstance(b, torch.Tensor) else np.asarray(
        jnp.asarray(b).astype(jnp.float32), np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _inputs(Bn, Sn, H, dh, seed):
    """wx ~ N(0, 1), r ~ N(0, 1/dh) (a recurrence strong enough to matter),
    and a gradient of hs ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    wx = rng.standard_normal((Bn, Sn, 4 * H * dh)).astype(np.float32)
    r = (rng.standard_normal((H, dh, 4 * dh)) * dh ** -0.5).astype(np.float32)
    dhs = rng.standard_normal((Bn, Sn, H, dh)).astype(np.float32)
    return wx, r, dhs


def _jax_run_scan(wx, r, H, dh, per_step=False):
    """The reference's ``run_scan`` (models/xlstm.py:145-161), its body as it
    stands there; ``per_step``: r given once a step ([S, H, dh, 4dh]), so
    that its cotangent comes back a step at a time."""
    Bn = wx.shape[0]
    d = H * dh

    def body(state, xs):
        w, rr = xs if per_step else (xs, r)
        rh = jnp.einsum("bhj,hjg->bhg", state[3].astype(w.dtype), rr)
        gates = w + rh.reshape(Bn, 4 * d)
        new = JX._slstm_cell(gates, state, H, dh)
        return new, new[3]

    z0 = jnp.zeros((Bn, H, dh), jnp.float32)
    state0 = (z0, z0 + 1e-6, jnp.full((Bn, H, dh), -1e30, jnp.float32), z0)
    xs = jnp.moveaxis(wx, 1, 0)
    _, hs = jax.lax.scan(body, state0, (xs, r) if per_step else xs)
    return jnp.moveaxis(hs, 0, 1).astype(wx.dtype)


def _plain_bwd(wx, r, dhs, dtype, state=None, dstate=False):
    tt = getattr(torch, dtype)
    wx, r = torch.from_numpy(wx).to(tt), torch.from_numpy(r).to(tt)
    H, dh = r.shape[:2]
    st = state if state is not None else ref.slstm_state0(wx.shape[0], H, dh, "cpu")
    hs, _, saved = ref.slstm_scan(wx, r, st, states=True)
    return hs, ref.slstm_scan_bwd(r, st, hs, saved, torch.from_numpy(dhs).to(tt),
                                  dstate=dstate)


# -- the plain backward ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bn,Sn,H,dh", [(B, S, 2, 64), (1, 17, 4, 32), (3, 9, 1, 64)])
def test_plain_bwd_matches_jax_vjp_of_run_scan(Bn, Sn, H, dh, dtype):
    wx, r, dhs = _inputs(Bn, Sn, H, dh, Sn + dh)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jw, jr, jd = (jnp.asarray(a).astype(jt) for a in (wx, r, dhs))
    hs_j, vjp = jax.vjp(lambda a, b: _jax_run_scan(a, b, H, dh), jw, jr)
    dw_j, dr_j = vjp(jd)
    if dtype == "bfloat16":
        rs = jnp.broadcast_to(jr, (Sn, *jr.shape))
        _, vjp_s = jax.vjp(lambda a, b: _jax_run_scan(a, b, H, dh, per_step=True), jw, rs)
        dr_j = vjp_s(jd)[1].astype(jnp.float32).sum(0)
    hs, (dwx, dr, dst) = _plain_bwd(wx, r, dhs, dtype)
    assert dst is None and dwx.dtype == dr.dtype == getattr(torch, dtype)
    assert tuple(dwx.shape) == wx.shape and tuple(dr.shape) == r.shape
    assert _rel(hs, hs_j) <= TOL[dtype]
    assert _rel(dwx, dw_j) <= TOL[dtype]
    assert _rel(dr, dr_j) <= TOL[dtype]


def _warm_state(Bn, H, dh, seed, dtype=torch.float64):
    """A start state as a decode finds it: a plain prefill's of 6 positions."""
    wx, r, _ = _inputs(Bn, 6, H, dh, seed)
    st0 = ref.slstm_state0(Bn, H, dh, "cpu")
    st = ref.slstm_scan(torch.from_numpy(wx).to(dtype), torch.from_numpy(r).to(dtype),
                        tuple(t.to(dtype) for t in st0))[1]
    return tuple(t.detach().clone() for t in st)


def _cell_m_held(gates, state, H, dh):
    """``ref.slstm_cell`` with the new stabilizer held constant where the
    step uses it (its gradient stopped)."""
    Bn = gates.shape[0]
    i_raw, f_raw, z_raw, o_raw = gates.reshape(Bn, H, 4, dh).unbind(2)
    c, n, m, _ = state
    lf = torch.nn.functional.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m, i_raw).detach()
    fs, is_ = torch.exp(lf + m - m_new), torch.exp(i_raw - m_new)
    c_new = fs * c + is_ * torch.tanh(z_raw)
    n_new = fs * n + is_
    return c_new, n_new, m_new, torch.sigmoid(o_raw) * c_new / torch.clamp_min(n_new, 1e-6)


def _autograd(wx, r, state, dhs, m_held=False):
    """The plain scan's gradient by autograd (float64): every position's
    cell through ``ref.slstm_cell``, or with ``m_held`` through
    :func:`_cell_m_held`."""
    leaves = [t.clone().requires_grad_(True) for t in (wx, r, *state)]
    wx, r, *st = leaves
    Bn, Sn, _ = wx.shape
    H, dh = r.shape[:2]
    cell = _cell_m_held if m_held else ref.slstm_cell
    st = tuple(st)
    hs = []
    for t in range(Sn):
        rh = torch.einsum("bhj,hjg->bhg", st[3], r).reshape(Bn, -1)
        st = cell(wx[:, t] + rh, st, H, dh)
        hs.append(st[3])
    return torch.autograd.grad(torch.stack(hs, 1), leaves, dhs)


@pytest.mark.parametrize("warm", [False, True])
def test_plain_bwd_matches_autograd_in_float64(warm):
    """From the prefill's state0 (its gradient: None) and from a warm start
    state (its gradient (dc, dn, dm, dh) against autograd's)."""
    Bn, Sn, H, dh = 2, 12, 2, 8
    wx, r, dhs = _inputs(Bn, Sn, H, dh, 3)
    f = torch.float64
    state = _warm_state(Bn, H, dh, 4) if warm else tuple(
        t.to(f) for t in ref.slstm_state0(Bn, H, dh, "cpu"))
    wx, r, dhs = (torch.from_numpy(a).to(f) for a in (wx, r, dhs))
    want = _autograd(wx, r, state, dhs)
    hs, _, saved = ref.slstm_scan(wx, r, state, states=True)
    dwx, dr, dst = ref.slstm_scan_bwd(r, state, hs, saved, dhs, dstate=warm)
    assert dwx.dtype == dr.dtype == f
    assert _rel(dwx, want[0]) <= 1e-10 and _rel(dr, want[1]) <= 1e-10
    if warm:
        for a, b in zip(dst, want[2:]):
            assert _rel(a, b) <= 1e-10
    else:
        assert dst is None


class _PlainScan(torch.autograd.Function):
    """The kernels' function and gradient in their plain versions: the
    training forward (``states=True``) and ``ref.slstm_scan_bwd``."""

    @staticmethod
    def forward(ctx, wx, r, c, n, m, h):
        hs, _, saved = ref.slstm_scan(wx, r, (c, n, m, h), states=True)
        ctx.save_for_backward(r, c, n, m, h, hs, *saved)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        r, c, n, m, h, hs, *saved = ctx.saved_tensors
        dwx, dr, dst = ref.slstm_scan_bwd(r, (c, n, m, h), hs, tuple(saved), dhs,
                                          dstate=True)
        return dwx, dr, *dst


def test_plain_bwd_passes_gradcheck_in_float64():
    Bn, Sn, H, dh = 2, 5, 2, 3
    wx, r, _ = _inputs(Bn, Sn, H, dh, 5)
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (wx, r)]
    leaves += [t.requires_grad_(True) for t in _warm_state(Bn, H, dh, 6)]
    assert torch.autograd.gradcheck(_PlainScan.apply, tuple(leaves))


def test_stabilizer_gradient_cancels():
    """Autograd of the plain scan with every step's new m held constant
    equals autograd through m (float64, 1e-10), every leaf's gradient, the
    start state's m included (it scales c_0 and n_0 through the first fs):
    h does not depend on the m trajectory, so the backward holds m
    constant."""
    Bn, Sn, H, dh = 2, 16, 2, 8
    wx, r, dhs = (torch.from_numpy(a).double() for a in _inputs(Bn, Sn, H, dh, 7))
    state = _warm_state(Bn, H, dh, 8)
    through_m = _autograd(wx, r, state, dhs)
    held = _autograd(wx, r, state, dhs, m_held=True)
    for a, b in zip(held, through_m):
        assert _rel(a, b) <= 1e-10


def test_ops_slstm_scan_is_differentiable_on_the_cpu():
    """The plain route: autograd of ``ref.slstm_scan``, no kernel launched;
    its gradient is the plain backward's (float32, 2e-5)."""
    wx, r, dhs = _inputs(2, 10, 2, 32, 9)
    tw, tr = (torch.from_numpy(a).requires_grad_(True) for a in (wx, r))
    st0 = ref.slstm_state0(2, 2, 32, "cpu")
    n0 = (SL.launches, SL.train_launches, SL.bwd_launches)
    hs, _ = ops.slstm_scan(tw, tr, st0)
    got = torch.autograd.grad(hs, (tw, tr), torch.from_numpy(dhs))
    assert (SL.launches, SL.train_launches, SL.bwd_launches) == n0
    _, (dwx, dr, _) = _plain_bwd(wx, r, dhs, "float32")
    assert _rel(got[0], dwx) <= 2e-5 and _rel(got[1], dr) <= 2e-5


def test_backward_kernel_refuses_cpu_tensors():
    wx, r, dhs = _inputs(1, 4, 2, 32, 10)
    hs, _, saved = ref.slstm_scan(torch.from_numpy(wx), torch.from_numpy(r),
                                  ref.slstm_state0(1, 2, 32, "cpu"), states=True)
    with pytest.raises(ValueError, match="CUDA"):
        SL.slstm_scan_bwd(torch.from_numpy(r), ref.slstm_state0(1, 2, 32, "cpu"), hs, saved,
                          torch.from_numpy(dhs))
    with pytest.raises(ValueError, match="CUDA"):
        SL.slstm_scan(torch.from_numpy(wx), torch.from_numpy(r),
                      ref.slstm_state0(1, 2, 32, "cpu"), states=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.slstm_scan(torch.from_numpy(wx).requires_grad_(True), torch.from_numpy(r),
                       ref.slstm_state0(1, 2, 32, "cpu"), force="kernel")


# -- the blocks in train mode ----------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, JaxModel(JCFG).init(jax.random.key(0)))


@pytest.mark.parametrize("blk", ["mlstm", "slstm"])
def test_block_train_mode_matches_jax_vjp(jparams, blk):
    """Layer 1's block in train mode: the output and the gradients of every
    param leaf and of the input against ``jax.vjp`` of the reference's
    block (1e-4); train mode writes no cache."""
    jp = {k: v[1] for k, v in jparams["segments"][0][blk].items()}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, CFG.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, S, CFG.d_model)).astype(np.float32)
    japply = JX.mlstm_apply if blk == "mlstm" else JX.slstm_apply
    tapply = X.mlstm_apply if blk == "mlstm" else X.slstm_apply
    ctx = ShardingCtx(None, rules_for(JCFG, "train"))

    def f(p, xx):
        return japply(ctx, JCFG, p, xx, mode="train")[0]
    jout, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    jdp, jdx = vjp(jnp.asarray(dy))
    names = sorted(jp)
    tp = {k: torch.tensor(jp[k], requires_grad=True) for k in names}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, cache = tapply(CFG, tp, tx, mode="train", cache=None)
    assert cache is None
    assert _rel(out, jout) <= 1e-5
    got = torch.autograd.grad(out, [tp[k] for k in names] + [tx], torch.from_numpy(dy))
    for k, g in zip(names + ["x"], got):
        want = jdx if k == "x" else jdp[k]
        assert _rel(g, want) <= 1e-4, k


@pytest.mark.parametrize("remat", [True, False])
def test_remat_marks_the_recompute_alone(monkeypatch, remat):
    """A train step under remat runs each sLSTM layer's scan twice, in the
    checkpoint's first pass marked "forward" and in the backward's
    recompute marked "recompute" (``ops.remat_context``), where the kernel
    route launches the serving kernel and the training forward; without
    remat once, unmarked. Outside a step nothing is marked."""
    from repro_torch import steps as ST
    from repro_torch.data import synth_batch
    from repro_torch.models import Model
    seen = []
    plain = ref.slstm_scan

    def spy(*a, **k):
        seen.append(ops.remat_pass())
        return plain(*a, **k)
    monkeypatch.setattr(ref, "slstm_scan", spy)
    cfg = dataclasses.replace(CFG, remat=remat)
    model = Model(cfg)
    params = model.init(0, "cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in synth_batch(cfg, B, 16, 1, 0).items()}
    ST.loss_and_grads(model, params, batch)
    pairs = cfg.n_layers // 2
    assert seen == (["forward"] * pairs + ["recompute"] * pairs if remat else [None] * pairs)
    assert ops.remat_pass() is None


def test_blocks_refuse_a_mode_they_do_not_take():
    for apply in (X.mlstm_apply, X.slstm_apply):
        with pytest.raises(NotImplementedError, match="train"):
            apply(CFG, {}, torch.zeros(1, 4, CFG.d_model), mode="paged_decode", cache=None)


def test_train_mode_keeps_the_prefill_length_check():
    p = {k: torch.zeros(v.shape) for k, v in X.slstm_specs(CFG).items()}
    with pytest.raises(ValueError, match="d_conv"):
        X.slstm_apply(CFG, p, torch.zeros(1, 2, CFG.d_model), mode="train", cache=None)


# -- the Trainer --------------------------------------------------------------------

def test_trainer_takes_full_width_xlstm():
    tr = Trainer(configs.get_config(ARCH), device="cpu")
    tr.pipeline.stop()
    assert tr.model.cfg.n_layers == 24 and tr.params is None


@pytest.fixture(scope="module")
def jax_states():
    """The JAX Trainer's ten xLSTM steps: the state (params, AdamW m and v)
    before each step and each step's metrics."""
    tr = JaxTrainer(JCFG, batch_size=B, seq_len=S, world_size=2, total_steps=STEPS, mesh=None)
    tr.init_state()
    states, metrics = [], []
    for _ in range(STEPS):
        states.append(jax.tree.map(np.asarray, {"p": tr.params, "o": tr.opt_state}))
        metrics.append({k: float(v) for k, v in tr.step_once().items()})
    tr.pipeline.stop()
    return states, metrics


def _held(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"] == i + 1
        for k in ("loss", "grad_norm", "world_loss"):
            assert abs(float(g[k]) - w[k]) <= 1e-4 * abs(w[k]), (i, k, float(g[k]), w[k])


def test_ten_steps_match_the_jax_trainer_from_its_states(jax_states):
    """Ten steps, each from the JAX Trainer's state before it (the port's
    own data cursor and key stream run on): loss, grad_norm and world_loss
    within 1e-4 (6.2e-6 read). Run free, two float32 trainers are held
    this close only through step 4 (``test_steps_run_free_match_the_jax_trainer``):
    the port's float32 run leaves the JAX Trainer's by 4.3e-4 in grad_norm
    at step 5 and 1.3e-3 at step 9, while the JAX float32 Trainer itself
    sits 1.1e-3 from the float64 trajectory at step 5 and the two float64
    runs stay within 6.1e-6 over ten steps
    (``test_ten_steps_in_float64_match_the_jax_trainer_under_x64``): AdamW
    normalizes each entry's step, so an entry whose gradient is rounding
    noise moves by a full step of either sign, as hymba's do."""
    states, want = jax_states
    tr = Trainer(CFG, batch_size=B, seq_len=S, world_size=2, total_steps=STEPS, device="cpu")
    tr.init_state()
    got = []
    try:
        for st in states:
            tr.params = from_jax_params(st["p"], CFG, "cpu")
            tr.opt_state = {k: from_jax_params(st["o"][k], CFG, "cpu") for k in ("m", "v")}
            got.append(tr.step_once())
    finally:
        tr.pipeline.stop()
    _held(got, want)


#: free-running, the two float32 trainers stay within 1e-4 through this
#: step (1.2e-6 in grad_norm at step 4, 4.3e-4 at step 5)
FREE_STEPS = 4


def test_steps_run_free_match_the_jax_trainer(jax_states):
    """The port's Trainer run free from the JAX Trainer's initial params,
    its own AdamW updates of the stacked pairs included: loss, grad_norm
    and world_loss within 1e-4 over the steps two float32 trajectories
    stay that close."""
    states, want = jax_states
    tr = Trainer(CFG, batch_size=B, seq_len=S, world_size=2, total_steps=STEPS, device="cpu")
    tr.init_state(from_jax_params(states[0]["p"], CFG, "cpu"))
    try:
        got = [tr.step_once() for _ in range(FREE_STEPS)]
    finally:
        tr.pipeline.stop()
    assert tr.step == FREE_STEPS
    _held(got, want)


class _Float64Names:
    """``jax.numpy`` with ``float32`` standing for ``float64``."""

    def __init__(self):
        self.float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_ten_steps_in_float64_match_the_jax_trainer_under_x64(jax_states):
    """The JAX Trainer under ``jax_enable_x64``, its model modules computing
    in float64 where they name float32 (the schedule stays float32, as the
    port's does), against the port's Trainer in float64, ten steps run free
    from the same params: loss, grad_norm and world_loss within 1e-4
    (6.1e-6 read): the float32 parting is rounding, not a difference of the
    packages. The key stream advanced by fold_in as the reference's."""
    from repro.models import layers as JL
    from repro.models import ssm as JS
    from repro.models import transformer as JT

    p0 = jax_states[0][0]["p"]
    dt = dict(param_dtype="float64", compute_dtype="float64", opt_state_dtype="float64")
    mods = (JL, JS, JT, JX)
    jax.config.update("jax_enable_x64", True)
    for m in mods:
        m.jnp = _Float64Names()
    try:
        jt = JaxTrainer(dataclasses.replace(JCFG, **dt), batch_size=B, seq_len=S, world_size=2,
                        total_steps=STEPS, mesh=None)
        jt.params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), p0)
        jt.opt_state = jt.optimizer.init(jt.params)
        try:
            want = [{k: float(v) for k, v in jt.step_once().items()} for _ in range(STEPS)]
        finally:
            jt.pipeline.stop()
        assert jax.tree.leaves(jt.params)[0].dtype == jnp.float64
    finally:
        for m in mods:
            m.jnp = jnp
        jax.config.update("jax_enable_x64", False)
    cfg = dataclasses.replace(CFG, **dt)
    tr = Trainer(cfg, batch_size=B, seq_len=S, world_size=2, total_steps=STEPS, device="cpu")
    tr.init_state(from_jax_params(p0, cfg, "cpu"))
    try:
        got = [tr.step_once() for _ in range(STEPS)]
    finally:
        tr.pipeline.stop()
    assert tr.step == STEPS
    assert tr.params["head"].dtype == torch.float64
    _held(got, want)
    key = jax.random.key(2)
    for s in range(STEPS):
        key = jax.random.fold_in(key, s)
    assert np.array_equal(tr.rng_key, np.asarray(jax.random.key_data(key)))
