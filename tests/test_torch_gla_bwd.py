"""The GLA backward's plain version and the SSD mixer's train mode against
the JAX package, on the CPU (float32, hymba's smoke config).

* ``ref.gla_bwd`` (the formula the GLA backward kernel computes: the
  chunks in reverse carrying dS, dlg by the scalar-decay identity) against
  ``jax.vjp`` of the reference's ``ssm.chunked_gla``: per-head q and k, and
  head-broadcast q and k as the SSD mixer passes them (the JAX gradient is
  then the sum over heads), S divisible and not divisible by the chunk,
  mild and steep decays, and a non-zero gradient of the final state.
  Tolerance 1e-5 (max |a - b| / max |b|): float32 both, the same products
  summed in another order. Under steep decays the reference's lg gradient
  is nan (its ``chunked_gla`` masks exp(cum_i - cum_j) only after the exp,
  which overflows above the diagonal, and the where's gradient is then
  0 * inf); there dlg is held to autograd alone.
* The same formula against autograd through ``ref.chunked_gla`` (whose
  masked exponent keeps its gradient finite), and as its backward under
  ``torch.autograd.gradcheck`` in float64.
* ``ops.gla``'s plain route differentiable, the parallel schedule refusing
  a gradient, and the chunk start states of ``ref.chunked_gla`` equal to
  the chunk-parallel scan's.
* The rows the heads share ([B,S,N] q and k, as the SSD mixer passes C_t
  and B_t): ``ops.gla`` equal to the expanded call in values and
  gradients, ``ref.gla_bwd`` returning the heads' sum against ``jax.vjp``,
  and ``ref.gla_bwd_states`` (the backward kernel's reversed state pass)
  against the gradient of a state fed in through a prefix chunk, by
  ``jax.vjp`` and by autograd, with a final-state cotangent (1e-5).
* ``ssd_apply(mode="train")`` against the reference's train mode, output
  and gradients (1e-4, tests/conftest.py's assert_close, as the mixer's
  other tests).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import assert_close  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.sharding import ShardingCtx, rules_for  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import gla_chunk as GC  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402

torch.set_num_threads(1)
CFG, JCFG = smoke_config("hymba-1.5b"), jax_smoke_config("hymba-1.5b")
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _inputs(B, S, H, N, P, seed, *, bcast, steep):
    """The GLA sweep's distributions from numpy; ``bcast``: one q and k row
    per position ([B,S,1,N]) for every head; ``steep``: log decays uniform
    in [-20, 0] a step."""
    rng = np.random.default_rng(seed)
    hq = 1 if bcast else H
    q = rng.standard_normal((B, S, hq, N), dtype=np.float32)
    k = rng.standard_normal((B, S, hq, N), dtype=np.float32) * 0.3
    v = rng.standard_normal((B, S, H, P), dtype=np.float32)
    if steep:
        lg = -20 * rng.random((B, S, H), dtype=np.float32)
    else:
        lg = -np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32))) * 0.3
    dy = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dfinal = rng.standard_normal((B, H, N, P), dtype=np.float32)
    return q, k, v, lg.astype(np.float32), dy, dfinal


# (B, S, H, N, P, chunk, bcast, steep, dfinal)
VJP_CASES = {
    "mild": (2, 48, 3, 8, 32, 16, False, False, False),
    "bcast": (2, 48, 3, 8, 32, 16, True, False, False),
    "ragged-bcast": (1, 40, 2, 16, 64, 16, True, False, False),   # chunk halved to 8
    "steep-bcast": (2, 48, 2, 8, 32, 16, True, True, False),
    "dfinal": (1, 40, 2, 8, 32, 16, False, False, True),
    "dfinal-bcast-steep": (1, 48, 2, 8, 32, 16, True, True, True),
    "one-chunk": (2, 24, 2, 16, 64, 256, True, False, False),   # chunk > S
}


@pytest.mark.parametrize("B,S,H,N,P,chunk,bcast,steep,dfinal", list(VJP_CASES.values()),
                         ids=list(VJP_CASES))
def test_gla_bwd_matches_jax_vjp(B, S, H, N, P, chunk, bcast, steep, dfinal):
    q, k, v, lg, dy, df = _inputs(B, S, H, N, P, 7, bcast=bcast, steep=steep)

    def f(q_, k_, v_, lg_):
        if bcast:
            q_, k_ = (jnp.broadcast_to(x, (B, S, H, N)) for x in (q_, k_))
        return JS.chunked_gla(q_, k_, v_, lg_, chunk=chunk)
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v, lg)))
    want = vjp((jnp.asarray(dy), jnp.asarray(df if dfinal else np.zeros_like(df))))
    tq, tk = (torch.from_numpy(x).expand(B, S, H, N) for x in (q, k))
    tv, tlg = torch.from_numpy(v), torch.from_numpy(lg)
    _, _, starts = ref.chunked_gla(tq, tk, tv, tlg, chunk=chunk, starts=True)
    got = ref.gla_bwd(tq, tk, tv, tlg, torch.from_numpy(dy), starts, chunk=chunk,
                      dfinal=torch.from_numpy(df) if dfinal else None)
    assert all(g.dtype == torch.float32 for g in got)
    dq, dk, dv, dlg = got
    assert dq.shape == dk.shape == (B, S, H, N) and dlg.shape == (B, S, H)
    if bcast:        # the expand's backward: the sum over heads
        dq, dk = (x.sum(2, keepdim=True) for x in (dq, dk))
    names = ("dq", "dk", "dv", "dlg")
    if steep:        # the reference's own lg gradient is nan here (module docstring)
        assert not np.isfinite(want[3]).all()
        names = names[:3]
    for name, a, b in zip(names, (dq, dk, dv, dlg), want):
        assert a.shape == b.shape and _rel(a.numpy(), b) <= TOL, name


@pytest.mark.parametrize("B,S,H,N,P,chunk,bcast,steep,dfinal", list(VJP_CASES.values()),
                         ids=list(VJP_CASES))
def test_gla_bwd_matches_autograd_of_the_plain_forward(B, S, H, N, P, chunk, bcast, steep,
                                                        dfinal):
    q, k, v, lg, dy, df = (torch.from_numpy(x) for x in
                           _inputs(B, S, H, N, P, 8, bcast=bcast, steep=steep))
    ins = [q.clone().requires_grad_(), k.clone().requires_grad_(), v.requires_grad_(),
           lg.requires_grad_()]
    y, final, starts = ref.chunked_gla(ins[0].expand(B, S, H, N), ins[1].expand(B, S, H, N),
                                       ins[2], ins[3], chunk=chunk, starts=True)
    loss = (y * dy).sum() + ((final * df).sum() if dfinal else 0)
    want = torch.autograd.grad(loss, ins)
    got = ref.gla_bwd(*(x.detach().expand(B, S, H, x.shape[-1]) for x in ins[:2]),
                      ins[2].detach(), ins[3].detach(), dy, starts.detach(), chunk=chunk,
                      dfinal=df if dfinal else None)
    dq, dk = (x.sum(2, keepdim=True) if bcast else x for x in got[:2])
    for name, a, b in zip(("dq", "dk", "dv", "dlg"), (dq, dk) + got[2:], want):
        assert torch.isfinite(b).all() and _rel(a.numpy(), b.numpy()) <= TOL, name


class _PlainGLA(torch.autograd.Function):
    """ref.chunked_gla with ref.gla_bwd as its backward (the formula the
    backward kernel computes), the final state's gradient included."""

    @staticmethod
    def forward(ctx, q, k, v, lg, chunk):
        y, final, starts = ref.chunked_gla(q, k, v, lg, chunk=chunk, starts=True)
        ctx.save_for_backward(q, k, v, lg, starts)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        q, k, v, lg, starts = ctx.saved_tensors
        return (*ref.gla_bwd(q, k, v, lg, dy, starts, chunk=ctx.chunk, dfinal=dfinal),
                None)


@pytest.mark.parametrize("bcast", [False, True])
def test_gla_bwd_passes_gradcheck_in_float64(bcast):
    g = torch.Generator().manual_seed(0)
    B, S, H, N, P = 1, 10, 2, 3, 4          # chunk 4 halved to 2
    hq = 1 if bcast else H
    q, k = (torch.randn(B, S, hq, N, generator=g, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    v = torch.randn(B, S, H, P, generator=g, dtype=torch.float64, requires_grad=True)
    lg = (-torch.rand(B, S, H, generator=g, dtype=torch.float64)).requires_grad_()

    def f(q_, k_, v_, lg_):
        return _PlainGLA.apply(q_.expand(B, S, H, N), k_.expand(B, S, H, N), v_, lg_, 4)
    assert torch.autograd.gradcheck(f, (q, k, v, lg))


def test_ops_gla_is_differentiable_on_the_cpu():
    q, k, v, lg, dy, df = (torch.from_numpy(x) for x in
                           _inputs(1, 24, 2, 8, 32, 3, bcast=True, steep=False))
    q, k = (x.expand(1, 24, 2, 8) for x in (q, k))
    ins = [x.clone().requires_grad_() for x in (q, k, v, lg)]
    y, final = ops.gla(*ins, chunk=8)
    got = torch.autograd.grad((y * dy).sum() + (final * df).sum(), ins)
    starts = ref.chunked_gla(q, k, v, lg, chunk=8, starts=True)[2]
    want = ref.gla_bwd(q, k, v, lg, dy, starts, chunk=8, dfinal=df)
    for name, a, b in zip(("dq", "dk", "dv", "dlg"), got, want):
        assert _rel(a.numpy(), b.numpy()) <= TOL, name
    assert GC.bwd_launches == 0
    with pytest.raises(ValueError, match="chunk schedule"):
        ops.gla(*ins, chunk=8, schedule="parallel")
    with torch.no_grad():        # serving's parallel prefill takes no gradient
        ops.gla(*ins, chunk=8, schedule="parallel")


def test_chunk_start_states_are_the_parallel_scans():
    q, k, v, lg, _, _ = (torch.from_numpy(x) for x in
                         _inputs(2, 40, 3, 8, 32, 5, bcast=False, steep=False))
    y0, f0 = ref.chunked_gla(q, k, v, lg, chunk=16)
    y, final, starts = ref.chunked_gla(q, k, v, lg, chunk=16, starts=True)
    assert torch.equal(y, y0) and torch.equal(final, f0)
    assert starts.shape == (2, 3, 5, 8, 32) and starts.dtype == torch.float32
    _, g, d = ref.gla_phase_a(q, k, v, lg, chunk=16)
    scan_starts, scan_final = ref.gla_scan(g, d)
    torch.testing.assert_close(starts, scan_starts, rtol=1e-6, atol=1e-6)
    assert not starts[:, :, 0].any()


@pytest.mark.parametrize("schedule", ["chunk", "parallel"])
def test_ops_gla_takes_shared_rows_as_the_expanded_call(schedule):
    """q and k as [B,S,N] rows shared by the heads: the same values as the
    head-stride-0 expand, and (chunk schedule) the same gradients, the
    expand's sum over heads included."""
    B, S, H, N, P = 2, 40, 3, 8, 32
    q, k, v, lg, dy, df = (torch.from_numpy(x) for x in
                           _inputs(B, S, H, N, P, 11, bcast=True, steep=False))
    q, k = q[:, :, 0], k[:, :, 0]
    grad = schedule == "chunk"
    a = [x.clone().requires_grad_(grad) for x in (q, k, v, lg)]
    b = [x.clone().requires_grad_(grad) for x in (q, k, v, lg)]
    with torch.set_grad_enabled(grad):
        y1, f1 = ops.gla(*a, chunk=16, schedule=schedule)
        y2, f2 = ops.gla(b[0][:, :, None].expand(B, S, H, N),
                         b[1][:, :, None].expand(B, S, H, N), b[2], b[3], chunk=16,
                         schedule=schedule)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)
    if not grad:
        return
    g1 = torch.autograd.grad((y1 * dy).sum() + (f1 * df).sum(), a)
    g2 = torch.autograd.grad((y2 * dy).sum() + (f2 * df).sum(), b)
    for name, x, y in zip(("dq", "dk", "dv", "dlg"), g1, g2):
        assert x.shape == y.shape and torch.equal(x, y), name
    assert g1[0].shape == (B, S, N)


@pytest.mark.parametrize("steep", [False, True])
def test_gla_bwd_of_shared_rows_is_the_heads_sum_against_jax(steep):
    B, S, H, N, P, chunk = 2, 48, 3, 8, 32, 16
    q, k, v, lg, dy, _ = _inputs(B, S, H, N, P, 12, bcast=True, steep=steep)

    def f(q_, k_, v_, lg_):
        q_, k_ = (jnp.broadcast_to(x[:, :, None], (B, S, H, N)) for x in (q_, k_))
        return JS.chunked_gla(q_, k_, v_, lg_, chunk=chunk)
    q3, k3 = q[:, :, 0], k[:, :, 0]
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q3, k3, v, lg)))
    want = vjp((jnp.asarray(dy), jnp.zeros((B, H, N, P), jnp.float32)))
    tq, tk = torch.from_numpy(q3), torch.from_numpy(k3)
    tv, tlg = torch.from_numpy(v), torch.from_numpy(lg)
    starts = ref.chunked_gla(tq[:, :, None].expand(B, S, H, N), tk[:, :, None].expand(
        B, S, H, N), tv, tlg, chunk=chunk, starts=True)[2]
    got = ref.gla_bwd(tq, tk, tv, tlg, torch.from_numpy(dy), starts, chunk=chunk)
    assert got[0].shape == got[1].shape == (B, S, N)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):   # lg: see the module docstring
        assert _rel(a.numpy(), b) <= TOL, name


def _prefixed(q, k, v, lg, dy, z, c):
    """The chunks after chunk z, behind a prefix chunk of c positions that
    feeds a state S0 in: positions n < N carry k = e_n and v = S0[n] (the
    variable), q = 0 and lg = 0, so the state entering the first real chunk
    is S0 and the prefix adds nothing to y. Returns the inputs (numpy) with
    v's prefix rows zero, to be filled, and dy with a zero prefix."""
    B, N = q.shape[0], q.shape[-1]

    def pre(x):
        return np.concatenate([np.zeros((B, c) + x.shape[2:], x.dtype), x[:, (z + 1) * c:]], 1)
    kp = pre(k)
    kp[:, :N] = np.eye(N, dtype=np.float32)[None, :, None, :]
    return pre(q), kp, pre(v), pre(lg), pre(dy)


@pytest.mark.parametrize("bcast", [False, True])
def test_gla_bwd_states_against_jax_vjp_and_autograd(bcast):
    """dS_z, the gradient of the state leaving chunk z, for every z, with a
    final-state cotangent: ref.gla_bwd_states against the gradient of S0
    fed in by a prefix chunk before chunks z+1.. (jax.vjp of the
    reference's chunked_gla, and autograd of ref.chunked_gla)."""
    B, S, H, N, P, c = 2, 48, 3, 8, 32, 16
    q, k, v, lg, dy, df = _inputs(B, S, H, N, P, 13, bcast=bcast, steep=False)
    qh, kh = (np.broadcast_to(x, (B, S, H, N)).copy() for x in (q, k))
    tq = torch.from_numpy(q[:, :, 0] if bcast else q)
    got = ref.gla_bwd_states(tq, torch.from_numpy(lg), torch.from_numpy(dy), chunk=c,
                             dfinal=torch.from_numpy(df))
    assert got.shape == (B, H, S // c, N, P) and got.dtype == torch.float32
    for z in range(S // c):
        pq, pk, pv, plg, pdy = _prefixed(qh, kh, v, lg, dy, z, c)
        s0 = np.random.default_rng(z).standard_normal((B, H, N, P)).astype(np.float32)

        def f(s0_):
            vv = jnp.asarray(pv).at[:, :N].set(jnp.transpose(s0_, (0, 2, 1, 3)))
            return JS.chunked_gla(jnp.asarray(pq), jnp.asarray(pk), vv, jnp.asarray(plg),
                                  chunk=c)
        _, vjp = jax.vjp(f, jnp.asarray(s0))
        want = np.asarray(vjp((jnp.asarray(pdy), jnp.asarray(df)))[0])
        assert _rel(got[:, :, z].numpy(), want) <= TOL, z
        ts0 = torch.from_numpy(s0).requires_grad_()
        tv = torch.cat([ts0.permute(0, 2, 1, 3), torch.from_numpy(pv[:, N:])], 1)
        y, fin = ref.chunked_gla(*(torch.from_numpy(x) for x in (pq, pk)), tv,
                                 torch.from_numpy(plg), chunk=c)
        (g,) = torch.autograd.grad((y * torch.from_numpy(pdy)).sum()
                                   + (fin * torch.from_numpy(df)).sum(), ts0)
        assert _rel(got[:, :, z].numpy(), g.numpy()) <= TOL, z


def test_head_group_fills_the_card_with_equal_groups():
    """K4b's head groups: hymba's training shape takes 5 heads a block
    (480 blocks a launch); every shape gets three blocks an H100 SM (the
    groups aim at BWD_BLOCKS, four) unless one head a block gives fewer,
    with groups as even as the count allows."""
    assert GC.head_group(4, 1536, 25, 256) == 5
    assert GC.head_group(1, 64, 2, 16) == 1               # small: a head a group
    for B, S, H, c in ((4, 1536, 25, 256), (2, 512, 3, 256), (1, 1000, 2, 8), (1, 64, 2, 16)):
        hg = GC.head_group(B, S, H, c)
        ng = -(-H // hg)
        blocks = B * (S // c) * -(-c // 64) * ng
        assert 1 <= hg <= H and (blocks >= 3 * 132 or hg == 1)
        assert ng * hg - H < hg                           # no empty group


def test_gla_bwd_wrapper_refuses_cpu_tensors():
    q, k, v, lg, dy, _ = (torch.from_numpy(x) for x in
                          _inputs(1, 16, 2, 8, 32, 3, bcast=False, steep=False))
    with pytest.raises(ValueError, match="CUDA"):
        GC.gla_chunk_bwd(q, k, v, lg, dy, torch.zeros(1, 2, 2, 8, 32), chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        GC.gla_chunk(q, k, v, lg, chunk=8, starts=True)


@pytest.fixture(scope="module")
def ssd_params():
    jp = jax_init_params(JS.ssd_specs(JCFG), jax.random.key(5), jnp.float32)
    rng = np.random.default_rng(5)
    for name in ("a_log", "dt_bias", "d_skip"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape, dtype=np.float32) * 0.5)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("S", [48, 13, 2])   # 13: chunk halved to 1; 2 < d_conv - 1
def test_ssd_train_mode_matches_jax(ssd_params, S):
    """Output and the gradients of every param and of x, through the GLA
    backward's plain route, against jax.vjp of the reference's train mode."""
    jp, tp = ssd_params
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, CFG.d_model), dtype=np.float32)
    dout = rng.standard_normal((2, S, CFG.d_model), dtype=np.float32)
    ctx = ShardingCtx(None, rules_for(JCFG, "train"))
    jout, vjp = jax.vjp(lambda p, x_: JS.ssd_apply(ctx, JCFG, p, x_, mode="train")[0],
                        jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dout))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, cache = SSM.ssd_apply(CFG, leaves, tx, mode="train")
    assert cache is None
    assert_close(out.detach(), jout)
    names = sorted(leaves)
    grads = torch.autograd.grad(out, [leaves[n] for n in names] + [tx],
                                torch.from_numpy(dout))
    for n, gr in zip(names, grads):
        assert_close(gr, jgp[n], msg=n)
    assert_close(grads[-1], jgx, msg="x")


def test_ssd_train_mode_is_the_prefill_without_a_cache(ssd_params):
    _, tp = ssd_params
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 20, CFG.d_model),
                                                                  dtype=np.float32))
    cache = {k: torch.zeros((2, *shape)) for k, (shape, _) in SSM.cache_shapes(CFG).items()}
    want, _ = SSM.ssd_apply(CFG, tp, x, mode="prefill", cache=cache)
    got, none = SSM.ssd_apply(CFG, tp, x, mode="train")
    assert none is None and torch.equal(got, want)


def test_gla_backward_source_is_deterministic_and_checked():
    """The GLA backward sums in fixed orders (no atomics anywhere in its
    source), refuses more shared memory than a block has, and each C entry
    returns the launch's status."""
    from pathlib import Path
    src = (Path(GC.__file__).resolve().parents[1] / "csrc" / "gla_chunk.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code
    for entry in ("repro_gla_chunk_bwd", "repro_gla_chunk_starts"):
        assert f'extern "C" int {entry}(' in src
    launch = src[src.index("int launch_bwd("):src.index("int dispatch_bwd(")]
    assert "smem > MAX_SMEM" in launch and "return (int)cudaGetLastError();" in launch
    assert GC.KERNELS.index("bwd") == 3 and "BWD = 3" in src
