"""The port's optimizers and LR schedules against the JAX package's: the
same params and gradients (numpy from a seed) through AdamW and Adafactor
for 3 steps, the three schedules, and the global norm. Tolerance: max |a -
b| / max |b| <= 1e-6 per leaf (float32 on both sides; the sums run in
another order, and the port's AdamW updates in place, which may fuse a
multiply-add the reference rounds twice)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as JO  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import (adafactor, adamw, constant, cosine,  # noqa: E402
                               global_norm, make_optimizer, wsd)

torch.set_num_threads(1)
REL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _tree(rng, scale=1.0):
    """A params-shaped tree: a list of dicts like a model's segments, one
    leaf large enough for Adafactor to factor, one vector, one stacked."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": a(160, 130), "segments": [{"w": a(3, 16, 8), "b": a(8)}],
            "final_norm": a(130)}


def _to_torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _check(tag, got, want):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        r = _rel(g.numpy(), np.asarray(w))
        assert r <= REL, (tag, i, r)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax_over_three_steps(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale=s) for s in (1.0, 0.3, 3.0)]   # 3.0 trips the clip
    sched_j, sched_t = JS.constant(1e-2), constant(1e-2)
    jopt = (JO.adamw if name == "adamw" else JO.adafactor)(sched_j)
    topt = (adamw if name == "adamw" else adafactor)(sched_t)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = topt.init(tp)
    assert topt.name == jopt.name == name
    _check("init state", ts, js)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.int32(step))
        tp, ts = topt.update(_to_torch(g), ts, tp, step)
        _check(f"params step {step}", tp, jp)
        _check(f"state step {step}", ts, js)


def test_adamw_keeps_bf16_params_and_state_dtypes():
    """A bf16 param and bf16 state: the update runs in float32 and casts
    back, as the reference's does; the values match it within one bf16
    rounding (2^-8)."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal((4, 8)).astype(np.float32)
    g = rng.standard_normal((4, 8)).astype(np.float32)
    jopt = JO.adamw(JS.constant(1e-2), state_dtype=jnp.bfloat16)
    topt = adamw(constant(1e-2), state_dtype=torch.bfloat16)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    jp, js = jopt.update({"w": jnp.asarray(g)}, jopt.init(jp), jp, jnp.int32(0))
    tp, ts = topt.update({"w": torch.from_numpy(g)}, topt.init(tp), tp, 0)
    assert tp["w"].dtype == ts["m"]["w"].dtype == torch.bfloat16
    for a, b in ((tp["w"], jp["w"]), (ts["m"]["w"], js["m"]["w"]),
                 (ts["v"]["w"], js["v"]["w"])):
        assert _rel(a.float().numpy(), np.asarray(b, np.float32)) <= 2 ** -8


def test_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    got = global_norm(_to_torch(tree)).item()
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert abs(got - want) <= REL * want


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-3),
    lambda m: m.cosine(3e-3, 10, 100),
    lambda m: m.wsd(3e-3, 10, 100),
    lambda m: m.wsd(1e-2, 1, 7, decay_frac=0.4, final_frac=0.05),
])
def test_schedules_match_jax(make):
    import repro_torch.optim as TO
    jfn, tfn = make(JS), make(TO)
    for step in (0, 1, 5, 9, 10, 11, 50, 89, 90, 95, 99, 100, 150):
        want = float(jfn(jnp.int32(step)))
        got = float(tfn(step))
        assert abs(got - want) <= REL * max(abs(want), 1e-12), (step, got, want)


def test_make_optimizer_follows_the_config():
    cfg = smoke_config("granite-3-2b")
    opt = make_optimizer(cfg, wsd(1e-3, 1, 10))
    assert opt.name == "adamw"
    from dataclasses import replace
    assert make_optimizer(replace(cfg, optimizer="adafactor"), cosine(1e-3, 1, 10)).name \
        == "adafactor"


def test_adamw_update_with_the_callers_norm_equals_its_own():
    """The train step hands AdamW the global norm it already computed for
    its metrics; the update is then the same, byte for byte, as one that
    computes the norm itself (grads large enough to clip)."""
    rng = np.random.default_rng(3)
    params, grads = _tree(rng), _tree(rng, scale=3.0)
    opt = adamw(constant(1e-2))
    a, b = _to_torch(params), _to_torch(params)
    sa, sb = opt.init(a), opt.init(b)
    g = _to_torch(grads)
    opt.update(g, sa, a, 0)
    opt.update(g, sb, b, 0, gnorm=global_norm(g))
    for x, y in zip(tree_leaves({"p": a, "s": sa}), tree_leaves({"p": b, "s": sb})):
        assert torch.equal(x, y)
