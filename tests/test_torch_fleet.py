"""The port's ServeEngine (device="cpu": the plain paged attention) against
the JAX package's ServeEngine with the same params: the same traffic gives
the same streams and the same tickets, preemption counts included, and a
session moves between the two engines mid-stream in both directions and
goes on with the stream of an unmigrated run. float32 on both sides, at
tests/test_serving.py's tiny widths."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.serving.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serving.kv_pool import PoolOOMError as JaxOOM  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving import PoolOOMError, ServeEngine  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)


def _tiny(fn):
    return replace(fn("granite-3-2b"), n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
                   vocab_pad_multiple=64)


JCFG, CFG = _tiny(jax_smoke_config), _tiny(smoke_config)


@pytest.fixture(scope="module")
def params():
    """The JAX engine's seed-0 params, numpy leaves."""
    return jax.tree.map(np.asarray, JaxEngine(JCFG, seed=0, max_len=8, page_size=4,
                                              n_pages=2).params)


def _pair(params, **kw):
    jax_eng = JaxEngine(JCFG, backend="mpich", seed=0, **kw)
    eng = ServeEngine(CFG, params=from_jax_params(params, CFG, "cpu"), device="cpu",
                      **kw)
    return jax_eng, eng


def _tickets(eng, sids):
    return [(eng.sched.state(s), eng.sched.tickets[s].preemptions,
             eng.sched.tickets[s].seq) for s in sids]


def test_continuous_batching_matches_jax_engine(params):
    # tests/test_serving.py::test_engine_matches_single_stream_server's traffic
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 6, dtype=np.int32), rng.integers(0, 256, 3), []]
    out = []
    for eng in _pair(params, max_len=24, page_size=4, n_pages=32, max_running=3):
        sids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, (8, 6, 4))]
        eng.run_until_drained(max_ticks=60)
        assert not eng.sched.live()
        out.append(([eng.stream(s) for s in sids], _tickets(eng, sids), eng.tick))
    assert out[1] == out[0]
    assert [len(s) for s in out[1][0]] == [8, 6, 4]

    # the port engine's stream equals the port Server's B=1 greedy stream
    srv = Server(CFG, device="cpu", params=from_jax_params(params, CFG, "cpu"))
    logits = srv.prefill(prompts[0][None, :], pad_to=24)
    first = np.argmax(logits[:, : CFG.vocab_size].numpy(), -1)
    toks, _ = srv.decode(7, first)
    assert out[1][0][0] == [int(first[0])] + [int(t[0]) for t in toks]


def test_preempt_and_readmit_match_jax_engine(params):
    # tests/test_serving.py::test_engine_preempt_readmit_byte_identical's
    # traffic: the pool is too small for both, the high-priority arrival
    # swaps the low one out, and the readmitted stream does not fork
    out = []
    for eng in _pair(params, max_len=24, page_size=4, n_pages=6, max_running=2):
        rng = np.random.default_rng(1)
        a = eng.submit(rng.integers(0, 256, 6, dtype=np.int32), max_new_tokens=8)
        for _ in range(3):
            eng.step_once()
        b = eng.submit(rng.integers(0, 256, 8), max_new_tokens=6, priority=5)
        ticks = eng.run_until_drained(max_ticks=200)
        out.append(([eng.stream(a), eng.stream(b)], _tickets(eng, [a, b]), ticks,
                    eng.pool.free_pages))
    assert out[1] == out[0]
    assert out[1][1][0][1] >= 1            # a was preempted and came back


def test_submit_rejects_overrun_like_jax_engine(params):
    # tests/test_serving.py::test_submit_rejects_overrunning_max_len
    rng = np.random.default_rng(2)
    cases = [(rng.integers(0, 256, 12), 8), (rng.integers(0, 256, 6), 8), ([], 13),
             (rng.integers(0, 256, 6), 7), ([], 12)]
    for eng in _pair(params, max_len=12, page_size=4, n_pages=8):
        got = []
        for prompt, n in cases:
            try:
                eng.submit(prompt, max_new_tokens=n)
                got.append("ok")
            except ValueError:
                got.append("rejected")
        assert got == ["rejected"] * 3 + ["ok"] * 2
    _, eng = _pair(params, max_len=12, page_size=4, n_pages=8)
    with pytest.raises(ValueError, match="token ids"):
        eng.submit([3, CFG.padded_vocab])


def test_growth_beyond_pool_capacity_raises_like_jax_engine(params):
    # tests/test_serving.py::test_decode_growth_beyond_pool_capacity_raises: a
    # pool of 2 positions, a page-less queued session; self-parking would free
    # nothing, so both engines raise instead of spinning
    for eng, oom in zip(_pair(params, max_len=8, page_size=2, n_pages=1,
                              max_running=2), (JaxOOM, PoolOOMError)):
        rng = np.random.default_rng(3)
        eng.submit(rng.integers(0, 256, 2), max_new_tokens=4)
        eng.submit(rng.integers(0, 256, 2), max_new_tokens=2)
        with pytest.raises(oom):
            eng.run_until_drained(max_ticks=50)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_session_migrates_mid_stream_between_the_packages(params, direction):
    rng = np.random.default_rng(4)
    prompts = {"a": rng.integers(0, 256, 6, dtype=np.int32),
               "b": rng.integers(0, 256, 11, dtype=np.int32)}    # spans 3 pages
    kw = dict(max_len=24, page_size=4, n_pages=32)
    ref, _ = _pair(params, **kw)
    for sid, p in prompts.items():
        ref.submit(p, sid=sid, max_new_tokens=8)
    ref.run_until_drained()

    jax_src, torch_src = _pair(params, **kw)
    jax_dst, torch_dst = _pair(params, **kw)
    src, dst = (jax_src, torch_dst) if direction == "jax_to_torch" else (torch_src, jax_dst)
    for sid, p in prompts.items():
        src.submit(p, sid=sid, max_new_tokens=8)
    for _ in range(3):
        src.step_once()
    for sid in prompts:
        state = src.export_session_state(sid)
        assert state["pool"]["tokens"]["leaf000"].dtype == np.float32
        assert state["pool"]["table"]["length"] == state["cursor"]["pos"]
        src.release_session(sid)
        dst.import_session_state(sid, state)
    assert not src.sched.live() and not src.pool.sessions
    dst.run_until_drained()
    for sid in prompts:
        assert dst.stream(sid) == ref.stream(sid)   # gap- and duplicate-free


def test_engine_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(CFG)
