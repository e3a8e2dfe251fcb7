"""The port's fleet ``ServeEngine`` serving xLSTM (xlstm-350m's smoke config,
float32) against the JAX package's engine on the same params and against
the port's own ``Server``.

xLSTM's cache leaves have no sequence axis, so both engines keep them as
each session's blocks: the port's on the pool's device, updated in place by
the lane's ``Model.decode_step`` at B = 1. The page accounting is the
reference's: an admission reserves the prompt's pages, a decode writes no
token rows and so grows none, and a swap-in takes none. The same traffic
gives the same streams, tickets (preemptions included) and page tables, a
session parked and swapped back in goes on with its stream, and a session
moves between the two engines mid-stream both ways.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.serving.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import ckpt_io  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)
ARCH = "xlstm-350m"
JCFG, CFG = jax_smoke_config(ARCH), smoke_config(ARCH)
V = CFG.vocab_size
#: a pool too small for both: the high-priority arrival parks the first
SMALL = dict(max_len=24, page_size=4, n_pages=4, max_running=2)


@pytest.fixture(scope="module")
def params():
    """The JAX engine's seed-0 params, numpy leaves."""
    return jax.tree.map(np.asarray, JaxEngine(JCFG, seed=0, max_len=8, page_size=4,
                                              n_pages=2).params)


def _pair(params, **kw):
    return (JaxEngine(JCFG, backend="mpich", seed=0, **kw),
            ServeEngine(CFG, params=from_jax_params(params, CFG, "cpu"), device="cpu", **kw))


def _tickets(eng, sids):
    return [(eng.sched.state(s), eng.sched.tickets[s].preemptions, eng.sched.tickets[s].seq)
            for s in sids]


def _table(eng):
    """The pool's JSON page table as a snapshot takes it."""
    return eng.pool.export_state()[1]


def _server_stream(params, prompt, n):
    srv = Server(CFG, device="cpu", params=from_jax_params(params, CFG, "cpu"))
    if not len(prompt):
        # the reference's empty prompt decodes from zero caches at position 0
        srv._set_caches(srv.model.alloc_caches(1, n, "cpu"))
        srv.pos = 0
        toks, _ = srv.decode(n, np.array([0]))
        return [int(t[0]) for t in toks]
    first = int(np.argmax(srv.prefill(np.asarray(prompt)[None, :])[0, :V].numpy()))
    toks, _ = srv.decode(n - 1, np.array([first]))
    return [first] + [int(t[0]) for t in toks]


def test_continuous_batching_matches_jax_engine_and_server(params):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, 6), rng.integers(0, V, 13), rng.integers(0, V, 4)]
    out = []
    for eng in _pair(params, max_len=32, page_size=4, n_pages=32, max_running=2):
        sids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, (8, 6, 5))]
        eng.run_until_drained(max_ticks=60)
        assert not eng.sched.live()
        out.append(([eng.stream(s) for s in sids], _tickets(eng, sids), eng.tick,
                    eng.pool.free_pages))
    assert out[1] == out[0]
    for p, stream in zip(prompts, out[1][0]):
        assert stream == _server_stream(params, p, len(stream))


def _preempt_traffic(eng):
    """Two sessions (one of them an empty prompt), then after 3 ticks a
    high-priority one that waits for a lane and then parks the first, which
    swaps back in at once into the lane the empty prompt freed. Returns the
    streams, tickets, ticks, free pages, and the page table and parked
    sessions after every tick."""
    rng = np.random.default_rng(1)
    a = eng.submit(rng.integers(0, V, 12), sid="a", max_new_tokens=8)
    c = eng.submit([], sid="c", max_new_tokens=5)
    tables, parked = [], []
    while eng.sched.live() and eng.tick < 200:
        if eng.tick == 3:
            b = eng.submit(rng.integers(0, V, 8), sid="b", max_new_tokens=6, priority=5)
        eng.step_once()
        tables.append(_table(eng))
        parked.append(sorted(eng.pool.parked))
    return ([eng.stream(s) for s in (a, c, b)], _tickets(eng, [a, c, b]), eng.tick,
            eng.pool.free_pages, tables, parked)


def test_park_and_unpark_match_jax_engine(params):
    """The high-priority arrival parks the first session (its blocks leave
    the card for the host), which swaps back in with no pages and goes on
    with its stream; a zero-length prompt decodes from zero blocks; the
    page tables after every tick equal the reference's."""
    jax_out, out = (_preempt_traffic(e) for e in _pair(params, **SMALL))
    assert out == jax_out
    streams, tickets, _, _, tables, _ = out
    assert tickets[0][1] == 1
    # the admission reserved the prompt's 3 pages, and no decode grew them;
    # parked for b's 2 pages and swapped back in the same tick, it holds none
    pages = [t["sessions"]["a"]["pages"] for t in tables if "a" in t["sessions"]]
    assert pages == [[0, 1, 2]] * 5 + [[]] * 2
    assert all(row["length"] == 0 for t in tables for row in t["sessions"].values())
    rng = np.random.default_rng(1)
    for p, s in zip((rng.integers(0, V, 12), [], rng.integers(0, V, 8)), streams):
        assert s == _server_stream(params, p, len(s))


def test_blocks_stay_on_the_device_and_park_to_host_bits(params):
    """A running session's blocks are the pool's tensors, updated in place
    by its decode (the same storage tick after tick); parked, they are host
    arrays; bf16 blocks go to the host as bits under ``ckpt_io.BFLOAT16``
    and export as plain ``uint16`` named in the table's ``"dtypes"``."""
    _, eng = _pair(params, **SMALL)
    eng.submit(np.arange(12) % V, sid="a", max_new_tokens=8)
    eng.step_once()
    blocks = eng.pool.sessions["a"].blocks
    assert len(blocks) == 9 and all(isinstance(t, torch.Tensor) for t in blocks.values())
    ptrs = {k: t.data_ptr() for k, t in blocks.items()}
    before = {k: t.clone() for k, t in blocks.items()}
    eng.step_once()
    after = eng.pool.sessions["a"].blocks
    assert {k: t.data_ptr() for k, t in after.items()} == ptrs
    assert any(not torch.equal(before[k], after[k]) for k in before)
    eng.pool.park("a")
    assert all(isinstance(a, np.ndarray) for a in eng.pool.parked["a"]["blocks"].values())

    cfg16 = replace(CFG, param_dtype="bfloat16", compute_dtype="bfloat16",
                    cache_dtype="bfloat16")
    eng16 = ServeEngine(cfg16, params=from_jax_params(params, cfg16, "cpu"), device="cpu",
                        **SMALL)
    eng16.submit(np.arange(12) % V, sid="a", max_new_tokens=8)
    eng16.step_once()
    conv = [k for k, t in eng16.pool.sessions["a"].blocks.items() if t.dtype == torch.bfloat16]
    assert len(conv) == 2
    live = {k: t.clone() for k, t in eng16.pool.sessions["a"].blocks.items()}
    exported = eng16.pool.export_session("a")
    assert sorted(exported["table"]["dtypes"]) == sorted(conv)
    assert all(exported["blocks"][k].dtype == np.uint16 for k in conv)
    eng16.pool.park("a")
    assert all(ckpt_io.dtype_name(eng16.pool.parked["a"]["blocks"][k].dtype) == "bfloat16"
               for k in conv)
    eng16.pool.unpark("a")
    assert all(torch.equal(eng16.pool.sessions["a"].blocks[k], t) for k, t in live.items())
    # the JAX package's form of the same bits (ml_dtypes bfloat16) reads back equal
    jform = {k: (a.view(ml_dtypes.bfloat16) if k in conv else a)
             for k, a in exported["blocks"].items()}
    eng16.pool.drop("a")
    eng16.pool.park_payload("a", {"table": {k: v for k, v in exported["table"].items()
                                            if k != "dtypes"},
                                  "tokens": {}, "blocks": jform})
    eng16.pool.unpark("a")
    assert all(torch.equal(eng16.pool.sessions["a"].blocks[k], t) for k, t in live.items())


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_session_migrates_mid_stream_between_the_packages(params, direction):
    rng = np.random.default_rng(4)
    prompts = {"a": rng.integers(0, V, 6), "b": rng.integers(0, V, 11)}
    kw = dict(max_len=32, page_size=4, n_pages=32)
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
        assert state["pool"]["tokens"] == {} and len(state["pool"]["blocks"]) == 9
        assert all(np.asarray(a).dtype == np.float32 for a in state["pool"]["blocks"].values())
        src.release_session(sid)
        dst.import_session_state(sid, state)
    assert not src.sched.live() and not src.pool.sessions
    dst.run_until_drained()
    for sid in prompts:
        assert dst.stream(sid) == ref.stream(sid)


def test_engine_still_refuses_hymba():
    with pytest.raises(NotImplementedError, match="ring"):
        ServeEngine(smoke_config("hymba-1.5b"), device="cpu")


def test_cli_fleet_snapshot_and_resume_equal_an_uninterrupted_run(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    args = ["--arch", ARCH, "--fleet", "--device", "cpu", "--batch", "3", "--prompt-len", "9",
            "--gen", "6"]
    whole = serve_cli.main(args)
    assert sorted(whole) == ["s0000", "s0001", "s0002"]
    assert all(len(s) == 6 for s in whole.values())
    assert f"{ARCH} fleet: 3 sessions x 6 tokens on cpu" in capsys.readouterr().out
    head = serve_cli.main(args + ["--ckpt-dir", str(tmp_path), "--snapshot-at", "3"])
    assert "fleet snapshot at tick 3 -> step_00000003" in capsys.readouterr().out
    tail = serve_cli.main(args + ["--ckpt-dir", str(tmp_path), "--resume",
                                  "--restore-backend", "fabric"])
    assert "resumed step_00000003 at tick 3 under fabric" in capsys.readouterr().out
    assert head == tail == whole
