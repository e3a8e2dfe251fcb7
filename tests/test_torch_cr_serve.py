"""A serving snapshot moves mid-decode between the JAX package's ``Server``
and the port's, either way, under another MPI flavor, and the port's
restored stream equals an uninterrupted run.

Both ways, on granite's smoke config and hymba's (float32 on both sides, the
port holding the JAX package's params through ``from_jax_params``):
  * JAX snapshot -> a fresh port ``Server`` (no prefill) under another
    flavor -> the greedy tail equals the JAX ``Server``'s uninterrupted tail,
    and the RNG key equals its key;
  * port snapshot -> a fresh JAX ``Server`` -> its tail equals the port's.
Port to port over all 25 ordered flavor pairs: the restored stream and key
equal an uninterrupted run byte for byte. And the CLI's ``--snapshot-at``,
then ``--resume --restore-backend``, equals an uninterrupted CLI run.

hymba's prompt lengths avoid 3 and 8, where the JAX ``Server``'s ``pad_to``
heuristic would also grow the conv cache or the SSD state; the decode stops
below ``pad_to``, where the JAX cache write would clamp.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.serving.engine import Server as JaxServer  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import BACKENDS  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)
#: arch -> (prompt length, pad_to); the snapshot comes after K decode steps
CASES = {"granite-3-2b": (9, 17), "hymba-1.5b": (20, 28)}
K = 3


def _first(logits, vocab):
    return np.argmax(np.asarray(logits)[:, :vocab], -1).astype(np.int32)


def _stack(toks):
    return np.stack([np.asarray(t) for t in toks], axis=1)


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_run(request, tmp_path_factory):
    """The JAX Server: prefill, K steps, snapshot, then the rest of the
    decode uninterrupted. Returns what the port needs to replay it."""
    arch = request.param
    S, pad_to = CASES[arch]
    jcfg = jax_smoke_config(arch)
    prompt = np.random.default_rng(S).integers(0, jcfg.vocab_size, (2, S), dtype=np.int32)
    base = tmp_path_factory.mktemp(arch)
    js = JaxServer(jcfg, backend="craympi", ckpt_dir=base / "jax", seed=0)
    head, _ = js.decode(K, _first(js.prefill(prompt, pad_to=pad_to), jcfg.vocab_size))
    js.checkpoint().wait()
    tail, _ = js.decode(pad_to - S - K - 1, head[-1])
    return {"arch": arch, "prompt": prompt, "pad_to": pad_to, "base": base, "jax": js,
            "step": js.cluster.writer.latest(), "tail": _stack(tail),
            "key": np.asarray(jax.random.key_data(js.rng_key)),
            "params": from_jax_params(jax.tree.map(np.asarray, js.params),
                                      smoke_config(arch), "cpu")}


def test_jax_snapshot_resumes_in_a_fresh_port_server(jax_run):
    cfg = smoke_config(jax_run["arch"])
    srv = Server(cfg, device="cpu", params=jax_run["params"], backend="mpich")
    srv.restore(jax_run["step"], new_backend="openmpi", rebuild=True)
    assert srv.cluster.backend_name == "openmpi"
    assert srv.pos == jax_run["prompt"].shape[1] + K and srv.max_len == jax_run["pad_to"]
    assert srv.last_runtime_restore["providers"] == 3
    tail, _ = srv.decode(jax_run["tail"].shape[1], srv.resume_tok)
    np.testing.assert_array_equal(_stack(tail), jax_run["tail"])
    np.testing.assert_array_equal(srv.rng_key, jax_run["key"])


def test_port_snapshot_resumes_in_a_fresh_jax_server(jax_run):
    cfg = smoke_config(jax_run["arch"])
    S, pad_to = jax_run["prompt"].shape[1], jax_run["pad_to"]
    srv = Server(cfg, device="cpu", params=jax_run["params"], backend="exampi",
                 ckpt_dir=jax_run["base"] / "port")
    head, _ = srv.decode(K, _first(srv.prefill(jax_run["prompt"], pad_to=pad_to),
                                   cfg.vocab_size))
    srv.checkpoint().wait()
    tail, _ = srv.decode(pad_to - S - K - 1, head[-1])
    np.testing.assert_array_equal(_stack(tail), jax_run["tail"])

    js = JaxServer(jax_smoke_config(jax_run["arch"]), backend="fabric", seed=0)
    js.params = jax_run["jax"].params
    js.restore(srv.cluster.writer.latest(), new_backend="mpich", rebuild=True)
    assert js.pos == S + K
    jtail, _ = js.decode(len(tail), js.resume_tok)
    np.testing.assert_array_equal(_stack(jtail), _stack(tail))
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(js.rng_key)), srv.rng_key)


# -- port to port over every ordered flavor pair ---------------------------------

PAIRS = sorted(itertools.product(BACKENDS, BACKENDS))
S, PAD = 9, 17


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Per source flavor: one snapshot after K steps, plus the uninterrupted
    tail and key. The prompt and params are shared."""
    cfg = smoke_config("granite-3-2b")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, S))
    params = Server(cfg, device="cpu", seed=4).params
    plain = Server(cfg, device="cpu", params=params, seed=4)   # never snapshotted
    toks, _ = plain.decode(PAD - S, _first(plain.prefill(prompt, pad_to=PAD), cfg.vocab_size))
    out = {"cfg": cfg, "params": params, "plain": (_stack(toks[K:]), plain.rng_key)}
    for src in BACKENDS:
        srv = Server(cfg, device="cpu", params=params, backend=src, seed=4,
                     ckpt_dir=tmp_path_factory.mktemp(src))
        head, _ = srv.decode(K, _first(srv.prefill(prompt, pad_to=PAD), cfg.vocab_size))
        srv.checkpoint().wait()
        tail, _ = srv.decode(PAD - S - K, head[-1])
        out[src] = (srv.cluster.writer.latest(), _stack(tail), srv.rng_key.copy())
    return out


@pytest.mark.parametrize("src,dst", PAIRS)
def test_port_restore_pair_continues_byte_for_byte(port_runs, src, dst):
    step, tail, key = port_runs[src]
    srv = Server(port_runs["cfg"], device="cpu", params=port_runs["params"],
                 backend=src, seed=99)
    srv.restore(step, new_backend=dst, rebuild=True)
    assert srv.cluster.backend_name == dst and srv.pos == S + K
    got, _ = srv.decode(tail.shape[1], srv.resume_tok)
    assert _stack(got).tobytes() == tail.tobytes() == port_runs["plain"][0].tobytes()
    assert srv.rng_key.tobytes() == key.tobytes() == port_runs["plain"][1].tobytes()
    for k in ("manifest_ms", "lower_half_ms", "rebind_ms", "arrays_ms", "total_ms"):
        assert k in srv.cluster.restart_timings


def test_resume_latest_and_recover_rewind_to_the_snapshot(port_runs):
    step, tail, key = port_runs["mpich"]
    srv = Server(port_runs["cfg"], device="cpu", params=port_runs["params"],
                 backend="mpich", ckpt_dir=step.parent)
    assert srv.resume_latest(new_backend="fabric") == step
    got, _ = srv.decode(2, srv.resume_tok)
    assert srv.pos == S + K + 2 and len(srv.generated) == 2
    srv.recover(step)                       # rewinds pos and the stream
    assert srv.pos == S + K and srv.generated == []
    again, _ = srv.decode(tail.shape[1], srv.resume_tok)
    assert _stack(again).tobytes() == tail.tobytes()
    assert srv.prepare_leave(0) is None and srv.rescale({}) is None
    assert Server(port_runs["cfg"], device="cpu", params=port_runs["params"]) \
        .resume_latest() is None


def test_cli_snapshot_then_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen", "10"]
    whole = np.stack(serve_cli.main(args), axis=1)
    ck = str(tmp_path / "svk")
    snap = np.stack(serve_cli.main(args + ["--ckpt-dir", ck, "--snapshot-at", "4"]), axis=1)
    rest = np.stack(serve_cli.main(args + ["--ckpt-dir", ck, "--resume",
                                           "--restore-backend", "fabric"]), axis=1)
    out = capsys.readouterr().out
    assert "serving snapshot at pos 10 -> step_00000010" in out
    assert "resumed step_00000010 mid-sequence at pos 10 under fabric; 6 tokens left" in out
    np.testing.assert_array_equal(snap, whole)
    np.testing.assert_array_equal(rest, whole[:, 4:])


def test_server_refuses_a_snapshot_without_a_runtime_section(tmp_path):
    """Both packages' ``Server.checkpoint`` write the runtime section; a
    bare array checkpoint is not a serving snapshot."""
    from repro_torch.core import Cluster
    c = Cluster(2, "mpich", ckpt_dir=tmp_path / "ck")
    c.checkpoint(4, {"caches": [torch.zeros(2, 3)]}, None).wait()
    c.writer.close()
    srv = Server(smoke_config("granite-3-2b"), device="cpu", backend="mpich")
    with pytest.raises(ValueError, match="no runtime section"):
        srv.restore(c.writer.latest(), rebuild=True)
