"""The port's single-stream Server against the JAX package's: the same params
and prompt give the same greedy token stream (granite smoke config, float32
on both sides, so argmax ties are not a concern at these margins). Also the
device rule: the card unless the caller asks for the CPU, never a silent
fallback."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.serving.engine import Server as JaxServer  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving.engine import Server, resolve_device  # noqa: E402

torch.set_num_threads(1)
ARCH = "granite-3-2b"


def test_greedy_stream_matches_jax_server():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9), dtype=np.int32)
    n = 8
    jsrv = JaxServer(jcfg, backend="mpich", seed=0)
    jlogits = jsrv.prefill(prompt, pad_to=prompt.shape[1] + n)
    jfirst = np.argmax(np.asarray(jlogits)[:, : cfg.vocab_size], -1).astype(np.int32)
    jtoks, _ = jsrv.decode(n - 1, jfirst)
    want = np.stack([jfirst] + [np.asarray(t) for t in jtoks], axis=1)

    srv = Server(cfg, device="cpu",
                 params=from_jax_params(jax.tree.map(np.asarray, jsrv.params), cfg, "cpu"))
    logits = srv.prefill(prompt, pad_to=prompt.shape[1] + n)
    first = np.argmax(logits[:, : cfg.vocab_size].numpy(), -1).astype(np.int32)
    toks, _ = srv.decode(n - 1, first)
    got = np.stack([first] + toks, axis=1)
    assert got.shape == (2, n)
    np.testing.assert_array_equal(got, want)
    assert srv.pos == jsrv.pos == prompt.shape[1] + n - 1


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(smoke_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--gen", "1", "--prompt-len", "2", "--batch", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_runs_on_cpu_when_asked(capsys):
    toks = serve_cli.main(["--device", "cpu", "--batch", "2", "--prompt-len", "5",
                           "--gen", "3"])
    assert len(toks) == 3 and all(t.shape == (2,) for t in toks)
    assert "on cpu" in capsys.readouterr().out


def test_server_rejects_bad_tokens_and_full_cache():
    srv = Server(smoke_config(ARCH), device="cpu", seed=3)
    with pytest.raises(ValueError, match="token ids"):
        srv.prefill(np.full((1, 4), 10**6))
    logits = srv.prefill(np.arange(4)[None], pad_to=5)
    assert logits.shape == (1, srv.cfg.padded_vocab) and torch.isfinite(logits).all()
    srv.decode(1, np.array([1]))
    with pytest.raises(RuntimeError, match="cache full"):
        srv.step_once()
