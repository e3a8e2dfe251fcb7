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


SUPERVISED = ["--device", "cpu", "--batch", "1", "--prompt-len", "4", "--gen", "10"]


@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_cli_supervised_kill_rank_recovers_the_same_tokens(tmp_path, capsys, tier):
    # the fault plan implies --supervise; at_step is the decode position
    # (the prompt's 4 tokens after the prefill), so the kill at 6 lands
    # after the first snapshot (every gen/2 = 5 steps: position 5)
    want = serve_cli.main(SUPERVISED)
    capsys.readouterr()
    extra = [] if tier == "ram" else ["--no-ram-tier"]
    got = serve_cli.main(SUPERVISED + ["--ckpt-dir", str(tmp_path / "ck"), "--fault-plan",
                                       '[{"kind":"kill_rank","at_step":6}]', *extra])
    out = capsys.readouterr().out
    incidents = [line for line in out.splitlines() if line.startswith("incident:")]
    assert len(incidents) == 1 and incidents[0].startswith("incident: rank_dead rank=1 ")
    assert f"tier={tier} " in incidents[0] and "pos=6->5" in incidents[0]
    assert "supervised decode: 10 tokens x batch 1" in out
    assert len(got) == len(want) == 10
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_cli_supervise_needs_a_ckpt_dir():
    with pytest.raises(SystemExit, match="ckpt-dir"):
        serve_cli.main(SUPERVISED + ["--supervise"])


@pytest.mark.parametrize("rescale", ["preempt", "off"])
def test_cli_preempt_follows_rescale_and_snapshot_flags(tmp_path, capsys, monkeypatch, rescale):
    # a preemption notice at position 8: the rescale rung serves it in place
    # unless --rescale off sends it down the ladder to the newest snapshot,
    # which --snapshot-every 3 puts at position 6 (the default, gen/2, at 5)
    from repro_torch.core import supervisor
    seen = []

    class Spy(supervisor.Supervisor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self.config)

    monkeypatch.setattr(supervisor, "Supervisor", Spy)
    want = serve_cli.main(SUPERVISED)
    capsys.readouterr()
    got = serve_cli.main(SUPERVISED + [
        "--ckpt-dir", str(tmp_path / "ck"), "--rescale", rescale, "--snapshot-every", "3",
        "--backoff-floor", "0", "--backoff-ceiling", "0.01", "--fault-plan",
        '[{"kind":"preempt_notice","at_step":8,"rank":1}]'])
    out = capsys.readouterr().out
    incidents = [line for line in out.splitlines() if line.startswith("incident:")]
    assert len(incidents) == 1 and incidents[0].startswith("incident: preempt_notice rank=1 ")
    if rescale == "preempt":
        assert "pos=8->8 tier=rescale ckpt=None " in incidents[0]
    else:
        assert "pos=8->6 tier=ram ckpt=ram:step_00000006 " in incidents[0]
    cfg, = seen
    assert (cfg.rescale, cfg.backoff_floor_s, cfg.backoff_ceiling_s) == (rescale, 0.0, 0.01)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
