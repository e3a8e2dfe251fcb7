"""The port's trainer under the checkpoint-restart plane, on the CPU.

* Checkpoints move between the packages both ways, granite, hymba and
  xlstm-350m: a
  JAX ``Trainer`` checkpoint resumed by the port's ``Trainer``, and the
  port's resumed by the JAX one (the module's one JAX trainer per arch),
  each continuing with the other's losses (max |a - b| / max |b| <= 1e-4:
  float32, as tests/test_torch_train.py) and the same key stream and data
  cursor.
* The torch chaos gate, granite, hymba and xlstm-350m: the port's
  kill-rank failover
  (under another MPI flavor and world size), and supervised ``kill_rank``
  served from RAM and from disk, ``preempt_notice`` on the rescale rung and
  ``restore_error``: each run's params and optimizer state equal a
  fault-free port run's byte for byte (tests/test_faults_supervisor.py's
  cases).
* The CLI's surfaces 1 (kill-rank and cross-flavor restart), 4
  (supervised, disk), 6 (the RAM tier) and 7 (the rescale rung) with
  ``--device cpu``, and ``--resume`` under another flavor.
"""
import json
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.train import Trainer as JaxTrainer  # noqa: E402
from repro_torch.configs import CkptIOConfig, SSMConfig, XLSTMConfig, smoke_config  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.ckpt_tiers import ReplicaTier  # noqa: E402
from repro_torch.core.faults import FaultInjector, FaultPlan, FaultSpec  # noqa: E402
from repro_torch.core.restore import load_manifest  # noqa: E402
from repro_torch.core.supervisor import Supervisor, SupervisorConfig  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models.params import from_jax_params, tree_leaves  # noqa: E402

torch.set_num_threads(1)
ARCH = "granite-3-2b"
B, S = 2, 32
STEPS, EVERY = 9, 3
#: the trained archs and their sequence lengths (hymba's at a length its
#: smoke window of 32 bites)
ARCHS = {"granite-3-2b": 32, "hymba-1.5b": 48, "xlstm-350m": 32}


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    faults.disarm_all()


def _close(tr):
    tr.pipeline.stop()
    if tr.cluster.writer is not None:
        tr.cluster.writer.close()


# -- checkpoints across the packages ---------------------------------------------

@pytest.fixture(scope="module", params=list(ARCHS))
def jax_trainer(request, tmp_path_factory):
    """The module's JAX Trainer per arch: 9 steps with a checkpoint every 3
    (steps 3, 6 and 9 kept); its arch, initial params and per-step
    losses."""
    arch = request.param
    tr = JaxTrainer(jax_smoke_config(arch), batch_size=B, seq_len=ARCHS[arch], world_size=2,
                    total_steps=STEPS, mesh=None,
                    ckpt_dir=tmp_path_factory.mktemp("jax") / "ck")
    tr.init_state()
    p0 = jax.tree.map(np.asarray, tr.params)
    losses = []
    for _ in range(STEPS):
        losses.append(float(tr.step_once()["loss"]))
        if tr.step % EVERY == 0:
            tr.checkpoint()
    tr.cluster.writer.wait_idle()
    yield tr, arch, p0, losses
    _close(tr)


def _port(cfg=None, **kw):
    kw.setdefault("batch_size", B)
    kw.setdefault("seq_len", S)
    kw.setdefault("total_steps", STEPS)
    return Trainer(cfg or smoke_config(ARCH), device="cpu", **kw)


def _near(got, want):
    return all(abs(g - w) <= 1e-4 * abs(w) for g, w in zip(got, want))


def _fold_chain(seed, n):
    key = jax.random.key(seed)
    for s in range(n):
        key = jax.random.fold_in(key, s)
    return np.asarray(jax.random.key_data(key))


def test_jax_trainer_checkpoint_resumes_in_the_port(jax_trainer, tmp_path):
    jtr, arch, _, losses = jax_trainer
    ck = jtr.cluster.writer.base / "step_00000006"
    tr = _port(smoke_config(arch), seq_len=ARCHS[arch], ckpt_dir=tmp_path / "ck")
    tr.init_state()
    try:
        tr.restore(ck, new_backend="exampi")
        assert tr.step == 6 and tr.cluster.backend_name == "exampi"
        assert tr.pipeline.state()["next_index"] == 6
        assert np.array_equal(tr.rng_key, _fold_chain(2, 6))
        assert all(t.dtype == torch.float32 and t.device.type == "cpu"
                   for t in tree_leaves({"p": tr.params, "o": tr.opt_state}))
        got = [float(tr.step_once()["loss"]) for _ in range(3)]
    finally:
        _close(tr)
    assert _near(got, losses[6:]), (got, losses[6:])


def test_port_checkpoint_resumes_in_the_jax_trainer(jax_trainer, tmp_path):
    jtr, arch, p0, losses = jax_trainer
    cfg = smoke_config(arch)
    tr = _port(cfg, seq_len=ARCHS[arch], ckpt_dir=tmp_path / "ck")
    tr.init_state(from_jax_params(p0, cfg, "cpu"))
    try:
        mine = [float(tr.step_once()["loss"]) for _ in range(6)]
        tr.checkpoint()
        tr.cluster.writer.wait_idle()
        ck = tr.cluster.writer.latest()
        assert ck.name == "step_00000006"
        assert _near(mine, losses[:6])
        man = load_manifest(ck)
        assert man["step"] == 6
    finally:
        _close(tr)
    jtr.restore(ck, new_backend="fabric")
    assert jtr.step == 6 and jtr.pipeline.state()["next_index"] == 6
    assert np.array_equal(np.asarray(jax.random.key_data(jtr.rng_key)), _fold_chain(2, 6))
    got = [float(jtr.step_once()["loss"]) for _ in range(3)]
    assert _near(got, losses[6:]), (got, losses[6:])


def test_trainer_refuses_a_checkpoint_without_a_runtime_section(tmp_path):
    """Both packages' ``Trainer.checkpoint`` write the runtime section (the
    key stream and the data cursor); a bare array checkpoint is not one."""
    from repro_torch.core import Cluster
    c = Cluster(2, "mpich", ckpt_dir=tmp_path / "bare")
    c.checkpoint(3, {"params": [torch.zeros(2, 3)]}, None).wait()
    c.writer.close()
    tr = _port(ckpt_dir=tmp_path / "ck")
    try:
        with pytest.raises(ValueError, match="no runtime section"):
            tr.restore(c.writer.latest())
    finally:
        _close(tr)


# -- the torch chaos gate ---------------------------------------------------------

def _tiny_cfg(arch=ARCH):
    cfg = replace(smoke_config(arch), n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
                  head_dim=16, d_ff=64, vocab_size=128, vocab_pad_multiple=64)
    if arch == "hymba-1.5b":   # a window layer and a global one; SSD heads of 16
        cfg = replace(cfg, n_layers=2, global_layers=(1,),
                      ssm=SSMConfig(d_state=8, d_conv=4, n_ssm_heads=2, head_dim=16, chunk=8))
    if arch == "xlstm-350m":   # one mLSTM + sLSTM pair; sLSTM heads of 16
        cfg = replace(cfg, n_layers=2, xlstm=XLSTMConfig(n_heads=2, chunk=8))
    return cfg


def _io():
    return CkptIOConfig(codec="zlib", incremental=True, drain_timeout=1.0)


def _tiny(ckpt_dir, world=2, arch=ARCH):
    return _port(_tiny_cfg(arch), batch_size=4, seq_len=16, world_size=world,
                 ckpt_dir=ckpt_dir, ckpt_io=_io())


def _bytes(tr):
    return [t.numpy().tobytes() for t in tree_leaves({"p": tr.params, "o": tr.opt_state})]


@pytest.fixture(scope="module", params=list(ARCHS))
def chaos_arch(request):
    return request.param


@pytest.fixture(scope="module")
def ref_bytes(tmp_path_factory, chaos_arch):
    tr = _tiny(tmp_path_factory.mktemp("ref") / "ck", arch=chaos_arch)
    tr.init_state()
    try:
        tr.run(STEPS, ckpt_every=EVERY, log_every=100)
        return _bytes(tr)
    finally:
        _close(tr)


def test_adafactor_trainer_restores_its_factored_state_byte_identical(tmp_path):
    """The restore places the optimizer state in the tree the optimizer's
    own ``init`` makes: an Adafactor run (the 128-wide embedding and head
    factored, the rest not) killed after its step-3 checkpoint ends with
    the fault-free run's params and state, byte for byte."""
    cfg = replace(_tiny_cfg(), optimizer="adafactor", d_model=128, n_heads=4,
                  head_dim=32)
    runs = []
    for kill in (None, 5):
        tr = _port(cfg, batch_size=4, seq_len=16, ckpt_dir=tmp_path / f"ck{kill}",
                   ckpt_io=_io())
        tr.init_state()
        try:
            tr.run(STEPS, ckpt_every=EVERY, kill_rank_at=kill, log_every=100)
            runs.append(_bytes(tr))
            state = tr.opt_state["f"]
        finally:
            _close(tr)
    assert set(state["embed"]) == {"vr", "vc"} and set(state["final_norm"]) == {"v"}
    assert runs[0] == runs[1]


def test_kill_rank_failover_under_another_flavor_is_byte_identical(tmp_path, ref_bytes,
                                                                   chaos_arch, capsys):
    tr = _tiny(tmp_path / "ck", world=4, arch=chaos_arch)
    tr.init_state()
    try:
        tr.run(STEPS, ckpt_every=EVERY, kill_rank_at=5, new_backend_on_restart="exampi",
               new_world_size_on_restart=3, log_every=100)
        assert "!! recovered from step_00000003 at step 3 (world=3, backend=exampi)" \
            in capsys.readouterr().out
        assert tr.step == STEPS and tr.cluster.backend_name == "exampi"
        assert _bytes(tr) == ref_bytes
    finally:
        _close(tr)


def _supervised(tmp_path, specs, arch, *, world=2, tier=True, **cfg_kw):
    cfg_kw.setdefault("backoff_floor_s", 0.01)
    cfg_kw.setdefault("backoff_ceiling_s", 0.05)
    tr = _tiny(tmp_path / "ck", world=world, arch=arch)
    tr.init_state()
    with FaultInjector(FaultPlan(specs)) as inj:
        sup = Supervisor(tr, injector=inj, lease_s=1.0, verbose=False,
                         tier=ReplicaTier() if tier else None,
                         config=SupervisorConfig(**cfg_kw))
        incidents = sup.run(STEPS, ckpt_every=EVERY)
    return tr, incidents


@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_supervised_kill_rank_is_byte_identical(tmp_path, ref_bytes, chaos_arch, tier):
    tr, incidents = _supervised(tmp_path, [FaultSpec("kill_rank", at_step=5)], chaos_arch,
                                tier=tier == "ram")
    try:
        inc, = incidents
        assert (inc.kind, inc.resumed_step, inc.world_after) == ("rank_dead", 3, 1)
        assert inc.tier == tier and inc.ckpt.startswith("ram:" if tier == "ram" else "step_")
        assert set(inc.timings) >= {"detect_ms", "classify_ms", "restore_ms", "resume_ms",
                                    "total_ms"}
        assert tr.step == STEPS and _bytes(tr) == ref_bytes
    finally:
        _close(tr)


def test_supervised_preempt_notice_rescales_byte_identical(tmp_path, ref_bytes, chaos_arch):
    tr, incidents = _supervised(tmp_path, [FaultSpec("preempt_notice", at_step=5, rank=3)],
                                chaos_arch, world=4)
    try:
        inc, = incidents
        assert inc.tier == "rescale" and inc.ckpt is None
        assert inc.resumed_step == inc.step == 5 and inc.world_after == 3
        assert tr.cluster.survivors() == [0, 1, 2]
        assert tr.step == STEPS and _bytes(tr) == ref_bytes
    finally:
        _close(tr)


def test_supervised_restore_error_retries_byte_identical(tmp_path, ref_bytes, chaos_arch):
    tr, incidents = _supervised(tmp_path, [FaultSpec("restore_error", at_step=5)],
                                chaos_arch)
    try:
        inc, = incidents
        assert inc.tier == "ram" and len(inc.ladder) == 1
        assert inc.ladder[0]["retryable"] is True
        assert tr.step == STEPS and _bytes(tr) == ref_bytes
    finally:
        _close(tr)


# -- the CLI ----------------------------------------------------------------------

CLI = ["--device", "cpu", "--batch-size", "2", "--seq-len", "16", "--steps", "12",
       "--ckpt-every", "4"]


def test_cli_kill_rank_restarts_under_another_flavor(tmp_path, capsys):
    """Surface 1: the rank dies at step 7, the job restarts from step 4
    under exampi on 3 ranks and finishes; only committed step dirs remain."""
    ck = tmp_path / "ck"
    tr = train_cli.main(CLI + ["--world-size", "4", "--backend", "craympi",
                               "--kill-rank-at", "7", "--restart-backend", "exampi",
                               "--restart-world-size", "3", "--ckpt-dir", str(ck),
                               "--translation", "slow", "--ckpt-codec", "none",
                               "--ckpt-keep", "2", "--ckpt-io-workers", "2",
                               "--snapshot-batch-mb", "0.5", "--drain-backoff", "1e-4",
                               "--drain-timeout", "5", "--lr", "1e-3"])
    out = capsys.readouterr().out
    assert "!! recovered from step_00000004 at step 4 (world=3, backend=exampi)" in out
    assert "done: loss " in out and tr.step == 12
    assert (tr.cluster.backend_name, tr.cluster.translation) == ("exampi", "slow")
    dirs = sorted(p.name for p in ck.iterdir())
    assert dirs == ["step_00000008", "step_00000012"]
    assert all((ck / d / "COMMIT").exists() for d in dirs)


def test_cli_hymba_kill_rank_restarts_under_another_flavor(tmp_path, capsys):
    """hymba-1.5b at smoke size through the CLI: a rank dies at step 6 and
    the job restarts from step 4 under exampi and finishes."""
    tr = train_cli.main(CLI + ["--arch", "hymba-1.5b", "--kill-rank-at", "6",
                               "--restart-backend", "exampi",
                               "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "!! recovered from step_00000004 at step 4 (world=2, backend=exampi)" in out
    assert "done: loss " in out and tr.step == 12 and tr.cfg.block == "hymba"


def test_cli_xlstm_kill_rank_restarts_under_another_flavor(tmp_path, capsys):
    """xlstm-350m at smoke size through the CLI: a rank dies at step 6 and
    the job restarts from step 4 under exampi and finishes."""
    tr = train_cli.main(CLI + ["--arch", "xlstm-350m", "--kill-rank-at", "6",
                               "--restart-backend", "exampi",
                               "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "!! recovered from step_00000004 at step 4 (world=2, backend=exampi)" in out
    assert "done: loss " in out and tr.step == 12 and tr.cfg.block == "xlstm"


def test_cli_resume_under_another_flavor_continues_the_losses(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    whole = train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "whole"),
                                  "--no-ckpt-incremental"])
    first = train_cli.main(CLI + ["--ckpt-dir", ck, "--steps", "8", "--no-ckpt-incremental"])
    capsys.readouterr()
    rest = train_cli.main(CLI + ["--ckpt-dir", ck, "--resume", "--restore-backend", "fabric",
                                 "--no-ckpt-incremental"])
    out = capsys.readouterr().out
    assert "resumed from step_00000008 at step 8 under fabric" in out
    assert first.step == 8 and rest.step == 12
    assert [t.numpy().tobytes() for t in tree_leaves(rest.params)] == \
        [t.numpy().tobytes() for t in tree_leaves(whole.params)]


@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_cli_supervised_kill_rank(tmp_path, capsys, tier):
    """Surfaces 4 (disk: --no-ram-tier) and 6 (the RAM tier, the default)."""
    extra = [] if tier == "ram" else ["--no-ram-tier"]
    tr = train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "ck"), "--lease-s", "1.0",
                               "--max-retries", "2", "--backoff-floor", "0",
                               "--fault-plan", json.dumps([{"kind": "kill_rank",
                                                            "at_step": 10}]), *extra])
    out = capsys.readouterr().out
    assert "!! incident: rank_dead" in out
    src = "ram:step_00000008" if tier == "ram" else "step_00000008"
    assert f"!! recovered from {src} (tier={tier})" in out
    assert f"incident: rank_dead rank=1 step=10->8 tier={tier} " in out
    assert "supervised run done: 1 incident(s), world=1" in out
    assert tr.step == 12


@pytest.mark.parametrize("rescale", ["preempt", "off"])
def test_cli_supervised_preempt_notice(tmp_path, capsys, rescale):
    """Surface 7: the rescale rung shrinks 4 -> 3 with no rewind; with
    --rescale off the notice goes down the restore ladder."""
    tr = train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "ck"), "--world-size", "4",
                               "--rescale", rescale, "--backoff-ceiling", "0.1",
                               "--fault-plan", json.dumps([{"kind": "preempt_notice",
                                                            "at_step": 10, "rank": 3}])])
    out = capsys.readouterr().out
    if rescale == "preempt":
        assert "!! rescaled around rank 3 (tier=rescale, world 4->3)" in out
        assert "step=10->10 tier=rescale ckpt=None" in out
    else:
        assert "step=10->8 tier=ram ckpt=ram:step_00000008" in out
    assert "supervised run done: 1 incident(s), world=3" in out
    assert tr.step == 12


def test_cli_supervise_without_faults_runs_clean(tmp_path, capsys):
    """--supervise alone (no fault plan), with the defaults spelled out."""
    tr = train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "ck"), "--supervise",
                               "--arch", "granite-3-2b", "--smoke", "--ram-tier",
                               "--ckpt-incremental", "--ckpt-pipeline"])
    out = capsys.readouterr().out
    assert "supervised run done: 0 incident(s), world=2" in out and tr.step == 12
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000004", "step_00000008", "step_00000012"]


def test_cli_refuses_the_blocking_snapshot_path():
    with pytest.raises(SystemExit):
        train_cli.main(CLI + ["--no-ckpt-pipeline"])
