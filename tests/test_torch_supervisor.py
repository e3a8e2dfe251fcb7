"""The port's supervised recovery loop (``repro_torch.core.supervisor``):
tests/test_faults_supervisor.py's supervisor cases, with the port's
``Server`` decoding as the workload in place of the reference's
``Trainer``. Each supervised run decodes from the same prompts (numpy from
a seed) as a fault-free run, and its decoded tokens and final cache bytes
must equal that run's. Also the lease/probe detector, and
``classify_failure`` against the JAX package's for every exception of its
table."""
import time
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import drain as jax_drain  # noqa: E402
from repro.core import faults as jax_faults  # noqa: E402
from repro.core import supervisor as jax_sup  # noqa: E402
from repro_torch.configs import CkptIOConfig, smoke_config  # noqa: E402
from repro_torch.core import Cluster, drain, faults  # noqa: E402
from repro_torch.core import supervisor as sup_mod  # noqa: E402
from repro_torch.core.ckpt_tiers import ReplicaTier  # noqa: E402
from repro_torch.core.faults import FaultInjector, FaultPlan, FaultSpec  # noqa: E402
from repro_torch.core.supervisor import (LeaseDetector, RecoveryFailed,  # noqa: E402
                                         Supervisor, SupervisorConfig,
                                         WorldFailure, classify_failure)
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)
CFG = replace(smoke_config("granite-3-2b"), n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
              vocab_pad_multiple=64)
# a one-token prompt: the decode position runs 1 -> 10, so snapshots every
# 3 steps land at positions 3, 6 and 9, as the reference trainer's steps do
PROMPT, STEPS, EVERY, BATCH = 1, 9, 3, 2


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    faults.disarm_all()


def _io(**kw):
    kw.setdefault("codec", "zlib")
    kw.setdefault("incremental", True)
    kw.setdefault("drain_timeout", 1.0)
    return CkptIOConfig(**kw)


def _arrays():
    rng = np.random.default_rng(3)
    return {"w": torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)),
            "m": torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))}


def _server(ckpt_dir, world=2):
    """A Server prefilled and seeded to decode STEPS tokens; its snapshots
    are written as the reference tests write theirs (zlib, incremental, so
    every entry carries a digest that verification re-checks)."""
    srv = Server(CFG, world_size=world, device="cpu", seed=0)
    if ckpt_dir is not None:
        srv.cluster = Cluster(world, "mpich", ckpt_dir=ckpt_dir, ckpt_io=_io())
    prompts = np.random.default_rng(7).integers(0, CFG.vocab_size, (BATCH, PROMPT))
    logits = srv.prefill(prompts, pad_to=PROMPT + STEPS)
    srv.start_decode(np.argmax(logits[:, : CFG.vocab_size].numpy(), -1))
    return srv


def _result(srv):
    """(decoded tokens [B, n], the caches' bytes)."""
    toks = np.stack(srv.generated, axis=1)
    return toks, [t.numpy().tobytes() for t in tree_leaves(srv.caches)]


@pytest.fixture(scope="module")
def reference():
    srv = _server(None)
    for _ in range(STEPS):
        srv.step_once()
    return _result(srv)


def _same(srv, reference):
    toks, caches = _result(srv)
    assert srv.pos == PROMPT + STEPS
    np.testing.assert_array_equal(toks, reference[0])
    assert caches == reference[1]


def _supervised(tmp_path, specs, world=2, tier=None, **sup_kw):
    srv = _server(tmp_path / "ck", world=world)
    with FaultInjector(FaultPlan(specs)) as inj:
        sup = Supervisor(srv, injector=inj, lease_s=1.0, verbose=False,
                         tier=tier, **sup_kw)
        incidents = sup.run(STEPS, ckpt_every=EVERY)
    return srv, incidents


def _supervised_tier(tmp_path, specs, world=2, **cfg_kw):
    cfg_kw.setdefault("backoff_floor_s", 0.01)
    cfg_kw.setdefault("backoff_ceiling_s", 0.05)
    return _supervised(tmp_path, specs, world=world, tier=ReplicaTier(),
                       config=SupervisorConfig(**cfg_kw))


def _close(srv):
    srv.cluster.writer.close()


# ---------------------------------------------------------------------------
# detector + classification
# ---------------------------------------------------------------------------

def test_lease_detector_expiry_and_probe():
    c = Cluster(2, "mpich")
    det = LeaseDetector(c, lease_s=0.05, probe=False)
    det.beat()
    assert det.poll() == []
    c.halt_rank(1)
    time.sleep(0.08)
    det.beat()                         # rank 0 renews; rank 1 cannot
    assert det.poll() == [(1, "lease_expired")]
    assert not c.ranks[1].alive
    # the active probe catches the same death with no lease latency
    c2 = Cluster(2, "openmpi")
    det2 = LeaseDetector(c2, lease_s=60.0, probe=True)
    c2.halt_rank(0)
    assert det2.poll() == [(0, "rank_dead")]


def test_probe_detects_dropped_token_without_declaring_death():
    c = Cluster(2, "fabric")
    inj = FaultInjector(FaultPlan([FaultSpec("drop_token", at_step=0, rank=1)]))
    inj.on_step(0, c)
    dead = LeaseDetector(c, lease_s=60.0, probe=True).poll()
    assert dead == [(1, "lost_token")]
    assert c.ranks[1].alive            # the node is fine; its token is not
    assert classify_failure(WorldFailure(dead)) == ("lost_token", 1)


# one exception per row of the reference's table, built by each package
CLASSIFY_CASES = {
    "drain_stall": lambda D, F, S: D.DrainStallError(3, {}, "x"),
    "rank_dead": lambda D, F, S: F.RankDeadError(1),
    "lease": lambda D, F, S: S.WorldFailure([(2, "lease_expired")]),
    "mixed": lambda D, F, S: S.WorldFailure([(0, "lost_token"), (1, "lease_expired")]),
    "lost_token": lambda D, F, S: S.WorldFailure([(3, "lost_token")]),
    "preempt": lambda D, F, S: F.PreemptNotice(2, 3.0),
    "injected": lambda D, F, S: F.InjectedFault("boom"),
    "token_msg": lambda D, F, S: KeyError("dangling endpoint token fi://x"),
    "snapshot_msg": lambda D, F, S: RuntimeError("snapshot batch 3 failed"),
    "unknown": lambda D, F, S: ValueError("wat"),
}


@pytest.mark.parametrize("case", sorted(CLASSIFY_CASES))
def test_classify_failure_matches_the_reference(case):
    make = CLASSIFY_CASES[case]
    got = classify_failure(make(drain, faults, sup_mod))
    assert got == jax_sup.classify_failure(make(jax_drain, jax_faults, jax_sup))
    assert got[0] in sup_mod.FAILURE_CLASSES
    assert sup_mod.FAILURE_CLASSES == jax_sup.FAILURE_CLASSES


def test_incident_fields_and_config_match_the_reference():
    import dataclasses
    assert [f.name for f in dataclasses.fields(sup_mod.Incident)] == \
        [f.name for f in dataclasses.fields(jax_sup.Incident)]
    assert dataclasses.asdict(SupervisorConfig()) == \
        dataclasses.asdict(jax_sup.SupervisorConfig())
    for policy in ("off", "preempt", "all"):
        assert SupervisorConfig(rescale=policy).rescale_classes() == \
            jax_sup.SupervisorConfig(rescale=policy).rescale_classes()


# ---------------------------------------------------------------------------
# supervised decode, disk tier
# ---------------------------------------------------------------------------

def test_supervised_kill_rank_byte_identical(tmp_path, reference):
    srv, incidents = _supervised(tmp_path, [FaultSpec("kill_rank", at_step=5)])
    try:
        assert [i.kind for i in incidents] == ["rank_dead"]
        inc = incidents[0]
        assert inc.resumed_step == 3 and inc.world_after == 1 and inc.tier == "disk"
        assert set(inc.timings) >= {"detect_ms", "classify_ms", "restore_ms",
                                    "resume_ms", "total_ms"}
        assert ("incident", "rank_dead", 1, 5) in srv.cluster.events
        _same(srv, reference)
    finally:
        _close(srv)


def test_supervised_corrupt_falls_back_to_good_ckpt(tmp_path, reference):
    # poison the position-6 snapshot at 7, kill at 8: recovery must skip the
    # poisoned image, land on 3, and still reproduce the fault-free run
    srv, incidents = _supervised(tmp_path, [FaultSpec("corrupt_shard", at_step=7),
                                            FaultSpec("kill_rank", at_step=8, rank=0)])
    try:
        inc = incidents[0]
        assert inc.kind == "rank_dead" and inc.resumed_step == 3
        assert inc.tier == "disk_chain"
        assert [e["level"] for e in inc.ladder] == ["disk"]
        _same(srv, reference)
    finally:
        _close(srv)


def test_supervisor_bounded_retries(tmp_path):
    class Hopeless:
        """Every step fails; recovery 'works' but never helps."""

        def __init__(self, cluster):
            self.cluster = cluster
            self.step = 0
            self.recoveries = 0

        def step_once(self):
            raise ValueError("persistent mystery failure")

        def checkpoint(self):
            pass

        def recover(self, ck, *, new_world_size=None):
            self.recoveries += 1

    c = Cluster(1, "mpich", ckpt_dir=tmp_path, ckpt_io=_io())
    c.checkpoint(1, _arrays(), None).wait()
    w = Hopeless(c)
    sup = Supervisor(w, max_retries=2, verbose=False)
    with pytest.raises(RecoveryFailed) as ei:
        sup.run(3)
    assert w.recoveries == 2
    assert len(ei.value.incidents) == 2
    assert all(i.kind == "unknown" for i in ei.value.incidents)
    c.writer.close()


def test_supervisor_recurring_failure_does_not_livelock(tmp_path):
    class Sisyphus:
        """Recovery rewinds past a deterministically recurring failure: the
        replayed steps must not reset the retry budget."""

        def __init__(self, cluster):
            self.cluster = cluster
            self.step = 0
            self.recoveries = 0

        def step_once(self):
            if self.step + 1 == 2:
                raise ValueError("deterministic failure at step 2")
            self.step += 1

        def checkpoint(self):
            pass

        def recover(self, ck, *, new_world_size=None):
            self.recoveries += 1
            self.step = 0

    c = Cluster(1, "mpich", ckpt_dir=tmp_path, ckpt_io=_io())
    c.checkpoint(1, _arrays(), None).wait()
    w = Sisyphus(c)
    sup = Supervisor(w, max_retries=2, verbose=False)
    with pytest.raises(RecoveryFailed):
        sup.run(5)
    assert w.recoveries == 2
    c.writer.close()


def test_supervisor_refuses_without_valid_checkpoint(tmp_path):
    srv = _server(tmp_path / "ck")
    with FaultInjector(FaultPlan([FaultSpec("kill_rank", at_step=1)])) as inj:
        sup = Supervisor(srv, injector=inj, verbose=False)
        with pytest.raises(RecoveryFailed, match="resumable"):
            sup.run(EVERY - 1)          # fails before the first snapshot
    _close(srv)


# ---------------------------------------------------------------------------
# RAM tier + escalation ladder
# ---------------------------------------------------------------------------

def test_supervised_ram_tier_serves_byte_identical(tmp_path, reference):
    srv, incidents = _supervised_tier(tmp_path, [FaultSpec("kill_rank", at_step=5)])
    try:
        inc = incidents[0]
        assert inc.kind == "rank_dead" and inc.tier == "ram"
        assert inc.ckpt == "ram:step_00000003"
        assert inc.ladder == []         # first rung, first try
        _same(srv, reference)
    finally:
        _close(srv)


def test_partner_death_escalates_to_disk(tmp_path, reference):
    # the victim and its ring partner die together: every RAM copy of the
    # victim's container is lost, so the ladder falls through to disk
    srv, incidents = _supervised_tier(
        tmp_path, [FaultSpec("partner_death", at_step=5)], world=4)
    try:
        inc = incidents[0]
        assert inc.tier in ("disk", "disk_chain")
        assert any(e.get("level") == "ram" for e in inc.ladder)
        assert inc.world_after == 2
        _same(srv, reference)
    finally:
        _close(srv)


def test_corrupt_replica_fails_verification_escalates(tmp_path, reference):
    srv, incidents = _supervised_tier(
        tmp_path, [FaultSpec("corrupt_replica", at_step=4, rank=0),
                   FaultSpec("kill_rank", at_step=5, rank=0)])
    try:
        inc = incidents[0]
        assert inc.tier in ("disk", "disk_chain")
        ram_rungs = [e for e in inc.ladder if e.get("level") == "ram"]
        assert len(ram_rungs) == 1      # non-retryable: exactly one attempt
        assert "TierVerifyError" in ram_rungs[0]["error"]
        assert ram_rungs[0]["retryable"] is False
        _same(srv, reference)
    finally:
        _close(srv)


def test_double_fault_mid_recovery_absorbed_not_dropped(tmp_path, reference):
    srv, incidents = _supervised_tier(
        tmp_path, [FaultSpec("double_fault", at_step=5)], world=4)
    try:
        assert len(incidents) == 1
        inc = incidents[0]
        assert inc.absorbed and inc.absorbed[0]["kind"] == "rank_dead"
        assert inc.world_before == 4 and inc.world_after == 2
        _same(srv, reference)
    finally:
        _close(srv)


def test_restore_error_retried_on_same_rung(tmp_path, reference):
    srv, incidents = _supervised_tier(
        tmp_path, [FaultSpec("restore_error", at_step=5)])
    try:
        inc = incidents[0]
        assert inc.tier == "ram"
        assert len(inc.ladder) == 1     # one failed try, then success
        assert inc.ladder[0]["retryable"] is True
        _same(srv, reference)
    finally:
        _close(srv)


def test_backoff_knobs_scale_recovery_spacing(tmp_path):
    class FlakyTwice:
        """Fails the same step until three recoveries have happened."""

        def __init__(self, cluster):
            self.cluster = cluster
            self.step = 0
            self.recoveries = 0

        def step_once(self):
            if self.step + 1 == 2 and self.recoveries < 3:
                raise ValueError("transient failure at step 2")
            self.step += 1

        def checkpoint(self):
            pass

        def recover(self, ck, *, new_world_size=None):
            self.recoveries += 1
            self.step = 0

    def run_with(floor):
        c = Cluster(1, "mpich", ckpt_dir=tmp_path / f"f{floor}", ckpt_io=_io())
        c.checkpoint(1, _arrays(), None).wait()
        w = FlakyTwice(c)
        sup = Supervisor(w, verbose=False,
                         config=SupervisorConfig(max_retries=3, backoff_floor_s=floor,
                                                 backoff_ceiling_s=0.2,
                                                 backoff_jitter=0.0))
        sup.run(4)
        c.writer.close()
        return sup.backoff_s

    assert run_with(0.0) == 0.0         # floor 0 disables backoff entirely
    # floor + doubled floor, jitter off: exactly 3x the floor accumulated
    assert run_with(0.04) == pytest.approx(0.12, rel=0.2)


def test_supervisor_config_legacy_kwargs_override(tmp_path):
    class Idle:
        def __init__(self, cluster):
            self.cluster = cluster
            self.step = 0

        def step_once(self):
            self.step += 1

        def checkpoint(self):
            pass

        def recover(self, ck, *, new_world_size=None):
            pass

    c = Cluster(1, "mpich", ckpt_dir=tmp_path, ckpt_io=_io())
    sup = Supervisor(Idle(c), verbose=False, max_retries=7,
                     config=SupervisorConfig(max_retries=2, lease_s=9.0))
    assert sup.config.max_retries == 7     # explicit kwarg wins over config
    assert sup.config.lease_s == 9.0       # config fields otherwise respected
    assert sup.max_retries == 7
    c.writer.close()
