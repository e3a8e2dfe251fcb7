"""The fleet's checkpoint/restart and migration in the port
(``ServeEngine.checkpoint`` / ``restore`` / ``recover`` / ``resume_latest``,
``serving/migrate.py``) at tests/test_serving.py's tiny widths, with the JAX
package's ServeEngine beside it on the same params (numpy from a seed).

tests/test_serving.py's fleet C/R and migration cases run on the port; a
fleet snapshot moves between the two packages' engines in both directions
and goes on with the streams of an uninterrupted run (float32); a JAX
snapshot resumed in the port and snapshotted again is the JAX container
byte for byte (entries, shard bytes, runtime meta with its JSON page
table); and a bfloat16 fleet snapshot has entries typed ``bfloat16`` (not
the ``uint16`` of its host bits), no ``"dtypes"`` side table, and restores
in the JAX engine bit for bit."""
import json
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.serving.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import ckpt_io, faults  # noqa: E402
from repro_torch.core.faults import FAULT_KINDS, FaultInjector, FaultPlan, FaultSpec  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving import (MigrationError, ServeEngine,  # noqa: E402
                                 migrate_sessions)
from repro_torch.serving.scheduler import MIGRATED, QUEUED, RUNNING  # noqa: E402

torch.set_num_threads(1)


def _tiny(fn, dtype="float32"):
    return replace(fn("granite-3-2b"), n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
                   vocab_pad_multiple=64, param_dtype=dtype, compute_dtype=dtype,
                   cache_dtype=dtype)


JCFG, CFG = _tiny(jax_smoke_config), _tiny(smoke_config)
KW = dict(max_len=24, page_size=4, n_pages=32)
# tests/test_torch_fleet.py's preemption traffic: a pool too small for both,
# the high-priority arrival parks the low one (parked during ticks 7-8)
PREEMPT_KW = dict(max_len=24, page_size=4, n_pages=6, max_running=2)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    faults.disarm_all()


@pytest.fixture(scope="module")
def params():
    """The JAX engine's seed-0 params, numpy leaves."""
    return jax.tree.map(np.asarray, JaxEngine(JCFG, seed=0, max_len=8, page_size=4,
                                              n_pages=2).params)


def _port(params, cfg=CFG, **kw):
    return ServeEngine(cfg, params=from_jax_params(params, cfg, "cpu"), device="cpu",
                       **kw)


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, n) for n in (6, 3, 8)]


def _late(eng):
    """The high-priority third session arrives at tick 3."""
    if eng.tick == 3 and "c" not in eng.sessions:
        eng.submit(_prompts()[2], sid="c", max_new_tokens=6, priority=5)


def _traffic(eng, until=None):
    """Two sessions, then the late one; stops after tick ``until``."""
    a, b, _ = _prompts()
    eng.submit(a, sid="a", max_new_tokens=8)
    eng.submit(b, sid="b", max_new_tokens=6)
    while eng.sched.live() or eng.tick < 3:
        _late(eng)
        eng.step_once()
        if until is not None and eng.tick == until:
            return None
    return {s: eng.stream(s) for s in sorted(eng.sessions)}


def _finish(eng):
    eng.run_until_drained()
    return {s: eng.stream(s) for s in sorted(eng.sessions)}


def _rank0(step):
    return json.loads((step / "rank00000" / "state.json").read_text())


# ---------------------------------------------------------------------------
# tests/test_serving.py's fleet cases, on the port
# ---------------------------------------------------------------------------

def test_engine_checkpoint_restore_cross_flavor(params, tmp_path):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, 6, dtype=np.int32)
    eng = _port(params, backend="mpich", ckpt_dir=tmp_path, **KW)
    s1 = eng.submit(prompt, max_new_tokens=8)
    s2 = eng.submit(rng.integers(0, 256, 3), max_new_tokens=6)
    for _ in range(3):
        eng.step_once()
    eng.checkpoint().wait()
    mid = {s: list(eng.stream(s)) for s in (s1, s2)}
    key_mid = eng.rng_key.copy()
    eng.run_until_drained()
    full = {s: eng.stream(s) for s in (s1, s2)}

    fresh = _port(params, backend="fabric", ckpt_dir=tmp_path, **KW)
    assert fresh.resume_latest() is not None
    assert fresh.cluster.backend_name == "fabric"     # an mpich image under fabric
    assert {s: fresh.stream(s) for s in (s1, s2)} == mid
    assert fresh.tick == 3 and fresh.rng_key.tobytes() == key_mid.tobytes()
    fresh.run_until_drained()
    assert {s: fresh.stream(s) for s in (s1, s2)} == full
    assert fresh.last_runtime_restore["skipped"] == []
    # under another flavor, through the restart plane
    other = _port(params, backend="mpich", ckpt_dir=tmp_path, **KW)
    assert other.resume_latest(new_backend="exampi") is not None
    assert other.cluster.backend_name == "exampi"
    assert _finish(other) == full


@pytest.mark.parametrize("moving", ["both", "one"])
def test_live_migration_cross_flavor_byte_identical(params, moving):
    # "one": the source keeps decoding the session it did not hand over
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, 6, dtype=np.int32)
    long_prompt = rng.integers(0, 256, 11, dtype=np.int32)  # spans 3 pages

    ref = _port(params, backend="mpich", **KW)
    r1 = ref.submit(prompt, max_new_tokens=8)
    r2 = ref.submit(long_prompt, max_new_tokens=6)
    ref.run_until_drained()

    src = _port(params, backend="mpich", **KW)
    a = src.submit(prompt, max_new_tokens=8)
    b = src.submit(long_prompt, max_new_tokens=6)
    for _ in range(3):
        src.step_once()
    dst = _port(params, backend="fabric", **KW)
    if moving == "one":
        rep = migrate_sessions(src, dst, [b])
        assert rep.sessions == [b] and src.sched.state(b) == MIGRATED
        assert list(src.pool.sessions) == [a]
        src.run_until_drained()
        dst.run_until_drained()
        assert src.stream(a) == ref.stream(r1)
        assert dst.stream(b) == ref.stream(r2)
        return
    rep = migrate_sessions(src, dst, [a, b])
    assert rep.sessions == [a, b] and rep.chunks > 0 and rep.bytes > 0
    assert (rep.src_flavor, rep.dst_flavor) == ("mpich", "fabric")
    assert src.sched.state(a) == MIGRATED and not src.sched.live()
    assert not src.pool.sessions
    dst.run_until_drained()
    assert dst.stream(a) == ref.stream(r1)   # gap- and duplicate-free
    assert dst.stream(b) == ref.stream(r2)


def test_migration_into_busy_destination_queues_then_runs(params):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, 6, dtype=np.int32)
    ref = _port(params, backend="mpich", **KW)
    r = ref.submit(prompt, max_new_tokens=8)
    ref.run_until_drained()

    src = _port(params, backend="mpich", **KW)
    a = src.submit(prompt, sid="mig-a", max_new_tokens=8)
    for _ in range(3):
        src.step_once()
    # the destination's one lane is busy: the migrated session lands
    # pool-resident but QUEUED, then takes the lane when the busy one retires
    dst = _port(params, backend="fabric", max_running=1, **KW)
    busy = dst.submit(rng.integers(0, 256, 4, dtype=np.int32), max_new_tokens=6)
    dst.step_once()
    assert dst.sched.lanes_free() == 0
    migrate_sessions(src, dst, [a])
    assert dst.sched.state(a) == QUEUED and a in dst.pool.sessions
    dst.run_until_drained(max_ticks=100)
    assert dst.stream(a) == ref.stream(r)
    assert len(dst.stream(busy)) == 6


def test_migration_torn_transfer_rejected(params):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, 6, dtype=np.int32)
    src = _port(params, backend="mpich", **KW)
    ref = _port(params, backend="mpich", **KW)
    a = src.submit(prompt, max_new_tokens=8)
    ra = ref.submit(prompt, max_new_tokens=8)
    for _ in range(2):
        src.step_once()
    ref.run_until_drained()
    dst = _port(params, backend="fabric", **KW)

    def flip(name, ctx):
        m = ctx["msg"]
        m["data"] = bytes([m["data"][0] ^ 0xFF]) + m["data"][1:]
        faults.disarm("serve.migrate.chunk", flip)

    faults.arm("serve.migrate.chunk", flip)
    with pytest.raises(MigrationError, match="torn transfer"):
        migrate_sessions(src, dst, [a])
    # at-most-once placement: still live at the source, absent at the destination
    assert src.sched.state(a) == RUNNING
    assert a not in dst.sessions and a not in dst.pool.sessions
    src.run_until_drained()
    assert src.stream(a) == ref.stream(ra)


def test_migrate_corrupt_fault_kind_fires_failpoint():
    assert "migrate_corrupt" in FAULT_KINDS

    class _StubCluster:
        def __init__(self):
            self.events = []

    plan = FaultPlan([FaultSpec(kind="migrate_corrupt", at_step=0)])
    with FaultInjector(plan) as inj:
        inj.on_step(0, _StubCluster())
        msg = {"data": b"\x00" * 8, "sha": "irrelevant"}
        faults.failpoint("serve.migrate.chunk", msg=msg)
        assert msg["data"] != b"\x00" * 8          # bytes flipped
        msg2 = {"data": b"\x00" * 8}
        faults.failpoint("serve.migrate.chunk", msg=msg2)
        assert msg2["data"] == b"\x00" * 8         # one-shot


def test_migrate_corrupt_fault_rejects_a_real_migration(params):
    src = _port(params, backend="mpich", **KW)
    a = src.submit(np.arange(6), max_new_tokens=8)
    src.step_once()
    dst = _port(params, backend="openmpi", **KW)
    with FaultInjector(FaultPlan([FaultSpec("migrate_corrupt", at_step=0)])) as inj:
        inj.on_step(0, src.cluster)
        with pytest.raises(MigrationError):
            migrate_sessions(src, dst, [a])
    assert src.sched.state(a) == RUNNING and not dst.sessions


# ---------------------------------------------------------------------------
# a fleet snapshot between the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uninterrupted(params):
    streams = _traffic(_port(params, **PREEMPT_KW))
    assert streams == _traffic(JaxEngine(JCFG, seed=0, **PREEMPT_KW))
    return streams


@pytest.mark.parametrize("snap_tick", [5, 7])      # tick 7: a session is parked
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_fleet_snapshot_moves_between_the_packages(params, uninterrupted, tmp_path,
                                                   direction, snap_tick):
    writer = JaxEngine(JCFG, seed=0, ckpt_dir=tmp_path, **PREEMPT_KW) \
        if direction == "jax_to_torch" else _port(params, ckpt_dir=tmp_path, **PREEMPT_KW)
    _traffic(writer, until=snap_tick)
    assert bool(writer.pool.parked) == (snap_tick == 7)
    writer.checkpoint().wait()
    reader = _port(params, backend="fabric", ckpt_dir=tmp_path, **PREEMPT_KW) \
        if direction == "jax_to_torch" \
        else JaxEngine(JCFG, backend="fabric", seed=0, ckpt_dir=tmp_path, **PREEMPT_KW)
    assert reader.resume_latest(new_backend="openmpi") is not None
    assert reader.tick == snap_tick and sorted(reader.pool.parked) == sorted(writer.pool.parked)
    assert reader.last_runtime_restore["skipped"] == []
    assert np.asarray(jax.random.key_data(reader.rng_key)
                      if direction == "torch_to_jax" else reader.rng_key).tobytes() \
        == np.asarray(writer.rng_key if direction == "torch_to_jax"
                      else jax.random.key_data(writer.rng_key)).tobytes()
    assert _finish(reader) == uninterrupted


@pytest.mark.parametrize("snap_tick", [5, 7])
def test_port_resnapshot_of_a_jax_snapshot_is_the_same_container(params, tmp_path,
                                                                 snap_tick):
    # the same fleet state snapshotted by each package: a JAX snapshot
    # restored by a fresh JAX engine and by a port engine, each snapshotted
    # again at once (a restore bumps the page table's ``seq`` in both)
    jax_eng = JaxEngine(JCFG, seed=0, ckpt_dir=tmp_path / "src", **PREEMPT_KW)
    _traffic(jax_eng, until=snap_tick)
    jax_eng.checkpoint().wait()
    src = jax_eng.cluster.writer.latest()
    again = JaxEngine(JCFG, seed=0, ckpt_dir=tmp_path / "jax", **PREEMPT_KW)
    eng = _port(params, ckpt_dir=tmp_path / "port", **PREEMPT_KW)
    for e in (again, eng):
        e.restore(src)
        e.checkpoint().wait()
    js, ts = again.cluster.writer.latest(), eng.cluster.writer.latest()
    assert ts.name == js.name == src.name
    for r in ("rank00000", "rank00001"):
        ji = json.loads((js / r / ckpt_io.INDEX_NAME).read_text())
        ti = json.loads((ts / r / ckpt_io.INDEX_NAME).read_text())
        assert ti == ji
        assert (ts / r / ckpt_io.BIN_NAME).read_bytes() == \
            (js / r / ckpt_io.BIN_NAME).read_bytes()
    jst, tst = _rank0(js), _rank0(ts)
    assert tst["runtime"] == jst["runtime"] and tst["tick"] == jst["tick"] == snap_tick
    table = tst["runtime"]["providers"]["kv_pages"]["meta"]["table"]
    assert "dtypes" not in table and bool(table["parked"]) == (snap_tick == 7)
    jm, tm = (json.loads((s / "manifest.json").read_text()) for s in (js, ts))
    assert tm["leaves"] == jm["leaves"]


# ---------------------------------------------------------------------------
# bfloat16: entries typed bfloat16, restored by the JAX engine
# ---------------------------------------------------------------------------

def test_bf16_fleet_snapshot_is_typed_bfloat16_and_restores_in_jax(params, tmp_path):
    cfg16, jcfg16 = _tiny(smoke_config, "bfloat16"), _tiny(jax_smoke_config, "bfloat16")
    p16 = jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16), params)
    eng = _port(p16, cfg=cfg16, ckpt_dir=tmp_path / "port", **PREEMPT_KW)
    assert eng.pool.stores["leaf000"].dtype == torch.bfloat16
    _traffic(eng, until=7)
    assert eng.pool.parked                      # a parked (host) payload rides too
    eng.checkpoint().wait()
    ts = eng.cluster.writer.latest()
    entries = json.loads((ts / "rank00000" / ckpt_io.INDEX_NAME).read_text())["entries"]
    page_entries = [e for e in entries.values() if e["dtype"] not in ("uint32",)]
    assert page_entries and {e["dtype"] for e in page_entries} == {"bfloat16"}
    meta = _rank0(ts)["runtime"]["providers"]["kv_pages"]
    assert "dtypes" not in meta["meta"]["table"]
    assert all("dtypes" not in row for row in meta["meta"]["table"]["parked"].values())
    assert {lf["dtype"] for lf in meta["leaves"]} == {"bfloat16"}

    jax_eng = JaxEngine(jcfg16, backend="fabric", seed=0, ckpt_dir=tmp_path / "jax",
                        **PREEMPT_KW)
    jax_eng.restore(ts, new_backend="exampi")
    ja, jt = jax_eng.pool.export_state()
    ta, tt = eng.pool.export_state()
    # the page tables agree but for ``seq``, which a restore bumps
    assert dict(jt, seq=None) == dict(tt, seq=None)
    for sid in ta:
        for key, t in ta[sid]["tokens"].items():
            j = np.asarray(ja[sid]["tokens"][key])
            assert j.dtype == ml_dtypes.bfloat16
            want = t.view(torch.int16).numpy() if isinstance(t, torch.Tensor) \
                else np.asarray(t).view(np.int16)
            np.testing.assert_array_equal(j.view(np.int16), want)
    # the JAX engine decodes on from the port's image, and the port's own
    # restore of it continues the uninterrupted port stream
    jax_streams = _finish(jax_eng)
    assert [len(v) for v in jax_streams.values()] == [8, 6, 6]
    ref = _traffic(_port(p16, cfg=cfg16, **PREEMPT_KW))
    back = _port(p16, cfg=cfg16, ckpt_dir=tmp_path / "port", **PREEMPT_KW)
    assert back.resume_latest(new_backend="craympi") is not None
    assert {ckpt_io.dtype_name(a.dtype)
            for a in back.pool.parked["a"]["tokens"].values()} == {"bfloat16"}
    assert back.export_session_state("a")["pool"]["table"]["dtypes"] == {
        "leaf000": "bfloat16", "leaf001": "bfloat16"}
    assert _finish(back) == ref


# ---------------------------------------------------------------------------
# the supervised fleet: a rank death re-homes every live session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_supervised_fleet_kill_rank_rehomes_with_equal_streams(params, uninterrupted,
                                                              tmp_path, tier):
    # benchmarks/bench_serve.py's re-home cell on the port, over the
    # preemption traffic: the late arrival comes with tick 3, so a recovery
    # that rewinds to tick 3 sees it arrive again
    from repro_torch.core.ckpt_tiers import ReplicaTier
    from repro_torch.core.supervisor import Supervisor, SupervisorConfig

    class Traffic(ServeEngine):
        def step_once(self):
            _late(self)
            return super().step_once()

    eng = Traffic(CFG, params=from_jax_params(params, CFG, "cpu"), device="cpu",
                  ckpt_dir=tmp_path, **PREEMPT_KW)
    a, b, _ = _prompts()
    eng.submit(a, sid="a", max_new_tokens=8)
    eng.submit(b, sid="b", max_new_tokens=6)
    plan = FaultPlan([FaultSpec("kill_rank", at_step=5, rank=1)])
    with FaultInjector(plan) as inj:
        sup = Supervisor(eng, injector=inj, lease_s=1.0, verbose=False,
                         tier=ReplicaTier() if tier == "ram" else None,
                         config=SupervisorConfig(backoff_floor_s=0.0))
        incidents = sup.run(10, ckpt_every=3)
    inc, = incidents
    assert (inc.kind, inc.tier, inc.world_before, inc.world_after) == \
        ("rank_dead", tier, 2, 1)
    assert inc.resumed_step == 3 and inc.rehomed >= 1
    assert inc.ckpt == ("ram:step_00000003" if tier == "ram" else "step_00000003")
    assert _finish(eng) == uninterrupted
    eng.cluster.writer.close()


# ---------------------------------------------------------------------------
# xLSTM's fleet: its sessions' blocks (recurrent states on the card) through
# the snapshot, across the packages, and through a migration across flavors
# ---------------------------------------------------------------------------

XCFG, XJCFG = smoke_config("xlstm-350m"), jax_smoke_config("xlstm-350m")
#: two lanes, 4 pages of 4: two priority-5 arrivals take both lanes and
#: park "a" (3 pages) from tick 4 until "b" retires
XKW = dict(max_len=32, page_size=4, n_pages=4, max_running=2)


@pytest.fixture(scope="module")
def xparams():
    return jax.tree.map(np.asarray, JaxEngine(XJCFG, seed=0, max_len=8, page_size=4,
                                              n_pages=2).params)


def _xtraffic(eng, until=None):
    rng = np.random.default_rng(5)
    a, d, b, e = (rng.integers(0, XCFG.vocab_size, n) for n in (12, 4, 8, 8))
    eng.submit(a, sid="a", max_new_tokens=12)
    eng.submit(d, sid="d", max_new_tokens=3)
    while eng.sched.live() or eng.tick < 1:
        if eng.tick == 1 and "b" not in eng.sessions:
            eng.submit(b, sid="b", max_new_tokens=8, priority=5)
            eng.submit(e, sid="e", max_new_tokens=8, priority=5)
        eng.step_once()
        if until is not None and eng.tick == until:
            return None
    return {s: eng.stream(s) for s in sorted(eng.sessions)}


@pytest.fixture(scope="module")
def x_uninterrupted(xparams):
    streams = _xtraffic(_port(xparams, cfg=XCFG, **XKW))
    assert streams == _xtraffic(JaxEngine(XJCFG, seed=0, **XKW))
    return streams


@pytest.mark.parametrize("snap_tick", [2, 6])      # tick 6: "a" is parked
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_xlstm_fleet_snapshot_moves_between_the_packages(xparams, x_uninterrupted, tmp_path,
                                                         direction, snap_tick):
    writer = JaxEngine(XJCFG, seed=0, ckpt_dir=tmp_path, **XKW) \
        if direction == "jax_to_torch" else _port(xparams, cfg=XCFG, ckpt_dir=tmp_path, **XKW)
    _xtraffic(writer, until=snap_tick)
    assert sorted(writer.pool.parked) == (["a"] if snap_tick == 6 else [])
    writer.checkpoint().wait()
    reader = _port(xparams, cfg=XCFG, backend="fabric", ckpt_dir=tmp_path, **XKW) \
        if direction == "jax_to_torch" \
        else JaxEngine(XJCFG, backend="fabric", seed=0, ckpt_dir=tmp_path, **XKW)
    assert reader.resume_latest(new_backend="openmpi") is not None
    assert reader.tick == snap_tick and sorted(reader.pool.parked) == sorted(writer.pool.parked)
    if direction == "jax_to_torch":
        # the resident sessions' blocks came back onto the pool's device
        assert all(isinstance(t, torch.Tensor) for a in reader.pool.sessions.values()
                   for t in a.blocks.values())
    assert _xfinish(reader) == x_uninterrupted


def _xfinish(eng):
    eng.run_until_drained()
    return {s: eng.stream(s) for s in sorted(eng.sessions)}


@pytest.mark.parametrize("snap_tick", [2, 6])
def test_xlstm_port_resnapshot_of_a_jax_snapshot_is_the_same_container(xparams, tmp_path,
                                                                       snap_tick):
    jax_eng = JaxEngine(XJCFG, seed=0, ckpt_dir=tmp_path / "src", **XKW)
    _xtraffic(jax_eng, until=snap_tick)
    jax_eng.checkpoint().wait()
    src = jax_eng.cluster.writer.latest()
    again = JaxEngine(XJCFG, seed=0, ckpt_dir=tmp_path / "jax", **XKW)
    eng = _port(xparams, cfg=XCFG, ckpt_dir=tmp_path / "port", **XKW)
    for e in (again, eng):
        e.restore(src)
        e.checkpoint().wait()
    js, ts = again.cluster.writer.latest(), eng.cluster.writer.latest()
    for r in ("rank00000", "rank00001"):
        ji = json.loads((js / r / ckpt_io.INDEX_NAME).read_text())
        assert json.loads((ts / r / ckpt_io.INDEX_NAME).read_text()) == ji
        assert (ts / r / ckpt_io.BIN_NAME).read_bytes() == \
            (js / r / ckpt_io.BIN_NAME).read_bytes()
    jst, tst = _rank0(js), _rank0(ts)
    assert tst["runtime"] == jst["runtime"] and tst["tick"] == jst["tick"] == snap_tick
    table = tst["runtime"]["providers"]["kv_pages"]["meta"]["table"]
    assert bool(table["parked"]) == (snap_tick == 6)
    jm, tm = (json.loads((s / "manifest.json").read_text()) for s in (js, ts))
    assert tm["leaves"] == jm["leaves"] and '"blocks"' in json.dumps(tst["runtime"])


def test_xlstm_live_migration_across_flavors(xparams, x_uninterrupted):
    """The running and the parked session move mpich -> fabric (their blocks
    in the reference's payload form) and finish there with the streams of
    an uninterrupted run; the sessions left behind finish at the source."""
    src = _port(xparams, cfg=XCFG, backend="mpich", **XKW)
    _xtraffic(src, until=6)
    assert sorted(src.pool.parked) == ["a"] and "b" in src.pool.sessions
    dst = _port(xparams, cfg=XCFG, backend="fabric", **XKW)
    rep = migrate_sessions(src, dst, ["a", "b"])
    assert rep.sessions == ["a", "b"] and rep.chunks == 18 and rep.bytes > 0
    assert (rep.src_flavor, rep.dst_flavor) == ("mpich", "fabric")
    assert src.sched.state("a") == src.sched.state("b") == MIGRATED
    dst.run_until_drained()
    src.run_until_drained()
    assert {s: dst.stream(s) for s in "ab"} == {s: x_uninterrupted[s] for s in "ab"}
    assert {s: src.stream(s) for s in "de"} == {s: x_uninterrupted[s] for s in "de"}
