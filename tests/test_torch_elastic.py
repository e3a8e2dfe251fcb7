"""The port's live rescale (``repro_torch.core.elastic``): the cases of
tests/test_elastic.py that need no ``Trainer`` (fabric retirement and
scavenging, the sparse COMM_WORLD re-point, graceful and dead shrinks with
handoff, redelivery and ring repair, digest-verified joins, fenced joiners),
the same shrinks and joins through both packages (reports, vids, buffered
messages and repaired RAM-tier containers equal), then the supervised
rescale rung with the port's ``Server`` and fleet as the workload: a preemption notice shrinks the world live, with no rewind and
no image read, and the decoded stream (and the cache bytes) equal a
fault-free run's."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import CkptIOConfig, smoke_config  # noqa: E402
from repro_torch.core import Cluster, elastic, faults  # noqa: E402
from repro_torch.core.backends.fabric import DepartedRankError, Fabric  # noqa: E402
from repro_torch.core.callspec import TAG_USER, handle_vid  # noqa: E402
from repro_torch.core.ckpt_tiers import ReplicaTier, container_sha  # noqa: E402
from repro_torch.core.drain import drain_rank  # noqa: E402
from repro_torch.core.faults import (FaultInjector, FaultPlan, FaultSpec,  # noqa: E402
                                     PreemptNotice)
from repro_torch.core.restore import load_manifest, repoint_world  # noqa: E402
from repro_torch.core.supervisor import (Supervisor, SupervisorConfig,  # noqa: E402
                                         classify_failure)
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)
WORLD = 4
CFG = replace(smoke_config("granite-3-2b"), n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
              vocab_pad_multiple=64)
PROMPT, STEPS, EVERY, BATCH = 1, 9, 3, 2


def _io(**kw):
    kw.setdefault("codec", "zlib")
    kw.setdefault("incremental", True)
    kw.setdefault("drain_timeout", 1.0)
    return CkptIOConfig(**kw)


def _arrays(seed=3):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))}


def _cluster(tmp_path, world=WORLD):
    return Cluster(world, "mpich", ckpt_dir=tmp_path / "ck", ckpt_io=_io())


def _commit(c, step, arrays=None):
    c.checkpoint(step, arrays or _arrays(), None).wait()
    c.writer.wait_idle()
    return c.writer.latest()


def _allreduce_all(c):
    """One world allreduce entered by every member concurrently."""
    return c.run_collective(
        lambda m: m.allreduce(m.comm_world(), 1.0, m.op_handles["MPI_SUM"]))


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    faults.disarm_all()


# ---------------------------------------------------------------------------
# fabric, re-point, resize
# ---------------------------------------------------------------------------

def test_fabric_retire_scavenge_and_departed_send():
    f = Fabric(3)
    f.send(0, 2, 7, "queued-before-departure")
    assert f.scavenge(2) == [(0, 7, "queued-before-departure")]
    f.retire(2)
    with pytest.raises(DepartedRankError) as ei:
        f.send(0, 2, 8, "too-late")
    assert ei.value.dst == 2
    with pytest.raises(ValueError, match="never shrinks"):
        f.resize(2)
    f.resize(5)
    assert f.world_size == 5
    f.send(0, 4, 1, "new slot reachable")


def test_repoint_world_vids_coherent_across_members(tmp_path):
    c = _cluster(tmp_path)
    old_vids = {r: handle_vid(c.mana(r).comm_world()) for r in range(WORLD)}
    assert len(set(old_vids.values())) == 1
    c.remove_rank(1)
    stats = c.resize([0, 2, 3])
    assert set(stats) == {0, 2, 3}
    new_vids = {r: handle_vid(c.mana(r).comm_world()) for r in (0, 2, 3)}
    assert len(set(new_vids.values())) == 1
    assert set(new_vids.values()) != set(old_vids.values())
    for r in (0, 2, 3):
        assert c.mana(r).world_size == 3
        assert c.mana(r).backend.comm_ranks(c.mana(r).backend.world_comm()) == [0, 2, 3]
    assert _allreduce_all(c) == [3.0, 3.0, 3.0]
    c.writer.close()


def test_repoint_world_purges_stale_internal_messages(tmp_path):
    c = _cluster(tmp_path, world=2)
    m0, m1 = c.mana(0), c.mana(1)
    m1.bcast(m1.comm_world(), "half-a-round", root=1)   # in flight
    drain_rank(m0)                       # buffers the internal bcast chunk
    m1.isend(0, tag=4, payload="user")
    drain_rank(m0)
    stats = repoint_world(m0, [0, 1])
    assert stats["purged_internal"] == 1
    assert [(s, t) for s, t, _ in m0.pending_messages] == [(1, TAG_USER + 4)]
    assert m0.recv(1, 4) == "user"
    c.writer.close()


def test_resize_rejects_dead_members(tmp_path):
    c = _cluster(tmp_path)
    c.halt_rank(2)
    with pytest.raises(ValueError, match="rank 2 is dead"):
        c.resize([0, 1, 2, 3])
    c.writer.close()


# ---------------------------------------------------------------------------
# shrink
# ---------------------------------------------------------------------------

def test_shrink_graceful_handoff_redelivery_and_repair(tmp_path):
    c = _cluster(tmp_path)
    tier = ReplicaTier()
    tier.replicate(c, _commit(c, 1))
    c.mana(0).backend.send(3, TAG_USER + 7, "for-the-leaver")
    c.mana(3).pending_messages.append((2, TAG_USER + 9, "leaver-held"))
    rep = elastic.shrink(c, 3, tier=tier, cursor={"next_index": 42}, timeout=5.0)
    assert rep.kind == "shrink" and rep.graceful
    assert rep.members == [0, 1, 2] and rep.inheritor == 0
    assert rep.workload_cursor == {"next_index": 42}
    assert rep.redelivered == 2          # scavenged msg + handed-off pending
    assert rep.cancelled == []
    assert rep.downtime_ms < 1000
    assert c.survivors() == [0, 1, 2]
    assert any(k[1] == 3 for k in tier.stores[0])
    img = tier.image(c)
    assert img is not None and img.step == 1
    inh = c.mana(0)
    assert inh.recv(0, 7) == "for-the-leaver"
    assert inh.recv(2, 9) == "leaver-held"
    assert _allreduce_all(c) == [3.0, 3.0, 3.0]
    with pytest.raises(DepartedRankError):
        c.mana(1).backend.send(3, TAG_USER + 1, "ghost")
    assert ("rescaled", "shrink", 3, (0, 1, 2)) in [
        e[:4] for e in c.events if e[0] == "rescaled"]
    c.writer.close()


def test_shrink_dead_leaver_skips_handoff_serves_from_replicas(tmp_path):
    c = _cluster(tmp_path)
    tier = ReplicaTier()
    tier.replicate(c, _commit(c, 1))
    c.halt_rank(2)                       # died without a grace window
    rep = elastic.shrink(c, 2, tier=tier, timeout=5.0)
    assert not rep.graceful and rep.handoff_items == 0
    assert rep.members == [0, 1, 3]
    img = tier.image(c)
    assert img is not None and img.step == 1
    assert _allreduce_all(c) == [3.0, 3.0, 3.0]
    c.writer.close()


def test_shrink_last_member_is_typed(tmp_path):
    c = _cluster(tmp_path, world=1)
    with pytest.raises(elastic.RescaleError, match="last"):
        elastic.shrink(c, 0)
    c.writer.close()


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

def test_join_streams_digest_verified_slice(tmp_path):
    c = _cluster(tmp_path, world=2)
    tier = ReplicaTier()
    tier.replicate(c, _commit(c, 1))
    rep = elastic.join(c, tier=tier, timeout=5.0)
    assert rep.kind == "join" and rep.members == [0, 1, rep.rank]
    assert rep.slice_verified is True
    assert rep.handoff_items == len(tier.stores[rep.rank])
    for cont in tier.stores[rep.rank].values():
        assert cont.sha == container_sha(cont.data)
    assert c.survivors() == [0, 1, rep.rank]
    assert _allreduce_all(c) == [3.0, 3.0, 3.0]
    c.writer.close()


def test_join_timeout_fences_joiner_world_untouched(tmp_path):
    c = _cluster(tmp_path, world=2)
    members_before = c.survivors()
    vids_before = {r: handle_vid(c.mana(r).comm_world()) for r in members_before}

    def stall(name, ctx):
        faults.disarm("elastic.join.ready", stall)
        raise faults.InjectedFault(f"injected join stall: rank {ctx.get('rank')} wedged")

    faults.arm("elastic.join.ready", stall)
    with pytest.raises(elastic.JoinTimeoutError) as ei:
        elastic.join(c, timeout=1.0)
    fenced = ei.value.rank
    assert c.survivors() == members_before
    assert {r: handle_vid(c.mana(r).comm_world()) for r in members_before} == vids_before
    assert _allreduce_all(c) == [2.0, 2.0]
    with pytest.raises(DepartedRankError):
        c.mana(0).backend.send(fenced, TAG_USER + 1, "ghost")
    assert any(e[0] == "join_fenced" and e[1] == fenced for e in c.events)
    c.writer.close()


def test_injected_join_timeout_fault_arms_the_failpoint(tmp_path):
    c = _cluster(tmp_path, world=2)
    with FaultInjector(FaultPlan([FaultSpec("join_timeout", at_step=1)])) as inj:
        inj.on_step(1, c)
        with pytest.raises(elastic.JoinTimeoutError):
            elastic.join(c, timeout=1.0)
    assert c.survivors() == [0, 1]
    c.writer.close()


def test_classify_preempt_notice():
    assert classify_failure(PreemptNotice(2, 3.0)) == ("preempt_notice", 2)


# ---------------------------------------------------------------------------
# the supervised rescale rung, the Server decoding
# ---------------------------------------------------------------------------

def _server(ckpt_dir, world=WORLD):
    srv = Server(CFG, world_size=world, device="cpu", seed=0)
    if ckpt_dir is not None:
        srv.cluster = Cluster(world, "mpich", ckpt_dir=ckpt_dir, ckpt_io=_io())
    prompts = np.random.default_rng(7).integers(0, CFG.vocab_size, (BATCH, PROMPT))
    logits = srv.prefill(prompts, pad_to=PROMPT + STEPS)
    srv.start_decode(np.argmax(logits[:, : CFG.vocab_size].numpy(), -1))
    return srv


def _result(srv):
    return (np.stack(srv.generated, axis=1),
            [t.numpy().tobytes() for t in tree_leaves(srv.caches)])


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


def _supervised(tmp_path, specs, world=WORLD, **cfg_kw):
    cfg_kw.setdefault("backoff_floor_s", 0.01)
    cfg_kw.setdefault("backoff_ceiling_s", 0.05)
    srv = _server(tmp_path / "ck", world=world)
    with FaultInjector(FaultPlan(specs)) as inj:
        sup = Supervisor(srv, injector=inj, lease_s=1.0, verbose=False,
                         tier=ReplicaTier(), config=SupervisorConfig(**cfg_kw))
        incidents = sup.run(STEPS, ckpt_every=EVERY)
    return srv, incidents


def test_supervised_preempt_rescale_rung_no_rewind(tmp_path, reference):
    srv, incidents = _supervised(tmp_path, [FaultSpec("preempt_notice", at_step=5, rank=3)])
    try:
        assert [i.kind for i in incidents] == ["preempt_notice"]
        inc = incidents[0]
        assert inc.tier == "rescale" and inc.ckpt is None
        # no rewind: decode continues at the very position the notice came
        assert inc.resumed_step == inc.step == 5
        assert inc.world_before == WORLD and inc.world_after == WORLD - 1
        assert srv.cluster.survivors() == [0, 1, 2]
        assert any(e[0] == "rescaled" for e in srv.cluster.events)
        srv.cluster.writer.wait_idle()
        assert load_manifest(srv.cluster.writer.latest())["members"] == [0, 1, 2]
        _same(srv, reference)
    finally:
        srv.cluster.writer.close()


def test_supervised_rescale_off_falls_through_to_ladder(tmp_path, reference):
    srv, incidents = _supervised(tmp_path, [FaultSpec("preempt_notice", at_step=5, rank=3)],
                                 rescale="off")
    try:
        inc = incidents[0]
        assert inc.kind == "preempt_notice"
        assert inc.tier in ("ram", "disk", "disk_chain")
        assert inc.resumed_step == 3
        _same(srv, reference)
    finally:
        srv.cluster.writer.close()


def test_supervised_rescale_all_serves_rank_dead(tmp_path, reference):
    srv, incidents = _supervised(tmp_path, [FaultSpec("kill_rank", at_step=5, rank=3)],
                                 rescale="all")
    try:
        inc = incidents[0]
        assert inc.kind == "rank_dead" and inc.tier == "rescale"
        assert inc.resumed_step == inc.step
        assert srv.cluster.survivors() == [0, 1, 2]
        _same(srv, reference)
    finally:
        srv.cluster.writer.close()


def test_supervised_shrink_downtime_beats_restore(tmp_path):
    srv1, inc1 = _supervised(tmp_path / "a", [FaultSpec("preempt_notice", at_step=5, rank=3)])
    srv1.cluster.writer.close()
    srv2, inc2 = _supervised(tmp_path / "b", [FaultSpec("preempt_notice", at_step=5, rank=3)],
                             rescale="off")
    srv2.cluster.writer.close()
    assert inc1[0].tier == "rescale" and inc2[0].tier in ("ram", "disk")
    assert inc1[0].timings["restore_ms"] < inc2[0].timings["restore_ms"]


def test_supervised_fleet_preempt_keeps_its_pages(tmp_path):
    """The fleet under a preemption notice: the world shrinks live, every
    session keeps its pages where they are (no store is replaced), and the
    streams equal a fault-free fleet's."""
    def fleet(ckpt_dir):
        eng = ServeEngine(CFG, world_size=WORLD, ckpt_dir=ckpt_dir, device="cpu",
                          max_len=24, page_size=4, n_pages=32, max_running=2)
        rng = np.random.default_rng(1)
        for n, m in ((6, 8), (3, 6), (9, 5)):
            eng.submit(rng.integers(0, 256, n), max_new_tokens=m)
        return eng

    ref = fleet(None)
    ref.run_until_drained()
    eng = fleet(tmp_path / "ck")
    stores = dict(eng.pool.stores)
    with FaultInjector(FaultPlan([FaultSpec("preempt_notice", at_step=2, rank=1)])) as inj:
        sup = Supervisor(eng, injector=inj, lease_s=1.0, verbose=False, tier=ReplicaTier(),
                         config=SupervisorConfig(backoff_floor_s=0.0))
        incidents = sup.run(4, ckpt_every=3)
    inc, = incidents
    assert inc.tier == "rescale" and inc.resumed_step == inc.step == 2
    assert all(eng.pool.stores[k] is v for k, v in stores.items())
    eng.run_until_drained()
    assert {s: eng.stream(s) for s in eng.sessions} == \
        {s: ref.stream(s) for s in ref.sessions}
    eng.cluster.writer.close()


# ---------------------------------------------------------------------------
# the same rescale in both packages
# ---------------------------------------------------------------------------

def _jax_side():
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs import CkptIOConfig as JaxIO
    from repro.core import Cluster as JaxCluster
    from repro.core import elastic as jax_elastic
    from repro.core.ckpt_tiers import ReplicaTier as JaxTier
    return jnp, JaxIO, JaxCluster, jax_elastic, JaxTier


def _drive_rescale(pkg, scenario, tmp_path, host):
    """One scenario through one package's Cluster, tier and elastic:
    two committed steps replicated over the ring, traffic in flight
    towards the leaver, then the membership change(s).  Returns what the
    two packages must agree on."""
    cluster_cls, io_cls, tier_cls, el, to_tree = pkg
    world = 2 if scenario == "join" else WORLD
    c = cluster_cls(world, "mpich", ckpt_dir=tmp_path / "ck",
                    ckpt_io=io_cls(codec="zlib", incremental=True, drain_timeout=1.0))
    tier = tier_cls()
    tier.attach(c)
    c.writer.on_commit = tier.note_commit
    for step in (1, 2):
        c.checkpoint(step, to_tree({k: v * step for k, v in host.items()}), None).wait()
        c.writer.wait_idle()
    reports = []
    if scenario in ("graceful", "shrink_then_join"):
        c.mana(0).backend.send(3, TAG_USER + 7, "for-the-leaver")
        c.mana(3).pending_messages.append((2, TAG_USER + 9, "leaver-held"))
        c.mana(1).bcast(c.mana(1).comm_world(), "half-a-round", root=1)
        drain_rank(c.mana(3))          # buffers the internal bcast chunk
        reports.append(el.shrink(c, 3, tier=tier, cursor={"next_index": 42}, timeout=5.0))
    if scenario == "dead":
        c.halt_rank(2)
        reports.append(el.shrink(c, 2, tier=tier, timeout=5.0))
    if scenario in ("join", "shrink_then_join"):
        reports.append(el.join(c, tier=tier, cursor={"shard": 5}, timeout=5.0))
    got = {
        "reports": [{k: v for k, v in vars(r).items()
                     if k not in ("timings", "downtime_ms")} for r in reports],
        "survivors": c.survivors(),
        "vids": {r: handle_vid(c.mana(r).comm_world()) for r in c.survivors()},
        "pending": {r: list(c.mana(r).pending_messages) for r in c.survivors()},
        "stores": {r: {k: (v.data, v.sha, v.index, v.state)
                       for k, v in sorted(tier.stores.get(r, {}).items())}
                   for r in c.survivors()},
        "events": [e[:-1] for e in c.events if e[0].startswith(("rescale", "join"))],
        "image": (lambda img: (img.step, sorted(img.containers)))(tier.image(c)),
    }
    for key, cont in (k for st in tier.stores.values() for k in st.items()):
        assert cont.sha == container_sha(cont.data), key
    c.writer.close()
    return got


@pytest.mark.parametrize("scenario", ["graceful", "dead", "join", "shrink_then_join"])
def test_rescale_matches_the_jax_package(tmp_path, scenario):
    """The same world, the same committed images (numpy from a seed) and
    the same membership change through both packages' ``Cluster``,
    ``ReplicaTier`` and ``elastic``: the reports agree field for field
    (timings aside), the survivors share the same COMM_WORLD vids and
    buffered messages, and every holder's containers (bytes, sha, index,
    state text) are equal after the ring repair."""
    jnp, JaxIO, JaxCluster, jax_elastic, JaxTier = _jax_side()
    host = {"w": np.random.default_rng(5).normal(size=(64, 16)).astype(np.float32),
            "m": np.random.default_rng(6).normal(size=(32, 8)).astype(np.float32)}
    jax_got = _drive_rescale(
        (JaxCluster, JaxIO, JaxTier, jax_elastic,
         lambda t: {k: jnp.asarray(v) for k, v in t.items()}),
        scenario, tmp_path / "jax", host)
    port_got = _drive_rescale(
        (Cluster, CkptIOConfig, ReplicaTier, elastic,
         lambda t: {k: torch.from_numpy(v) for k, v in t.items()}),
        scenario, tmp_path / "port", host)
    assert port_got["reports"] and port_got["reports"] == jax_got["reports"]
    for key in ("survivors", "vids", "pending", "events", "image"):
        assert port_got[key] == jax_got[key], key
    assert port_got["stores"].keys() == jax_got["stores"].keys()
    for r in port_got["stores"]:
        assert port_got["stores"][r] == jax_got["stores"][r], r
    # the repair left every container of the newest image on two survivors
    held = [k for st in port_got["stores"].values() for k in st if k[0] == 2]
    assert all(held.count(k) >= 2 for k in set(held))
