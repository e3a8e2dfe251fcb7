"""The port's peer-replicated RAM tier (``repro_torch.core.ckpt_tiers``):
tests/test_ckpt_tiers.py's cases through the port's ``Cluster`` with torch
tensors as the checkpointed arrays (ring pairing, commit-riding replication
over the interposed p2p plane, checksum-verified ``TierImage`` assembly from
survivors only, delta-chain retention, ring repair, the checkpoint-source
protocol), the writer's ``on_commit`` hook, and the tier against the JAX
package's: for the same committed image (float32 and bfloat16 leaves made
with numpy from a seed) both tiers hold the same container bytes, index,
state text and ``container_sha``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import CkptIOConfig as JaxIO  # noqa: E402
from repro.core import Cluster as JaxCluster  # noqa: E402
from repro.core.ckpt_tiers import ReplicaTier as JaxTier  # noqa: E402
from repro_torch.configs import CkptIOConfig  # noqa: E402
from repro_torch.core import Cluster, ckpt_io, faults  # noqa: E402
from repro_torch.core.ckpt_tiers import (Container, ReplicaTier, TierImage,  # noqa: E402
                                         TierVerifyError, container_sha,
                                         ring_partner)
from repro_torch.core.faults import FaultInjector, FaultPlan, FaultSpec  # noqa: E402
from repro_torch.core.restore import (DirCheckpointSource, as_source,  # noqa: E402
                                      load_arrays, load_manifest, load_rank_state)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    faults.disarm_all()


def _io(**kw):
    kw.setdefault("codec", "zlib")
    kw.setdefault("incremental", True)
    kw.setdefault("drain_timeout", 1.0)
    return CkptIOConfig(**kw)


def _host(seed=3):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64, 16)).astype(np.float32),
            "m": rng.normal(size=(64, 16)).astype(np.float32)}


def _arrays(seed=3):
    return {k: torch.from_numpy(v) for k, v in _host(seed).items()}


def _cluster(tmp_path, world=2):
    return Cluster(world, "mpich", ckpt_dir=tmp_path / "ck", ckpt_io=_io())


def _commit(c, step, arrays=None):
    c.checkpoint(step, arrays or _arrays(), None).wait()
    c.writer.wait_idle()
    return c.writer.latest()


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_ring_partner_pairing():
    alive = [0, 1, 2, 3]
    assert [ring_partner(r, alive) for r in alive] == [1, 2, 3, 0]
    assert ring_partner(1, [1, 3]) == 3        # skips dead ranks
    assert ring_partner(3, [1, 3]) == 1        # wraps
    assert ring_partner(0, [0]) is None        # alone: nobody to push to


def test_memory_shard_reader_matches_disk_reader(tmp_path):
    c = _cluster(tmp_path)
    step_dir = _commit(c, 1)
    rdir = step_dir / "rank00000"
    index = ckpt_io.read_rank_index(rdir)
    data = (rdir / ckpt_io.BIN_NAME).read_bytes()
    mem = ckpt_io.MemoryShardReader(index, data)
    with ckpt_io.RankShardReader(rdir) as disk:
        for key in index["entries"]:
            np.testing.assert_array_equal(np.asarray(mem.read(key)),
                                          np.asarray(disk.read(key)))
            assert mem.entry(key) == index["entries"][key]
    mem.close()
    c.writer.close()


def test_writer_on_commit_runs_after_publish_and_swallows_errors(tmp_path):
    c = _cluster(tmp_path)
    seen = []

    def hook(step_dir):
        # called on the finalize thread once the image is committed
        seen.append((step_dir.name, (step_dir / "COMMIT").exists(),
                     step_dir.with_name(step_dir.name + ".tmp").exists()))
        raise RuntimeError("tier bookkeeping must not fail the commit")

    c.writer.on_commit = hook
    req = c.checkpoint(4, _arrays(), None)
    req.wait()
    c.writer.wait_idle()
    assert req.error is None
    assert seen == [("step_00000004", True, False)]
    assert c.writer.latest().name == "step_00000004"
    c.writer.close()


# ---------------------------------------------------------------------------
# replication + image assembly
# ---------------------------------------------------------------------------

def test_replicate_stores_primary_and_partner_copies(tmp_path):
    c = _cluster(tmp_path, world=2)
    step_dir = _commit(c, 1)
    tier = ReplicaTier()
    tier.replicate(c, step_dir)
    # each rank holds its own container plus its ring predecessor's
    assert set(tier.stores[0]) == {(1, 0), (1, 1)}
    assert set(tier.stores[1]) == {(1, 1), (1, 0)}
    assert tier.newest_step == 1
    assert tier.stats["replicated_steps"] == 1
    assert tier.stats["pushed_bytes"] > 0
    # the replica crossed the interposed p2p plane as real payload bytes
    primary = tier.stores[0][(1, 0)]
    replica = tier.stores[1][(1, 0)]
    assert primary is not replica
    assert replica.sha == container_sha(replica.data)
    c.writer.close()


def test_image_serves_newest_step_from_survivors(tmp_path):
    c = _cluster(tmp_path, world=2)
    step_dir = _commit(c, 1)
    tier = ReplicaTier()
    tier.replicate(c, step_dir)
    c.halt_rank(1)                     # rank 1's memory is gone...
    img = tier.image(c)
    assert isinstance(img, TierImage)  # ...but rank 0 holds its replica
    assert img.step == 1 and img.name == "ram:step_00000001"
    assert img.manifest() == load_manifest(step_dir)
    assert img.rank_state(0) == load_rank_state(step_dir, 0)
    assert img.nbytes > 0
    c.writer.close()


def test_image_none_when_tier_empty_or_copies_lost(tmp_path):
    c = _cluster(tmp_path, world=2)
    tier = ReplicaTier()
    assert tier.image(c) is None       # nothing replicated yet
    step_dir = _commit(c, 1)
    tier.replicate(c, step_dir)
    # both holders of every copy die -> the needed containers are gone
    c.halt_rank(0)
    c.halt_rank(1)
    assert tier.image(c) is None
    c.writer.close()


def test_image_checksum_mismatch_raises(tmp_path):
    c = _cluster(tmp_path, world=2)
    tier = ReplicaTier()
    tier.replicate(c, _commit(c, 1))
    # rot every surviving copy of rank 0's container in place
    for store in tier.stores.values():
        if (1, 0) in store:
            old = store[(1, 0)]
            bad = bytearray(old.data)
            bad[len(bad) // 2] ^= 0xFF
            store[(1, 0)] = Container(old.step, old.rank, old.index,
                                      bytes(bad), old.state, old.sha)
    with pytest.raises(TierVerifyError, match="rank 0"):
        tier.image(c)
    c.writer.close()


def test_delta_chain_retention_and_reset(tmp_path):
    c = _cluster(tmp_path, world=2)
    tier = ReplicaTier()
    a1 = _arrays()
    tier.replicate(c, _commit(c, 1, a1))
    a2 = {"w": a1["w"] + 1, "m": a1["m"]}      # m stays clean -> delta
    d2 = _commit(c, 2, a2)
    tier.replicate(c, d2)
    m2 = json.loads((d2 / "manifest.json").read_text())
    assert m2.get("base_steps") == [1]
    # delta image: base-step containers survive retention, and the
    # assembled image reads across the chain
    assert set(tier.manifests) == {1, 2}
    assert any(k[0] == 1 for k in tier.stores[0])
    img = tier.image(c)
    assert img is not None and img.step == 2
    got = load_arrays(img, {"w": None, "m": None}, parallel=False)
    np.testing.assert_array_equal(got["m"], a2["m"].numpy())
    np.testing.assert_array_equal(got["w"], a2["w"].numpy())
    tier.replicate(c, _commit(c, 3, {"w": a2["w"] + 1, "m": a2["m"] + 1}))
    tier.reset()
    assert tier.image(c) is None and tier.stores == {} and \
        tier.newest_step is None
    c.writer.close()


def test_note_commit_attached_vs_detached(tmp_path):
    c = _cluster(tmp_path, world=2)
    tier = ReplicaTier()
    d1 = _commit(c, 1)
    tier.note_commit(d1)               # detached: queued, not replicated
    assert tier.newest_step is None
    assert tier.drain_commits(c) == 1
    assert tier.newest_step == 1
    tier.attach(c)
    tier.note_commit(_commit(c, 2))    # attached: replicates inline
    assert tier.newest_step == 2
    assert tier.drain_commits(c) == 0  # nothing left queued
    # hooked onto the writer, a commit replicates before wait_idle returns
    c.writer.on_commit = tier.note_commit
    _commit(c, 3, _arrays(5))
    assert tier.newest_step == 3
    c.writer.close()


# ---------------------------------------------------------------------------
# checkpoint-source protocol
# ---------------------------------------------------------------------------

def test_as_source_coerces_paths_and_passes_sources(tmp_path):
    c = _cluster(tmp_path)
    step_dir = _commit(c, 1)
    src = as_source(step_dir)
    assert isinstance(src, DirCheckpointSource)
    assert src.name == step_dir.name
    assert as_source(src) is src               # idempotent
    tier = ReplicaTier()
    tier.replicate(c, step_dir)
    img = tier.image(c)
    assert as_source(img) is img               # TierImage speaks the protocol
    c.writer.close()


def test_repair_repushes_single_copies_after_partner_death(tmp_path):
    """Ring re-pairing after a world shrink: a survivor whose ring partner
    died holds the ONLY copy of some containers — repair must re-push each
    to the holder's next alive ring partner, restoring 2x redundancy."""
    c = _cluster(tmp_path, world=4)
    tier = ReplicaTier()
    tier.replicate(c, _commit(c, 1))
    c.halt_rank(1)                     # its copies of (1,0) and (1,1) die
    stats = tier.repair(c)
    assert stats["single_copy"] == 2 and stats["repushed"] == 2
    alive = c.survivors()
    for r in range(4):
        holders = [h for h in alive if (1, r) in tier.stores.get(h, {})]
        assert len(holders) >= 2, f"rank {r} container not redundant"
    for h in alive:
        for cont in tier.stores[h].values():
            assert cont.sha == container_sha(cont.data)
    # the repair holds up under the SECOND death
    c.halt_rank(0)
    img = tier.image(c)
    assert img is not None and img.step == 1
    c.writer.close()


def test_attach_after_death_repairs_inline(tmp_path):
    c = _cluster(tmp_path, world=4)
    tier = ReplicaTier()
    tier.replicate(c, _commit(c, 1))
    c.halt_rank(3)
    tier.attach(c)
    alive = c.survivors()
    for r in range(4):
        holders = [h for h in alive if (1, r) in tier.stores.get(h, {})]
        assert len(holders) >= 2, f"rank {r} container not redundant"
    c.writer.close()


def test_repair_noop_when_already_redundant(tmp_path):
    c = _cluster(tmp_path, world=2)
    tier = ReplicaTier()
    tier.replicate(c, _commit(c, 1))
    assert tier.repair(c) == {"repushed": 0, "single_copy": 0}
    c.halt_rank(1)                     # one survivor: nobody to push to
    assert tier.repair(c)["repushed"] == 0
    c.writer.close()


def test_load_arrays_from_ram_image_matches_disk(tmp_path):
    c = _cluster(tmp_path, world=2)
    arrays = _arrays(7)
    step_dir = _commit(c, 1, arrays)
    tier = ReplicaTier()
    tier.replicate(c, step_dir)
    img = tier.image(c)
    sh = {"w": None, "m": None}
    from_disk = load_arrays(step_dir, sh, parallel=False)
    from_ram = load_arrays(img, sh, parallel=False)
    for k in arrays:
        np.testing.assert_array_equal(from_disk[k], from_ram[k])
        np.testing.assert_array_equal(from_ram[k], arrays[k].numpy())
    c.writer.close()


# ---------------------------------------------------------------------------
# the RAM-tier fault kinds fire on the port's cluster
# ---------------------------------------------------------------------------

def test_partner_death_and_corrupt_replica_fire(tmp_path):
    c = _cluster(tmp_path, world=4)
    tier = ReplicaTier()
    tier.attach(c)
    c.writer.on_commit = tier.note_commit
    _commit(c, 1)
    with FaultInjector(FaultPlan([FaultSpec("corrupt_replica", at_step=1, rank=0),
                                  FaultSpec("partner_death", at_step=2, rank=1)])) as inj:
        inj.tier = tier
        inj.on_step(1, c)
        with pytest.raises(TierVerifyError, match="rank 0"):
            tier.image(c)
        inj.on_step(2, c)
    # the victim and its ring partner died together
    assert c.survivors() == [0, 3]
    assert [s.kind for _, s in inj.fired] == ["corrupt_replica", "partner_death"]
    c.writer.close()


# ---------------------------------------------------------------------------
# the same committed image in both packages' tiers
# ---------------------------------------------------------------------------

def _bf16(a):
    return torch.from_numpy(a.astype(ml_dtypes.bfloat16).view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_tier_containers_equal_the_jax_tiers(tmp_path, dtype, codec):
    h = _host(11)
    if dtype == "bfloat16":
        jax_tree = {k: jnp.asarray(v.astype(ml_dtypes.bfloat16)) for k, v in h.items()}
        port_tree = {k: _bf16(v) for k, v in h.items()}
    else:
        jax_tree = {k: jnp.asarray(v) for k, v in h.items()}
        port_tree = {k: torch.from_numpy(v) for k, v in h.items()}
    jc = JaxCluster(2, "mpich", ckpt_dir=tmp_path / "jax", ckpt_io=JaxIO(codec=codec))
    tc = Cluster(2, "mpich", ckpt_dir=tmp_path / "port", ckpt_io=CkptIOConfig(codec=codec))
    jt, tt = JaxTier(), ReplicaTier()
    for cl, tier, tree in ((jc, jt, jax_tree), (tc, tt, port_tree)):
        tier.attach(cl)
        cl.writer.on_commit = tier.note_commit
        cl.checkpoint(5, tree, None).wait()
        cl.writer.wait_idle()
        assert tier.newest_step == 5
    for holder in (0, 1):
        assert jt.stores[holder].keys() == tt.stores[holder].keys() == {(5, 0), (5, 1)}
        for key in jt.stores[holder]:
            j, t = jt.stores[holder][key], tt.stores[holder][key]
            assert t.data == j.data and t.sha == j.sha == container_sha(t.data)
            assert t.index == j.index
            assert t.state == j.state
    entries = tt.stores[0][(5, 0)].index["entries"]
    assert {e["dtype"] for e in entries.values()} == {dtype}
    # each package's RAM image reads back the same bits
    got = load_arrays(tt.image(tc), {"w": None, "m": None}, parallel=False)
    for k in h:
        want = h[k].astype(ml_dtypes.bfloat16).view(np.uint16) \
            if dtype == "bfloat16" else h[k]
        np.testing.assert_array_equal(np.asarray(got[k]).view(want.dtype), want)
    jc.writer.close()
    tc.writer.close()
