"""The port's copy of tests/test_restore_matrix.py: cross-backend elastic
restart over the full save->restore backend-pair matrix at world=4, through
``repro_torch.core`` with torch tensors as the checkpointed arrays.

Every ordered (checkpoint_backend, restart_backend) pair is exercised
against one rich checkpoint per source flavor — split communicators, a
derived datatype over an ALIASED base (MPI_INT8_T), a custom reduction op,
an in-flight message drained into the image — asserting restored
param/optimizer equality, live handle translation through OLD handle
values, drain-log replay stats, and the capability-translation counters
the pair plan predicts."""
import itertools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import BACKENDS, Cluster, backend_family, restart_matrix  # noqa: E402
from repro_torch.core.restore import (find_resumable, load_arrays,  # noqa: E402
                                      load_rank_state, translation_plan)
from repro_torch.models.params import tree_map  # noqa: E402

torch.set_num_threads(1)

# the full ordered-pair sweep at world=4 is the heavyweight tier-1 tail;
# CI runs it in the dedicated slow step
pytestmark = pytest.mark.slow

WORLD = 4
PAIRS = sorted(itertools.product(BACKENDS, BACKENDS))


def _split_all(cluster, color_fn):
    out = [None] * cluster.world_size

    def run(r):
        m = cluster.mana(r)
        out[r] = m.comm_split(m.comm_world(), color_fn(r), r)

    ts = [threading.Thread(target=run, args=(r,))
          for r in range(cluster.world_size)]
    [t.start() for t in ts]
    [t.join(timeout=30) for t in ts]
    assert all(h is not None for h in out)
    return out


def _coll(cluster, fn, ranks=None):
    """Drive a collective wrapper on each selected rank's own thread."""
    ranks = list(range(cluster.world_size)) if ranks is None else ranks
    out, errs = {}, []

    def run(r):
        try:
            out[r] = fn(cluster.mana(r))
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=run, args=(r,)) for r in ranks]
    [t.start() for t in ts]
    [t.join(timeout=30) for t in ts]
    if errs:
        raise errs[0]
    return [out[r] for r in ranks]


class _SrcCkpt:
    """One source flavor's checkpoint plus the OLD handle values the
    restarted side must keep honoring."""

    def __init__(self, base_dir, src: str):
        rng = np.random.default_rng(7)
        self.arrays = {
            "params": torch.from_numpy(rng.normal(size=(32, 16))
                                       .astype(np.float32)),
            "opt": {"m": torch.from_numpy(rng.normal(size=(32, 16))
                                          .astype(np.float32)),
                    "count": torch.tensor(13, dtype=torch.int32)},
        }
        self.shardings = tree_map(lambda _: None, self.arrays)
        self.cluster = Cluster(WORLD, src, ckpt_dir=base_dir / f"ck_{src}")
        self.subs = _split_all(self.cluster, lambda r: r % 2)
        m0 = self.cluster.mana(0)
        self.vec = m0.type_vector(3, 2, 8, m0.dtype_handles["MPI_INT8_T"])
        self.op = m0.op_create("logsumexp", commutative=False)
        self.cluster.mana(3).isend(0, tag=21, payload={"src": src})
        # collective-using workload: a completed world allreduce (native or
        # derived per flavor) plus a scatter left IN FLIGHT — root entered,
        # peers not yet — whose fan-out the quiesce must drain into the
        # image (scatter is root->each-member under every flavor, so the
        # drained pattern completes under any restart flavor of the matrix)
        self.allred = _coll(self.cluster,
                            lambda m: m.allreduce(m.comm_world(), m.rank + 1,
                                                  m.op_handles["MPI_SUM"]))
        assert self.allred == [10] * WORLD
        m2 = self.cluster.mana(2)
        m2.scatter(m2.comm_world(),
                   [{"src": src, "chunk": q} for q in range(WORLD)], root=2)
        self.cluster.checkpoint(5, self.arrays, None).wait()
        self.ck = self.cluster.writer.latest()


@pytest.fixture(scope="module")
def src_ckpts(tmp_path_factory):
    base = tmp_path_factory.mktemp("matrix")
    return {src: _SrcCkpt(base, src) for src in BACKENDS}


@pytest.mark.parametrize("src,dst", PAIRS)
def test_backend_pair_restart(src_ckpts, src, dst):
    sc = src_ckpts[src]
    fresh = sc.cluster.restart(sc.ck, new_backend=dst,
                               shardings=sc.shardings)
    # -- param/optimizer equality through the overlapped restore ----------
    got = fresh.restored_arrays
    np.testing.assert_array_equal(np.asarray(got["params"]),
                                  np.asarray(sc.arrays["params"]))
    np.testing.assert_array_equal(np.asarray(got["opt"]["m"]),
                                  np.asarray(sc.arrays["opt"]["m"]))
    assert int(got["opt"]["count"]) == 13
    # -- old handle values stay live under the new flavor ------------------
    f0 = fresh.mana(0)
    assert f0.comm_size(sc.subs[0]) == WORLD // 2
    env = f0.type_envelope(sc.vec)
    assert env["combiner"] == "vector" and env["stride"] == 8
    base_name = env["base"]["name"]
    # envelope re-encode: the aliased base landed on dst's canonical name
    # (the SOURCE may itself have canonicalized at creation time — exampi
    # resolves MPI_INT8_T to the shared MPI_CHAR pointer before logging)
    plan = translation_plan(src, dst, f0.backend)
    src_canonical = translation_plan(src, src).dtype_aliases["MPI_INT8_T"]
    assert base_name == plan.dtype_aliases.get(src_canonical, src_canonical)
    # -- drained in-flight message redelivered exactly once ----------------
    assert f0.recv(3, 21) == {"src": src}
    # nothing left, buffered or on the fabric (iprobe: non-blocking)
    assert f0.iprobe(3, 21) is None
    # -- the in-flight scatter completes from the drained image ------------
    for r in (0, 1, 3):
        m = fresh.mana(r)
        assert m.scatter(m.comm_world(), None, root=2) \
            == {"src": src, "chunk": r}, f"{src}->{dst}: scatter replay"
    # -- fresh collectives run under the NEW flavor over restored handles --
    got = _coll(fresh, lambda m: m.allreduce(m.comm_world(), m.rank * 2,
                                             m.op_handles["MPI_SUM"]))
    assert got == [12] * WORLD
    # ... including on a restored SPLIT communicator ({0, 2})
    sub_sum = _coll(fresh, lambda m: m.allreduce(sc.subs[0], m.rank + 1,
                                                 m.op_handles["MPI_SUM"]),
                    ranks=[0, 2])
    assert sub_sum == [4, 4]
    # -- drain-log replay stats rode the checkpoint image ------------------
    rs = load_rank_state(sc.ck, 0)
    assert rs["drain"]["messages_buffered"] >= 1 \
        or load_rank_state(sc.ck, 3)["drain"]["requests_completed"] >= 1
    # -- rebind counters match what the pair plan predicts -----------------
    st = fresh.rebind_stats[0]
    assert st["pair"] == f"{src}->{dst}"
    assert st["lazy"] >= 3          # world comm + named dtypes + ops
    if plan.replay_comm_split:
        assert st["replayed"] >= 2  # the split comm AND the custom op
    else:
        assert st["serialized"] >= 1
        assert st["replayed"] >= 1  # ops always replay
    # -- restart timings mirror checkpoint's phase breakdown ---------------
    for key in ("manifest_ms", "lower_half_ms", "rebind_ms", "arrays_ms",
                "total_ms"):
        assert key in fresh.restart_timings


def test_matrix_shape_and_families():
    m = restart_matrix()
    assert len(m) == len(BACKENDS) ** 2
    for (s, d), plan in m.items():
        assert plan.same_family == (backend_family(s) == backend_family(d))
    # the MPICH family replays across its members; nobody else cross-replays
    assert m[("craympi", "mpich")].replay_comm_split
    assert m[("mpich", "craympi")].replay_comm_split
    assert not m[("mpich", "openmpi")].replay_comm_split
    assert not m[("openmpi", "exampi")].replay_comm_split
    # exampi restarts re-encode aliased dtype envelopes; others don't
    assert m[("mpich", "exampi")].reencode_envelopes
    assert not m[("exampi", "mpich")].reencode_envelopes


def test_parallel_rebind_matches_sequential(src_ckpts):
    sc = src_ckpts["craympi"]
    par = sc.cluster.restart(sc.ck, new_backend="openmpi",
                             shardings=sc.shardings, parallel=True)
    seq = sc.cluster.restart(sc.ck, new_backend="openmpi",
                             shardings=sc.shardings, parallel=False)
    np.testing.assert_array_equal(np.asarray(par.restored_arrays["params"]),
                                  np.asarray(seq.restored_arrays["params"]))
    for a, b in zip(par.rebind_stats, seq.rebind_stats):
        assert {k: a[k] for k in ("replayed", "serialized", "lazy")} \
            == {k: b[k] for k in ("replayed", "serialized", "lazy")}
    assert par.mana(0).comm_size(sc.subs[0]) \
        == seq.mana(0).comm_size(sc.subs[0])


@pytest.mark.parametrize("new_world", [2, 6])
def test_elastic_world_resize_across_backends(src_ckpts, new_world):
    sc = src_ckpts["mpich"]
    fresh = sc.cluster.restart(sc.ck, new_backend="fabric",
                               new_world_size=new_world,
                               shardings=sc.shardings)
    assert fresh.world_size == new_world
    assert len(fresh.rebind_stats) == new_world
    np.testing.assert_array_equal(np.asarray(fresh.restored_arrays["params"]),
                                  np.asarray(sc.arrays["params"]))
    # rank images wrap around: every new rank has a live vid table
    for r in range(new_world):
        assert fresh.mana(r).vids.live_count() > 0


def test_find_resumable_skips_orphaned_delta_chain(tmp_path):
    import shutil

    from repro_torch.core.ckpt import CheckpointWriter

    # keep=5: GC retains everything here AND deltas stay deltas (a full
    # checkpoint only every 5th) — keep=0 would force every step full
    w = CheckpointWriter(tmp_path, 2, keep=5, codec="none",
                         incremental=True)
    arrays = {"w": torch.arange(8.0)}
    try:
        w.checkpoint(1, arrays, None, {}).wait()      # full
        w.checkpoint(2, arrays, None, {}).wait()      # delta on 1
        w.checkpoint(3, arrays, None, {}).wait()      # delta on 1
    finally:
        w.close()
    assert find_resumable(tmp_path).name == "step_00000003"
    # orphan the chain: the base full checkpoint disappears behind GC's back
    shutil.rmtree(tmp_path / "step_00000001")
    res = find_resumable(tmp_path)
    # steps 2 and 3 reference step 1 -> unusable; nothing intact remains
    assert res is None
    # a later FULL checkpoint becomes resumable again
    w2 = CheckpointWriter(tmp_path, 2, keep=5, codec="none",
                          incremental=True)
    try:
        w2.checkpoint(4, arrays, None, {}).wait()
    finally:
        w2.close()
    assert find_resumable(tmp_path).name == "step_00000004"
    out = load_arrays(tmp_path / "step_00000004", {"w": None})
    np.testing.assert_array_equal(out["w"], np.arange(8.0))


def test_nested_split_replay_keeps_parent_dependency(tmp_path):
    """A replayed split must bind AFTER its parent regardless of ggid hash
    order (vids are CRC32 of member ranks — a child can hash below its
    parent, which a single-pass planner would mis-order)."""
    from repro_torch.core import Fabric, Mana
    from repro_torch.core.descriptors import Kind
    from repro_torch.core.restore import _plan_rebind, rebind_objects
    from repro_torch.core import ckpt_io

    c = Cluster(WORLD, "mpich", ckpt_dir=tmp_path / "ck")
    subs = _split_all(c, lambda r: r % 2)      # world -> {0,2} / {1,3}
    # split the SUBCOMM again: a replayable split whose parent is itself
    # a replayed descriptor
    nested = [None] * WORLD

    def run(r):
        m = c.mana(r)
        nested[r] = m.comm_split(subs[r], color=0, key=r)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(WORLD)]
    [t.start() for t in ts]
    [t.join(timeout=30) for t in ts]
    snap = c.mana(0).snapshot()

    # the plan must carry a dep edge for EVERY replayed child whose parent
    # is rebuilt in this pass, independent of hash order
    shell = Mana("craympi", Fabric(WORLD), 0, WORLD)
    rp = _plan_rebind(shell, snap)
    replayed_children = [
        vid for vid, mode in rp.modes.items()
        if mode == "replay" and rp.by_vid[vid].kind == Kind.COMM
        and rp.by_vid[vid].meta.get("parent") in rp.modes
        and rp.modes[rp.by_vid[vid].meta.get("parent")] != "lazy"]
    assert replayed_children, "scenario must produce a dependent split"
    for vid in replayed_children:
        assert vid in rp.deps, f"missing parent dep for {vid:#x}"

    # end-to-end under the PARALLEL engine: nested membership survives
    pool = ckpt_io.IOPool(4)
    try:
        m2 = Mana("craympi", Fabric(WORLD), 0, WORLD)
        rebind_objects(m2, c.mana(0).snapshot(), pool=pool)
    finally:
        pool.close()
    assert m2.comm_size(nested[0]) == 2
    assert sorted(m2._desc(nested[0]).meta["ranks"]) == [0, 2]
    phys = m2._phys(nested[0])
    assert sorted(m2.backend.comm_ranks(phys)) == [0, 2]


def test_mana_restore_single_rank_api(src_ckpts):
    """Mana.restore stays the supported single-rank entry point (used
    outside Cluster.restart), with and without a pool."""
    from repro_torch.core import Fabric, Mana
    from repro_torch.core import ckpt_io

    sc = src_ckpts["openmpi"]
    snap = load_rank_state(sc.ck, 0)["mana"]
    fabric = Fabric(WORLD)
    seq = Mana.restore(dict(snap), fabric, 0, WORLD, backend_name="mpich")
    assert seq.comm_size(sc.subs[0]) == WORLD // 2
    pool = ckpt_io.IOPool(2)
    try:
        snap2 = load_rank_state(sc.ck, 0)["mana"]
        par = Mana.restore(snap2, Fabric(WORLD), 0, WORLD,
                           backend_name="exampi", pool=pool)
    finally:
        pool.close()
    assert par.comm_size(sc.subs[0]) == WORLD // 2
    assert par.type_envelope(sc.vec)["combiner"] == "vector"


def test_resumable_writer_accessor(tmp_path):
    from repro_torch.core.ckpt import CheckpointWriter

    w = CheckpointWriter(tmp_path, 2)
    try:
        assert w.resumable() is None
        w.checkpoint(9, {"x": torch.zeros(3)}, None, {}).wait()
        assert w.resumable() == w.latest()
    finally:
        w.close()


# ---------------------------------------------------------------------------
# chaos fallback: torn/corrupted newest checkpoint, restore on every family
# ---------------------------------------------------------------------------

def test_corrupt_and_torn_ckpts_fall_back_on_all_families(tmp_path):
    """Corrupt one shard of the newest committed checkpoint AND leave a
    kill-mid-append half-written step behind it: digest-verified resumable
    selection must land on the last complete, digest-valid checkpoint, and
    that checkpoint must restore under EVERY backend family."""
    from repro_torch.configs import CkptIOConfig
    from repro_torch.core import ckpt_io, faults
    from repro_torch.core.restore import verify_checkpoint

    rng = np.random.default_rng(11)
    arrays1 = {"w": torch.from_numpy(rng.normal(size=(48, 8)).astype(np.float32))}
    arrays2 = {"w": torch.from_numpy(rng.normal(size=(48, 8)).astype(np.float32))}
    base = tmp_path / "ck"
    c = Cluster(2, "mpich", ckpt_dir=base,
                ckpt_io=CkptIOConfig(codec="zlib", incremental=True))
    c.checkpoint(1, arrays1, None).wait()
    good = c.writer.latest()
    c.checkpoint(2, arrays2, None).wait()

    # corrupt one shard of the newest COMMITTED image
    newest = c.writer.latest()
    assert newest != good
    binf = newest / "rank00000" / ckpt_io.BIN_NAME
    data = bytearray(binf.read_bytes())
    data[len(data) // 2] ^= 0x5A
    binf.write_bytes(bytes(data))
    assert verify_checkpoint(newest), "corruption escaped verification"

    # and a kill-mid-append on top: step 3 dies half-written (uncommitted)
    def die(name, ctx):
        raise faults.InjectedFault("kill mid-append")

    faults.arm("ckpt_io.append", die)
    try:
        with pytest.raises(Exception):
            c.checkpoint(3, arrays1, None).wait()
    finally:
        faults.disarm("ckpt_io.append")

    assert find_resumable(base) == good
    # the surviving checkpoint restores under every implementation family
    families = {}
    for name in BACKENDS:
        families.setdefault(backend_family(name), name)
    for fam, dst in sorted(families.items()):
        fresh = c.restart(good, new_backend=dst,
                          shardings={"w": None})
        got = np.asarray(fresh.restored_arrays["w"])
        np.testing.assert_array_equal(got, np.asarray(arrays1["w"]),
                                      err_msg=f"family {fam} ({dst})")
        assert fresh.backend_name == dst
        fresh.writer.close()
    c.writer.close()
