"""The port's checkpoint container against the JAX package's.

The same arrays, made with numpy from a seed, go through both packages'
``Cluster.checkpoint``: float32 and bfloat16 leaves (the port's as
``torch.bfloat16``, the JAX package's as ``ml_dtypes.bfloat16``), a 0-d
leaf and a ``"runtime"`` subtree. Under the lossless codecs every entry,
digest and shard file must be equal byte for byte; under the lossy ``int8``
codec the entries must be equal. Each package's ``load_arrays`` reads the
other's directory bit for bit. Also: the numpy threefry split against
``jax.random.split``, the pipelined snapshot's copy inside the blocking
window, and the generated fast path's imports after a legacy-vid free.
"""
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import CkptIOConfig as JaxIO  # noqa: E402
from repro.core import Cluster as JaxCluster  # noqa: E402
from repro.core.restore import load_arrays as jax_load  # noqa: E402
from repro_torch.configs import CkptIOConfig  # noqa: E402
from repro_torch.core import Cluster, ckpt_io  # noqa: E402
from repro_torch.core import runtime_state as RS  # noqa: E402
from repro_torch.core.restore import load_arrays  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
STEP = 7


def _host(seed):
    """numpy leaves: float32 (one with a wide range), bfloat16 as float32
    values rounded by ml_dtypes, a 0-d float32, int32 positions and a
    threefry key."""
    r = np.random.default_rng(seed)
    bf = lambda *s: r.normal(size=s).astype(np.float32).astype(ml_dtypes.bfloat16)
    return {"params": {"w": r.normal(size=(16, 24)).astype(np.float32),
                       "b": bf(40, 9), "scale": np.float32(r.normal()),
                       "big": (r.normal(size=(3, 300)) * 1e6).astype(np.float32)},
            "runtime": {"kv_caches": [{"attn": {"k": bf(2, 2, 12, 8),
                                                "v": bf(2, 2, 12, 8)}}],
                        "pos": np.arange(5, dtype=np.int32),
                        "rng": np.array([0, 13], np.uint32)}}


def _jax_tree(h):
    return jax.tree.map(jnp.asarray, h)


def _torch_leaf(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _torch_tree(h):
    out = jax.tree.map(_torch_leaf, h)
    out["runtime"]["rng"] = h["runtime"]["rng"]          # a host array stays one
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype in (ml_dtypes.bfloat16, ckpt_io.BFLOAT16) \
        else a


def _write_both(tmp_path, codec, seed=0):
    h = _host(seed)
    jc = JaxCluster(2, "mpich", ckpt_dir=tmp_path / "jax", ckpt_io=JaxIO(codec=codec))
    jc.checkpoint(STEP, _jax_tree(h), None).wait()
    tc = Cluster(2, "mpich", ckpt_dir=tmp_path / "port", ckpt_io=CkptIOConfig(codec=codec))
    tc.checkpoint(STEP, _torch_tree(h), None).wait()
    jc.writer.close()
    tc.writer.close()
    return h, jc.writer.latest(), tc.writer.latest()


def _index(step):
    return json.loads((step / "rank00000" / ckpt_io.INDEX_NAME).read_text())


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_same_arrays_same_bytes(tmp_path, codec):
    _, js, ts = _write_both(tmp_path, codec)
    ji, ti = _index(js), _index(ts)
    assert ji == ti
    entries = ti["entries"]
    assert {e["dtype"] for e in entries.values()} == {"float32", "bfloat16", "int32", "uint32"}
    assert [e["shape"] for e in entries.values() if e["dtype"] == "float32"].count([]) == 1
    assert sum(e.get("kind") == "runtime" for e in entries.values()) == 4
    assert filecmp.cmp(js / "rank00000" / ckpt_io.BIN_NAME,
                       ts / "rank00000" / ckpt_io.BIN_NAME, shallow=False)
    jm, tm = (json.loads((s / "manifest.json").read_text()) for s in (js, ts))
    assert jm["leaves"] == tm["leaves"]
    assert {k: jm[k] for k in jm if k not in ("per_rank_write_s", "straggler_rank")} \
        == {k: tm[k] for k in tm if k not in ("per_rank_write_s", "straggler_rank")}


def test_int8_codec_writes_equal_entries(tmp_path):
    _, js, ts = _write_both(tmp_path, "int8", seed=1)
    ji, ti = _index(js), _index(ts)
    assert ji == ti
    assert any(e["enc_dtype"] == "int8" and e["dtype"] == "bfloat16"
               for e in ti["entries"].values())
    # the lossy round trip decodes to the same bits in both packages
    tree = jax.tree.map(lambda _: None, _host(1))
    got, want = load_arrays(ts, tree), jax_load(js, tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("codec", ["none", "zlib", "int8"])
def test_digests_of_both_packages_agree(tmp_path, codec):
    from repro.core import ckpt_io as jax_io
    h = _host(2)
    for a in jax.tree.leaves(h):
        port = ckpt_io.shard_digest(_bits(a).view(ckpt_io.BFLOAT16)
                                    if a.dtype == ml_dtypes.bfloat16 else a)
        assert port == jax_io.shard_digest(a)
    # incremental checkpoints record the digests in the index
    jc = JaxCluster(1, "fabric", ckpt_dir=tmp_path / "j",
                    ckpt_io=JaxIO(codec=codec, incremental=True))
    tc = Cluster(1, "fabric", ckpt_dir=tmp_path / "t",
                 ckpt_io=CkptIOConfig(codec=codec, incremental=True))
    jc.checkpoint(1, _jax_tree(h), None).wait()
    tc.checkpoint(1, _torch_tree(h), None).wait()
    ji, ti = _index(jc.writer.latest()), _index(tc.writer.latest())
    assert ji == ti and all(e["digest"] for e in ti["entries"].values())


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_each_package_restores_the_others_bit_for_bit(tmp_path, codec):
    h, js, ts = _write_both(tmp_path, codec, seed=3)
    want = jax.tree.leaves(h)
    null = jax.tree.map(lambda _: None, h)
    port_reads_jax = load_arrays(js, null)
    jax_reads_port = jax_load(ts, null)
    for a, b, c in zip(jax.tree.leaves(port_reads_jax), jax.tree.leaves(jax_reads_port), want):
        np.testing.assert_array_equal(_bits(a), _bits(c))
        np.testing.assert_array_equal(_bits(b), _bits(c))
        assert np.shape(a) == np.shape(b) == np.shape(c)
    # placed on a device: tensors of the logical dtype (bf16 through its bits)
    on_cpu = load_arrays(js, jax.tree.map(lambda _: torch.device("cpu"), h))
    k = on_cpu["runtime"]["kv_caches"][0]["attn"]["k"]
    assert k.dtype == torch.bfloat16 and k.device.type == "cpu"
    np.testing.assert_array_equal(k.view(torch.int16).numpy().view(np.uint16),
                                  _bits(h["runtime"]["kv_caches"][0]["attn"]["k"]))
    assert on_cpu["params"]["scale"].shape == ()


def test_bf16_round_to_nearest_even_matches_ml_dtypes():
    r = np.random.default_rng(4)
    x = np.concatenate([r.normal(size=4000).astype(np.float32) * 10.0 ** r.integers(-40, 38, 4000),
                        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0 + 2 ** -8,
                                  1.0 + 3 * 2 ** -8, 3.4e38, -1e-45], np.float32)])
    x = x.astype(np.float32)
    got = ckpt_io.f32_to_bf16_bits(x)
    assert ckpt_io.dtype_name(got.dtype) == "bfloat16"
    np.testing.assert_array_equal(got.view(np.uint16),
                                  x.astype(ml_dtypes.bfloat16).view(np.uint16))
    back = ckpt_io.bf16_bits_to_f32(got)
    np.testing.assert_array_equal(back, x.astype(ml_dtypes.bfloat16).astype(np.float32))
    # the dtype cache never confuses the tagged bits with plain uint16
    assert ckpt_io.dtype_name(np.dtype(np.uint16)) == "uint16"
    assert ckpt_io.dtype_name(ckpt_io.BFLOAT16) == "bfloat16"
    assert ckpt_io.resolve_dtype("bfloat16") is ckpt_io.BFLOAT16


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5])
@pytest.mark.parametrize("num", [2, 3])
def test_threefry_split_matches_jax(seed, num):
    key = jax.random.key(seed)
    raw = RS.threefry_key(seed)
    np.testing.assert_array_equal(raw, np.asarray(jax.random.key_data(key)))
    for _ in range(3):
        want = np.asarray(jax.random.key_data(jax.random.split(key, num)))
        np.testing.assert_array_equal(RS.threefry_split(raw, num), want)
        key, raw = jax.random.split(key)[0], RS.threefry_split(raw)[0]
    assert str(jax.random.key_impl(key)) == RS.THREEFRY


def test_snapshot_copies_inside_the_blocking_window(tmp_path):
    """The decode writes the caches in place: a write right after
    ``checkpoint()`` returns must not reach the snapshot."""
    x = torch.arange(4096, dtype=torch.float32).view(64, 64)
    before = x.clone()
    c = Cluster(1, "mpich", ckpt_dir=tmp_path / "ck")
    req = c.checkpoint(1, {"runtime": {"kv": x}}, None)
    x.fill_(-1.0)
    req.wait()
    got = load_arrays(c.writer.latest(), {"runtime": {"kv": None}})["runtime"]["kv"]
    np.testing.assert_array_equal(got, before.numpy())
    assert req.timings["blocking_ms"] >= req.timings["snapshot_ms"] >= 0
    c.writer.close()


def test_pipeline_arena_is_reused_and_locked(tmp_path):
    from repro_torch.core import ckpt_pipeline as CP
    c = Cluster(1, "mpich", ckpt_dir=tmp_path / "ck",
                ckpt_io=CkptIOConfig(snapshot_batch_mb=0.0625))
    arrays = {"a": torch.randn(300, 100), "b": [torch.randn(200, 64), np.float32(2.0)]}
    c.checkpoint(1, arrays, None).wait()
    arenas = c.writer.arenas
    grown = [a._buf.numel() for a in arenas]
    assert max(grown) >= 300 * 100 * 4 and all(a.try_acquire() for a in arenas)
    for a in arenas:
        a.release()
    c.checkpoint(2, arrays, None).wait()
    assert [a._buf.numel() for a in arenas] == grown        # reused, not regrown
    # both arenas held by writers: the snapshot spills instead of stalling
    for a in arenas:
        assert a.try_acquire()
    pool = c.writer._get_pool()
    res = CP.SnapshotPipeline(pool, arenas=arenas).run(
        CP.plan_snapshot(arrays)[1], lambda *a: None)
    res["release"]()
    [f.result() for f in res["futures"]]
    assert res["counters"]["spills"] == 1
    for a in arenas:
        a.release()
    c.writer.close()


def test_generated_fast_path_imports_no_jax_after_a_legacy_free():
    code = (
        "import sys\n"
        "from repro_torch.core import Cluster, callspec\n"
        "c = Cluster(2, 'mpich', translation='slow')\n"
        "m = c.mana(0)\n"
        "m.enable_fastpath()\n"
        "spec = next(s for s in callspec.REGISTRY if s.name == 'comm_free')\n"
        "src = callspec.compile_fastpath(spec, m, transcripts=True).__source__\n"
        "assert 'repro_torch.core.interpose import _KIND_NAME' in src, src\n"
        "h = m.comm_create([0, 1])\n"
        "assert m._legacy_of, 'no legacy vid recorded'\n"
        "n = len(m._legacy_of)\n"
        "m.comm_free(h)\n"
        "assert len(m._legacy_of) == n - 1\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_generate_no_reference_imports():
    """Imports inside generated source strings are invisible to the AST
    walk in test_torch_imports.py: no string of the port names the JAX
    package's modules."""
    import re
    pkg = ROOT / "src" / "repro_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not re.search(r"(from|import)\s+(jax|ml_dtypes|repro)(\.|\s|$)", line), \
                f"{path}: {line.strip()}"


def test_fault_inside_the_window_fails_clean(tmp_path):
    """A raise at the ``ckpt.snapshot_batch`` failpoint fails the checkpoint
    inside its blocking window: the request carries the error, both arenas go
    back to the pair, nothing half-written is visible, and the next
    checkpoint commits and restores."""
    from repro_torch.core import faults
    c = Cluster(1, "mpich", ckpt_dir=tmp_path / "ck",
                ckpt_io=CkptIOConfig(snapshot_batch_mb=0.0625))
    arrays = {"a": torch.randn(200, 100), "b": torch.randn(300, 100)}

    def boom(name, ctx):
        if ctx["batch"] == 1:
            raise faults.InjectedFault("mid-snapshot")

    faults.arm("ckpt.snapshot_batch", boom)
    try:
        with pytest.raises(faults.InjectedFault):
            c.checkpoint(1, arrays, None)
    finally:
        faults.disarm("ckpt.snapshot_batch")
    assert all(a.try_acquire() for a in c.writer.arenas)
    for a in c.writer.arenas:
        a.release()
    assert c.writer.latest() is None
    c.writer.wait_idle()
    c.checkpoint(2, arrays, None).wait()
    got = load_arrays(c.writer.latest(), {"a": None, "b": None})
    np.testing.assert_array_equal(got["b"], arrays["b"].numpy())
    c.writer.close()


def test_restart_hands_the_arenas_to_the_fresh_writer(tmp_path):
    """The restarted cluster's writer keeps the pinned arena pair the old
    one grew (the restore stages the card's leaves through it, and the next
    snapshot reuses it), and both arenas are free afterwards."""
    c = Cluster(2, "mpich", ckpt_dir=tmp_path / "ck")
    arrays = {"a": torch.randn(64, 48), "b": [torch.randn(5), np.int32(3)]}
    c.checkpoint(1, arrays, None).wait()
    arenas = c.writer.arenas
    fresh = c.restart(c.writer.latest(), new_backend="openmpi",
                      shardings={"a": torch.device("cpu"), "b": [None, None]})
    assert fresh.writer.arenas is arenas
    assert all(a.try_acquire() for a in arenas)
    for a in arenas:
        a.release()
    torch.testing.assert_close(fresh.restored_arrays["a"], arrays["a"], rtol=0, atol=0)
    np.testing.assert_array_equal(fresh.restored_arrays["b"][0], arrays["b"][0].numpy())
    fresh.checkpoint(2, arrays, None).wait()
    fresh.writer.close()


def test_restore_reads_only_the_chunked_container(tmp_path):
    """Neither package writes another format: a manifest of any other
    format is refused, on the parallel and the sequential path."""
    c = Cluster(1, "mpich", ckpt_dir=tmp_path / "ck")
    c.checkpoint(1, {"a": torch.ones(3)}, None).wait()
    step = c.writer.latest()
    c.writer.close()
    man = json.loads((step / "manifest.json").read_text())
    man["format"] = 1
    (step / "manifest.json").write_text(json.dumps(man))
    for parallel in (True, False):
        with pytest.raises(ValueError, match="format 1"):
            load_arrays(step, {"a": None}, parallel=parallel)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_restore_onto_a_missing_card_raises(tmp_path):
    """No CPU fallback: a placement on ``cuda`` without a card raises."""
    c = Cluster(1, "mpich", ckpt_dir=tmp_path / "ck")
    c.checkpoint(1, {"a": torch.ones(3), "b": np.int32(2)}, None).wait()
    c.writer.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_arrays(c.writer.latest(), {"a": torch.device("cuda"), "b": None})
