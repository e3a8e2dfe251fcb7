"""The port's device-resident PagePool and its scheduler copy against the JAX
package's: the same scripted operations on both give the same page tables,
free lists, victims and exported bytes, exactly (float32 rows made with
numpy from a seed). Also the host payload format: bfloat16 travels as its
uint16 bits with the dtype recorded; the whole-pool snapshot keeps resident
rows as tensors on the pool's device and types host bfloat16 as the
checkpoint container does (``ckpt_io.BFLOAT16``), with no dtype table; and
the pool's device is the card unless the caller names another."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.kv_pool import PagePool as JaxPool  # noqa: E402
from repro.serving.kv_pool import PoolOOMError as JaxOOM  # noqa: E402
from repro.serving.scheduler import ContinuousBatchScheduler as JaxSched  # noqa: E402
from repro_torch.core import ckpt_io  # noqa: E402
from repro_torch.serving import scheduler as S  # noqa: E402
from repro_torch.serving.kv_pool import PagePool, PoolOOMError  # noqa: E402

torch.set_num_threads(1)
NUMEL = 6


def _rows(rng, n):
    return {k: rng.standard_normal((n, NUMEL)).astype(np.float32) for k in ("k", "v")}


def _same_state(jp, tp):
    ja, jt = jp.export_state()
    ta, tt = tp.export_state()
    assert tt == jt
    assert ta.keys() == ja.keys()
    for sid in ja:
        assert ta[sid].keys() == ja[sid].keys()
        for part in ja[sid]:
            assert ta[sid][part].keys() == ja[sid][part].keys()
            for key, want in ja[sid][part].items():
                got = ta[sid][part][key]
                # resident rows stay tensors on the pool's device; parked
                # payloads and blocks are host arrays
                if isinstance(got, torch.Tensor):
                    assert part == "tokens" and not sid.startswith("parked:")
                    assert got.device == tp.device
                    got = got.numpy()
                assert isinstance(got, np.ndarray) and got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    assert tp.free_pages == jp.free_pages and tp._free == jp._free


def _both(jp, tp, fn, *args, **kw):
    """Call ``fn`` on both pools; both must return the same or raise OOM."""
    out = []
    for pool, oom in ((jp, JaxOOM), (tp, PoolOOMError)):
        try:
            out.append(("ok", fn(pool, *args, **kw)))
        except oom as e:
            out.append(("oom", (e.needed, e.free)))
    assert out[0] == out[1], out
    return out[0]


def test_scripted_sequence_matches_jax_pool_exactly():
    rng = np.random.default_rng(0)
    jp, tp = JaxPool(10, 4), PagePool(10, 4, device="cpu")

    def write(p, sid, start, rows):
        p.write_tokens(sid, start, rows)

    def admit(p, sid, n, prio):
        return p.admit(sid, n, priority=prio).pages

    # admit + write, a zero-length admission growing onto its first page
    _both(jp, tp, admit, "a", 6, 0)
    _both(jp, tp, write, "a", 0, _rows(rng, 6))
    _both(jp, tp, admit, "z", 0, 1)
    assert tp.sessions["z"].pages == [] and tp.read_tokens("z")["k"].shape == (0, NUMEL)
    _both(jp, tp, write, "z", 0, _rows(rng, 1))
    _both(jp, tp, admit, "c", 5, 0)
    _both(jp, tp, write, "c", 0, _rows(rng, 5))
    _same_state(jp, tp)
    # growth over a page edge (a owns 2 pages = 8 rows; rows 6..9 need a third)
    _both(jp, tp, write, "a", 6, _rows(rng, 4))
    assert len(tp.sessions["a"].pages) == 3
    _same_state(jp, tp)
    # OOM, then the victim policy: lowest priority, newest arrival among ties
    assert _both(jp, tp, admit, "d", 20, 2)[0] == "oom"
    assert _both(jp, tp, lambda p: p.preempt_victim(below_priority=2))[1] == "c"
    assert _both(jp, tp, lambda p: p.preempt_victim(below_priority=0))[1] is None
    assert _both(jp, tp, lambda p: p.preempt_victim(exclude={"c"}))[1] == "a"
    # park the victim (bytes to the host, pages freed), admit a newcomer
    _both(jp, tp, lambda p: p.park("c")["table"])
    _both(jp, tp, admit, "d", 7, 2)
    _both(jp, tp, write, "d", 0, _rows(rng, 7))
    _same_state(jp, tp)
    # unpark while short of pages raises and leaves the payload parked
    _both(jp, tp, admit, "e", 12, 0)
    assert _both(jp, tp, lambda p: p.unpark("c"))[0] == "oom"
    assert "c" in tp.parked and "c" not in tp.sessions
    _both(jp, tp, lambda p: p.release("e"))
    _both(jp, tp, lambda p: p.unpark("c").seq)
    _same_state(jp, tp)
    # export / drop / import keeps the arrival seq; a JAX payload imports into
    # the port and the port's into JAX
    jpay, tpay = jp.export_session("a"), tp.export_session("a")
    assert tpay["table"] == jpay["table"]
    for key in jpay["tokens"]:
        np.testing.assert_array_equal(tpay["tokens"][key], jpay["tokens"][key])
    _both(jp, tp, lambda p: p.drop("a"))
    jp.import_session("a", tpay)
    tp.import_session("a", jpay)
    assert tp.sessions["a"].seq == jpay["table"]["seq"] == 1
    _same_state(jp, tp)
    # park_payload of a foreign payload, then a snapshot with a parked entry
    _both(jp, tp, lambda p: p.park_payload("f", jpay))
    _same_state(jp, tp)
    # truncate frees tail pages; defrag compacts and keeps every row
    _both(jp, tp, lambda p: p.truncate("a", 5))
    _both(jp, tp, lambda p: p.release("z"))
    before = {s: {k: v.clone() for k, v in tp.read_tokens(s).items()} for s in tp.sessions}
    assert _both(jp, tp, lambda p: p.defrag())[1]["moved"] > 0
    for s, rows in before.items():
        for k, v in rows.items():
            assert torch.equal(tp.read_tokens(s)[k], v)
    _same_state(jp, tp)
    # a whole-pool snapshot moves between the packages: the JAX snapshot in a
    # fresh port pool equals it in a fresh JAX pool, and the port's likewise
    for snap in (jp.export_state(), tp.export_state()):
        jp2, tp2 = JaxPool(10, 4), PagePool(10, 4, device="cpu")
        jp2.import_state(*snap)
        tp2.import_state(*snap)
        _same_state(jp2, tp2)
        assert tp2.export_state()[1]["sessions"] == tp.export_state()[1]["sessions"]


def test_write_and_read_are_batched_device_ops():
    tp = PagePool(8, 4, device="cpu")
    tp.admit("a", 0)
    rows = torch.arange(30, dtype=torch.float32).view(10, 3)
    tp.write_tokens("a", 0, {"k": rows})
    assert torch.equal(tp.read_tokens("a")["k"], rows)
    pages = tp.sessions["a"].pages
    assert torch.equal(tp.stores["k"][pages[2], 1], rows[9])
    with pytest.raises(ValueError, match="inconsistent"):
        tp.write_tokens("a", 0, {"k": rows, "v": rows[:2]})
    with pytest.raises(ValueError, match="numel"):
        tp.write_tokens("a", 0, {"k": torch.zeros(1, 4)})


def test_bfloat16_payload_travels_as_uint16_bits():
    src = PagePool(6, 4, device="cpu")
    src.admit("a", 5)
    rows = torch.randn(5, 8, generator=torch.Generator().manual_seed(1)).bfloat16()
    src.write_tokens("a", 0, {"k": rows})
    pay = src.export_session("a")
    assert pay["table"]["dtypes"] == {"k": "bfloat16"}
    assert pay["tokens"]["k"].dtype == np.uint16
    np.testing.assert_array_equal(pay["tokens"]["k"],
                                  rows.view(torch.int16).numpy().view(np.uint16))
    dst = PagePool(6, 4, device="cpu")
    dst.import_session("a", pay)
    assert dst.stores["k"].dtype == torch.bfloat16
    assert torch.equal(dst.read_tokens("a")["k"], rows)
    # parked and whole-pool snapshots keep the dtype too: a parked payload
    # as bits typed like the container's, a resident one as its tensor
    src.park("a")
    arrays, table = src.export_state()
    assert "dtypes" not in table["parked"]["a"]
    parked = arrays["parked:a"]["tokens"]["k"]
    assert ckpt_io.dtype_name(parked.dtype) == "bfloat16"
    np.testing.assert_array_equal(parked.view(np.uint16), pay["tokens"]["k"])
    dst2 = PagePool(6, 4, device="cpu")
    dst2.import_state(arrays, table)
    assert "dtypes" not in dst2.parked["a"]["table"]
    assert ckpt_io.dtype_name(dst2.parked["a"]["tokens"]["k"].dtype) == "bfloat16"
    # a parked session exports in the migration form, as a resident one does
    back = dst2.export_session("a")
    assert back["table"] == pay["table"] and back["tokens"]["k"].dtype.metadata is None
    np.testing.assert_array_equal(back["tokens"]["k"], pay["tokens"]["k"])
    dst2.unpark("a")
    assert torch.equal(dst2.read_tokens("a")["k"], rows)
    src.unpark("a")
    arrays, table = src.export_state()
    assert "dtypes" not in table
    assert arrays["a"]["tokens"]["k"].dtype == torch.bfloat16
    dst3 = PagePool(6, 4, device="cpu")
    dst3.import_state(arrays, table)
    assert torch.equal(dst3.read_tokens("a")["k"], rows)
    # host bits typed bfloat16 (as a checkpoint restores them) land as bf16
    dst4 = PagePool(6, 4, device="cpu")
    dst4.import_state({"a": {"tokens": {"k": pay["tokens"]["k"].view(ckpt_io.BFLOAT16)}}},
                      table)
    assert torch.equal(dst4.read_tokens("a")["k"], rows)
    bad = dict(pay, table=dict(pay["table"], dtypes={"k": "float8"}))
    with pytest.raises(ValueError, match="float8"):
        PagePool(6, 4, device="cpu").import_session("a", bad)


def test_float32_payload_has_no_dtype_entry():
    p = PagePool(4, 4, device="cpu")
    p.admit("a", 2)
    p.write_tokens("a", 0, {"k": np.ones((2, 3), np.float32)})
    assert "dtypes" not in p.export_session("a")["table"]
    assert "dtypes" not in p.export_state()[1]


def test_layer_view_is_a_strided_view_of_the_store():
    n_layers, K, D = 3, 2, 4
    p = PagePool(5, 2, device="cpu")
    p.admit("a", 3)
    rows = torch.randn(3, n_layers * K * D)
    p.write_tokens("a", 0, {"k": rows})
    view = p.layer_view("k", n_layers, K, D)
    assert view.data_ptr() == p.stores["k"].data_ptr()
    page = p.sessions["a"].pages[1]               # position 2 of page size 2
    assert torch.equal(view[page, 0, 1], rows[2].view(n_layers, K, D)[1])
    assert view[:, :, 1].stride() == (2 * n_layers * K * D, n_layers * K * D, D, 1)
    with pytest.raises(ValueError, match="numel"):
        p.layer_view("k", 2, K, D)


def test_pool_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagePool(4, 4)
    assert PagePool(4, 4, device="cpu").device == torch.device("cpu")


def test_scheduler_snapshot_matches_jax_scheduler():
    js, ts = JaxSched(max_running=2), S.ContinuousBatchScheduler(max_running=2)
    for sched in (js, ts):
        for sid, prio in (("a", 0), ("b", 3), ("c", 0), ("d", 3)):
            sched.submit(sid, priority=prio)
        for _ in range(2):
            sched.admitted(sched.next_admission())
        assert sched.next_admission() is None
        sched.preempted("b")
        sched.admitted(sched.next_admission())
        sched.retired("d")
        sched.migrated("b")
    assert ts.snapshot() == js.snapshot()
    assert ts.queued() == js.queued() and ts.live() == js.live()
    assert [ts.tickets[s].field_history for s in "abcd"] == \
        [js.tickets[s].field_history for s in "abcd"]
    assert (S.QUEUED, S.RUNNING, S.DONE, S.MIGRATED) == ("QUEUED", "RUNNING", "DONE",
                                                          "MIGRATED")
    # a snapshot restores across the packages
    ts2 = S.ContinuousBatchScheduler(max_running=1)
    ts2.restore(js.snapshot())
    js2 = JaxSched(max_running=1)
    js2.restore(ts.snapshot())
    assert ts2.snapshot() == js2.snapshot() == js.snapshot()
