"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``; each test skips without a CUDA device. This file imports no
JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: bf16 2e-2 (8 significant bits; one rounding of an output near
1 is 2^-8), float32 2e-5 (summation order only), as tests/test_kernels.py.
The GLA kernels take tests/test_kernels.py's GLA sweep tolerances, 5e-2 in
bf16 and 5e-4 in float32 (absolute and relative): they are held against
the step-by-step recurrence, whose float32 sums run in another order over
hundreds of decayed terms, and their outputs are not bounded by 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import gla_chunk as GC  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PA  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.serving.engine import ServeEngine, Server  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
GLA_TOL = {torch.bfloat16: 5e-2, torch.float32: 5e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, dtype):
    torch.testing.assert_close(a.float(), b.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,K,S,D,window", [
    (2, 8, 2, 200, 64, None), (1, 4, 4, 64, 32, None), (2, 4, 2, 130, 64, 40)])
def test_flash_kernel_matches_plain(cuda, B, H, K, S, D, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=cuda).to(dtype).transpose(1, 2)
               for n in (H, K, K))
    n0 = FA.launches
    out = ops.flash_attention(q, k, v, window=window)
    assert FA.launches == n0 + 1
    _close(out, ref.naive_attention(q, k, v, window=window), dtype)


def _flash_views(cuda, B, H, K, S, D, dtype, seed):
    """q, k, v as the model passes them (``layers.py`` prefill): [B,S,n,D]
    projections seen as [B,n,S,D] views; v is a slice of a wider row, as a
    fused projection's would be."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (torch.randn(B, S, n, D, generator=g, device=cuda).to(dtype) for n in (H, K))
    row = torch.randn(B, S, (K + 2) * D, generator=g, device=cuda).to(dtype)
    v = row[..., 2 * D:].view(B, S, K, D)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _flash_held(q, k, v, window, dtype):
    n0 = FA.launches
    out = ops.flash_attention(q, k, v, window=window)
    assert FA.launches == n0 + 1
    assert out.stride() == q.stride()
    _close(out, ref.naive_attention(q, k, v, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [24, 63, 64, 65, 127, 129, 1000, 1536])
def test_flash_kernel_sequence_lengths(cuda, S, dtype):
    q, k, v = _flash_views(cuda, 2, 4, 2, S, 64, dtype, seed=S)
    _flash_held(q, k, v, None, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [1, 63, 64, 65, 1024])
def test_flash_kernel_windows(cuda, window, dtype):
    q, k, v = _flash_views(cuda, 2, 4, 1, 1536, 64, dtype, seed=window)
    _flash_held(q, k, v, window, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("G", [1, 4, 5, 16])
def test_flash_kernel_group_sizes_and_head_dims(cuda, G, D, dtype):
    q, k, v = _flash_views(cuda, 2, 2 * G, 2, 300, D, dtype, seed=G * D)
    _flash_held(q, k, v, None, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_on_model_views_equals_contiguous_copy(cuda, dtype):
    """The strided views and contiguous [B,H,S,D] copies of the same data
    give the same output bit for bit (the tensor maps follow the strides)."""
    q, k, v = _flash_views(cuda, 2, 8, 2, 200, 64, dtype, seed=7)
    assert not (q.is_contiguous() or v.is_contiguous())
    a = FA.flash_attention(q, k, v, window=50)
    b = FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=50)
    assert torch.equal(a, b)


def _decode_calls(cuda, dtype):
    """One call each of K2, K2 over a ring and K3 at small shapes, as
    closures over fixed inputs; with their launch counters."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, H, K, D, S = 2, 8, 2, 64, 300
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, K, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    kr, vr = (torch.randn(B, 64, K, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    qp, kp, vp, table, lens = _paged_inputs(cuda, 2, H, K, D, 3, 1, [300, 129], 16, dtype,
                                            seed=5)
    return {
        "decode": (lambda L=S: DA.decode_attention(q, k, v, L), "launches", DA),
        "ring": (lambda L=S: DA.ring_decode_attention(q, kr, vr, 200 + L, window=64),
                 "ring_launches", DA),
        "paged": (lambda L=S: PA.paged_decode_attention(qp, kp, vp, table,
                                                        torch.clamp(lens, max=L)),
                  "launches", PA),
    }


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_kernels_are_deterministic_across_launches(cuda, kind, dtype):
    fn, _, _ = _decode_calls(cuda, dtype)[kind]
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_kernels_replay_in_a_cuda_graph(cuda, kind):
    """Three calls captured in one graph and replayed three times equal the
    eager calls bit for bit: each launch leaves its ticket counters at 0."""
    fn, _, _ = _decode_calls(cuda, torch.bfloat16)[kind]
    lengths = (300, 129, 1)
    eager = [fn(L) for L in lengths]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(L) for L in lengths]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)
    assert torch.equal(fn(300), eager[0])


def test_decode_graph_replays_after_the_counters_grow(cuda):
    """A graph captured before a larger launch grows the ticket counters
    still replays equal to the eager call (the outgrown buffer stays
    allocated), and a capture that would need more counters raises."""
    fn, _, _ = _decode_calls(cuda, torch.bfloat16)["decode"]
    want = fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    K, D, S = 2, 32, 16
    dev = torch.device("cuda", torch.cuda.current_device())
    assert DA.counters(cuda, 1) is DA.counters(dev, 1)
    rows = DA.counters(dev, 1).numel() // K + 1
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(rows, 4, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(rows, S, K, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    big = DA.decode_attention(q, k, v, S)
    _close(big, ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), S),
           torch.bfloat16)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(DA.decode_attention(q, k, v, S), big)
    more = DA.counters(dev, 1).numel() // K + 1
    q2 = torch.zeros(more, 4, D, device=cuda).bfloat16()
    k2 = torch.zeros(more, S, K, D, device=cuda).bfloat16()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            DA.decode_attention(q2, k2, k2, S)


@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_kernels_are_one_launch_per_call(cuda, kind):
    fn, counter, mod = _decode_calls(cuda, torch.bfloat16)[kind]
    fn()
    torch.cuda.synchronize()
    n0 = getattr(mod, counter)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    assert getattr(mod, counter) == n0 + 3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0
               and "decode_kernel" in e.key]
    assert len(kernels) == 1 and kernels[0].count == 3, [(e.key, e.count) for e in kernels]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length,window", [(1, None), (DA.SPLIT, None),
                                           (DA.SPLIT + 1, None), (300, None), (300, 50)])
@pytest.mark.parametrize("H,K", [(8, 2), (DA.MAX_G, 1), (4, 4)])
def test_decode_kernel_matches_plain(cuda, length, window, dtype, H, K):
    B, S, D = 2, 300, 64
    g = torch.Generator(device=cuda).manual_seed(length)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, K, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    n0 = DA.launches
    out = ops.decode_attention(q, k, v, length, window=window)
    assert DA.launches == n0 + 1
    _close(out, ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                           length, window=window), dtype)
    assert torch.equal(out, ops.decode_attention(q, k, v, length, window=window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length,window", [(16 * DA.SPLIT, None), (16 * DA.SPLIT + 1, None),
                                           (40 * DA.SPLIT, None), (40 * DA.SPLIT, 1000)])
def test_decode_kernel_long_cache(cuda, length, window, dtype):
    """More splits than the combine's one load batch (16): its largest-m
    pass runs first."""
    B, H, K, D = 2, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(length)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, length, K, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    out = ops.decode_attention(q, k, v, length, window=window)
    _close(out, ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                           length, window=window), dtype)
    assert torch.equal(out, ops.decode_attention(q, k, v, length, window=window))


def _paged_inputs(cuda, B, H, K, D, n_layers, layer, lengths, page, dtype, seed,
                  shuffle=True):
    """A stacked pool store [P, page, n_layers*K*D] seen as layer ``layer``'s
    strided [P, page, K, D] view, a table of distinct pages (shuffled or in
    order) with the entries past each length set to 0, and int32 lengths."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = max(-(-max(lengths) // page), 1)
    P = B * n + 3
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    stores = [torch.randn(P, page, n_layers * K * D, generator=g, device=cuda).to(dtype)
              for _ in range(2)]
    kp, vp = (st.view(P, page, n_layers, K, D)[:, :, layer] for st in stores)
    order = torch.randperm(P, generator=torch.Generator().manual_seed(seed)) if shuffle \
        else torch.arange(P)
    table = order[: B * n].view(B, n).to(torch.int32)
    for b, L in enumerate(lengths):
        table[b, -(-L // page):] = 0
    return q, kp, vp, table.to(cuda), torch.tensor(lengths, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths,window", [([1, 16], None), ([DA.SPLIT, 300], None),
                                            ([300, DA.SPLIT + 1], 50), ([0, 17], None)])
@pytest.mark.parametrize("H,K,D", [(8, 2, 64), (DA.MAX_G, 1, 32), (4, 4, 64)])
def test_paged_decode_kernel_matches_plain(cuda, lengths, window, dtype, H, K, D):
    q, kp, vp, table, lens = _paged_inputs(cuda, 2, H, K, D, 3, 1, lengths, 16, dtype,
                                           seed=sum(lengths) + H)
    assert not kp.is_contiguous()                 # the strided per-layer view
    n0 = PA.launches
    out = ops.paged_decode_attention(q, kp, vp, table, lens, window=window)
    assert PA.launches == n0 + 1
    _close(out, ref.naive_paged_decode_attention(q, kp, vp, table, lens, window=window),
           dtype)
    assert torch.equal(out, ops.paged_decode_attention(q, kp, vp, table, lens,
                                                       window=window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length,window", [(1, None), (DA.SPLIT, None), (300, None),
                                           (300, 50)])
def test_paged_kernel_over_in_order_pages_equals_contiguous_kernel(cuda, length, window,
                                                                   dtype):
    B, H, K, D, page, S = 2, 8, 2, 64, 16, 320
    g = torch.Generator(device=cuda).manual_seed(length)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, K, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    n = S // page
    table = torch.arange(B * n, dtype=torch.int32, device=cuda).view(B, n)
    lens = torch.full((B,), length, dtype=torch.int32, device=cuda)
    paged = PA.paged_decode_attention(q, k.view(B * n, page, K, D), v.view(B * n, page, K, D),
                                      table, lens, window=window)
    assert torch.equal(paged, DA.decode_attention(q, k, v, length, window=window))


def test_paged_decode_kernel_refuses_what_it_does_not_take(cuda):
    q, kp, vp, table, lens = _paged_inputs(cuda, 1, 4, 2, 64, 2, 0, [5], 16,
                                           torch.float32, seed=0)
    with pytest.raises(TypeError, match="int32"):
        PA.paged_decode_attention(q, kp, vp, table.long(), lens)
    with pytest.raises(ValueError, match="head dim"):
        PA.paged_decode_attention(q[..., :48].contiguous(), kp[..., :48], vp[..., :48],
                                  table, lens)
    with pytest.raises(ValueError, match="query heads per KV head"):
        PA.paged_decode_attention(torch.randn(1, 2 * DA.MAX_G, 64, device=cuda),
                                  kp[:, :, :1], vp[:, :, :1], table, lens)


def test_decode_kernel_refuses_more_query_heads_per_kv_head(cuda):
    q = torch.randn(1, 2 * DA.MAX_G, 64, device=cuda)
    k = torch.randn(1, 8, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="query heads per KV head"):
        DA.decode_attention(q, k, k, 4)


def test_force_ref_on_cuda_launches_nothing(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda)
    n0 = (FA.launches, DA.launches, PA.launches)
    ops.flash_attention(q, q, q, force="ref")
    ops.decode_attention(q[:, :, 0], q.transpose(1, 2), q.transpose(1, 2), 3, force="ref")
    table = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    ops.paged_decode_attention(q[:, :, 0], q.view(2, 8, 1, 32), q.view(2, 8, 1, 32), table,
                               lens, force="ref")
    assert (FA.launches, DA.launches, PA.launches) == n0


def test_smoke_server_on_card_matches_cpu(cuda):
    cfg = smoke_config("granite-3-2b")
    gpu = Server(cfg, device=cuda, seed=0)
    cpu = Server(cfg, device="cpu", params=tree_map(lambda t: t.cpu(), gpu.params))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    lg, lc = gpu.prefill(prompt, pad_to=20), cpu.prefill(prompt, pad_to=20)
    # float32 through 3 layers, card vs CPU matmul order (conftest assert_close)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    first = np.argmax(lc[:, : cfg.vocab_size].numpy(), -1)
    (tg, _), (tc, _) = gpu.decode(6, first), cpu.decode(6, first)
    np.testing.assert_array_equal(np.stack(tg), np.stack(tc))



def test_smoke_fleet_on_card_matches_server_streams(cuda):
    """A short fleet run on the card (float32 smoke config, a pool small
    enough to force a swap): every stream equals the port Server's B=1
    greedy stream, and the decode went through the paged kernel only."""
    cfg = smoke_config("granite-3-2b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 9, 14)]
    eng = ServeEngine(cfg, device=cuda, seed=0, max_len=40, page_size=4, n_pages=10,
                      max_running=3)
    n0 = (FA.launches, DA.launches, PA.launches)
    sids = [eng.submit(p, max_new_tokens=8) for p in prompts[:2]]
    for _ in range(2):
        eng.step_once()
    sids.append(eng.submit(prompts[2], max_new_tokens=8, priority=5))
    eng.run_until_drained(max_ticks=200)
    assert sum(eng.sched.tickets[s].preemptions for s in sids) >= 1
    decoded = sum(len(eng.stream(s)) - 1 for s in sids)
    assert (FA.launches - n0[0], DA.launches - n0[1], PA.launches - n0[2]) == (
        3 * cfg.n_layers, 0, decoded * cfg.n_layers)
    for p, sid in zip(prompts, sids):
        srv = Server(cfg, device=cuda, params=eng.params)
        logits = srv.prefill(p[None, :], pad_to=len(p) + 8)
        first = torch.argmax(logits[:, : cfg.vocab_size], -1).cpu().numpy()
        toks, _ = srv.decode(7, first)
        assert eng.stream(sid) == [int(first[0])] + [int(t[0]) for t in toks]


def _gla_inputs(cuda, B, H, S, N, P, dtype, seed, broadcast=False, steep=False):
    """tests/test_kernels.py's GLA inputs. ``broadcast``: q and k are the
    model's head-broadcast views (one row per position, head stride 0,
    sliced out of a wider projection row). ``steep``: log decays uniform in
    [-20, 0] a step, so a chunk's cum falls far below float32's exp range."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    if broadcast:
        row = randn(B, S, 2 * N + 8).to(dtype)
        q = row[..., 8:8 + N, None].transpose(-1, -2).expand(B, S, H, N)
        k = (row[..., 8 + N:, None] * 0.3).to(dtype).transpose(-1, -2).expand(B, S, H, N)
        assert q.stride(2) == 0 and k.stride(2) == 0
    else:
        q, k = randn(B, S, H, N).to(dtype), (randn(B, S, H, N) * 0.3).to(dtype)
    v = randn(B, S, H, P).to(dtype)
    lg = -torch.nn.functional.softplus(randn(B, S, H)) * 0.3
    if steep:
        lg = -20 * torch.rand(B, S, H, generator=g, device=cuda)
    return q, k, v, lg


def _gla_close(a, b, dtype):
    torch.testing.assert_close(a.float(), b.float(), rtol=GLA_TOL[dtype],
                               atol=GLA_TOL[dtype])


GLA_CASES = [(2, 3, 64, 8, 32, 16, False), (1, 2, 96, 16, 64, 64, False),   # 96: chunk 32
             (1, 2, 40, 8, 32, 16, True), (2, 2, 512, 16, 64, 256, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,S,N,P,chunk,broadcast", GLA_CASES)
def test_gla_chunk_kernel_matches_plain(cuda, B, H, S, N, P, chunk, broadcast, dtype):
    q, k, v, lg = _gla_inputs(cuda, B, H, S, N, P, dtype, S + N, broadcast)
    n0 = GC.launches
    y, state = ops.gla(q, k, v, lg, chunk=chunk)
    assert GC.launches == n0 + 1
    want, h = ref.naive_gla(q, k, v, lg)
    assert y.dtype == dtype and state.dtype == torch.float32
    _gla_close(y, want, dtype)
    _gla_close(state, h, dtype)
    y2, s2 = ref.chunked_gla(q, k, v, lg, chunk=chunk)
    _gla_close(y, y2, dtype)
    _gla_close(state, s2, dtype)
    assert torch.equal(y, GC.gla_chunk(q, k, v, lg, chunk=chunk)[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,S,N,P,chunk,broadcast", GLA_CASES)
def test_gla_parallel_kernels_match_plain_phases(cuda, B, H, S, N, P, chunk, broadcast,
                                                  dtype):
    q, k, v, lg = _gla_inputs(cuda, B, H, S, N, P, dtype, S + N + 1, broadcast)
    n0 = (GC.launches_a, GC.launches_b)
    y, final = ops.gla(q, k, v, lg, chunk=chunk, schedule="parallel")
    assert (GC.launches_a, GC.launches_b) == (n0[0] + 1, n0[1] + 1)
    want, h = ref.naive_gla(q, k, v, lg)
    _gla_close(y, want, dtype)
    _gla_close(final, h, dtype)
    # each phase against its plain version on the same inputs
    ya, g, d = GC.gla_phase_a(q, k, v, lg, chunk=chunk)
    pa, pg, pd = ref.gla_phase_a(q, k, v, lg, chunk=chunk)
    _gla_close(ya, pa, dtype)
    _gla_close(g, pg, dtype)
    _gla_close(d, pd, dtype)
    start, _ = ref.gla_scan(pg, pd)
    _gla_close(GC.gla_phase_b(q, lg, start, pa, chunk=chunk),
               ref.gla_phase_b(q, lg, start, pa, chunk=chunk), dtype)
    # the two schedules against each other
    _gla_close(y, GC.gla_chunk(q, k, v, lg, chunk=chunk)[0], dtype)


def _gla_all(q, k, v, lg, chunk):
    """Every GLA kernel on one input: K4's (y, state), phase A's (y_intra,
    g, delta), phase B's y on the plain phase A's outputs and scan."""
    pa, pg, pd = ref.gla_phase_a(q, k, v, lg, chunk=chunk)
    start = GC.scan_chunks(pg, pd)[0].contiguous()
    return (GC.gla_chunk(q, k, v, lg, chunk=chunk) + GC.gla_phase_a(q, k, v, lg, chunk=chunk)
            + (GC.gla_phase_b(q, lg, start, pa, chunk=chunk),))


def _gla_plain(q, k, v, lg, chunk):
    """_gla_all's plain versions, in the same order."""
    pa, pg, pd = ref.gla_phase_a(q, k, v, lg, chunk=chunk)
    start = GC.scan_chunks(pg, pd)[0].contiguous()
    return (ref.chunked_gla(q, k, v, lg, chunk=chunk) + (pa, pg, pd)
            + (ref.gla_phase_b(q, lg, start, pa, chunk=chunk),))


@pytest.mark.parametrize("N,P", [(8, 32), (16, 64)])
@pytest.mark.parametrize("c", [1, 8, 16, 24, 64, 256])
def test_gla_bf16_kernels_at_every_chunk_length(cuda, c, N, P):
    """The tensor-core kernels take any chunk: 16-row tiles with a ragged
    last one (1, 8, 24), one tile, several, the serving chunk 256; q/k as
    the mixer's head-stride-0 views."""
    S = 3 * c
    q, k, v, lg = _gla_inputs(cuda, 2, 3, S, N, P, torch.bfloat16, 7 * c + N, broadcast=True)
    assert GC.chunk_len(S, c) == c
    for got, want in zip(_gla_all(q, k, v, lg, c), _gla_plain(q, k, v, lg, c)):
        assert got.shape == want.shape and got.dtype == want.dtype
        _gla_close(got, want, torch.bfloat16)
    y, final = GC.gla_chunk_parallel(q, k, v, lg, chunk=c)
    want, h = ref.gla_chunk_parallel(q, k, v, lg, chunk=c)
    _gla_close(y, want, torch.bfloat16)
    _gla_close(final, h, torch.bfloat16)


@pytest.mark.parametrize("S,N,P,chunk", [(512, 16, 64, 256), (192, 8, 32, 64),
                                         (72, 16, 64, 24)])
def test_gla_bf16_kernels_under_steep_decays(cuda, S, N, P, chunk):
    """Log decays down to -20 a step drive a chunk's cum to -2500: the bf16
    kernels' off-diagonal decay factors underflow to 0 exactly where the
    true product does, and nothing overflows. (The float32 kernels are not
    held here: at cum -2500 each exp(cum_i - cum_j) carries |cum| 2^-24 of
    rounding in the plain version as in the kernel, about GLA_TOL.)"""
    dtype = torch.bfloat16
    q, k, v, lg = _gla_inputs(cuda, 2, 3, S, N, P, dtype, S + 3, broadcast=True, steep=True)
    assert lg.min().item() < -19
    for got, want in zip(_gla_all(q, k, v, lg, chunk), _gla_plain(q, k, v, lg, chunk)):
        assert torch.isfinite(got).all()
        _gla_close(got, want, dtype)
    want, h = ref.naive_gla(q, k, v, lg)
    y, final = GC.gla_chunk(q, k, v, lg, chunk=chunk)
    _gla_close(y, want, dtype)
    _gla_close(final, h, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gla_kernels_are_deterministic_across_launches(cuda, dtype):
    q, k, v, lg = _gla_inputs(cuda, 2, 3, 512, 16, 64, dtype, 3, broadcast=True)
    first, second = _gla_all(q, k, v, lg, 256), _gla_all(q, k, v, lg, 256)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_gla_kernels_replay_in_a_cuda_graph(cuda):
    """K4, phase A and phase B captured in one graph and replayed three
    times equal the eager calls bit for bit."""
    q, k, v, lg = _gla_inputs(cuda, 2, 3, 512, 16, 64, torch.bfloat16, 4, broadcast=True)
    pa, pg, pd = ref.gla_phase_a(q, k, v, lg, chunk=256)
    start = GC.scan_chunks(pg, pd)[0].contiguous()

    def calls():
        return (GC.gla_chunk(q, k, v, lg, chunk=256) + GC.gla_phase_a(q, k, v, lg, chunk=256)
                + (GC.gla_phase_b(q, lg, start, pa, chunk=256),))
    eager = calls()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)


@pytest.mark.parametrize("schedule,names", [("chunk", ("gla_chunk_kernel",)),
                                            ("parallel", ("gla_phase_a_kernel",
                                                          "gla_phase_b_kernel"))])
def test_gla_kernels_are_one_launch_per_call(cuda, schedule, names):
    """The profiler sees one K4 kernel per chunk-schedule call, one of each
    phase per parallel-schedule call, and no other GLA kernel, over 6 calls
    back to back (as ``chip_smoke.kernel_us`` profiles them: after a
    warm-up step, since the tracer may drop the records of the first
    launches after it starts). The wrappers count 6 launches each."""
    q, k, v, lg = _gla_inputs(cuda, 2, 3, 512, 16, 64, torch.bfloat16, 5, broadcast=True)
    ops.gla(q, k, v, lg, chunk=256, schedule=schedule)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                                 active=1, repeat=1)) as prof:
        ops.gla(q, k, v, lg, chunk=256, schedule=schedule)
        torch.cuda.synchronize()
        prof.step()
        n0 = (GC.launches, GC.launches_a, GC.launches_b)
        for _ in range(6):
            ops.gla(q, k, v, lg, chunk=256, schedule=schedule)
        torch.cuda.synchronize()
        prof.step()
    per = (6, 0, 0) if schedule == "chunk" else (0, 6, 6)
    assert (GC.launches, GC.launches_a, GC.launches_b) == tuple(a + b for a, b in zip(n0, per))
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0
            and "gla_" in e.key}
    assert len(seen) == len(names), seen
    for n in names:
        assert any(n in key and cnt == 6 for key, cnt in seen.items()), seen


def test_gla_kernels_refuse_unbuilt_shapes(cuda):
    q, k, v, lg = _gla_inputs(cuda, 1, 2, 32, 32, 64, torch.float32, 0)
    with pytest.raises(ValueError, match="not in"):
        GC.gla_chunk(q, k, v, lg, chunk=16)
    with pytest.raises(ValueError, match="not in"):
        GC.gla_phase_a(q, k, v, lg, chunk=16)
    q, k, v, lg = _gla_inputs(cuda, 1, 2, 32, 16, 64, torch.float32, 0)
    with pytest.raises(TypeError, match="dtypes"):
        GC.gla_chunk(q, k, v.bfloat16(), lg, chunk=16)
    q, k, v, lg = _gla_inputs(cuda, 1, 1, 4096, 16, 64, torch.float32, 0)
    with pytest.raises(ValueError, match="shared memory"):
        GC.gla_chunk(q, k, v, lg, chunk=4096)


def test_gla_bf16_kernels_refuse_misaligned_rows(cuda):
    """The bf16 kernels copy rows, and phase B's start, 16 bytes at a time:
    a view whose data does not start on 16 bytes raises, and the CUDA
    context stays usable."""
    q, k, v, lg = _gla_inputs(cuda, 1, 2, 32, 16, 64, torch.bfloat16, 0)
    qs = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    qs.copy_(q)
    with pytest.raises(ValueError, match="16 bytes"):
        GC.gla_chunk(qs, k, v, lg, chunk=16)
    ya, g, d = GC.gla_phase_a(q, k, v, lg, chunk=16)
    start, _ = GC.scan_chunks(g, d)
    shifted = torch.empty(start.numel() + 1, device=cuda)[1:].view(start.shape)
    shifted.copy_(start)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16 bytes"):
        GC.gla_phase_b(q, lg, shifted, ya, chunk=16)
    assert torch.equal(GC.gla_phase_b(q, lg, start, ya, chunk=16),
                       GC.gla_phase_b(q, lg, start.clone(), ya, chunk=16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("W,window,pos", [
    (64, 64, 10),       # pos < W: the ring is not full yet
    (64, 64, 63),       # pos = W - 1: full, not wrapped
    (64, 64, 1000),     # pos >> W: wrapped many times
    (300, 256, 290),    # W_ring > window (a prompt grown by pad_to): the window bites
    (300, 256, 700),    # ... and wrapped
    (48, 256, 200),     # W_ring < window: the ring bounds the range
])
def test_ring_decode_kernel_matches_plain(cuda, W, window, pos, dtype):
    B, H, K, D = 2, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(pos + W)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, W, K, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    n0 = DA.ring_launches
    out = ops.window_decode_attention(q, k, v, pos, window=window)
    assert DA.ring_launches == n0 + 1
    _close(out, ref.naive_ring_decode_attention(q, k, v, pos, window=window), dtype)
    assert torch.equal(out, ops.window_decode_attention(q, k, v, pos, window=window))


def test_force_ref_on_cuda_launches_no_new_kernel(cuda):
    q, k, v, lg = _gla_inputs(cuda, 1, 2, 32, 8, 32, torch.float32, 0)
    n0 = (GC.launches, GC.launches_a, GC.launches_b, DA.ring_launches)
    ops.gla(q, k, v, lg, chunk=16, force="ref")
    ops.gla(q, k, v, lg, chunk=16, schedule="parallel", force="ref")
    kr = torch.randn(1, 16, 1, 32, device=cuda)
    ops.window_decode_attention(torch.randn(1, 2, 32, device=cuda), kr, kr, 20, window=8,
                                force="ref")
    assert (GC.launches, GC.launches_a, GC.launches_b, DA.ring_launches) == n0


@pytest.mark.parametrize("schedule", ["chunk", "parallel"])
def test_smoke_hymba_server_on_card_matches_cpu(cuda, schedule):
    cfg = smoke_config("hymba-1.5b")
    gpu = Server(cfg, device=cuda, seed=0, gla_schedule=schedule)
    cpu = Server(cfg, device="cpu", params=tree_map(lambda t: t.cpu(), gpu.params),
                 gla_schedule=schedule)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    n = (GC.launches, GC.launches_a, DA.launches, DA.ring_launches)
    lg, lc = gpu.prefill(prompt, pad_to=48), cpu.prefill(prompt, pad_to=48)
    # float32 through 3 layers, card vs CPU matmul order (conftest assert_close)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    first = np.argmax(lc[:, : cfg.vocab_size].numpy(), -1)
    (tg, _), (tc, _) = gpu.decode(6, first), cpu.decode(6, first)
    np.testing.assert_array_equal(np.stack(tg), np.stack(tc))
    gla = GC.launches - n[0] if schedule == "chunk" else GC.launches_a - n[1]
    # 3 layers: 2 windowed (ring) and 1 global, each with SSD heads
    assert (gla, DA.launches - n[2], DA.ring_launches - n[3]) == (3, 6, 12)


# -- the checkpoint-restart plane on the card -----------------------------------

def _bf16_granite():
    import dataclasses
    return dataclasses.replace(smoke_config("granite-3-2b"), param_dtype="bfloat16",
                               compute_dtype="bfloat16", cache_dtype="bfloat16")


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _served(cuda, tmp_path, n=3):
    cfg = _bf16_granite()
    srv = Server(cfg, device=cuda, seed=1, ckpt_dir=tmp_path / "ck")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    logits = srv.prefill(prompt, pad_to=24)
    toks, _ = srv.decode(n, torch.argmax(logits[:, : cfg.vocab_size], -1).cpu().numpy())
    return srv, toks


def test_cache_writes_after_checkpoint_leave_the_snapshot(cuda, tmp_path):
    from repro_torch.core.restore import load_arrays
    from repro_torch.models.params import tree_leaves
    srv, _ = _served(cuda, tmp_path)
    before = [t.clone() for t in tree_leaves(srv.caches)]
    req = srv.checkpoint()
    for t in tree_leaves(srv.caches):     # at once, on the current stream
        t.fill_(7.0)
    req.wait()
    meta = srv.runtime.snapshot()[1]
    got = load_arrays(srv.cluster.writer.latest(),
                      {"runtime": {"kv_caches": tree_map(
                          lambda _: cuda, srv.runtime.shardings(meta)["kv_caches"]),
                          "rng": None}})["runtime"]["kv_caches"]
    for a, b in zip(tree_leaves(got), before):
        assert a.dtype == torch.bfloat16 and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_bf16_leaves_survive_d2h_disk_h2d_bit_for_bit(cuda, tmp_path, codec):
    from repro_torch.configs import CkptIOConfig
    from repro_torch.core import Cluster
    from repro_torch.core.restore import load_arrays
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3, 67, 33, generator=g, device=cuda).to(torch.bfloat16)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                            1e-40, -3e-39, 65504.0], device=cuda).to(torch.bfloat16)
    arrays = {"a": x, "b": [special, torch.tensor(2.5, device=cuda).to(torch.bfloat16)],
              "c": torch.zeros(0, 4, device=cuda, dtype=torch.bfloat16)}
    c = Cluster(2, "mpich", ckpt_dir=tmp_path / "ck", ckpt_io=CkptIOConfig(codec=codec))
    c.checkpoint(1, arrays, None).wait()
    got = load_arrays(c.writer.latest(), tree_map(lambda _: cuda, arrays))
    for a, b in zip([got["a"], *got["b"], got["c"]], [x, special, arrays["b"][1], arrays["c"]]):
        assert a.device == b.device and a.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    c.writer.close()


def test_restored_server_lives_on_the_card_and_continues(cuda, tmp_path):
    from repro_torch.models.params import tree_leaves
    srv, _ = _served(cuda, tmp_path)
    srv.checkpoint().wait()
    tail, _ = srv.decode(4, srv.resume_tok)
    fresh = Server(srv.cfg, device=cuda, params=srv.params, ckpt_dir=tmp_path / "ck")
    fresh.restore(srv.cluster.writer.latest(), new_backend="openmpi", rebuild=True)
    leaves = tree_leaves(fresh.caches)
    assert leaves and all(t.device.type == cuda.type for t in leaves)
    assert fresh.max_len == 24 and fresh.pos == srv.pos - 4
    again, _ = fresh.decode(4, fresh.resume_tok)
    np.testing.assert_array_equal(np.stack(again), np.stack(tail))
    assert fresh.rng_key.tobytes() == srv.rng_key.tobytes()


def test_snapshot_launches_no_decode_kernel(cuda, tmp_path):
    srv, _ = _served(cuda, tmp_path)
    n = (DA.launches, DA.ring_launches, PA.launches, FA.launches)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        req = srv.checkpoint()
        torch.cuda.synchronize()
    req.wait()
    assert (DA.launches, DA.ring_launches, PA.launches, FA.launches) == n
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [nm for nm in names if "decode" in nm or "flash" in nm], names


def test_restore_stages_through_the_writers_pinned_arena(cuda, tmp_path):
    from repro_torch.models.params import tree_leaves
    srv, _ = _served(cuda, tmp_path)
    srv.checkpoint().wait()
    fresh = Server(srv.cfg, device=cuda, params=srv.params, ckpt_dir=tmp_path / "ck")
    arenas = fresh.cluster.writer.arenas
    fresh.restore(srv.cluster.writer.latest(), new_backend="exampi", rebuild=True)
    assert fresh.cluster.writer.arenas is arenas
    staged = sum(t.numel() * t.element_size() for t in tree_leaves(fresh.caches))
    buf = arenas[0]._buf
    assert buf.is_pinned() and buf.numel() >= staged
    assert all(a.try_acquire() for a in arenas)
    for a in arenas:
        a.release()
    fresh.checkpoint().wait()                     # the snapshot reuses it
    assert arenas[0]._buf is buf


# -- the fleet's C/R and the supervised recovery loop on the card --------------

class _LateTraffic(ServeEngine):
    """A fleet whose late high-priority session arrives with tick 2, so a
    recovery that rewinds past tick 2 sees it arrive again."""
    late = None

    def step_once(self):
        if self.late is not None and self.tick == 2 and "late" not in self.sessions:
            self.submit(self.late, sid="late", max_new_tokens=8, priority=5)
        return super().step_once()


def _bf16_fleet(cuda, tmp_path, late=False):
    """A bf16 smoke fleet on the card, a pool small enough to park a session."""
    eng = _LateTraffic(_bf16_granite(), device=cuda, seed=1, ckpt_dir=tmp_path / "ck",
                       max_len=40, page_size=4, n_pages=10, max_running=3)
    rng = np.random.default_rng(1)
    for n in (20, 9):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, n), max_new_tokens=8)
    if late:
        eng.late = rng.integers(0, eng.cfg.vocab_size, 14)
    return eng


def test_fleet_snapshot_launches_no_decode_kernel(cuda, tmp_path):
    eng = _bf16_fleet(cuda, tmp_path)
    for _ in range(3):
        eng.step_once()
    n = (DA.launches, DA.ring_launches, PA.launches, FA.launches)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        req = eng.checkpoint()
        torch.cuda.synchronize()
    req.wait()
    assert (DA.launches, DA.ring_launches, PA.launches, FA.launches) == n
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [nm for nm in names if "decode" in nm or "flash" in nm], names
    # the rows went off the card through the writer's pinned arena, timed
    # on the side stream apart from the host copies
    assert eng.cluster.writer.arenas[0]._buf.is_pinned()
    tm = req.timings
    assert 0 < tm["device_copy_ms"] and 0 <= tm["host_copy_ms"] <= tm["snapshot_ms"]
    eng.cluster.writer.close()


@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_supervised_fleet_kill_rank_rehomes_on_the_card(cuda, tmp_path, tier):
    from repro_torch.core.ckpt_tiers import ReplicaTier
    from repro_torch.core.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.core.supervisor import Supervisor, SupervisorConfig
    ref = _bf16_fleet(cuda, tmp_path / "ref", late=True)
    ref.run_until_drained(max_ticks=200)
    eng = _bf16_fleet(cuda, tmp_path / "sup", late=True)
    plan = FaultPlan([FaultSpec("kill_rank", at_step=5, rank=1)])
    with FaultInjector(plan) as inj:
        sup = Supervisor(eng, injector=inj, lease_s=1.0, verbose=False,
                         tier=ReplicaTier() if tier == "ram" else None,
                         config=SupervisorConfig(backoff_floor_s=0.0))
        incidents = sup.run(10, ckpt_every=3)
    inc, = incidents
    assert (inc.kind, inc.tier, inc.world_before, inc.world_after, inc.resumed_step) == \
        ("rank_dead", tier, 2, 1, 3)
    assert inc.rehomed >= 1
    assert all(t.device.type == cuda.type for t in eng.pool.stores.values())
    eng.run_until_drained(max_ticks=200)
    assert sorted(eng.sessions) == sorted(ref.sessions)
    assert {s: eng.stream(s) for s in eng.sessions} == {s: ref.stream(s) for s in ref.sessions}
    for e in (ref, eng):
        e.cluster.writer.close()


# -- K1's logsumexp and the backward kernels ------------------------------------
# The backward's gradients are not bounded by 1, so they are held by
# max |a - b| / max |b|: bf16 2e-2 (P and dS are rounded to bf16 for their
# products, as the forward rounds P, and the gradients to bf16 on output),
# float32 2e-5 (summation order only). The logsumexp is float32 in both
# dtypes: 1e-4 absolute (bf16 inputs: the kernel's row max and sum come
# from ex2.approx over the same bf16 scores; float32: expf and summation
# order), against values of order log S.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
LSE_TOL = 1e-4


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _bwd_inputs(cuda, B, H, K, S, D, dtype, seed):
    q, k, v = _flash_views(cuda, B, H, K, S, D, dtype, seed)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    do = torch.randn(B, H, S, D, generator=g, device=cuda).to(dtype)
    return q, k, v, do


def _bwd_held(q, k, v, do, window, dtype):
    o, lse = FA.flash_attention(q, k, v, window=window, lse=True)
    torch.testing.assert_close(lse, ref.naive_attention_lse(q, k, window=window),
                               rtol=0, atol=LSE_TOL)
    n0 = (FA.bwd_dq_launches, FA.bwd_dkdv_launches)
    *got, dr = FA._bwd(q, k, v, o, lse, do, window=window)
    assert (FA.bwd_dq_launches, FA.bwd_dkdv_launches) == tuple(n + 1 for n in n0)
    # the row sums the dQ launch writes for dK/dV: float32 sums of exact
    # products, in another order
    torch.testing.assert_close(dr, ref.attention_bwd_delta(o, do), rtol=0, atol=LSE_TOL)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    for name, a, b, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == dtype, name
        assert a.stride() == torch.empty_like(x).stride(), name
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= BWD_TOL[dtype], (name, _rel(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_lse_matches_plain_and_leaves_the_output_unchanged(cuda, window, dtype):
    """The logsumexp output against the plain one; the output with the
    write on equals the prefill's (null buffer) bit for bit."""
    q, k, v = _flash_views(cuda, 2, 8, 2, 333, 64, dtype, seed=11)
    o, lse = FA.flash_attention(q, k, v, window=window, lse=True)
    assert lse.shape == (2, 8, 333) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref.naive_attention_lse(q, k, window=window),
                               rtol=0, atol=LSE_TOL)
    assert torch.equal(o, FA.flash_attention(q, k, v, window=window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S,window", [(256, None), (200, None), (77, None), (300, 50),
                                      (130, 64), (127, None), (128, None), (129, None),
                                      (255, None), (257, None), (129, 9), (255, 100),
                                      (257, 200), (300, 129)])
def test_flash_bwd_matches_plain(cuda, S, window, G, D, dtype):
    """The 128-row blocks' and 64-row tiles' edges (S around 128 and 256),
    windows narrower and wider than a block, both head dims (the 64- and
    128-byte swizzles, each tile read K-major and MN-major)."""
    q, k, v, do = _bwd_inputs(cuda, 2, 2 * G, 2, S, D, dtype, seed=S + G + D)
    _bwd_held(q, k, v, do, window, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_at_granite_shape(cuda, dtype):
    q, k, v, do = _bwd_inputs(cuda, 1, 32, 8, 1024, 64, dtype, seed=3)
    _bwd_held(q, k, v, do, None, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_is_deterministic(cuda, dtype):
    """Two runs on the same inputs give equal bits (no atomics; each
    gradient row is summed by one block in a fixed order)."""
    q, k, v, do = _bwd_inputs(cuda, 2, 8, 2, 300, 64, dtype, seed=5)
    o, lse = FA.flash_attention(q, k, v, lse=True)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_takes_a_transposed_do_as_it_comes(cuda, dtype):
    """dO as training hands it over (the transposed view of a [B,S,H,D]
    gradient) gives the same bits as its contiguous copy, through the
    wrapper and through FlashAttention's backward."""
    q, k, v, _ = _bwd_inputs(cuda, 2, 8, 2, 200, 64, dtype, seed=13)
    g = torch.Generator(device=cuda).manual_seed(14)
    do = torch.randn(2, 200, 8, 64, generator=g, device=cuda).to(dtype).transpose(1, 2)
    assert not do.is_contiguous() and FA._rows_ok(do)
    o, lse = FA.flash_attention(q, k, v, window=77, lse=True)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do, window=77)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), window=77)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    qa, ka, va = (x.detach().requires_grad_() for x in (q, k, v))
    out = FA.FlashAttention.apply(qa, ka, va, 77)
    c = torch.autograd.grad(out, (qa, ka, va), do, retain_graph=True)
    d = torch.autograd.grad(out, (qa, ka, va), do.contiguous())
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    assert all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_launch_from_a_fresh_host_thread(cuda, dtype):
    """The autograd engine runs a backward on its own thread, whose first
    CUDA call it may be: the backward, and the forward, launched from a
    thread that has made no CUDA call give the main thread's bits."""
    import threading
    q, k, v, do = _bwd_inputs(cuda, 2, 8, 2, 200, 64, dtype, seed=15)
    o, lse = FA.flash_attention(q, k, v, window=77, lse=True)
    want = FA.flash_attention_bwd(q, k, v, o, lse, do, window=77)
    got = {}

    def run(name, fn):
        got[name] = fn()
        torch.cuda.synchronize()
    for name, fn in (("bwd", lambda: FA.flash_attention_bwd(q, k, v, o, lse, do, window=77)),
                     ("fwd", lambda: FA.flash_attention(q, k, v, window=77, lse=True))):
        t = threading.Thread(target=run, args=(name, fn))
        t.start()
        t.join()
    assert all(torch.equal(x, y) for x, y in zip(got["bwd"], want))
    assert torch.equal(got["fwd"][0], o) and torch.equal(got["fwd"][1], lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_autograd_function_matches_plain_autograd(cuda, dtype):
    """ops.flash_attention under autograd on the card (FlashAttention: the
    forward with its logsumexp, the backward kernels on a non-contiguous
    dO) against autograd of the plain version."""
    q, k, v = (x.detach().requires_grad_() for x in _flash_views(cuda, 2, 8, 2, 150, 64,
                                                                   dtype, seed=9))
    n0 = (FA.launches, FA.bwd_dkdv_launches)
    out = ops.flash_attention(q, k, v, window=60)
    w = torch.randn(2, 150, 8, 64, device=cuda).to(dtype).transpose(1, 2)
    got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    assert (FA.launches, FA.bwd_dkdv_launches) == (n0[0] + 1, n0[1] + 1)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    ref_out = ops.flash_attention(qr, kr, vr, window=60, force="ref")
    want = torch.autograd.grad((ref_out.float() * w.float()).sum(), (qr, kr, vr))
    for a, b in zip(got, want):
        assert _rel(a, b) <= BWD_TOL[dtype]


def test_flash_bwd_refuses_what_it_does_not_take(cuda):
    q, k, v, do = _bwd_inputs(cuda, 1, 4, 2, 64, 64, torch.bfloat16, seed=1)
    o, lse = FA.flash_attention(q, k, v, lse=True)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="do"):
        FA.flash_attention_bwd(q, k, v, o, lse, do.float())
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_bwd(*(x[..., :48] for x in (q, k, v, o)), lse, do[..., :48])


# -- training on the card --------------------------------------------------------

@pytest.fixture
def deterministic_restored():
    """The trainer turns on deterministic algorithms for the process; give
    the tests after these the mode they had."""
    was = torch.are_deterministic_algorithms_enabled()
    yield
    torch.use_deterministic_algorithms(was)


def _counts():
    return (FA.launches, FA.bwd_dq_launches, FA.bwd_dkdv_launches)


def test_smoke_train_step_on_card_matches_plain_path(cuda, deterministic_restored):
    """One float32 smoke-size step's loss and gradients on the card (K1's
    forward twice a layer under remat, the backward kernels once) against
    the same step with the plain attention under autograd on the card:
    max |a - b| / max |b| <= 1e-4 per leaf (float32, the kernels' sums in
    another order, as the CPU parity tests)."""
    from repro_torch import steps as ST
    from repro_torch.data import synth_batch
    from repro_torch.launch.train import Trainer
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves
    cfg = smoke_config("granite-3-2b")
    tr = Trainer(cfg, batch_size=2, seq_len=48, device=cuda)
    tr.pipeline.stop()
    assert torch.are_deterministic_algorithms_enabled()
    tr.init_state()
    batch = tr._device_batch(synth_batch(cfg, 2, 48, 1, 0))
    n0, L = _counts(), cfg.n_layers
    grads, total, _, _ = ST.loss_and_grads(tr.model, tr.params, batch)
    assert _counts() == (n0[0] + 2 * L, n0[1] + L, n0[2] + L)
    want, want_total, _, _ = ST.loss_and_grads(Model(cfg, force="ref"), tr.params, batch)
    assert _counts() == (n0[0] + 2 * L, n0[1] + L, n0[2] + L)
    assert abs(total.item() - want_total.item()) <= 1e-5 * abs(want_total.item())
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_train_kill_and_recover_on_card_is_byte_identical(cuda, tmp_path, dtype,
                                                                deterministic_restored):
    """Six steps with a checkpoint every 3: a run whose last rank dies at
    step 4 and restarts under exampi ends with the params and optimizer
    state of an uninterrupted run, byte for byte."""
    from dataclasses import replace

    from repro_torch.launch.train import Trainer
    from repro_torch.models.params import tree_leaves
    cfg = replace(smoke_config("granite-3-2b"), param_dtype=dtype, compute_dtype=dtype)

    def run(ck, kill):
        tr = Trainer(cfg, batch_size=2, seq_len=48, device=cuda, ckpt_dir=ck, total_steps=6)
        tr.init_state()
        tr.run(6, ckpt_every=3, kill_rank_at=kill,
               new_backend_on_restart="exampi" if kill else None, log_every=1)
        leaves = tree_leaves({"p": tr.params, "o": tr.opt_state})
        assert all(t.device.type == "cuda" for t in leaves)
        assert tr.params["head"].dtype == getattr(torch, dtype)
        out = [t.cpu().contiguous().view(torch.uint8).numpy().tobytes() for t in leaves]
        losses = {h["step"]: h["loss"] for h in tr.history}
        tr.pipeline.stop()
        tr.cluster.writer.close()
        return out, losses

    assert run(tmp_path / "a", None) == run(tmp_path / "b", 4)
