"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``; each test skips without a CUDA device. This file imports no
JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: bf16 2e-2 (8 significant bits; one rounding of an output near
1 is 2^-8), float32 2e-5 (summation order only), as tests/test_kernels.py.
The GLA kernels take tests/test_kernels.py's GLA sweep tolerances, 5e-2 in
bf16 and 5e-4 in float32 (absolute and relative): they are held against
the step-by-step recurrence, whose float32 sums run in another order over
hundreds of decayed terms, and their outputs are not bounded by 1. So
does the sLSTM scan, held to its plain version over up to 1024 recurrent
steps (each product over dh in another order; in bf16 a one-ulp change of
a rounded gate moves the exp gates by about 1%).
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import gla_chunk as GC  # noqa: E402
from repro_torch.kernels import latent_decode_attention as LA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PA  # noqa: E402
from repro_torch.kernels import slstm_scan as SL  # noqa: E402
from repro_torch.kernels.timing import graph_kernels  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.serving.engine import ServeEngine, Server  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# the decode's split lengths: 128 positions at head dim 64 (and 32), 64 at 128
S64, S128 = DA.split_len(64), DA.split_len(128)
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
    # q's strides, or at v's narrower width q's dimension order
    assert out.stride() == FA._empty_rows(q, v.shape[-1]).stride()
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
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 5, 7, 16])
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


def _decode_calls(cuda, dtype, D=64, G=4):
    """One call each of K2, K2 over a ring and K3 at small shapes (head dim
    ``D``, ``G`` query heads a KV head), as closures over fixed inputs; with
    their launch counters."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, H, K, S = 2, 2 * G, 2, 300
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


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_kernels_are_deterministic_across_launches(cuda, kind, dtype, D):
    fn, _, _ = _decode_calls(cuda, dtype, D)[kind]
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_kernels_replay_in_a_cuda_graph(cuda, kind, D):
    """Three calls captured in one graph and replayed three times equal the
    eager calls bit for bit: each launch leaves its ticket counters at 0."""
    fn, _, _ = _decode_calls(cuda, torch.bfloat16, D)[kind]
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


@pytest.mark.parametrize("D", [64, 128])
def test_decode_graph_replays_after_the_counters_grow(cuda, D):
    """A graph captured before a larger launch grows the ticket counters
    still replays equal to the eager call (the outgrown buffer stays
    allocated), and a capture that would need more counters raises."""
    fn, _, _ = _decode_calls(cuda, torch.bfloat16, D)["decode"]
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


@pytest.mark.parametrize("G", [4, 3, 7])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_kernels_are_one_launch_per_call(cuda, kind, D, G):
    """One bf16 call is one decode kernel node of a CUDA graph captured
    around it (the paged call's length clamp is a node of its own), the
    kernel ``DA.kernel`` names for (D, G) (the tensor-core kernel at every G
    > 1 here), and the wrapper's count moves by one a call."""
    fn, counter, mod = _decode_calls(cuda, torch.bfloat16, D, G)[kind]
    n0 = getattr(mod, counter)
    nodes = [n for n, _, _ in graph_kernels(fn) if re.search(r"decode_(mma_|g1_)?kernel", n)]
    assert getattr(mod, counter) == n0 + 2        # the warm-up call and the captured one
    want = DA.kernel(torch.bfloat16, D, G)
    assert len(nodes) == 1 and re.search(rf"decode_split\d+{want}ILi{D}E", nodes[0]), nodes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length,window", [(1, None), (S64, None),
                                           (S64 + 1, None), (300, None), (300, 50)])
@pytest.mark.parametrize("H,K", [(8, 2), (DA.MAX_G, 1), (4, 4), (6, 2), (14, 2)])
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
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("n,extra,window", [(16, 0, None), (16, 1, None), (40, 0, None),
                                            (40, 0, 1000), (70, 5, None)])
def test_decode_kernel_long_cache(cuda, n, extra, window, dtype, D):
    """More splits than the combine's one load batch (16), and at D = 128
    more than its two in registers a lane (64): the longer passes run."""
    B, H, K = 2, 8, 2
    length = n * DA.split_len(D) + extra
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
@pytest.mark.parametrize("lengths,window", [([1, 16], None), ([S64, 300], None),
                                            ([300, S64 + 1], 50), ([0, 17], None),
                                            ([S128 - 1, S128 + 1], None), ([S128, 0], 20)])
@pytest.mark.parametrize("H,K,D", [(8, 2, 64), (DA.MAX_G, 1, 32), (4, 4, 64), (10, 2, 128),
                                   (40, 8, 128), (6, 2, 64), (24, 8, 64), (14, 2, 128),
                                   (56, 8, 128)])
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
@pytest.mark.parametrize("length,window", [(1, None), (S64, None), (300, None),
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


def _gla_one_launch_profile(schedule):
    """The profiled calls of test_gla_kernels_are_one_launch_per_call, run
    as ``python -c`` in a process of its own: prints, as JSON, the GLA
    kernels the profiler saw over 6 calls with their counts, and the
    wrappers' launch counts over those calls."""
    cuda = torch.device("cuda")
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
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0
            and "gla_" in e.key}
    launches = [b - a for a, b in zip(n0, (GC.launches, GC.launches_a, GC.launches_b))]
    print(json.dumps({"seen": seen, "launches": launches}))


@pytest.mark.parametrize("schedule,names", [("chunk", ("gla_chunk_kernel",)),
                                            ("parallel", ("gla_phase_a_kernel",
                                                          "gla_phase_b_kernel"))])
def test_gla_kernels_are_one_launch_per_call(cuda, schedule, names):
    """The profiler sees one K4 kernel per chunk-schedule call, one of each
    phase per parallel-schedule call, and no other GLA kernel, over 6 calls
    back to back (as ``chip_smoke.kernel_us`` profiles them: after a
    warm-up step, since the tracer may drop the records of the first
    launches after it starts). The wrappers count 6 launches each. The
    calls are profiled in a fresh process: in one whose card sat idle for a
    while (a minute of kernel builds, or a sleep), the tracer kept 2 or 3
    of the window's 6 records on an H100 (``tools/profiler_drops.py``)."""
    here = Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(here)!r}, {str(Path(GC.__file__).parents[2])!r}]; "
            "import test_torch_gpu as T; T._gla_one_launch_profile(sys.argv[1])")
    out = subprocess.run([sys.executable, "-c", code, schedule], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    seen = got["seen"]
    assert got["launches"] == ([6, 0, 0] if schedule == "chunk" else [0, 6, 6])
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
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 5, 7])
@pytest.mark.parametrize("S,window", [(256, None), (200, None), (77, None), (300, 50),
                                      (130, 64), (127, None), (128, None), (129, None),
                                      (255, None), (257, None), (129, 9), (255, 100),
                                      (257, 200), (300, 129)])
def test_flash_bwd_matches_plain(cuda, S, window, G, D, dtype):
    """The 128-row blocks' and 64-row tiles' edges (S around 128 and 256),
    windows narrower and wider than a block, every head dim (the 64- and
    128-byte swizzles, each tile read K-major and MN-major; at 128 each
    tile two 64-column halves, dQ's blocks 128 rows and dK/dV's 64)."""
    q, k, v, do = _bwd_inputs(cuda, 2, 2 * G, 2, S, D, dtype, seed=S + G + D)
    _bwd_held(q, k, v, do, window, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_at_granite_shape(cuda, dtype):
    q, k, v, do = _bwd_inputs(cuda, 1, 32, 8, 1024, 64, dtype, seed=3)
    _bwd_held(q, k, v, do, None, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [1024, None])
def test_flash_bwd_at_hymba_shape(cuda, window, dtype):
    """hymba's training shape: G = 5 (25 query heads over 5 KV heads), S
    1536, its 29 window-1024 layers and 3 global ones."""
    q, k, v, do = _bwd_inputs(cuda, 4, 25, 5, 1536, 64, dtype, seed=21)
    _bwd_held(q, k, v, do, window, dtype)


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


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_launch_from_a_fresh_host_thread(cuda, dtype, D):
    """The autograd engine runs a backward on its own thread, whose first
    CUDA call it may be: the backward, and the forward, launched from a
    thread that has made no CUDA call give the main thread's bits."""
    import threading
    q, k, v, do = _bwd_inputs(cuda, 2, 8, 2, 200, D, dtype, seed=15)
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
    return (FA.launches, FA.bwd_dq_launches, FA.bwd_dkdv_launches, GC.launches,
            GC.bwd_launches)


@pytest.mark.parametrize("arch", ["granite-3-2b", "hymba-1.5b", "xlstm-350m"])
def test_smoke_train_step_on_card_matches_plain_path(cuda, deterministic_restored, arch):
    """One float32 smoke-size step's loss and gradients on the card (K1's
    forward twice a layer under remat, the backward kernels once; hymba's
    K4 twice a layer and its backward once; xLSTM's sLSTM serving kernel
    in the checkpoint's first pass, its training forward in the recompute
    and its backward once a pair, no attention) against the same
    step with the plain versions under autograd on the card: max |a - b| /
    max |b| <= 1e-4 per leaf (float32, the kernels' sums in another order,
    as the CPU parity tests)."""
    from repro_torch import steps as ST
    from repro_torch.data import synth_batch
    from repro_torch.launch.train import Trainer
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves
    cfg = smoke_config(arch)
    tr = Trainer(cfg, batch_size=2, seq_len=48, device=cuda)
    tr.pipeline.stop()
    assert torch.are_deterministic_algorithms_enabled()
    tr.init_state()
    batch = tr._device_batch(synth_batch(cfg, 2, 48, 1, 0))
    n0, L = _counts(), cfg.n_layers
    ssd = L if arch == "hymba-1.5b" else 0
    attn = 0 if arch == "xlstm-350m" else L
    pairs = L // 2 if arch == "xlstm-350m" else 0
    step = (n0[0] + 2 * attn, n0[1] + attn, n0[2] + attn, n0[3] + 2 * ssd, n0[4] + ssd)
    s0 = (SL.launches, SL.train_launches, SL.bwd_launches)
    s1 = (s0[0] + pairs, s0[1] + pairs, s0[2] + pairs)
    grads, total, _, _ = ST.loss_and_grads(tr.model, tr.params, batch)
    assert _counts() == step and (SL.launches, SL.train_launches, SL.bwd_launches) == s1
    want, want_total, _, _ = ST.loss_and_grads(Model(cfg, force="ref"), tr.params, batch)
    assert _counts() == step and (SL.launches, SL.train_launches, SL.bwd_launches) == s1
    assert abs(total.item() - want_total.item()) <= 1e-5 * abs(want_total.item())
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_remat_step_on_card_equals_the_step_without(cuda, deterministic_restored, dtype):
    """A two-pair xLSTM step under remat launches the sLSTM's serving kernel
    in each checkpoint's first pass, its training forward in the recompute
    and its backward once (2 + 2 + 2), and gives the loss and gradients of
    the same step with remat off (one training forward and one backward a
    pair) bit for bit, under the trainer's deterministic mode."""
    import dataclasses

    from repro_torch import steps as ST
    from repro_torch.data import synth_batch
    from repro_torch.launch.train import Trainer
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves
    cfg = dataclasses.replace(smoke_config("xlstm-350m"), param_dtype=dtype,
                              compute_dtype=dtype)
    assert cfg.n_layers == 4 and cfg.remat
    tr = Trainer(cfg, batch_size=2, seq_len=48, device=cuda)
    tr.pipeline.stop()
    assert torch.are_deterministic_algorithms_enabled()
    tr.init_state()
    batch = tr._device_batch(synth_batch(cfg, 2, 48, 1, 0))
    got = {}
    for remat in (True, False):
        s0 = (SL.launches, SL.train_launches, SL.bwd_launches)
        got[remat] = ST.loss_and_grads(Model(dataclasses.replace(cfg, remat=remat)),
                                       tr.params, batch)
        n = (SL.launches - s0[0], SL.train_launches - s0[1], SL.bwd_launches - s0[2])
        assert n == ((2, 2, 2) if remat else (0, 2, 2))
    (g_on, total_on, _, _), (g_off, total_off, _, _) = got[True], got[False]
    assert torch.equal(total_on, total_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["granite-3-2b", "hymba-1.5b", "xlstm-350m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_train_kill_and_recover_on_card_is_byte_identical(cuda, tmp_path, dtype,
                                                                deterministic_restored, arch):
    """Six steps with a checkpoint every 3: a run whose last rank dies at
    step 4 and restarts under exampi ends with the params and optimizer
    state of an uninterrupted run, byte for byte."""
    from dataclasses import replace

    from repro_torch.launch.train import Trainer
    from repro_torch.models.params import tree_leaves
    cfg = replace(smoke_config(arch), param_dtype=dtype, compute_dtype=dtype)

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


# -- the GLA backward (K4b) --------------------------------------------------------

# max |a - b| / max |b| per gradient: bf16 2e-2 (dv's products take the
# decayed q.k rounded to bf16, as K4 rounds its probabilities, and dv is
# bf16 on output; dq and dk are float32 to about 16 bits through the hi/lo
# split); float32 1e-4 (exact scalar products in another order; dlg is a
# difference of per-row dots summed over up to S positions)
GLA_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _gla_bwd_held(q, k, v, lg, chunk, dtype, seed):
    """K4's chunk start states against the plain ones (K4's tolerance), y
    and the final state unchanged with them on, then K4b against
    ``ref.gla_bwd`` on the same inputs, and a second run equal bit for bit;
    then the same through the shared-row route: q and k as one [B,S,N] row
    for every head (head 0's), dq and dk returned as such rows in q's dtype
    and held to ``ref.gla_bwd``'s per-head rows summed over the heads in
    float32."""
    g = torch.Generator(device=q.device).manual_seed(seed)
    dy = torch.randn(v.shape, generator=g, device=q.device).to(dtype)
    y, fin, starts = GC.gla_chunk(q, k, v, lg, chunk=chunk, starts=True)
    _gla_close(starts, ref.chunked_gla(q, k, v, lg, chunk=chunk, starts=True)[2], dtype)
    y0, fin0 = GC.gla_chunk(q, k, v, lg, chunk=chunk)
    assert torch.equal(y, y0) and torch.equal(fin, fin0)
    n0, per = GC.bwd_launches, GC.BWD_LAUNCHES if dtype == torch.bfloat16 else 1
    got = GC.gla_chunk_bwd(q, k, v, lg, dy, starts, chunk=chunk)
    assert GC.bwd_launches == n0 + per
    want = ref.gla_bwd(q, k, v, lg, dy, starts, chunk=chunk)
    for name, a, b in zip(("dq", "dk", "dv", "dlg"), got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel(a, b) <= GLA_BWD_TOL[dtype], (name, _rel(a, b))
    assert got[2].dtype == v.dtype and got[3].dtype == torch.float32
    again = GC.gla_chunk_bwd(q, k, v, lg, dy, starts, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the shared-row route
    B, S, H, N = q.shape
    q0, k0 = q[:, :, 0], k[:, :, 0]
    qe, ke = (x[:, :, None].expand(B, S, H, N) for x in (q0, k0))
    starts = GC.gla_chunk(qe, ke, v, lg, chunk=chunk, starts=True)[2]
    got = GC.gla_chunk_bwd(q0, k0, v, lg, dy, starts, chunk=chunk)
    assert GC.bwd_launches == n0 + 3 * per
    want = ref.gla_bwd(qe, ke, v, lg, dy, starts, chunk=chunk)
    want = (want[0].float().sum(2), want[1].float().sum(2)) + want[2:]
    for name, a, b in zip(("dq", "dk", "dv", "dlg"), got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel(a, b) <= GLA_BWD_TOL[dtype], (name, _rel(a, b))
    assert got[0].dtype == got[1].dtype == q.dtype
    again = GC.gla_chunk_bwd(q0, k0, v, lg, dy, starts, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _bwd_parts(dtype=torch.bfloat16, B=4, H=25, S=1536, N=16, P=64, chunk=256, seed=6):
    """One shared-row K4b call's outputs and its launches' scratch, beside
    the inputs and ``ref.gla_bwd``'s per-head rows (for the launch tests),
    at hymba's training shape: heads in 5 groups of 5."""
    cuda = torch.device("cuda")
    q, k, v, lg = _gla_inputs(cuda, B, H, S, N, P, dtype, seed=seed, broadcast=True)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(v.shape, generator=g, device=cuda).to(dtype)
    starts = GC.gla_chunk(q, k, v, lg, chunk=chunk, starts=True)[2]
    got = GC._bwd(q[:, :, 0], k[:, :, 0], v, lg, dy, starts, chunk=chunk)
    want = ref.gla_bwd(q, k, v, lg, dy, starts, chunk=chunk)
    return (q, k, v, lg, dy, chunk), got, want


def test_gla_bwd_state_pass_matches_plain(cuda):
    """The reversed state pass (every chunk's increment, walked into dS_z
    by the dq launch's first blocks) against ``ref.gla_bwd_states``, and
    the chunks' cum log2(e) and 64-row tiles' factors it writes."""
    (q, k, v, lg, dy, chunk), got, _ = _bwd_parts()
    scr = got[4]
    assert _rel(scr["dstate"], ref.gla_bwd_states(q, lg, dy, chunk=chunk)) <= \
        GLA_BWD_TOL[torch.bfloat16]
    B, S, H = lg.shape
    cum = lg.float().reshape(B, S // chunk, chunk, H).cumsum(2).reshape(B, S, H)
    torch.testing.assert_close(scr["cl"], cum.transpose(1, 2) * 1.4426950408889634,
                               rtol=1e-5, atol=1e-4)
    # the tiles' factors from the launch's own cl (its sums run in another
    # order than cumsum's; ex2 is within a few ulps)
    cl, x = scr["cl"], torch.arange(S, device=lg.device) % chunk
    x0 = torch.arange(S, device=lg.device) - x % 64          # the row's tile's first row
    x1 = torch.minimum(x0 + 63, torch.arange(S, device=lg.device) - x + chunk - 1)
    torch.testing.assert_close(scr["fwd"], torch.exp2(cl - cl[..., x0]), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(scr["bwd"], torch.exp2(cl[..., x1] - cl), rtol=1e-5, atol=1e-6)


def test_gla_bwd_dq_launch_matches_plain(cuda):
    """dq: the heads' sum of the shared row's gradient, and each head's q .
    dq row (rq) that dlg takes, against the plain per-head rows."""
    (q, k, v, lg, dy, chunk), got, want = _bwd_parts()
    assert _rel(got[0], want[0].float().sum(2)) <= GLA_BWD_TOL[torch.bfloat16]
    rq = (q.float() * want[0].float()).sum(-1).transpose(1, 2)
    assert _rel(got[4]["rq"], rq) <= GLA_BWD_TOL[torch.bfloat16]


def test_gla_bwd_dkdv_launch_matches_plain(cuda):
    """dk (the heads' sum), dv and each head's k . dk row (rk)."""
    (q, k, v, lg, dy, chunk), got, want = _bwd_parts()
    assert _rel(got[1], want[1].float().sum(2)) <= GLA_BWD_TOL[torch.bfloat16]
    assert _rel(got[2], want[2]) <= GLA_BWD_TOL[torch.bfloat16]
    rk = (k.float() * want[1].float()).sum(-1).transpose(1, 2)
    assert _rel(got[4]["rk"], rk) <= GLA_BWD_TOL[torch.bfloat16]


def test_gla_bwd_finish_matches_plain(cuda):
    """The finish: dlg the suffix sums of the launches' own rq - rk (float32
    sums in another order: 1e-5 of the largest), and dq and dk the head
    groups' partials added in group order in float32, then bf16: equal bit
    for bit."""
    _, got, _ = _bwd_parts()
    scr = got[4]
    assert scr["dqp"].shape[0] == 5
    r = (scr["rq"] - scr["rk"]).double()
    dlg = r.flip(-1).cumsum(-1).flip(-1).transpose(1, 2)
    assert _rel(got[3], dlg) <= 1e-5
    for out, part in ((got[0], scr["dqp"]), (got[1], scr["dkp"])):
        acc = torch.zeros_like(part[0])
        for x in part:
            acc = acc + x
        assert torch.equal(out, acc.to(out.dtype))


GLA_BWD_CASES = [(2, 3, 64, 8, 32, 16, False), (1, 2, 40, 8, 32, 16, True),   # 40: chunk 8
                 (1, 2, 96, 16, 64, 64, False), (2, 2, 512, 16, 64, 256, True),  # 96: chunk 32
                 (1, 2, 1000, 16, 64, 256, True)]                               # 1000: chunk 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,S,N,P,chunk,broadcast", GLA_BWD_CASES)
def test_gla_bwd_kernel_matches_plain(cuda, B, H, S, N, P, chunk, broadcast, dtype):
    q, k, v, lg = _gla_inputs(cuda, B, H, S, N, P, dtype, seed=S + N, broadcast=broadcast)
    _gla_bwd_held(q, k, v, lg, chunk, dtype, seed=S)


@pytest.mark.parametrize("N,P", [(8, 32), (16, 64)])
@pytest.mark.parametrize("c", [1, 8, 16, 24, 64, 256])
def test_gla_bwd_bf16_kernel_at_every_chunk_length(cuda, c, N, P):
    """Chunks of one row, below a 16-row tile, one tile, a ragged tile, and
    up to the serving chunk."""
    q, k, v, lg = _gla_inputs(cuda, 2, 2, 3 * c, N, P, torch.bfloat16, seed=c,
                              broadcast=True)
    _gla_bwd_held(q, k, v, lg, c, torch.bfloat16, seed=c)


@pytest.mark.parametrize("S,N,P,chunk", [(512, 16, 64, 256), (192, 8, 32, 64)])
def test_gla_bwd_bf16_kernel_under_steep_decays(cuda, S, N, P, chunk):
    q, k, v, lg = _gla_inputs(cuda, 2, 2, S, N, P, torch.bfloat16, seed=S, broadcast=True,
                              steep=True)
    _gla_bwd_held(q, k, v, lg, chunk, torch.bfloat16, seed=S)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gla_bwd_at_hymba_training_shape(cuda, dtype):
    q, k, v, lg = _gla_inputs(cuda, 4, 25, 1536, 16, 64, dtype, seed=1, broadcast=True)
    _gla_bwd_held(q, k, v, lg, 256, dtype, seed=2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gla_autograd_function_matches_plain_autograd(cuda, dtype):
    """ops.gla under autograd on the card (GLAChunk: K4 with its chunk
    start states, then K4b; q and k passed as the rows the heads share, and
    their gradients come back as such rows from K4b) against autograd of
    the plain version on the card (the rows expanded inside, the expand's
    backward summing the heads)."""
    q, k, v, lg = _gla_inputs(cuda, 2, 3, 200, 16, 64, dtype, seed=4, broadcast=True)
    row = q[:, :, 0].detach().clone().requires_grad_()
    kr = k[:, :, 0].detach().clone().requires_grad_()
    vv, ll = v.detach().clone().requires_grad_(), lg.detach().clone().requires_grad_()
    w = torch.randn(v.shape, device=cuda).to(dtype)

    def grads(force):
        y, _ = ops.gla(row, kr, vv, ll, chunk=64, force=force)   # the rows unexpanded
        return torch.autograd.grad((y.float() * w.float()).sum(), (row, kr, vv, ll))
    n0 = (GC.launches, GC.bwd_launches)
    n1 = (n0[0] + 1, n0[1] + (GC.BWD_LAUNCHES if dtype == torch.bfloat16 else 1))
    got = grads(None)
    assert (GC.launches, GC.bwd_launches) == n1
    want = grads("ref")
    assert (GC.launches, GC.bwd_launches) == n1
    for name, a, b in zip(("dq", "dk", "dv", "dlg"), got, want):
        assert a.dtype == b.dtype and _rel(a, b) <= GLA_BWD_TOL[dtype], (name, _rel(a, b))


def test_gla_autograd_backward_is_k4b_alone(cuda):
    """On the bf16 kernel route the shared rows' gradients come back from
    K4b as [B,S,N] rows in q's dtype, and the backward launches K4b's four
    kernels and nothing else (no cast or sum pass over per-head rows, no
    zeros for the final state's gradient): over 6 backward calls the
    profiler sees each of those kernels and no other, none more than 6
    times (it may drop records, as test_gla_kernels_are_one_launch_per_call
    notes; the counts are held exactly by chip_smoke.py's K4b timing)."""
    q, k, v, lg = _gla_inputs(cuda, 2, 5, 512, 16, 64, torch.bfloat16, seed=9, broadcast=True)
    row = q[:, :, 0].detach().clone().requires_grad_()
    kr = k[:, :, 0].detach().clone().requires_grad_()
    vv, ll = v.detach().clone().requires_grad_(), lg.detach().clone().requires_grad_()
    w = torch.randn(v.shape, device=cuda).to(v.dtype)
    y, _ = ops.gla(row, kr, vv, ll, chunk=256)
    grads = torch.autograd.grad(y, (row, kr, vv, ll), w, retain_graph=True)  # builds
    torch.cuda.synchronize()
    assert grads[0].shape == row.shape and grads[0].dtype == row.dtype
    assert grads[1].shape == kr.shape and grads[1].dtype == kr.dtype
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                                 active=1, repeat=1)) as prof:
        torch.autograd.grad(y, (row, kr, vv, ll), w, retain_graph=True)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(6):
            torch.autograd.grad(y, (row, kr, vv, ll), w, retain_graph=True)
        torch.cuda.synchronize()
        prof.step()
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0}
    names = ("gla_bwd_state_kernel", "gla_bwd_dq_kernel", "gla_bwd_dkdv_kernel",
             "gla_bwd_finish_kernel")
    for n in names:
        assert any(n + "<" in key for key in seen), (n, seen)
    for key, cnt in seen.items():
        assert any(n + "<" in key for n in names) and cnt <= 6, seen


def test_gla_bwd_refuses_what_it_does_not_take(cuda):
    q, k, v, lg = _gla_inputs(cuda, 1, 2, 64, 16, 64, torch.bfloat16, seed=3)
    _, _, starts = GC.gla_chunk(q, k, v, lg, chunk=16, starts=True)
    dy = torch.zeros_like(v)
    with pytest.raises(ValueError, match="starts"):
        GC.gla_chunk_bwd(q, k, v, lg, dy, starts[:, :, :2], chunk=16)
    with pytest.raises(ValueError, match="dy"):
        GC.gla_chunk_bwd(q, k, v, lg, dy.float(), starts, chunk=16)
    with pytest.raises(ValueError, match="not in"):
        GC.gla_chunk_bwd(q[..., :12], k[..., :12], v, lg, dy, starts, chunk=16)
    with pytest.raises(ValueError, match="both"):
        GC.gla_chunk_bwd(q[:, :, 0], k, v, lg, dy, starts, chunk=16)


# -- head dim 128 (qwen2.5-14b: G = 5; minicpm-2b runs at head dim 64, G = 1) -------

def _padded_views(cuda, B, H, K, S, D, dtype, seed):
    """q, k, v as [B,n,S,D] views whose rows start 16 bytes past a 128-byte
    boundary: each a slice of a [B,S,n*D + pad] row, pad 16 bytes (strided
    views as a fused projection passes them; the TMA needs only 16)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    pad = 16 // torch.empty((), dtype=dtype).element_size()
    out = []
    for n in (H, K, K):
        row = torch.randn(B, S, n * D + pad, generator=g, device=cuda).to(dtype)
        x = row[..., pad:].unflatten(-1, (n, D)).transpose(1, 2)
        assert x.data_ptr() % 128 == 16 and x.stride(2) * x.element_size() % 128
        out.append(x)
    return tuple(out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_at_head_dim_128_take_rows_on_16_bytes(cuda, dtype):
    """Rows 16- but not 128-byte aligned give a contiguous copy's bits, in
    the forward (and its logsumexp) and the backward."""
    q, k, v = _padded_views(cuda, 2, 10, 2, 200, 128, dtype, seed=3)
    o, lse = FA.flash_attention(q, k, v, window=77, lse=True)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    oc, lsec = FA.flash_attention(qc, kc, vc, window=77, lse=True)
    assert torch.equal(o, oc) and torch.equal(lse, lsec)
    _close(o, ref.naive_attention(q, k, v, window=77), dtype)
    g = torch.Generator(device=cuda).manual_seed(4)
    do = torch.randn(2, 200, 10 * 128 + 8, generator=g, device=cuda).to(dtype)
    do = do[..., 8:].unflatten(-1, (10, 128)).transpose(1, 2)
    assert FA._rows_ok(do)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do, window=77)
    b = FA.flash_attention_bwd(qc, kc, vc, oc, lsec, do.contiguous(), window=77)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _bwd_held(q, k, v, do, 77, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("S", [31, 32, 33, 127, 128, 129, 1000, 1024])
def test_flash_bwd_at_head_dim_128_tile_edges(cuda, S, window, dtype):
    """dK/dV at D = 128 streams 32-row query tiles past 128-row KV blocks
    (two warpgroups of 64 rows): S on both sides of each edge, with and
    without a window, G = 5; two runs equal bit for bit."""
    q, k, v, do = _bwd_inputs(cuda, 2, 10, 2, S, 128, dtype, seed=S + 7)
    _bwd_held(q, k, v, do, window, dtype)
    o, lse = FA.flash_attention(q, k, v, window=window, lse=True)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_at_qwen_shape(cuda, dtype):
    """qwen2.5-14b's training shape, one row of the batch: 40 query heads
    over 8 KV heads, S 1024, D 128; two runs equal bit for bit."""
    q, k, v, do = _bwd_inputs(cuda, 1, 40, 8, 1024, 128, dtype, seed=23)
    _bwd_held(q, k, v, do, None, dtype)
    o, lse = FA.flash_attention(q, k, v, lse=True)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length,window", [(1, None), (S128 - 1, None), (S128, None),
                                           (S128 + 1, None), (300, None), (300, 50),
                                           (1056, None), (1056, 70)])
@pytest.mark.parametrize("H,K", [(10, 2), (4, 4), (DA.MAX_G, 1), (14, 2), (56, 8)])
def test_decode_kernel_at_head_dim_128(cuda, length, window, dtype, H, K):
    """K2 at D = 128 around its 64-position split (bf16 on the tensor
    cores; a float32 row is the whole warp, its positions in two batches of
    loads), qwen's G = 5, G = 1 and the largest G."""
    B, S, D = 2, 1056, 128
    g = torch.Generator(device=cuda).manual_seed(length + H)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, K, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    n0 = DA.launches
    out = ops.decode_attention(q, k, v, length, window=window)
    assert DA.launches == n0 + 1
    _close(out, ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                           length, window=window), dtype)
    assert torch.equal(out, ops.decode_attention(q, k, v, length, window=window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("W,window,pos", [(64, 64, 40), (64, 64, 300), (300, 256, 1000)])
def test_ring_decode_kernel_at_head_dim_128(cuda, W, window, pos, dtype):
    g = torch.Generator(device=cuda).manual_seed(pos)
    q = torch.randn(2, 10, 128, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, W, 2, 128, generator=g, device=cuda).to(dtype) for _ in range(2))
    _close(DA.ring_decode_attention(q, k, v, pos, window=window),
           ref.naive_ring_decode_attention(q, k, v, pos, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,K", [(40, 8), (4, 4), (DA.MAX_G, 1)])
@pytest.mark.parametrize("length,window", [(1, None), (S128 - 1, None), (S128, None),
                                           (S128 + 1, None), (1000, None), (300, 50),
                                           (1056, None)])
def test_paged_kernel_at_head_dim_128_over_in_order_pages_equals_contiguous(
        cuda, length, window, dtype, H, K):
    B, D, page, S = 2, 128, 16, 1056
    g = torch.Generator(device=cuda).manual_seed(length)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, K, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    n = S // page
    table = torch.arange(B * n, dtype=torch.int32, device=cuda).view(B, n)
    lens = torch.full((B,), length, dtype=torch.int32, device=cuda)
    paged = PA.paged_decode_attention(q, k.view(B * n, page, K, D), v.view(B * n, page, K, D),
                                      table, lens, window=window)
    assert torch.equal(paged, DA.decode_attention(q, k, v, length, window=window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,K", [(40, 8), (4, 4), (DA.MAX_G, 1)])
@pytest.mark.parametrize("lengths,window", [([1, S128 - 1], None), ([S128, S128 + 1], None),
                                            ([1056, 300], None), ([1056, 0], 50)])
def test_paged_kernel_at_head_dim_128_over_shuffled_pages(cuda, lengths, window, dtype, H,
                                                          K):
    """K3 at D = 128 over a 3-layer store's strided view and a shuffled
    table, around the 64-position split, G = 5, 1 and 16."""
    q, kp, vp, table, lens = _paged_inputs(cuda, 2, H, K, 128, 3, 1, lengths, 16, dtype,
                                           seed=sum(lengths) + H)
    n0 = PA.launches
    out = PA.paged_decode_attention(q, kp, vp, table, lens, window=window)
    assert PA.launches == n0 + 1
    _close(out, ref.naive_paged_decode_attention(q, kp, vp, table, lens, window=window),
           dtype)
    assert torch.equal(out, PA.paged_decode_attention(q, kp, vp, table, lens, window=window))


def _qwen_d128(dtype="float32"):
    """qwen2.5-14b's smoke config at head dim 128 (2 layers, 4/2 heads)."""
    from dataclasses import replace
    return replace(smoke_config("qwen2.5-14b"), head_dim=128, n_layers=2,
                   param_dtype=dtype, compute_dtype=dtype, cache_dtype=dtype)


def _biased(params):
    """Non-zero q/k/v biases (the spec initialises them to zeros)."""
    g = torch.Generator(device=params["embed"].device).manual_seed(5)
    for name in ("bq", "bk", "bv"):
        b = params["segments"][0]["attn"][name]
        b.copy_(0.5 * torch.randn(b.shape, generator=g, device=b.device).to(b.dtype))
    return params


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2.5-14b", "qwen2.5-14b-d128",
                                  "llava-next-34b", "granite-moe-3b-a800m"])
def test_dense_family_smoke_server_on_card_matches_cpu(cuda, arch):
    """A smoke prefill launches K1 once a layer and a decode step K2 once a
    layer, and the card's logits and greedy stream equal the CPU's plain
    path's (float32, non-zero biases for qwen, llava's image, the MoE
    layer's capacity dispatch and its top-k decode)."""
    cfg = _qwen_d128() if arch.endswith("d128") else smoke_config(arch)
    gpu = Server(cfg, device=cuda, seed=0)
    if cfg.qkv_bias:
        _biased(gpu.params)
    cpu = Server(cfg, device="cpu", params=tree_map(lambda t: t.cpu(), gpu.params))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (2, 12))
    pe = rng.standard_normal((2, cfg.img_tokens, 1024)).astype(np.float32) \
        if cfg.img_tokens else None
    n0 = (FA.launches, DA.launches)
    lg = gpu.prefill(prompt, pe, pad_to=20)
    assert (FA.launches, DA.launches) == (n0[0] + cfg.n_layers, n0[1])
    lc = cpu.prefill(prompt, pe, pad_to=20)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    first = np.argmax(lc[:, : cfg.vocab_size].numpy(), -1)
    n0 = (FA.launches, DA.launches)
    tg, _ = gpu.decode(1, first)
    assert (FA.launches, DA.launches) == (n0[0], n0[1] + cfg.n_layers)
    tg2, _ = gpu.decode(5, tg[-1])
    tc, _ = cpu.decode(6, first)
    np.testing.assert_array_equal(np.stack(tg + tg2), np.stack(tc))


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2.5-14b-d128", "llava-next-34b",
                                  "granite-moe-3b-a800m"])
def test_dense_family_smoke_train_step_on_card_matches_plain_path(cuda, deterministic_restored,
                                                                  arch):
    """One float32 step at D = 128 (qwen, non-zero biases), at minicpm's
    G = 1, with llava's image and through the MoE layer under
    deterministic algorithms: 2 K1 forwards a layer, one of each backward
    kernel, the gradients within 1e-4 of the plain path's per leaf."""
    from repro_torch import steps as ST
    from repro_torch.data import synth_batch
    from repro_torch.launch.train import Trainer
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves
    cfg = _qwen_d128() if arch.endswith("d128") else smoke_config(arch)
    tr = Trainer(cfg, batch_size=2, seq_len=48, device=cuda)
    tr.pipeline.stop()
    tr.init_state()
    if cfg.qkv_bias:
        _biased(tr.params)
    batch = tr._device_batch(synth_batch(cfg, 2, 48, 1, 0))
    n0, L = _counts(), cfg.n_layers
    grads, total, _, _ = ST.loss_and_grads(tr.model, tr.params, batch)
    assert _counts() == (n0[0] + 2 * L, n0[1] + L, n0[2] + L, n0[3], n0[4])
    want, want_total, _, _ = ST.loss_and_grads(Model(cfg, force="ref"), tr.params, batch)
    assert abs(total.item() - want_total.item()) <= 1e-5 * abs(want_total.item())
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        assert _rel(a, b) <= 1e-4


# -- K1 at head dim 128 on a producer warpgroup and two consumer warpgroups
#    that take turns (128-row KV tiles); the bf16 decode at G = 1 (minicpm-2b)
#    on its own kernel, whose blocks walk the (row, KV head, split) items ----

@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 255, 256, 1000, 1024, 1536])
def test_flash_d128_kernel_at_tile_edges(cuda, S):
    """bf16 K1 at D = 128: 128-row query blocks of two 64-row warpgroups
    over 128-row KV tiles, S on both sides of each edge, G = 5, the model's
    strided views; the logsumexp against the plain one, and the output with
    it written equal to the prefill's bit for bit."""
    q, k, v = _flash_views(cuda, 2, 10, 2, S, 128, torch.bfloat16, seed=S + 128)
    _flash_held(q, k, v, None, torch.bfloat16)
    o, lse = FA.flash_attention(q, k, v, lse=True)
    torch.testing.assert_close(lse, ref.naive_attention_lse(q, k), rtol=0, atol=LSE_TOL)
    assert torch.equal(o, FA.flash_attention(q, k, v))


@pytest.mark.parametrize("window", [1, 63, 64, 65, 127, 128, 129, 200, 1000])
@pytest.mark.parametrize("G", [1, 5, 8, 16])
def test_flash_d128_kernel_windows_and_groups(cuda, window, G):
    """Windows narrower and wider than a KV tile and a query block (a tile
    outside one warpgroup's window is masked whole; its rows start with no
    valid key), and G = 1, 5, 8, 16 query heads a KV head; the logsumexp."""
    q, k, v = _flash_views(cuda, 1, 2 * G, 2, 600, 128, torch.bfloat16, seed=window + G)
    _flash_held(q, k, v, window, torch.bfloat16)
    _, lse = FA.flash_attention(q, k, v, window=window, lse=True)
    torch.testing.assert_close(lse, ref.naive_attention_lse(q, k, window=window), rtol=0,
                               atol=LSE_TOL)


def test_flash_d128_kernel_is_deterministic(cuda):
    """Two launches at qwen2.5-14b's prefill shape (one row) give equal bits."""
    q, k, v = _flash_views(cuda, 1, 40, 8, 1024, 128, torch.bfloat16, seed=40)
    a = FA.flash_attention(q, k, v, lse=True)
    b = FA.flash_attention(q, k, v, lse=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _close(a[0], ref.naive_attention(q, k, v), torch.bfloat16)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("length,window", [
    (1, None), (S64 - 1, None), (S64, None), (S64 + 1, None), (1000, None), (1056, None),
    (16 * S64, None), (16 * S64 + 1, None), (40 * S64 + 7, None), (1056, 50), (1056, 200),
    (40 * S64 + 7, 1000)])
def test_decode_g1_kernel_matches_plain(cuda, length, window, D):
    """bf16 K2 at G = 1 (minicpm-2b: one query head a KV head) around its
    128-position split, over more splits than the combine's load batch
    (16) and than a warp's lanes (32), with windows; one launch, two calls
    bit-equal."""
    B, H = 2, 4
    g = torch.Generator(device=cuda).manual_seed(length + D)
    q = torch.randn(B, H, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, length + 3, H, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    n0 = DA.launches
    out = ops.decode_attention(q, k, v, length, window=window)
    assert DA.launches == n0 + 1
    _close(out, ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                           length, window=window), torch.bfloat16)
    assert torch.equal(out, ops.decode_attention(q, k, v, length, window=window))


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("W,window,pos", [(64, 64, 40), (1024, 1024, 1567), (300, 256, 1000),
                                          (2100, 2100, 2099)])
def test_ring_decode_g1_kernel_matches_plain(cuda, W, window, pos, D):
    g = torch.Generator(device=cuda).manual_seed(pos + D)
    q = torch.randn(2, 4, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, W, 4, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    n0 = DA.ring_launches
    out = DA.ring_decode_attention(q, k, v, pos, window=window)
    assert DA.ring_launches == n0 + 1
    _close(out, ref.naive_ring_decode_attention(q, k, v, pos, window=window), torch.bfloat16)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("lengths,window", [([1, S64 - 1], None), ([S64, S64 + 1], None),
                                            ([1056, 300], None), ([1056, 0], 50),
                                            ([17 * S64 + 5, 9], None)])
def test_paged_decode_g1_kernel_over_shuffled_pages(cuda, lengths, window, D):
    """K3 at G = 1 over a 3-layer store's strided view and a shuffled table."""
    q, kp, vp, table, lens = _paged_inputs(cuda, 2, 4, 4, D, 3, 1, lengths, 16,
                                           torch.bfloat16, seed=sum(lengths) + D)
    n0 = PA.launches
    out = PA.paged_decode_attention(q, kp, vp, table, lens, window=window)
    assert PA.launches == n0 + 1
    _close(out, ref.naive_paged_decode_attention(q, kp, vp, table, lens, window=window),
           torch.bfloat16)
    assert torch.equal(out, PA.paged_decode_attention(q, kp, vp, table, lens, window=window))


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("length,window", [(1, None), (S64 + 1, None), (1000, None),
                                           (1056, None), (1056, 70), (2200, None)])
def test_paged_g1_kernel_over_in_order_pages_equals_contiguous(cuda, length, window, D):
    """At G = 1 the paged decode over pages in order gives the contiguous
    decode's bits: both cut a row into the same splits."""
    B, H, page, S = 2, 4, 16, 2208
    g = torch.Generator(device=cuda).manual_seed(length + D)
    q = torch.randn(B, H, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, H, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    n = S // page
    table = torch.arange(B * n, dtype=torch.int32, device=cuda).view(B, n)
    lens = torch.full((B,), length, dtype=torch.int32, device=cuda)
    paged = PA.paged_decode_attention(q, k.view(B * n, page, H, D), v.view(B * n, page, H, D),
                                      table, lens, window=window)
    assert torch.equal(paged, DA.decode_attention(q, k, v, length, window=window))


def test_decode_g1_lane_gives_a_batched_rows_bits(cuda):
    """A row decoded alone (B = 1, as a fleet lane) equals the same row of
    a batch of 4 at minicpm-2b's shape: the blocks walk other items, but
    each item's partial and the combine do not depend on B."""
    B, H, D, L = 4, 36, 64, 1056
    g = torch.Generator(device=cuda).manual_seed(36)
    q = torch.randn(B, H, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, L, H, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    batch = DA.decode_attention(q, k, v, L)
    for b in range(B):
        assert torch.equal(DA.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], L),
                           batch[b:b + 1])


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_g1_kernels_are_deterministic_across_launches(cuda, kind, D):
    fn, _, _ = _decode_calls(cuda, torch.bfloat16, D, G=1)[kind]
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_g1_kernels_replay_in_a_cuda_graph(cuda, kind, D):
    """Three G = 1 calls captured in one graph and replayed three times
    equal the eager calls bit for bit: each launch leaves its ticket
    counters at 0."""
    fn, _, _ = _decode_calls(cuda, torch.bfloat16, D, G=1)[kind]
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


def test_decode_g1_graph_replays_after_the_counters_grow(cuda):
    """A G = 1 graph captured before a larger launch grows the ticket
    counters still replays equal to the eager call."""
    fn, _, _ = _decode_calls(cuda, torch.bfloat16, 64, G=1)["decode"]
    want = fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    K, D, S = 4, 64, 300
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = DA.counters(dev, 1).numel() // K + 1
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(rows, K, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(rows, S, K, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    big = DA.decode_attention(q, k, v, S)
    _close(big, ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), S),
           torch.bfloat16)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(DA.decode_attention(q, k, v, S), big)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_g1_kernels_are_one_launch_per_call(cuda, kind, D):
    """Each G = 1 call is one launch of decode_g1_kernel (the last split's
    block combines), for K2, K2 over a ring and K3 at D 32 and 64: one
    decode kernel node of a CUDA graph captured around a call, and no other
    decode kernel; the wrapper's count moves by one a call."""
    fn, counter, mod = _decode_calls(cuda, torch.bfloat16, D, G=1)[kind]
    n0 = getattr(mod, counter)
    nodes = [n for n, _, _ in graph_kernels(fn) if re.search(r"decode_(mma_|g1_)?kernel", n)]
    assert getattr(mod, counter) == n0 + 2
    assert len(nodes) == 1 and "decode_g1_kernel" in nodes[0], nodes


# -- K1's bf16 forward at D = 64 on flash_ws_kernel (persistent; a producer
#    warpgroup and two consumers taking turns; O out by TMA stores) and dQ at
#    D = 128 on dq_d128_kernel (persistent; Q and dO in two buffers, Dr from
#    the producer's warps, dQ out by TMA stores); which kernel a call ran is
#    read from the kernel nodes of a CUDA graph captured around it ----------

def _ws_held(q, k, v, window):
    """K1 (flash_ws_kernel at D = 64) against the plain version, with its
    logsumexp, and its output with the logsumexp written equal to the
    output without it."""
    n0 = FA.launches
    o, lse = FA.flash_attention(q, k, v, window=window, lse=True)
    assert FA.launches == n0 + 1 and o.stride() == q.stride()
    _close(o, ref.naive_attention(q, k, v, window=window), torch.bfloat16)
    torch.testing.assert_close(lse, ref.naive_attention_lse(q, k, window=window), rtol=0,
                               atol=LSE_TOL)
    assert torch.equal(o, FA.flash_attention(q, k, v, window=window))
    return o, lse


@pytest.mark.parametrize("window", [None, 1024, 100])
@pytest.mark.parametrize("S", [77, 1000, 1536])
@pytest.mark.parametrize("G", [1, 4, 5, 16])
def test_flash_ws64_matches_plain(cuda, G, S, window):
    """flash_ws_kernel<64> at G = 1 (minicpm-2b), 4 (granite), 5 (hymba), 16;
    S a multiple of no tile (77, 1000) and hymba's 1536, hymba's window of
    1024 (wider than S = 77's rows, narrower than 1536's), one narrower than
    a KV tile, and none; the model's strided views."""
    q, k, v = _flash_views(cuda, 2, 2 * G, 2, S, 64, torch.bfloat16, seed=S + G)
    _ws_held(q, k, v, window)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 255, 256, 257])
def test_flash_ws64_at_tile_edges(cuda, S):
    """S on both sides of the 64-row warpgroup, 128-row block and 128-row KV
    tile edges, G = 1."""
    q, k, v = _flash_views(cuda, 3, 4, 4, S, 64, torch.bfloat16, seed=S + 64)
    _ws_held(q, k, v, None)


def test_flash_ws64_on_model_views_equals_contiguous_copy(cuda):
    """The strided views and contiguous copies give the same bits (the
    tensor maps follow the strides), and so do two launches."""
    q, k, v = _flash_views(cuda, 2, 8, 2, 300, 64, torch.bfloat16, seed=70)
    assert not (q.is_contiguous() or v.is_contiguous())
    a = FA.flash_attention(q, k, v, window=50, lse=True)
    b = FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=50, lse=True)
    c = FA.flash_attention(q, k, v, window=50, lse=True)
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))


def test_flash_ws64_launches_from_a_fresh_host_thread(cuda):
    """A thread that has made no CUDA call (the autograd engine's worker)
    launches flash_ws_kernel<64> with the main thread's bits."""
    import threading
    q, k, v = _flash_views(cuda, 2, 4, 4, 200, 64, torch.bfloat16, seed=71)
    want = FA.flash_attention(q, k, v, window=77, lse=True)
    got = []

    def run():
        got.append(FA.flash_attention(q, k, v, window=77, lse=True))
        torch.cuda.synchronize()
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert torch.equal(got[0][0], want[0]) and torch.equal(got[0][1], want[1])


@pytest.mark.parametrize("row,B,H,K,S,D,window", [
    ("1 granite", 1, 32, 8, 1024, 64, None), ("1h hymba windowed", 1, 25, 5, 1536, 64, 1024),
    ("1h hymba global", 1, 25, 5, 1536, 64, None), ("1m minicpm", 1, 36, 36, 1024, 64, None),
    ("1q qwen", 1, 40, 8, 1024, 128, None), ("smoke", 2, 4, 2, 64, 32, None)])
def test_flash_forward_routes_each_model_to_its_kernel(cuda, row, B, H, K, S, D, window):
    """One call of the forward (with and without the logsumexp) is one kernel
    node of a CUDA graph captured around it, and that kernel is the one
    fwd_kernel names for the row's (D, G, window)."""
    q, k, v = _flash_views(cuda, B, H, K, S, D, torch.bfloat16, seed=S + H)
    want = FA.fwd_kernel(torch.bfloat16, D, H // K, window)
    for lse in (False, True):
        nodes = graph_kernels(lambda: FA.flash_attention(q, k, v, window=window, lse=lse))
        assert len(nodes) == 1, nodes
        assert want in nodes[0][0] and f"{want}ILi{D}" in nodes[0][0], (row, nodes)


@pytest.mark.parametrize("D,dq_name", [(64, "dq_bf16_kernel"), (128, "dq_d128_kernel")])
def test_flash_bwd_is_two_kernel_nodes(cuda, D, dq_name):
    """One backward call is two kernel nodes of a captured CUDA graph, dQ
    first (dq_d128_kernel at D = 128), then dK/dV; the wrapper's counts move
    by one each."""
    q, k, v, do = _bwd_inputs(cuda, 2, 10, 2, 300, D, torch.bfloat16, seed=73)
    o, lse = FA.flash_attention(q, k, v, lse=True)
    nodes = graph_kernels(lambda: FA.flash_attention_bwd(q, k, v, o, lse, do))
    assert len(nodes) == 2, nodes
    assert dq_name in nodes[0][0] and "dkdv_bf16_kernel" in nodes[1][0], nodes


@pytest.mark.parametrize("window", [None, 64, 1000])
@pytest.mark.parametrize("S", [65, 100, 129, 300, 1000])
@pytest.mark.parametrize("G", [1, 5, 8])
def test_dq128_matches_plain(cuda, G, S, window):
    """dq_d128_kernel at G = 1, 5 (qwen2.5-14b), 8; S ragged against its
    128-row tiles and the 64-row K/V tiles; windows narrower than a tile,
    and wider; the row sums it hands dK/dV against the plain ones."""
    q, k, v, do = _bwd_inputs(cuda, 2, 2 * G, 2, S, 128, torch.bfloat16, seed=S * G + 5)
    _bwd_held(q, k, v, do, window, torch.bfloat16)


def test_dq128_is_bit_stable_at_qwen_training_shape(cuda):
    """qwen2.5-14b's training shape, the whole batch (B4 H40 K8 S1024 D128):
    two backward runs give equal bits, dQ within its tolerance."""
    q, k, v, do = _bwd_inputs(cuda, 4, 40, 8, 1024, 128, torch.bfloat16, seed=74)
    o, lse = FA.flash_attention(q, k, v, lse=True)
    a = FA._bwd(q, k, v, o, lse, do)
    b = FA._bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = ref.attention_bwd_dq(q, k, v, lse, do, ref.attention_bwd_delta(o, do))
    assert _rel(a[0], want) <= BWD_TOL[torch.bfloat16]


# -- the attention kernels at the shapes of llava-next-34b (G = 7, head dim
#    128) and granite-moe-3b-a800m (G = 3, head dim 64) ----------------------------

FAMILY_SHAPES = {"llava-next-34b": (4, 56, 8, 128), "granite-moe-3b-a800m": (4, 24, 8, 64)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", FAMILY_SHAPES)
def test_flash_kernels_at_the_family_prefill_shape(cuda, arch, dtype):
    """K1 (the route's kernel, one launch), its logsumexp and its backward
    at the family's prefill and training shape, S 1024."""
    B, H, K, D = FAMILY_SHAPES[arch]
    q, k, v, do = _bwd_inputs(cuda, B, H, K, 1024, D, dtype, seed=H)
    _flash_held(q, k, v, None, dtype)
    _bwd_held(q, k, v, do, None, dtype)
    names = [n for n, _, _ in graph_kernels(lambda: FA.flash_attention(q, k, v))]
    assert len(names) == 1 and FA.fwd_kernel(dtype, D, H // K) in names[0], names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length", [1, 577, 1056])
@pytest.mark.parametrize("arch", FAMILY_SHAPES)
def test_decode_kernels_at_the_family_decode_shape(cuda, arch, length, dtype):
    """K2 at the family's decode (caches of 1056 rows, the Server's 1024 +
    32), and K3 for one lane over a strided store of the family's depth,
    bit-equal to K2 over in-order pages."""
    B, H, K, D = FAMILY_SHAPES[arch]
    g = torch.Generator(device=cuda).manual_seed(length + H)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, 1056, K, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    n0 = DA.launches
    out = ops.decode_attention(q, k, v, length)
    assert DA.launches == n0 + 1
    _close(out, ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), length),
           dtype)
    n = 1056 // 16
    table = torch.arange(B * n, dtype=torch.int32, device=cuda).view(B, n)
    lens = torch.full((B,), length, dtype=torch.int32, device=cuda)
    paged = PA.paged_decode_attention(q, k.view(B * n, 16, K, D), v.view(B * n, 16, K, D),
                                      table, lens)
    assert torch.equal(paged, out)
    qp, kp, vp, table, lens = _paged_inputs(cuda, 1, H, K, D, 4, 2, [length], 16, dtype,
                                            seed=length)
    _close(PA.paged_decode_attention(qp, kp, vp, table, lens),
           ref.naive_paged_decode_attention(qp, kp, vp, table, lens), dtype)


# -- the bf16 split-KV decode at G > 1 on decode_mma_kernel<D> (D = 64 and
#    128: the KV head's query heads on mma.sync, K/V staged by cp.async, the
#    last block's combine in one round), for K2, K2 over a ring and K3 ----------

MMA_G = [2, 3, 4, 5, 7, 8, 16]


def _mma_lengths(D):
    """Lengths at the split edges (split_len(D) positions, and four splits),
    the serving 1056 and a long 4097."""
    s = DA.split_len(D)
    return [1, s - 1, s, s + 1, 4 * s - 1, 4 * s + 1, 1056, 4097]


@pytest.mark.parametrize("G", MMA_G)
@pytest.mark.parametrize("D", [64, 128])
def test_decode_mma_kernel_matches_plain(cuda, D, G):
    """K2 on the tensor-core kernel at each G and length, with and without
    a window, against the plain version; two launches give equal bits."""
    assert DA.kernel(torch.bfloat16, D, G) == "decode_mma_kernel"
    B, K = 2, 2
    for length in _mma_lengths(D):
        for window in (None, 100):
            g = torch.Generator(device=cuda).manual_seed(length + 17 * G + D)
            q = torch.randn(B, G * K, D, generator=g, device=cuda).bfloat16()
            k, v = (torch.randn(B, length, K, D, generator=g, device=cuda).bfloat16()
                    for _ in range(2))
            n0 = DA.launches
            out = ops.decode_attention(q, k, v, length, window=window)
            assert DA.launches == n0 + 1
            _close(out, ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                                   length, window=window), torch.bfloat16)
            assert torch.equal(out, ops.decode_attention(q, k, v, length, window=window))


@pytest.mark.parametrize("G", MMA_G)
@pytest.mark.parametrize("D", [64, 128])
def test_ring_decode_mma_kernel_matches_plain(cuda, D, G):
    """K2 over a ring on the tensor-core kernel: below, at and past the
    ring's width, a window narrower than the ring."""
    for W, window, pos in ((300, 256, 40), (300, 256, 299), (300, 256, 1000),
                           (1024, 1024, 1567)):
        g = torch.Generator(device=cuda).manual_seed(pos + G + D)
        q = torch.randn(2, 2 * G, D, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(2, W, 2, D, generator=g, device=cuda).bfloat16() for _ in range(2))
        out = DA.ring_decode_attention(q, k, v, pos, window=window)
        _close(out, ref.naive_ring_decode_attention(q, k, v, pos, window=window),
               torch.bfloat16)
        assert torch.equal(out, DA.ring_decode_attention(q, k, v, pos, window=window))


@pytest.mark.parametrize("G", MMA_G)
@pytest.mark.parametrize("D", [64, 128])
def test_paged_decode_mma_kernel_over_shuffled_pages(cuda, D, G):
    """K3 on the tensor-core kernel over a 3-layer store's strided view and
    a shuffled table, at the split edges and the serving length, windows."""
    s = DA.split_len(D)
    for lengths, window in (([1, s - 1], None), ([s, s + 1], None), ([4 * s + 1, 0], None),
                            ([1056, 300], None), ([1056, 4097], 50)):
        q, kp, vp, table, lens = _paged_inputs(cuda, 2, 2 * G, 2, D, 3, 1, lengths, 16,
                                               torch.bfloat16, seed=sum(lengths) + G)
        n0 = PA.launches
        out = PA.paged_decode_attention(q, kp, vp, table, lens, window=window)
        assert PA.launches == n0 + 1
        _close(out, ref.naive_paged_decode_attention(q, kp, vp, table, lens, window=window),
               torch.bfloat16)
        assert torch.equal(out, PA.paged_decode_attention(q, kp, vp, table, lens,
                                                          window=window))


@pytest.mark.parametrize("D,G", [(64, 3), (64, 4), (64, 5), (128, 5), (128, 7)])
def test_decode_mma_bit_equalities(cuda, D, G):
    """At the models' (D, G): K3 over pages that lie in order equals K2 bit
    for bit, a row decoded alone (B = 1, a fleet lane) equals the same row
    of a batch of 4, and two launches agree, at lengths 1, 500, 1056 and
    4097, with and without a window."""
    B, K, page, S = 4, 8, 16, 4112
    g = torch.Generator(device=cuda).manual_seed(G * D)
    q = torch.randn(B, G * K, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, K, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    n = S // page
    table = torch.arange(B * n, dtype=torch.int32, device=cuda).view(B, n)
    for length in (1, 500, 1056, 4097):
        for window in (None, 300):
            lens = torch.full((B,), length, dtype=torch.int32, device=cuda)
            batch = DA.decode_attention(q, k, v, length, window=window)
            paged = PA.paged_decode_attention(q, k.view(B * n, page, K, D),
                                              v.view(B * n, page, K, D), table, lens,
                                              window=window)
            assert torch.equal(paged, batch), (length, window)
            assert torch.equal(DA.decode_attention(q, k, v, length, window=window), batch)
            for b in range(B):
                lane = DA.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], length,
                                           window=window)
                assert torch.equal(lane, batch[b:b + 1]), (length, window, b)


@pytest.mark.parametrize("G", [3, 7])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kind", ["decode", "ring", "paged"])
def test_decode_mma_kernels_replay_in_a_cuda_graph(cuda, kind, D, G):
    """Three calls captured in one graph and replayed three times equal the
    eager calls bit for bit: each launch leaves its ticket counters at 0."""
    fn, _, _ = _decode_calls(cuda, torch.bfloat16, D, G)[kind]
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


@pytest.mark.parametrize("D,G", [(64, 3), (128, 7)])
def test_decode_mma_graph_replays_after_the_counters_grow(cuda, D, G):
    """A G > 1 graph captured before a larger launch grows the ticket
    counters still replays equal to the eager call."""
    fn, _, _ = _decode_calls(cuda, torch.bfloat16, D, G)["decode"]
    want = fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    K, S = 2, 16
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = DA.counters(dev, 1).numel() // K + 1
    g = torch.Generator(device=cuda).manual_seed(13 + G)
    q = torch.randn(rows, G * K, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(rows, S, K, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    big = DA.decode_attention(q, k, v, S)
    _close(big, ref.naive_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), S),
           torch.bfloat16)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(DA.decode_attention(q, k, v, S), big)


# -- MLA (minicpm3-4b): K1 and its backward at qk head dim 96 beside V at
#    its 64 columns; the latent decode, every query head over one latent row
#    of 288 (its first 256 the value), contiguous and through a page table --

LAT_SCALE = 1 / 96 ** 0.5     # MLA's 1/sqrt(qk_nope + qk_rope)


def _mla_inputs(cuda, B, H, K, S, dtype, seed, Dv=64):
    """q, k at 96 and v, dO at Dv (MLA's 64), as the model lays them out:
    [B,S,n,width] projections seen as [B,n,S,width] views."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, n, d, generator=g, device=cuda).to(dtype).transpose(1, 2)
                   for n, d in ((H, 96), (K, 96), (K, Dv), (H, Dv)))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 129, 300, 1024])
@pytest.mark.parametrize("G", [1, 5])
def test_flash_d96_matches_plain(cuda, G, S, window, dtype):
    """K1 at head dim 96 beside V at 64, the model's strided views; its
    logsumexp too, and the output with it written equal to the prefill's
    bit for bit."""
    q, k, v, _ = _mla_inputs(cuda, 2, 2 * G, 2, S, dtype, seed=S + G)
    _flash_held(q, k, v, window, dtype)
    o, lse = FA.flash_attention(q, k, v, window=window, lse=True)
    assert o.shape == (2, 2 * G, S, 64)
    assert torch.equal(o, FA.flash_attention(q, k, v, window=window))
    torch.testing.assert_close(lse, ref.naive_attention_lse(q, k, window=window), rtol=0,
                               atol=LSE_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("S", [17, 65, 300, 1024])
@pytest.mark.parametrize("G", [1, 5])
def test_flash_bwd_d96_matches_plain(cuda, G, S, window, dtype):
    """dq_d128_kernel<96, 96, 64> (with the row sums) and
    dkdv_bf16_kernel<96, 96, 64> against the plain backward, dO at V's 64
    columns; two runs equal bit for bit."""
    q, k, v, do = _mla_inputs(cuda, 2, 2 * G, 2, S, dtype, seed=S * G)
    _bwd_held(q, k, v, do, window, dtype)
    o, lse = FA.flash_attention(q, k, v, window=window, lse=True)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_d96_at_minicpm3_shape(cuda, dtype):
    """minicpm3-4b's prefill and training shape: B4 H40 K40 S1024, V at its
    64 columns as the model lays it out."""
    q, k, v, do = _mla_inputs(cuda, 4, 40, 40, 1024, dtype, seed=96)
    _flash_held(q, k, v, None, dtype)
    _bwd_held(q, k, v, do, None, dtype)


@pytest.mark.parametrize("G", [1, 5])
def test_flash_d96_padded_v_still_runs_on_128s_tiles(cuda, G):
    """V zero-padded to 96 (the pair (96, 96)) keeps the kernels on D =
    128's tiles, and their outputs' first 64 columns equal the (96, 64)
    kernels' bit for bit: the same sums, the padding's zero products added
    or not."""
    q, k, v, do = _mla_inputs(cuda, 2, 2 * G, 2, 300, torch.bfloat16, seed=G + 9)
    vp, dop = (torch.nn.functional.pad(x, (0, 32)) for x in (v, do))
    _flash_held(q, k, vp, 100, torch.bfloat16)
    _bwd_held(q, k, vp, dop, 100, torch.bfloat16)
    o, lse = FA.flash_attention(q, k, v, window=100, lse=True)
    op, lsep = FA.flash_attention(q, k, vp, window=100, lse=True)
    assert torch.equal(o, op[..., :64]) and torch.equal(lse, lsep)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, window=100)
    pad = FA.flash_attention_bwd(q, k, vp, op, lsep, dop, window=100)
    assert torch.equal(got[0], pad[0]) and torch.equal(got[1], pad[1])
    assert torch.equal(got[2], pad[2][..., :64])
    nodes = graph_kernels(lambda: FA.flash_attention(q, k, vp))
    assert len(nodes) == 1 and "flash_ws_kernelILi128ELi96ELi128E" in nodes[0][0], nodes


def test_flash_refuses_unpaired_head_dims(cuda):
    """v's width must be q's, or 64 beside 96: (64, 32), (128, 64) and (96,
    32) raise before any launch."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for D, Dv in ((64, 32), (128, 64), (96, 32)):
        q, k = (torch.randn(1, 2, 64, D, generator=g, device=cuda).bfloat16() for _ in range(2))
        v = torch.randn(1, 2, 64, Dv, generator=g, device=cuda).bfloat16()
        n0 = FA.launches
        with pytest.raises(ValueError, match="head dim"):
            FA.flash_attention(q, k, v)
        assert FA.launches == n0


def test_flash_d96_is_one_forward_and_two_backward_kernel_nodes(cuda):
    """One forward call is one flash_ws_kernel<128, 96, 64> node of a
    captured CUDA graph (with and without the logsumexp); one backward call
    is dq_d128_kernel<96, 96, 64>, then dkdv_bf16_kernel<96, 96, 64>."""
    q, k, v, do = _mla_inputs(cuda, 2, 8, 8, 300, torch.bfloat16, seed=7)
    assert FA.fwd_kernel(torch.bfloat16, 96, 1) == "flash_ws_kernel"
    for lse in (False, True):
        nodes = graph_kernels(lambda: FA.flash_attention(q, k, v, lse=lse))
        assert len(nodes) == 1 and "flash_ws_kernelILi128ELi96ELi64E" in nodes[0][0], nodes
    o, lse = FA.flash_attention(q, k, v, lse=True)
    nodes = graph_kernels(lambda: FA.flash_attention_bwd(q, k, v, o, lse, do))
    assert len(nodes) == 2, nodes
    assert "dq_d128_kernelILi96ELi96ELi64E" in nodes[0][0], nodes
    assert "dkdv_bf16_kernelILi96ELi96ELi64E" in nodes[1][0], nodes


def _latent_inputs(cuda, B, H, S, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, H, LA.DK, generator=g, device=cuda).to(dtype)
    lat = torch.randn(B, S, LA.DK, generator=g, device=cuda).to(dtype)
    return q, lat


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 577, 1056])
@pytest.mark.parametrize("H", [1, 16, 40, 48])
def test_latent_decode_matches_plain(cuda, H, length, dtype):
    q, lat = _latent_inputs(cuda, 3, H, 1056, dtype, seed=H + length)
    n0 = LA.launches
    got = ops.latent_decode_attention(q, lat, length, v_dim=LA.DV, scale=LAT_SCALE)
    assert LA.launches == n0 + 1 and got.shape == (3, H, LA.DV) and got.dtype == dtype
    _close(got, ref.naive_latent_decode_attention(q, lat, length, v_dim=LA.DV,
                                                  scale=LAT_SCALE), dtype)


def _latent_pages(cuda, q, lengths, dtype, seed, page=16, n_layers=62, layer=20):
    """Layer ``layer``'s strided [P, page, 288] view of a stacked pool store
    [P, page, n_layers * 288] (the fleet's layout) and a table of distinct
    shuffled pages, the entries past each length 0."""
    B = q.shape[0]
    n = max(-(-max(lengths) // page), 1)
    P = B * n + 3
    g = torch.Generator(device=cuda).manual_seed(seed)
    store = torch.randn(P, page, n_layers * LA.DK, generator=g, device=cuda).to(dtype)
    pages = store.view(P, page, n_layers, 1, LA.DK)[:, :, layer, 0]
    table = torch.randperm(P, generator=torch.Generator().manual_seed(seed))[:B * n]
    table = table.view(B, n).to(torch.int32)
    for b, L in enumerate(lengths):
        table[b, -(-L // page):] = 0
    return pages, table.to(cuda), torch.tensor(lengths, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths", [[1], [16], [1056], [1, 64, 65, 1056], [0, 300]])
def test_paged_latent_decode_over_shuffled_pages_matches_plain(cuda, lengths, dtype):
    q, _ = _latent_inputs(cuda, len(lengths), 40, 1, dtype, seed=len(lengths))
    pages, table, lens = _latent_pages(cuda, q, lengths, dtype, seed=sum(lengths) + 1)
    n0 = LA.paged_launches
    got = ops.paged_latent_decode_attention(q, pages, table, lens, v_dim=LA.DV,
                                            scale=LAT_SCALE)
    assert LA.paged_launches == n0 + 1
    _close(got, ref.naive_paged_latent_decode_attention(q, pages, table, lens, v_dim=LA.DV,
                                                        scale=LAT_SCALE), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length", [1, 64, 500, 1056])
def test_paged_latent_over_in_order_pages_is_the_contiguous_bits(cuda, length, dtype):
    """Over pages that lie in order the paged form runs the contiguous
    form's blocks on the same rows: equal bit for bit; so are a row decoded
    alone (a B = 1 fleet lane) and the same row of the batch, and two
    launches."""
    B, S, page = 4, 1056, 16
    q, lat = _latent_inputs(cuda, B, 40, S, dtype, seed=length)
    n = S // page
    table = torch.arange(B * n, dtype=torch.int32, device=cuda).view(B, n)
    lens = torch.full((B,), length, dtype=torch.int32, device=cuda)
    batch = LA.latent_decode_attention(q, lat, length, v_dim=LA.DV, scale=LAT_SCALE)
    paged = LA.paged_latent_decode_attention(q, lat.view(B * n, page, LA.DK), table, lens,
                                             v_dim=LA.DV, scale=LAT_SCALE)
    assert torch.equal(paged, batch)
    assert torch.equal(LA.latent_decode_attention(q, lat, length, v_dim=LA.DV,
                                                  scale=LAT_SCALE), batch)
    for b in range(B):
        lane = LA.paged_latent_decode_attention(q[b:b + 1], lat[b].view(n, page, LA.DK),
                                                table[:1], lens[:1], v_dim=LA.DV,
                                                scale=LAT_SCALE)
        assert torch.equal(lane, batch[b:b + 1]), b


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_latent_decode_is_one_kernel_node(cuda, kind):
    """One bf16 call is one latent_mma_kernel node of a CUDA graph captured
    around it (the row's blocks combine its partials in the same launch),
    the wrapper's count moves by one a call, and the grid is at most one
    wave."""
    q, lat = _latent_inputs(cuda, 4, 40, 1056, torch.bfloat16, seed=3)
    if kind == "contiguous":
        def fn():
            return LA.latent_decode_attention(q, lat, 1056, v_dim=LA.DV, scale=LAT_SCALE)
        counter = "launches"
    else:
        table = torch.arange(4 * 66, dtype=torch.int32, device=cuda).view(4, 66)
        lens = torch.full((4,), 1056, dtype=torch.int32, device=cuda)
        pages = lat.view(4 * 66, 16, LA.DK)

        def fn():
            return LA.paged_latent_decode_attention(q, pages, table, lens, v_dim=LA.DV,
                                                    scale=LAT_SCALE)
        counter = "paged_launches"
    n0 = getattr(LA, counter)
    nodes = [n for n, _, _ in graph_kernels(fn) if "latent" in n]
    assert getattr(LA, counter) == n0 + 2          # the warm-up call and the captured one
    assert len(nodes) == 1 and "latent_mma_kernel" in nodes[0], nodes
    # the grid: one block an item (4 rows x 17 spans x 3 head tiles), within a wave
    grid = [g for n, g, _ in graph_kernels(fn) if "latent" in n][0]
    wave = LA.wave(cuda, paged=kind == "paged")
    assert grid == (min(4 * LA.n_spans(1056) * LA.n_tiles(40), wave), 1, 1), (grid, wave)


def test_latent_decode_replays_in_a_cuda_graph(cuda):
    """Three calls captured in one graph and replayed three times equal the
    eager calls bit for bit: each launch leaves its ticket counters at 0."""
    q, lat = _latent_inputs(cuda, 4, 40, 1056, torch.bfloat16, seed=5)
    lengths = (1056, 300, 1)
    eager = [LA.latent_decode_attention(q, lat, L, v_dim=LA.DV, scale=LAT_SCALE)
             for L in lengths]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [LA.latent_decode_attention(q, lat, L, v_dim=LA.DV, scale=LAT_SCALE)
                for L in lengths]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, eager))


def test_latent_decode_refuses_what_it_does_not_take(cuda):
    q, lat = _latent_inputs(cuda, 2, 40, 64, torch.bfloat16, seed=1)
    kw = dict(v_dim=LA.DV, scale=LAT_SCALE)
    for bad in (lambda: LA.latent_decode_attention(q[..., :256], lat[..., :256], 8, **kw),
                lambda: LA.latent_decode_attention(q, lat, 8, v_dim=128, scale=0.1),
                lambda: LA.latent_decode_attention(q, lat, 0, **kw),
                lambda: LA.latent_decode_attention(q, lat, 65, **kw),
                lambda: LA.latent_decode_attention(q.repeat(1, 2, 1), lat, 8, **kw),
                lambda: LA.latent_decode_attention(q, lat[:, ::2], 8, **kw)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        LA.latent_decode_attention(q.float(), lat, 8, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 577, 1056])
def test_latent_capacity_above_the_length_is_the_exact_fits_bits(cuda, length, dtype):
    """The plan depends on the row's length alone: a cache of 2048 positions
    and a table twice the lane's pages give the bits of the cache that holds
    exactly ``length`` positions, and so does a table of the pages it needs."""
    B, page, kw = 4, 16, dict(v_dim=LA.DV, scale=LAT_SCALE)
    q, lat = _latent_inputs(cuda, B, 40, 2048, dtype, seed=length + 7)
    exact = LA.latent_decode_attention(q, lat[:, :length].contiguous(), length, **kw)
    assert torch.equal(LA.latent_decode_attention(q, lat, length, **kw), exact)
    n = -(-length // page)
    pages = lat.view(B * 128, page, LA.DK)
    lens = torch.full((B,), length, dtype=torch.int32, device=cuda)
    tight = torch.arange(B * 128, dtype=torch.int32, device=cuda).view(B, 128)[:, :n]
    wide = torch.zeros(B, 2 * n, dtype=torch.int32, device=cuda)
    wide[:, :n] = tight
    got = LA.paged_latent_decode_attention(q, pages, tight.contiguous(), lens, **kw)
    assert torch.equal(got, LA.paged_latent_decode_attention(q, pages, wide, lens, **kw))
    assert torch.equal(got, exact)      # the tables' pages hold each row in order


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_latent_ragged_lengths_in_one_call(cuda, dtype):
    """Rows of lengths 0 to 1056 in one paged call: each against the plain
    version, each bit-equal to the same row decoded alone as a B = 1 lane,
    the empty row zeros."""
    lengths = [0, 1, 65, 577, 1056, 64, 2, 1000]
    kw = dict(v_dim=LA.DV, scale=LAT_SCALE)
    q, _ = _latent_inputs(cuda, len(lengths), 40, 1, dtype, seed=11)
    pages, table, lens = _latent_pages(cuda, q, lengths, dtype, seed=12)
    got = LA.paged_latent_decode_attention(q, pages, table, lens, **kw)
    _close(got, ref.naive_paged_latent_decode_attention(q, pages, table, lens, **kw), dtype)
    assert not got[0].any()
    for b in range(len(lengths)):
        lane = LA.paged_latent_decode_attention(q[b:b + 1], pages, table[b:b + 1],
                                                lens[b:b + 1], **kw)
        assert torch.equal(lane, got[b:b + 1]), b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H", [1, 16, 40, 48])
def test_latent_lane_is_its_batched_rows_bits_at_every_head_count(cuda, H, dtype):
    """At 1, 16, 40 and 48 heads (one, one, three and three head tiles) a
    B = 1 call gives its row's bits in a batch of four."""
    kw = dict(v_dim=LA.DV, scale=LAT_SCALE)
    q, lat = _latent_inputs(cuda, 4, H, 1056, dtype, seed=H)
    batch = LA.latent_decode_attention(q, lat, 777, **kw)
    for b in range(4):
        assert torch.equal(LA.latent_decode_attention(q[b:b + 1], lat[b:b + 1], 777, **kw),
                           batch[b:b + 1]), b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_latent_launches_agree_after_a_launch_at_another_length(cuda, dtype):
    """Two launches at length 1056 are bit-equal with launches at 577 and at
    3000 positions (another plan, more spans) between them: each launch
    leaves its ticket counters at zero."""
    kw = dict(v_dim=LA.DV, scale=LAT_SCALE)
    q, lat = _latent_inputs(cuda, 4, 40, 3000, dtype, seed=21)
    first = LA.latent_decode_attention(q, lat, 1056, **kw)
    LA.latent_decode_attention(q, lat, 577, **kw)
    LA.latent_decode_attention(q, lat, 3000, **kw)
    assert torch.equal(LA.latent_decode_attention(q, lat, 1056, **kw), first)
    torch.cuda.synchronize()
    assert not DA.counters(cuda, 4 * LA.n_tiles(40)).any()


def _mla_cfg():
    """minicpm3's smoke config at the kernels' head dims: qk 64 + 32, the
    latent row 256 + 32, v 64; 8 heads, 2 layers, float32."""
    from dataclasses import replace

    from repro_torch.configs import MLAConfig
    return replace(smoke_config("minicpm3-4b"), n_layers=2, n_heads=8, n_kv_heads=8,
                   mla=MLAConfig(q_lora_rank=64, kv_lora_rank=256, qk_nope_dim=64,
                                 qk_rope_dim=32, v_head_dim=64))


def test_mla_server_on_card_matches_cpu(cuda):
    """A prefill launches K1 (head dim 96) once a layer and a decode step the
    latent decode once a layer; the card's logits and greedy stream equal
    the CPU's plain path's."""
    cfg = _mla_cfg()
    gpu = Server(cfg, device=cuda, seed=0)
    cpu = Server(cfg, device="cpu", params=tree_map(lambda t: t.cpu(), gpu.params))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 70))
    n0 = (FA.launches, LA.launches)
    lg = gpu.prefill(prompt, pad_to=80)
    assert (FA.launches, LA.launches) == (n0[0] + cfg.n_layers, n0[1])
    lc = cpu.prefill(prompt, pad_to=80)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    first = np.argmax(lc[:, : cfg.vocab_size].numpy(), -1)
    tg, _ = gpu.decode(6, first)
    assert (FA.launches, LA.launches) == (n0[0] + cfg.n_layers, n0[1] + 6 * cfg.n_layers)
    tc, _ = cpu.decode(6, first)
    np.testing.assert_array_equal(np.stack(tg), np.stack(tc))


def test_mla_fleet_on_card_matches_server_streams(cuda):
    """The fleet on the card through the paged latent decode (a pool small
    enough to force a swap): every stream equals the Server's B = 1 greedy
    stream, and no contiguous decode ran."""
    cfg = _mla_cfg()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 9, 14)]
    eng = ServeEngine(cfg, device=cuda, seed=0, max_len=40, page_size=4, n_pages=10,
                      max_running=3)
    n0 = (FA.launches, LA.launches, LA.paged_launches)
    sids = [eng.submit(p, max_new_tokens=8) for p in prompts[:2]]
    for _ in range(2):
        eng.step_once()
    sids.append(eng.submit(prompts[2], max_new_tokens=8, priority=5))
    eng.run_until_drained(max_ticks=200)
    assert sum(eng.sched.tickets[s].preemptions for s in sids) >= 1
    decoded = sum(len(eng.stream(s)) - 1 for s in sids)
    assert (FA.launches - n0[0], LA.launches - n0[1], LA.paged_launches - n0[2]) == (
        3 * cfg.n_layers, 0, decoded * cfg.n_layers)
    for p, sid in zip(prompts, sids):
        srv = Server(cfg, device=cuda, params=eng.params)
        first = torch.argmax(srv.prefill(p[None, :], pad_to=len(p) + 8)[:, : cfg.vocab_size],
                             -1).cpu().numpy()
        toks, _ = srv.decode(7, first)
        assert eng.stream(sid) == [int(first[0])] + [int(t[0]) for t in toks]


def test_mla_train_step_on_card_matches_plain_path(cuda, deterministic_restored):
    """One float32 step through MLA on the card: 2 K1 forwards a layer at
    head dim 96 and one of each backward kernel, the gradients within 1e-4
    of the plain path's per leaf."""
    from repro_torch import steps as ST
    from repro_torch.data import synth_batch
    from repro_torch.launch.train import Trainer
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves
    cfg = _mla_cfg()
    tr = Trainer(cfg, batch_size=2, seq_len=48, device=cuda)
    tr.pipeline.stop()
    tr.init_state()
    batch = tr._device_batch(synth_batch(cfg, 2, 48, 1, 0))
    n0, L = _counts(), cfg.n_layers
    grads, total, _, _ = ST.loss_and_grads(tr.model, tr.params, batch)
    assert _counts() == (n0[0] + 2 * L, n0[1] + L, n0[2] + L, n0[3], n0[4])
    want, want_total, _, _ = ST.loss_and_grads(Model(cfg, force="ref"), tr.params, batch)
    assert abs(total.item() - want_total.item()) <= 1e-5 * abs(want_total.item())
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        assert _rel(a, b) <= 1e-4


# -- the sLSTM recurrence (xLSTM) ------------------------------------------------

def _slstm_inputs(cuda, B, S, H, dh, dtype, seed=0):
    """wx ~ N(0, 1) (the hoisted projection's scale), r ~ N(0, 1/dh) (a
    recurrence strong enough to matter; the model's init is 50 times
    weaker), and a start state as a decode finds it (a prefill's)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    wx = torch.randn(B, S, 4 * H * dh, generator=g, device=cuda).to(dtype)
    r = (torch.randn(H, dh, 4 * dh, generator=g, device=cuda) / dh ** 0.5).to(dtype)
    return wx, r


def _slstm_close(got, want, dtype):
    """hs and the final h (|h| <= 1) absolutely; c, n and m relative to
    their largest entries."""
    (hs, st), (hs_w, st_w) = got, want
    tol = GLA_TOL[dtype]
    torch.testing.assert_close(hs.float(), hs_w.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st[3], st_w[3], rtol=tol, atol=tol)
    for a, b in zip(st[:3], st_w[:3]):
        assert _rel(a, b) <= tol


def _same_scan(a, b):
    """Two scans' hs and final states equal bit for bit."""
    (hs, st), (hs2, st2) = a, b
    return torch.equal(hs, hs2) and all(torch.equal(x, y) for x, y in zip(st, st2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,dh", [(4, 1024, 4, 256), (4, 1, 4, 256), (1, 1, 4, 256),
                                      (3, 37, 2, 64), (9, 20, 1, 32), (2, 17, 2, 96),
                                      (3, 5, 1, 160)])
def test_slstm_scan_matches_plain(cuda, B, S, H, dh, dtype):
    """xlstm-350m's prefill (B4 S1024), decode step (B4 S1) and fleet lane
    (B1 S1) from a prefill's state, the smoke width, two row groups, and
    head widths whose block slice of R is staged in 8-byte copies (96,
    160)."""
    wx, r = _slstm_inputs(cuda, B, S + 8, H, dh, dtype)
    st0 = ref.slstm_state0(B, H, dh, cuda)
    start = ref.slstm_scan(wx[:, :8].contiguous(), r, st0)[1]
    x = wx[:, 8:].contiguous()
    n0 = SL.launches
    got = ops.slstm_scan(x, r, start)
    assert SL.launches == n0 + 1
    _slstm_close(got, ref.slstm_scan(x, r, start), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slstm_scan_bit_equalities(cuda, dtype):
    """Two runs agree; scan(S + 1) is scan(S) then scan(1) from its final
    state; each row at B = 4 is that row alone at B = 1: bit for bit."""
    B, S, H, dh = 4, 257, 4, 256
    wx, r = _slstm_inputs(cuda, B, S + 1, H, dh, dtype, seed=1)
    st0 = ref.slstm_state0(B, H, dh, cuda)
    whole = SL.slstm_scan(wx, r, st0)
    assert _same_scan(whole, SL.slstm_scan(wx, r, st0))
    part = SL.slstm_scan(wx[:, :S].contiguous(), r, st0)
    last = SL.slstm_scan(wx[:, S:].contiguous(), r, part[1])
    assert torch.equal(torch.cat([part[0], last[0]], 1), whole[0])
    assert all(torch.equal(a, b) for a, b in zip(last[1], whole[1]))
    for b in range(B):
        one = SL.slstm_scan(wx[b:b + 1].contiguous(), r,
                            tuple(t[b:b + 1].contiguous() for t in st0))
        assert torch.equal(one[0], whole[0][b:b + 1])
        assert all(torch.equal(a, w[b:b + 1]) for a, w in zip(one[1], whole[1]))


@pytest.mark.parametrize("S", [1, 1024])
def test_slstm_scan_is_one_kernel_node(cuda, S):
    wx, r = _slstm_inputs(cuda, 4, S, 4, 256, torch.bfloat16)
    st0 = ref.slstm_state0(4, 4, 256, cuda)
    nodes = graph_kernels(lambda: SL.slstm_scan(wx, r, st0))
    assert len(nodes) == 1 and SL.kernel(torch.bfloat16) in nodes[0][0]
    assert tuple(nodes[0][1]) == (SL.CLUSTER, 4, 1) and tuple(nodes[0][2]) == (256, 1, 1)


def test_slstm_scan_refuses_what_it_does_not_take(cuda):
    wx, r = _slstm_inputs(cuda, 2, 3, 2, 64, torch.float32)
    st0 = ref.slstm_state0(2, 2, 64, cuda)
    with pytest.raises(TypeError):
        SL.slstm_scan(wx.half(), r.half(), st0)
    with pytest.raises(ValueError, match="multiple of 32"):
        SL.slstm_scan(wx[..., :4 * 2 * 48].contiguous(), r[:, :48, :192].contiguous(),
                      tuple(t[..., :48].contiguous() for t in st0))
    with pytest.raises(ValueError, match="contiguous"):
        SL.slstm_scan(wx.transpose(0, 1).contiguous().transpose(0, 1), r, st0)
    with pytest.raises(ValueError, match="CUDA"):
        SL.slstm_scan(wx.cpu(), r.cpu(), tuple(t.cpu() for t in st0))


# the backward against ref.slstm_scan_bwd, max |a - b| / max |b| per
# gradient: the forward's tolerance (GLA_TOL), a reverse recurrence over up
# to 1024 steps whose float32 sums run in another order, and in bf16 the
# gates' gradients rounded to bf16 (5.8e-3 the largest read on the card)

def _slstm_bwd_inputs(cuda, B, S, H, dh, dtype, warm, seed=2):
    wx, r = _slstm_inputs(cuda, B, S + 8, H, dh, dtype, seed)
    st0 = ref.slstm_state0(B, H, dh, cuda)
    if warm:
        st0 = ref.slstm_scan(wx[:, :8].contiguous(), r, st0)[1]
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    dhs = torch.randn(B, S, H, dh, generator=g, device=cuda).to(dtype)
    return wx[:, 8:].contiguous(), r, st0, dhs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,dh,warm", [(4, 1024, 4, 256, False), (2, 300, 4, 256, True),
                                           (1, 64, 4, 256, False), (3, 37, 2, 64, True),
                                           (9, 5, 1, 32, True), (2, 1, 4, 256, True),
                                           (4, 2, 4, 256, False), (9, 45, 2, 96, True),
                                           (5, 33, 3, 32, False), (1, 2, 1, 96, True),
                                           (3, 19, 2, 128, True), (6, 9, 1, 192, False)])
def test_slstm_scan_bwd_matches_plain(cuda, B, S, H, dh, warm, dtype):
    """The training forward's hs and final state equal the serving launch's
    bit for bit and its saved gates and states hold to the plain ones; the
    backward fed by them, and by the plain forward's, holds to
    ``ref.slstm_scan_bwd`` (dwx, dR, and from a warm start the start
    state's dc, dn, dm, dh); one launch each. Beside xlstm-350m's shapes
    the edges: S = 1 and 2 (the backward's two-step-ahead loads and
    coefficients past the start, the training forward's first staged
    chunk), S not a multiple of the forward's staged chunks, odd and
    single rows (a row pair half empty), two row groups (B = 9), head
    widths 32 and 96 (one and three k steps a product; the forward's saves
    stored by each cell) and 64, 128, 192 (staged)."""
    x, r, st0, dhs = _slstm_bwd_inputs(cuda, B, S, H, dh, dtype, warm)
    tol = GLA_TOL[dtype]
    n0 = (SL.launches, SL.train_launches, SL.bwd_launches)
    hs, fin = SL.slstm_scan(x, r, st0)
    hs2, fin2, saved = SL.slstm_scan(x, r, st0, states=True)
    assert _same_scan((hs, fin), (hs2, fin2))
    hs_w, _, saved_w = ref.slstm_scan(x, r, st0, states=True)
    assert saved[0].dtype == dtype and all(t.dtype == torch.float32 for t in saved[1:])
    for a, b in zip(saved, saved_w):
        assert _rel(a, b) <= tol
    for h_, sv in ((hs2, saved), (hs_w, saved_w)):
        got = SL.slstm_scan_bwd(r, st0, h_, sv, dhs, dstate=warm)
        want = ref.slstm_scan_bwd(r, st0, h_, sv, dhs, dstate=warm)
        assert got[0].dtype == dtype and got[1].dtype == dtype
        assert _rel(got[0], want[0]) <= tol and _rel(got[1], want[1]) <= tol
        if warm:
            for a, b in zip(got[2], want[2]):
                assert _rel(a, b) <= tol
        else:
            assert got[2] is None
    assert (SL.launches, SL.train_launches, SL.bwd_launches) == \
        (n0[0] + 1, n0[1] + 1, n0[2] + 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,dh", [(4, 129, 4, 256), (9, 37, 2, 96), (3, 1, 1, 32)])
def test_slstm_scan_bwd_bit_equalities(cuda, B, S, H, dh, dtype):
    """Two runs agree bit for bit, and each row at B is that row alone at
    B = 1, the start state's gradient included."""
    x, r, st0, dhs = _slstm_bwd_inputs(cuda, B, S, H, dh, dtype, True, seed=3)
    hs, _, saved = SL.slstm_scan(x, r, st0, states=True)
    a = SL.slstm_scan_bwd(r, st0, hs, saved, dhs, dstate=True)
    b = SL.slstm_scan_bwd(r, st0, hs, saved, dhs, dstate=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(u, v) for u, v in zip(a[2], b[2]))
    for i in range(B):
        sb = tuple(t[i:i + 1].contiguous() for t in st0)
        hb, _, sv = SL.slstm_scan(x[i:i + 1].contiguous(), r, sb, states=True)
        one = SL.slstm_scan_bwd(r, sb, hb, sv, dhs[i:i + 1].contiguous(), dstate=True)
        assert torch.equal(one[0], a[0][i:i + 1])
        assert all(torch.equal(u, v[i:i + 1]) for u, v in zip(one[2], a[2]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slstm_scan_bwd_is_one_kernel_node(cuda, dtype):
    x, r, st0, dhs = _slstm_bwd_inputs(cuda, 4, 64, 4, 256, dtype, False)
    hs, _, saved = SL.slstm_scan(x, r, st0, states=True)
    nodes = graph_kernels(lambda: SL._bwd(r, st0, hs, saved, dhs))
    assert len(nodes) == 1 and SL.kernel(dtype, bwd=True) in nodes[0][0]
    assert tuple(nodes[0][1]) == (SL.CLUSTER, 4, 1) and tuple(nodes[0][2]) == (256, 1, 1)
    nodes = graph_kernels(lambda: SL.slstm_scan(x, r, st0, states=True))
    assert len(nodes) == 1 and SL.kernel(dtype) in nodes[0][0]


def test_ops_slstm_scan_trains_through_the_kernels(cuda):
    """With a gradient asked for, ``ops.slstm_scan`` on the card runs the
    training forward and, in the backward, the backward kernel: one launch
    each and none of the serving forward; the gradients of wx and r equal
    the plain route's autograd on the same inputs (float32, GLA_TOL)."""
    x, r, st0, dhs = _slstm_bwd_inputs(cuda, 2, 40, 2, 64, torch.float32, False, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (x, r)]
    n0 = (SL.launches, SL.train_launches, SL.bwd_launches)
    hs, fin = ops.slstm_scan(*leaves, st0)
    assert not any(t.requires_grad for t in fin)
    got = torch.autograd.grad(hs, leaves, dhs)
    assert (SL.launches, SL.train_launches, SL.bwd_launches) == (n0[0], n0[1] + 1, n0[2] + 1)
    plain = [t.clone().requires_grad_(True) for t in (x, r)]
    want = torch.autograd.grad(ops.slstm_scan(*plain, st0, force="ref")[0], plain, dhs)
    for a, b in zip(got, want):
        assert _rel(a, b) <= GLA_TOL[torch.float32]


def test_slstm_scan_bwd_refuses_what_it_does_not_take(cuda):
    x, r, st0, dhs = _slstm_bwd_inputs(cuda, 2, 6, 2, 64, torch.float32, False)
    hs, _, saved = SL.slstm_scan(x, r, st0, states=True)
    with pytest.raises(ValueError, match="dhs"):
        SL.slstm_scan_bwd(r, st0, hs, saved, dhs.half())
    with pytest.raises(ValueError, match="contiguous"):
        SL.slstm_scan_bwd(r, st0, hs, saved, dhs.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="c "):
        SL.slstm_scan_bwd(r, st0, hs, (saved[0], saved[1][:, :3], *saved[2:]), dhs)


def test_xlstm_server_on_card_matches_cpu(cuda):
    """A prefill launches the sLSTM scan once an sLSTM layer, a decode step
    once more; the card's logits and greedy stream equal the CPU's plain
    path's (float32 smoke config)."""
    cfg = smoke_config("xlstm-350m")
    gpu = Server(cfg, device=cuda, seed=0)
    cpu = Server(cfg, device="cpu", params=tree_map(lambda t: t.cpu(), gpu.params))
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    n0, L = SL.launches, cfg.n_layers // 2
    lg = gpu.prefill(prompt)
    assert SL.launches == n0 + L
    lc = cpu.prefill(prompt)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    first = np.argmax(lc[:, : cfg.vocab_size].numpy(), -1)
    tg, _ = gpu.decode(6, first)
    assert SL.launches == n0 + 7 * L
    tc, _ = cpu.decode(6, first)
    np.testing.assert_array_equal(np.stack(tg), np.stack(tc))


def test_xlstm_fleet_on_card_matches_server_streams(cuda):
    """The fleet on the card (a pool small enough to force a swap, the
    blocks kept on the card): every stream equals the Server's B = 1 greedy
    stream, and every decoded token launched the scan once a layer."""
    cfg = smoke_config("xlstm-350m")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 9, 14)]
    eng = ServeEngine(cfg, device=cuda, seed=0, max_len=40, page_size=4, n_pages=7,
                      max_running=3)
    n0, L = SL.launches, cfg.n_layers // 2
    sids = [eng.submit(p, max_new_tokens=8) for p in prompts[:2]]
    for _ in range(2):
        eng.step_once()
    sids.append(eng.submit(prompts[2], max_new_tokens=8, priority=5))
    eng.run_until_drained(max_ticks=200)
    assert sum(eng.sched.tickets[s].preemptions for s in sids) >= 1
    decoded = sum(len(eng.stream(s)) - 1 for s in sids)
    assert SL.launches - n0 == (3 + decoded) * L
    for p, sid in zip(prompts, sids):
        srv = Server(cfg, device=cuda, params=eng.params)
        first = torch.argmax(srv.prefill(p[None, :])[:, : cfg.vocab_size], -1).cpu().numpy()
        toks, _ = srv.decode(7, first)
        assert eng.stream(sid) == [int(first[0])] + [int(t[0]) for t in toks]
