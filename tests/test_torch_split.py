"""The split-KV decode's cut of a cache into splits, on the CPU: the split
length per head dim (the wrappers' against the CUDA source's
``split_len``), the split counts of the contiguous, ring and paged
decodes, the float32 partials a launch allocates for them, which kernel
runs at each (dtype, head dim, G) (the wrappers' ``kernel`` against the
source's ``mma_route`` and dispatch), and the tensor-core kernel's plan at
the serving shapes: its blocks in one wave, its combine in one round. The
kernels themselves run only on the card (``tests/test_torch_gpu.py``)."""
import inspect
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PA  # noqa: E402


def _source_split_len(D: int) -> int:
    """``split_len(D)`` as ``csrc/decode_split.cuh`` defines it."""
    src = (build.CSRC / "decode_split.cuh").read_text()
    m = re.search(r"constexpr int split_len\(int D\) \{ return D > (\d+) \? (\d+) : (\d+); \}",
                  src)
    assert m, "split_len not found in decode_split.cuh"
    edge, above, below = (int(x) for x in m.groups())
    return above if D > edge else below


@pytest.mark.parametrize("D", DA.HEAD_DIMS)
def test_split_length_per_head_dim(D):
    """64 positions at head dim 128 (the bf16 kernel's tensor-core tile),
    128 below; the wrappers pass the source's value."""
    assert DA.split_len(D) == {32: 128, 64: 128, 128: 64}[D]
    assert DA.split_len(D) == _source_split_len(D)
    assert PA.split_len is DA.split_len


def test_wrappers_size_partials_by_the_split_length():
    """Both entries size their partials with ``partials`` over the split
    count at the call's head dim and pass that split to the C entry."""
    for src in (inspect.getsource(DA._launch), inspect.getsource(PA.paged_decode_attention)):
        assert "partials(" in src and "split_len(D)" in src
    for fn in (DA.decode_attention, DA.ring_decode_attention):
        assert "n_splits(" in inspect.getsource(fn) and ", D)" in inspect.getsource(fn)


@pytest.mark.parametrize("D", DA.HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 31, 63, 64, 65, 127, 128, 129, 1000, 1056, 4096, 4097])
def test_n_splits_cover_the_positions(S, D):
    n, split = DA.n_splits(S, D), DA.split_len(D)
    assert (n - 1) * split < S <= n * split


@pytest.mark.parametrize("D", DA.HEAD_DIMS)
@pytest.mark.parametrize("n_tab,page", [(1, 16), (4, 16), (66, 16), (5, 1), (3, 64),
                                        (2, 100), (17, 7)])
def test_paged_and_contiguous_n_splits_agree(n_tab, page, D):
    """A paged table's positions are cut as a contiguous cache of as many
    positions is, so in-order pages give the contiguous decode's bits."""
    assert PA.n_splits(n_tab, page, D) == DA.n_splits(n_tab * page, D)


@pytest.mark.parametrize("D,S,want", [(64, 1056, 9), (128, 1056, 17), (128, 1024, 16),
                                      (64, 1024, 8), (128, 64, 1), (128, 65, 2)])
def test_serving_shapes_split_counts(D, S, want):
    """granite-3-2b's last decode step (9 splits of 128), qwen2.5-14b's (17
    of 64: 136 blocks over its 8 KV heads at one fleet lane)."""
    assert DA.n_splits(S, D) == want


@pytest.mark.parametrize("B,H,K,D,ns", [(4, 40, 8, 128, 17), (1, 40, 8, 128, 17),
                                        (4, 32, 8, 64, 9), (2, 16, 1, 128, 70),
                                        (1, 4, 4, 32, 1)])
def test_partials_shapes(B, H, K, D, ns):
    """The scratch a launch writes: unnormalised outputs [B,K,ns,G,D] and
    each split's (m, l) [2,B,K,ns,G], float32 whatever the input dtype."""
    part_o, part_ml = DA.partials(B, H, K, D, ns, "cpu")
    G = H // K
    assert part_o.shape == (B, K, ns, G, D) and part_o.dtype == torch.float32
    assert part_ml.shape == (2, B, K, ns, G) and part_ml.dtype == torch.float32
    assert part_o.is_contiguous() and part_ml.is_contiguous()


def _g1_source():
    """``csrc/decode_split.cuh``'s G = 1 part: namespace ``g1`` through the
    dispatch."""
    src = (build.CSRC / "decode_split.cuh").read_text()
    return src[src.index("namespace g1 {"):]


@pytest.mark.parametrize("B,H,K,D,S,ns", [(4, 36, 36, 64, 1056, 9), (1, 36, 36, 64, 1056, 9),
                                          (2, 4, 4, 32, 2049, 17), (3, 4, 4, 64, 128, 1)])
def test_g1_split_plan_and_partials(B, H, K, D, S, ns):
    """The G = 1 decode (minicpm-2b's MHA: B4 H36 K36 D64 at 1056 positions,
    and one fleet lane of it) cuts a row into split_len(D) = 128-position
    splits like every G, so its work items, (row, KV head, split), number
    B K ns, and its partials are the G = 1 case of ``partials``."""
    assert H == K and DA.n_splits(S, D) == ns
    part_o, part_ml = DA.partials(B, H, K, D, ns, "cpu")
    assert part_o.shape == (B, K, ns, 1, D) and part_ml.shape == (2, B, K, ns, 1)
    assert part_o.numel() == B * K * ns * D and part_ml[0].numel() == B * K * ns
    page = 16
    assert PA.n_splits(-(-S // page), page, D) == DA.n_splits(-(-S // page) * page, D)


@pytest.mark.parametrize("D", [32, 64])
def test_g1_kernel_takes_the_wrappers_split(D):
    """decode_g1_kernel's items are split_len(D) positions (the value the
    wrappers size the partials by and pass to the C entry), and a split is
    its 4 warps' 32 positions each."""
    src = _g1_source()
    assert re.search(r"static constexpr int SPLIT = split_len\(D\);", src)
    assert re.search(r"constexpr int NWARP = 4;", src)
    assert DA.split_len(D) == _source_split_len(D) == 4 * 32


def _dispatch():
    """The source's ``dispatch`` body."""
    src = (build.CSRC / "decode_split.cuh").read_text()
    return src[src.index("int dispatch("):]


@pytest.mark.parametrize("D", [32, 64])
def test_dispatch_routes_bf16_g1_to_its_kernel(D):
    """bf16 at G = 1 (H == K) and D <= 64 launches decode_g1_kernel, after
    the tensor-core route (which takes D = 64 only at G > 1) and before the
    general bf16 one at D = 32; float32 and D = 128 keep their kernels."""
    body = _dispatch()
    m = re.search(rf"if \(dtype == 1 && D == {D} && H == K\)\s+return launch_g1<{D}>\(", body)
    assert m, f"no G = 1 route at D = {D}"
    tc = re.search(r"const bool tc = dtype == 1 && mma_route\(D, H / K\);", body)
    assert tc and tc.start() < m.start()
    assert not _route_rule()(D, 1)
    general = re.search(r"if \(dtype == 1 && D == 32\)\s+return launch<bf16, 32>\(", body)
    assert general and m.start() < general.start()
    assert "launch<bf16, 64>" not in body    # bf16 at D = 64 is G = 1's or the tensor cores'
    assert not re.search(r"dtype == 0[^\n]*H == K", body)
    assert "launch_g1<128>" not in body


def _route_rule():
    """``mma_route``'s expression as Python: a function of (D, G)."""
    src = (build.CSRC / "decode_split.cuh").read_text()
    m = re.search(r"constexpr bool mma_route\(int D, int G\) \{\s*return ([^;]+);\s*\}", src)
    assert m, "mma_route not found in decode_split.cuh"
    expr = m.group(1).replace("&&", " and ").replace("||", " or ")
    return lambda D, G: bool(eval(expr, {}, {"D": D, "G": G}))


@pytest.mark.parametrize("G", range(1, DA.MAX_G + 1))
@pytest.mark.parametrize("D", DA.HEAD_DIMS)
def test_wrapper_route_mirrors_the_source(D, G):
    """``kernel`` names the kernel the C dispatch launches at every head dim
    and G: the tensor-core kernel where ``mma_route`` holds in bf16, the G
    = 1 kernel at G = 1 and D <= 64, else decode_kernel (float32 always)."""
    if _route_rule()(D, G):
        want = "decode_mma_kernel"
    elif G == 1 and D <= 64:
        want = "decode_g1_kernel"
    else:
        want = "decode_kernel"
    assert DA.kernel(torch.bfloat16, D, G) == want
    assert DA.kernel(torch.float32, D, G) == "decode_kernel"
    body = _dispatch()
    for d in (64, 128):
        assert re.search(rf"if \(tc && D == {d}\)\s+return launch_mma<{d}>\(", body)


@pytest.mark.parametrize("row,D,G,kernel", [
    ("2 granite-3-2b", 64, 4, "decode_mma_kernel"), ("2r hymba-1.5b", 64, 5, "decode_mma_kernel"),
    ("2e granite-moe-3b-a800m", 64, 3, "decode_mma_kernel"),
    ("2m minicpm-2b", 64, 1, "decode_g1_kernel"), ("2q qwen2.5-14b", 128, 5, "decode_mma_kernel"),
    ("2l llava-next-34b", 128, 7, "decode_mma_kernel"),
    ("the smoke configs' head dim", 32, 4, "decode_kernel")])
def test_model_shapes_route(row, D, G, kernel):
    """Each model's decode (K2, K2 over a ring and K3 alike), by the rule."""
    assert DA.kernel(torch.bfloat16, D, G) == kernel


def _tc(D):
    """``tc::L<D>``'s members as the source defines them, with the
    namespace's constants."""
    src = (build.CSRC / "decode_split.cuh").read_text()
    ns = src[src.index("namespace tc {"):src.index("}  // namespace tc")]
    env = {"D": D, "GMAX": DA.MAX_G, "split_len": DA.split_len}
    decls = re.findall(r"^constexpr int (\w+) = ([^;]+);", ns, re.M)
    decls += re.findall(r"static constexpr int (\w+) = ([^;]+);", ns)
    for name, expr in decls:
        e = expr.replace("/", "//")
        if m := re.fullmatch(r"(.+?) \? (.+?) : (.+)", e.strip()):   # a ? b : c
            e = f"({m.group(2)}) if ({m.group(1)}) else ({m.group(3)})"
        env[name] = eval(e, {}, env)
    return env


@pytest.mark.parametrize("G", [1, 2, 3, 5, 7, 8, 16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("ns", [1, 2, 3, 4, 5, 8, 9, 16, 17, 33, 65])
def test_block_plan(ns, D, G):
    """A launch over ns splits: a tensor-core block takes MMA_SPAN = 128
    positions (tc::L<D>::SPAN: one split at D = 64, two at 128), so a row
    runs ceil(ns / per) blocks and writes one partial a block, as the
    source's launch_mma sizes its grid. The other kernels (float32, and
    bf16 at G = 1 and D = 64) run ns blocks (or items) and write ns
    partials."""
    L = _tc(D)
    assert L["SPAN"] == DA.MMA_SPAN and L["PER"] == DA.MMA_SPAN // DA.split_len(D)
    sl = DA.slots(torch.bfloat16, D, G, ns)
    if DA.kernel(torch.bfloat16, D, G) == "decode_mma_kernel":
        assert sl == -(-ns // L["PER"]) and (sl - 1) * L["SPAN"] < ns * DA.split_len(D)
    else:
        assert (D, G) == (64, 1) and sl == ns
    assert DA.slots(torch.float32, D, G, ns) == ns
    src = (build.CSRC / "decode_split.cuh").read_text()
    body = src[src.index("int launch_mma("):]
    body = body[:body.index("\n}\n")]
    assert "const int n_blk = (n_splits + Ly::PER - 1) / Ly::PER;" in body
    assert "kernel<<<dim3(n_blk, K, B), tc::THREADS, Ly::BYTES, st>>>(" in body


@pytest.mark.parametrize("row,B,H,K,D,slots", [
    ("2e granite-moe-3b-a800m", 4, 24, 8, 64, 9), ("2l llava-next-34b", 4, 56, 8, 128, 9),
    ("2 granite-3-2b", 4, 32, 8, 64, 9), ("2q qwen2.5-14b", 4, 40, 8, 128, 9)])
def test_partials_at_the_serving_shapes(row, B, H, K, D, slots):
    """The scratch a launch at the row's last decode step (1056 positions:
    9 splits of 128 at D = 64, 17 of 64 at 128) allocates: one partial a
    128-position block, G x D float32 outputs and an (m, l) each."""
    G = H // K
    sl = DA.slots(torch.bfloat16, D, G, DA.n_splits(1056, D))
    assert sl == slots
    part_o, part_ml = DA.partials(B, H, K, D, sl, "cpu")
    assert part_o.shape == (B, K, slots, G, D) and part_ml.shape == (2, B, K, slots, G)
    assert part_o.numel() * 4 == B * K * slots * G * D * 4


SMS = 132            # SMs of an H100 SXM
SM_SMEM = 233472     # bytes of shared memory an SM holds (228 KB)


@pytest.mark.parametrize("row,B,K,D,length", [
    ("2e granite-moe-3b-a800m", 4, 8, 64, 1056), ("2l llava-next-34b", 4, 8, 128, 1056),
    ("2 granite-3-2b", 4, 8, 64, 1056), ("2q qwen2.5-14b", 4, 8, 128, 1056),
    ("2r hymba-1.5b's ring", 4, 5, 64, 1024)])
def test_tensor_core_decode_runs_in_one_wave(row, B, K, D, length):
    """The rows' blocks fit the card at once: tc::L<D>::RESIDENT blocks an
    SM (their dynamic shared memory, at most the block's static arrays and
    the 1 KB the card reserves a block allow it) times 132 SMs hold them
    all: 288 blocks (160 for hymba's ring) against 396 slots at D = 128 and
    528 at 64."""
    L = _tc(D)
    blocks = B * K * DA.slots(torch.bfloat16, D, 2, DA.n_splits(length, D))
    assert blocks <= L["RESIDENT"] * SMS
    static = (3 * L["NWARP"] + 3) * DA.MAX_G * 4 + 4
    assert L["RESIDENT"] * (L["BYTES"] + static + 1024) <= SM_SMEM
    assert {64: 4, 128: 3}[D] == L["RESIDENT"]
    assert L["BYTES"] == 2 * L["SPAN"] * (D * 2 + 16) + DA.MAX_G * (D * 2 + 16)
    src = (build.CSRC / "decode_split.cuh").read_text()
    assert "__launch_bounds__(tc::THREADS, tc::L<D>::RESIDENT) decode_mma_kernel(" in src


@pytest.mark.parametrize("G", [2, 3, 4, 5, 7, 8, 16])
@pytest.mark.parametrize("D", [64, 128])
def test_combine_takes_a_serving_rows_partials_in_one_round(D, G):
    """At 1056 positions the last block's combine stages every partial in
    shared memory in one round (CS a round, as the kernel sizes it) at
    every G <= 16 at D = 64 and every G <= 8 at 128 (16 takes two)."""
    L = _tc(D)
    n_p = DA.slots(torch.bfloat16, D, G, DA.n_splits(1056, D))
    cs = min(L["CMAX"], (L["BYTES"] - L["WMAX"] * G * 4) // (G * D * 4))
    assert cs * G * D * 4 + L["WMAX"] * G * 4 <= L["BYTES"]
    assert (cs >= n_p) == (D == 64 or G <= 8)
    src = (build.CSRC / "decode_split.cuh").read_text()
    assert "const int CS = min(CMAX, (Ly::BYTES - WMAX * G * 4) / (GD * 4));" in src
