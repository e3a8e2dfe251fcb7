"""The split-KV decode's cut of a cache into splits, on the CPU: the split
length per head dim (the wrappers' against the CUDA source's
``split_len``), the split counts of the contiguous, ring and paged
decodes, and the float32 partials a launch allocates for them. The
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


@pytest.mark.parametrize("D", [32, 64])
def test_dispatch_routes_bf16_g1_to_its_kernel(D):
    """bf16 at G = 1 (H == K) and D <= 64 launches decode_g1_kernel;
    float32, G > 1 and D = 128 keep their kernels."""
    src = (build.CSRC / "decode_split.cuh").read_text()
    body = src[src.index("int dispatch("):]
    m = re.search(rf"if \(dtype == 1 && D == {D} && H == K\)\s+return launch_g1<{D}>\(", body)
    assert m, f"no G = 1 route at D = {D}"
    # the G = 1 route comes before the general bf16 one at the same D
    general = re.search(rf"if \(dtype == 1 && D == {D}\)\s+return launch<bf16, {D}>\(", body)
    assert general and m.start() < general.start()
    assert not re.search(r"dtype == 0[^\n]*H == K", body)
    assert "launch_g1<128>" not in body
