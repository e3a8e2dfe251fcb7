"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``; each test skips without a CUDA device. This file imports no
JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: bf16 2e-2 (8 significant bits; one rounding of an output near
1 is 2^-8), float32 2e-5 (summation order only), as tests/test_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.serving.engine import Server  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


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


def test_decode_kernel_refuses_more_query_heads_per_kv_head(cuda):
    q = torch.randn(1, 2 * DA.MAX_G, 64, device=cuda)
    k = torch.randn(1, 8, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="query heads per KV head"):
        DA.decode_attention(q, k, k, 4)


def test_force_ref_on_cuda_launches_nothing(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda)
    n0 = (FA.launches, DA.launches)
    ops.flash_attention(q, q, q, force="ref")
    ops.decode_attention(q[:, :, 0], q.transpose(1, 2), q.transpose(1, 2), 3, force="ref")
    assert (FA.launches, DA.launches) == n0


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

