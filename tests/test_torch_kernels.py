"""The port's plain attention versions against the JAX package's oracles and
its Pallas kernels (interpret mode, as tests/test_kernels.py runs them), the
ops dispatch, and the kernel build command. Same numpy inputs on both sides.

Tolerance: float32 on both sides, different summation order: 1e-5 against
the jnp oracles (same math, only the softmax/einsum order differs) and 2e-5
against the Pallas kernels (online softmax, the tests/test_kernels.py TOL).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

torch.set_num_threads(1)
TOL_ORACLE = 1e-5
TOL_PALLAS = 2e-5


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,K,S,D,window", [
    (2, 4, 2, 32, 32, None),     # G = 2
    (1, 4, 4, 48, 32, None),     # G = 1
    (2, 4, 2, 32, 64, 8),        # window
])
def test_naive_attention_matches_jax_and_pallas(B, H, K, S, D, window):
    rng = np.random.default_rng(S + D + H)
    q = rng.standard_normal((B, H, S, D), dtype=np.float32)
    k = rng.standard_normal((B, K, S, D), dtype=np.float32)
    v = rng.standard_normal((B, K, S, D), dtype=np.float32)
    got = ref.naive_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=window)
    _close(got, jref.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     window=window), TOL_ORACLE)
    _close(got, pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window, q_block=16, kv_block=16,
                             interpret=True), TOL_PALLAS)


@pytest.mark.parametrize("length", [1, 21, 64])
@pytest.mark.parametrize("B,H,K,D,window", [
    (2, 4, 2, 32, None),         # G = 2
    (1, 4, 4, 64, None),         # G = 1
    (2, 4, 2, 32, 16),           # window
])
def test_naive_decode_attention_matches_jax_and_pallas(B, H, K, D, window, length):
    S = 64
    rng = np.random.default_rng(length + D + H)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, K, D), dtype=np.float32)     # cache layout
    v = rng.standard_normal((B, S, K, D), dtype=np.float32)
    got = ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)), length,
                               window=window)
    _close(got, jref.naive_decode_attention(
        jnp.asarray(q), jnp.moveaxis(jnp.asarray(k), 1, 2),
        jnp.moveaxis(jnp.asarray(v), 1, 2), length, window=window), TOL_ORACLE)
    _close(got, pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length,
                              n_splits=8, window=window, interpret=True), TOL_PALLAS)


def test_ops_dispatch_cpu_takes_plain_version():
    q, k, v = (torch.randn(1, 2, 8, 32) for _ in range(3))
    before = (FA.launches, DA.launches)
    torch.testing.assert_close(ops.flash_attention(q, k, v), ref.naive_attention(q, k, v))
    torch.testing.assert_close(ops.flash_attention(q, k, v, force="ref"),
                               ref.naive_attention(q, k, v))
    qd, kd = torch.randn(1, 2, 32), torch.randn(1, 8, 2, 32)
    torch.testing.assert_close(
        ops.decode_attention(qd, kd, kd, 5),
        ref.naive_decode_attention(qd, kd.transpose(1, 2), kd.transpose(1, 2), 5))
    assert (FA.launches, DA.launches) == before


@pytest.mark.parametrize("call", ["flash", "decode"])
def test_ops_force_kernel_on_cpu_raises(call):
    q, k = torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "flash":
            ops.flash_attention(q, k, k, force="kernel")
        else:
            ops.decode_attention(q[:, :, 0], k.transpose(1, 2), k.transpose(1, 2), 3,
                                 force="kernel")
    with pytest.raises(ValueError, match="force"):
        ops.flash_attention(q, k, k, force="xla")


@pytest.mark.parametrize("fn", [FA.flash_attention, DA.decode_attention])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    q = torch.randn(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, q, q, 3) if fn is DA.decode_attention else fn(q, q, q)


@pytest.mark.parametrize("name", build.SOURCES)
def test_build_command_targets_sm90a_from_package_sources(name, tmp_path):
    cmd = build.nvcc_command(name, tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-std=c++17"} <= set(cmd)
    sources = [c for c in cmd if c.endswith((".cu", ".cuh", ".cpp"))]
    assert sources == [str(build.CSRC / f"{name}.cu")]
    assert (build.CSRC / f"{name}.cu").is_file()
    assert build.BUILD_ROOT.parent == build.CSRC.parent     # inside the package
    with pytest.raises(KeyError):
        build.nvcc_command("cublas", tmp_path / "x.so")


def test_build_dir_is_ignored_by_git():
    root = build.PKG.parents[1]
    ignored = (root / ".gitignore").read_text().split()
    assert str(build.BUILD_ROOT.relative_to(root)) + "/" in ignored


def test_nonzero_launch_status_raises():
    build.check(0, "k")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        build.check(9, "k")
