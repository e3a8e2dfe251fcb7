"""The port's plain attention versions against the JAX package's oracles and
its Pallas kernels (interpret mode, as tests/test_kernels.py runs them), the
ops dispatch, and the kernel build command. Same numpy inputs on both sides.

Tolerance: float32 on both sides, different summation order: 1e-5 against
the jnp oracles (same math, only the softmax/einsum order differs) and 2e-5
against the Pallas kernels (online softmax, the tests/test_kernels.py TOL).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention import paged_attention_pool_view as pallas_pool_view  # noqa: E402
from repro.kernels.decode_attention import paged_decode_attention as pallas_paged  # noqa: E402
from repro.serving.kv_pool import PagePool as JaxPool  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PA  # noqa: E402
from repro_torch.serving.kv_pool import PagePool  # noqa: E402

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


@pytest.mark.parametrize("window", [None, 24])
def test_naive_paged_decode_attention_matches_pallas_paged_kernel(window):
    # tests/test_kernels.py::test_paged_decode_attention's shapes: a shuffled
    # pool larger than needed, table entries past each length set to 0
    B, H, K, D, page_size, n_pages = 2, 4, 2, 64, 16, 4
    n_pool = B * n_pages + 3
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kp = rng.standard_normal((n_pool, page_size, K, D), dtype=np.float32)
    vp = rng.standard_normal((n_pool, page_size, K, D), dtype=np.float32)
    pt = rng.permutation(n_pool)[:B * n_pages].reshape(B, n_pages).astype(np.int32)
    lengths = np.array([page_size * n_pages - 5, 2 * page_size - 3], np.int32)
    for b in range(B):
        pt[b, (lengths[b] + page_size - 1) // page_size:] = 0
    got = ops.paged_decode_attention(*(torch.from_numpy(x) for x in (q, kp, vp, pt, lengths)),
                                     window=window)
    _close(got, pallas_paged(*(jnp.asarray(x) for x in (q, kp, vp, pt, lengths)),
                             window=window, interpret=True), TOL_ORACLE)
    # a zero length gives a zero row, as the Pallas kernel's empty sum does
    lengths[1] = 0
    got = ref.naive_paged_decode_attention(*(torch.from_numpy(x) for x in
                                             (q, kp, vp, pt, lengths)), window=window)
    assert not got[1].any()
    _close(got, pallas_paged(*(jnp.asarray(x) for x in (q, kp, vp, pt, lengths)),
                             window=window, interpret=True), TOL_ORACLE)


def test_kernel_view_matches_jax_pool_kernel_view():
    # tests/test_serving.py::test_kernel_view_matches_dense_decode_attention
    K, D, H = 2, 8, 4
    rng = np.random.default_rng(9)
    jp, tp = JaxPool(16, 4), PagePool(16, 4, device="cpu")
    for sid, L in (("s0", 6), ("s1", 11)):
        rows = {k: rng.standard_normal((L, K * D)).astype(np.float32) for k in "kv"}
        for p in (jp, tp):
            p.admit(sid, L)
            p.write_tokens(sid, 0, rows)
    jview = jp.kernel_view(["s0", "s1"], "k", "v", K, D)
    tview = tp.kernel_view(["s0", "s1"], "k", "v", K, D)
    for j, t in zip(jview, tview):
        assert tuple(t.shape) == j.shape and str(t.dtype).endswith(str(j.dtype))
        np.testing.assert_array_equal(t.numpy(), j)
    assert tview[0].data_ptr() == tp.stores["k"].data_ptr()      # a view, no copy
    q = rng.standard_normal((2, H, D)).astype(np.float32)
    _close(ops.paged_attention_pool_view(torch.from_numpy(q), tview),
           pallas_pool_view(q, jview, interpret=True), TOL_ORACLE)
    with pytest.raises(ValueError, match="K\\*D"):
        tp.kernel_view(["s0"], "k", "v", K, D + 1)


def test_ops_dispatch_cpu_takes_plain_version():
    q, k, v = (torch.randn(1, 2, 8, 32) for _ in range(3))
    before = (FA.launches, DA.launches, PA.launches)
    torch.testing.assert_close(ops.flash_attention(q, k, v), ref.naive_attention(q, k, v))
    torch.testing.assert_close(ops.flash_attention(q, k, v, force="ref"),
                               ref.naive_attention(q, k, v))
    qd, kd = torch.randn(1, 2, 32), torch.randn(1, 8, 2, 32)
    torch.testing.assert_close(
        ops.decode_attention(qd, kd, kd, 5),
        ref.naive_decode_attention(qd, kd.transpose(1, 2), kd.transpose(1, 2), 5))
    table, lengths = torch.zeros(1, 2, dtype=torch.int32), torch.tensor([5], dtype=torch.int32)
    torch.testing.assert_close(
        ops.paged_decode_attention(qd, kd.view(2, 4, 2, 32), kd.view(2, 4, 2, 32), table,
                                   lengths),
        ref.naive_paged_decode_attention(qd, kd.view(2, 4, 2, 32), kd.view(2, 4, 2, 32),
                                         table, lengths))
    assert (FA.launches, DA.launches, PA.launches) == before


@pytest.mark.parametrize("call", ["flash", "decode", "paged"])
def test_ops_force_kernel_on_cpu_raises(call):
    q, k = torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "flash":
            ops.flash_attention(q, k, k, force="kernel")
        elif call == "decode":
            ops.decode_attention(q[:, :, 0], k.transpose(1, 2), k.transpose(1, 2), 3,
                                 force="kernel")
        else:
            ops.paged_decode_attention(q[:, :, 0], k.view(2, 8, 1, 32), k.view(2, 8, 1, 32),
                                       torch.zeros(1, 1, dtype=torch.int32),
                                       torch.ones(1, dtype=torch.int32), force="kernel")
    with pytest.raises(ValueError, match="force"):
        ops.flash_attention(q, k, k, force="xla")


@pytest.mark.parametrize("fn", [FA.flash_attention, DA.decode_attention,
                                PA.paged_decode_attention, FA.flash_attention_bwd])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    q = torch.randn(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        if fn is DA.decode_attention:
            fn(q, q, q, 3)
        elif fn is PA.paged_decode_attention:
            fn(q[:, :, 0], q, q, torch.zeros(1, 1, dtype=torch.int32),
               torch.ones(1, dtype=torch.int32))
        elif fn is FA.flash_attention_bwd:
            fn(q, q, q, q, torch.zeros(1, 2, 8), q)
        else:
            fn(q, q, q)


def test_backward_source_is_deterministic_and_on_wgmma_and_tma():
    """K1's backward sums every output row in one block, in a fixed order:
    no atomic operation in its code (comments aside); its bf16 kernels take
    their tiles from TMA into wgmma, and the row sums come from the dQ
    kernel, not from a pass of their own. The TMA and wgmma helpers live in
    the shared ``hopper.cuh``, which the source includes: it is read with
    it."""
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert '#include "hopper.cuh"' in src
    src += (build.CSRC / "hopper.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code.lower()
    assert "preprocess" not in code and "bwd_delta" not in code
    assert "cp.async.bulk.tensor" in code and "wgmma.mma_async" in code
    assert "mma.sync" not in code
    assert {"dq_bf16_kernel", "dkdv_bf16_kernel", "dq_f32_kernel", "dkdv_f32_kernel"} <= set(
        re.findall(r"\b(\w+_kernel)\b", code))
    assert re.findall(r'extern "C" int (\w+)', code) == ["repro_flash_attention_bwd_v",
                                                          "repro_flash_attention_bwd"]


@pytest.mark.parametrize("name", build.SOURCES)
def test_build_command_targets_sm90a_from_package_sources(name, tmp_path):
    cmd = build.nvcc_command(name, tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-std=c++17"} <= set(cmd)
    sources = [c for c in cmd if c.endswith((".cu", ".cuh", ".cpp"))]
    assert sources == [str(build.CSRC / f"{name}.cu")]
    assert "paged_decode_attention" in build.SOURCES
    assert (build.CSRC / f"{name}.cu").is_file()
    assert build.BUILD_ROOT.parent == build.CSRC.parent     # inside the package
    with pytest.raises(KeyError):
        build.nvcc_command("cublas", tmp_path / "x.so")


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._lib_path(n) for n in build.SOURCES}
    hdr = tmp_path / "decode_split.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: build._lib_path(n) for n in build.SOURCES}
    assert after["decode_attention"] != before["decode_attention"]
    assert after["paged_decode_attention"] != before["paged_decode_attention"]


def test_build_dir_is_ignored_by_git():
    root = build.PKG.parents[1]
    ignored = (root / ".gitignore").read_text().split()
    assert str(build.BUILD_ROOT.relative_to(root)) + "/" in ignored


def test_nonzero_launch_status_raises():
    build.check(0, "k")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        build.check(9, "k")
