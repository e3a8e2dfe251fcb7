"""The port's data pipeline against the JAX package's: ``synth_batch`` byte
for byte (text, multi-codebook and image-token configs), the prefetching
pipeline's batches and cursor, an exact resume from its state, a reattach
onto another rank's Mana, and the prefetch requests retired as they are
consumed."""
from dataclasses import replace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.core import Cluster as JaxCluster  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import Cluster  # noqa: E402
from repro_torch.data import DataPipeline, synth_batch  # noqa: E402

ARCH = "granite-3-2b"


@pytest.mark.parametrize("extra", [{}, {"n_codebooks": 3}, {"img_tokens": 4}])
@pytest.mark.parametrize("seed,index", [(1, 0), (1, 7), (17, 123456)])
def test_synth_batch_equals_jax_byte_for_byte(extra, seed, index):
    got = synth_batch(replace(smoke_config(ARCH), **extra), 3, 24, seed, index)
    want = JP.synth_batch(replace(jax_smoke_config(ARCH), **extra), 3, 24, seed, index)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def _take(p, n):
    return [p.next() for _ in range(n)]


def test_pipeline_batches_and_cursor_equal_jax_and_resume_exactly():
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    cl, jcl = Cluster(2, "mpich"), JaxCluster(2, "mpich")
    p = DataPipeline(cfg, 2, 16, seed=5, mana=cl.mana(0))
    jp = JP.DataPipeline(jcfg, 2, 16, seed=5, mana=jcl.mana(0))
    try:
        for a, b in zip(_take(p, 3), _take(jp, 3)):
            assert all(a[k].tobytes() == b[k].tobytes() for k in b)
        st = p.state()
        assert st == jp.state() == {"seed": 5, "next_index": 3, "batch_size": 2,
                                    "seq_len": 16}
        ahead = _take(p, 2)
        r = DataPipeline.resume(cfg, st, mana=cl.mana(1))
        try:
            for a, b in zip(_take(r, 2), ahead):
                assert all(a[k].tobytes() == b[k].tobytes() for k in b)
        finally:
            r.stop()
    finally:
        p.stop()
        jp.stop()


def test_pipeline_reattach_keeps_the_cursor_and_retires_requests():
    cfg = smoke_config(ARCH)
    cl = Cluster(2, "mpich")
    p = DataPipeline(cfg, 2, 8, seed=3, mana=cl.mana(0))
    try:
        want = [synth_batch(cfg, 2, 8, 3, i) for i in range(6)]
        got = _take(p, 3)
        assert p.reattach(cl.mana(1)) == {"next_index": 3}
        assert p.mana is cl.mana(1)
        got += _take(p, 3)
        for a, b in zip(got, want):
            assert all(a[k].tobytes() == b[k].tobytes() for k in b)
        # consumed batches' prefetch requests are freed (MPI_Request_free):
        # only the prefetched-but-unconsumed ones may remain registered
        assert len(p._requests) <= p.prefetch + 1
    finally:
        p.stop()
