# NOTE: deliberately NO --xla_force_host_platform_device_count here — smoke
# tests and benches must see the real single device; only launch/dryrun.py and
# the subprocess scenarios set up placeholder device fleets.
import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: restart-matrix / chaos-adjacent tests — CI runs them in a "
        "separate tier-1 step (select with -m slow, skip with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device and nvcc (the port's hand-written kernels); "
        "skips without one — run with -m gpu on the card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def assert_close(a, b, rtol=1e-4, atol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)
