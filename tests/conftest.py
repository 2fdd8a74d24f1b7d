"""Shared fixtures.  NOTE: no XLA device-count forcing here — smoke tests and
benches see the real single CPU device; only launch/dryrun.py forces 512."""
import jax
import numpy as np
import pytest


@pytest.fixture(scope="session", autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")
