"""Test configuration: force an 8-virtual-device CPU backend.

Tests run on the CPU (the CI analog of the reference's software-only
GoogleTest harness, .travis.yml:1-12): the XLA host-device-count flag
gives eight virtual devices for the sharded paths, and jax_platforms is
pinned to the CPU before any backend is initialized, so a machine with a
GPU runs the same tests.  The card itself is exercised by
``python chip_smoke.py`` (README, "Tests"); a test that could only run
there would carry the registered ``gpu`` marker and decide inside a
fixture, never at import time, whether a card is present.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO_ROOT, "data")


@pytest.fixture(scope="session")
def data_dir():
    return DATA_DIR


def random_walk(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(n))


@pytest.fixture
def make_random_walk():
    return random_walk


@pytest.fixture(autouse=True, scope="module")
def _drop_executables_between_modules():
    """XLA:CPU's in-process JIT has segfaulted compiling (or cache-
    (de)serializing) the streaming-append executable late in full-suite
    runs — hundreds of live executables; never when the module runs
    alone, with or without the persistent cache.  Dropping compiled
    executables between modules keeps the compiler far from that state;
    within-module warmth (where reuse actually happens) is preserved."""
    yield
    jax.clear_caches()
