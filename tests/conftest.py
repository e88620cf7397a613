"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; the standard way to test
pjit/shard_map/psum without a pod is XLA's host-platform device-count
override (SURVEY.md section 4).

The platform is pinned through the config value itself (not only the
JAX_PLATFORMS variable), before any backend initializes, so the suite
runs on the CPU even where a GPU is present.  Tests that need the card
carry the `gpu` marker and skip here; `python chip_smoke.py` runs what
only the card can run.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu", jax.devices()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """`@pytest.mark.gpu` tests need an NVIDIA card; decided here, per
    test, never while modules are imported."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` "
                        "on the card")


@pytest.fixture()
def rng(request):
    """Per-test rng seeded from the test id: draws are deterministic
    AND independent of which other tests ran first.  (A session-scoped
    rng coupled every test to suite composition — adding a test shifted
    all downstream draws and made unrelated tests flaky.)"""
    import zlib

    return np.random.default_rng(zlib.adler32(request.node.nodeid.encode()))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The suite compiles hundreds of distinct XLA programs (many of them
    shard_map programs over the 8-device mesh, plus interpret-mode
    Pallas kernels); holding every executable alive for the whole
    session accumulates runtime state (collective contexts, thread
    pools) that has been observed to end in a segfault inside a late
    sharded solve (XLA:CPU runtime, not test logic — the same test
    passes standalone and in subsets).  Per-module cache clearing
    bounds that state; modules re-compile what they need.
    """
    yield
    jax.clear_caches()
