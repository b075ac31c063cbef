"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated without several GPUs by forcing the host
platform and splitting it into 8 XLA devices. Must run before jax is
imported anywhere. Tests that need the card carry the `gpu` marker and skip
unless a GPU backend is present:

    MONTECOSMO_TEST_PLATFORM=cuda,cpu python -m pytest tests/ -m gpu
"""
import os

# CPU unless MONTECOSMO_TEST_PLATFORM says otherwise: tests validate numerics
# and sharding, the benchmark and chip_smoke.py run on the card.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ.get("MONTECOSMO_TEST_PLATFORM", "cpu"))

# persistent compilation cache: the model-layer tests are compile-dominated
# (~2 min per jitted phase on CPU); repeated runs hit the cache.
# $JAX_COMPILATION_CACHE_DIR wins over tests/.jax_cache when set.
from montecosmo_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(default=os.path.join(os.path.dirname(__file__), ".jax_cache"),
                     min_compile_secs=5)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "nightly: slow integration tests (deselect with -m 'not nightly')")
    config.addinivalue_line(
        "markers", "smoke: fast numerics tier (~5 min: pytest -m smoke)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on CPU; see module doc)")


# Fast numerics tier: every file NOT in this set
# is auto-marked `smoke`. The listed files are the compile-heavy model /
# pipeline / sharded-exec suites that push the full run past a judgeable
# wall time on a loaded 1-core box.
_HEAVY_FILES = {
    "test_pipeline.py", "test_model.py", "test_model_variants.py",
    "test_nuts_host_pipeline.py", "test_posterior_recovery.py",
    "test_sharded_exec.py", "test_sharded_model.py", "test_sharded_render.py",
    "test_parallel.py", "test_distributed.py", "test_samplers.py",
    "test_runner.py", "test_vi.py", "test_powspec.py", "test_catalogs.py",
    "test_naive_reference.py", "test_staged_pm.py", "test_chip_smoke.py",
    "test_chip_smoke_sampler.py", "test_chip_smoke_multi.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.path.name not in _HEAVY_FILES and "nightly" not in item.keywords:
            item.add_marker(pytest.mark.smoke)
    if config.getoption("-m"):
        return  # explicit marker expression wins
    skip = pytest.mark.skip(reason="nightly: run with -m nightly")
    for item in items:
        if "nightly" in item.keywords:
            item.add_marker(skip)
