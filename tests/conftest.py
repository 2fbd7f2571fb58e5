"""Test config: run on a virtual 8-device CPU mesh with float64 available.

Must set the env vars before jax initializes its backends. Tests that need
the GPU carry the `gpu` marker and skip here (see the `gpu` fixture);
`python chip_smoke.py` runs their bodies on the card.
"""

import os

# Force CPU: tests want real float64 and an 8-device host mesh, whatever
# accelerator the machine has.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# If jax was imported before this file, the env var alone is too late; the
# config route always works.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from smartedgesensor3dhumanpose_tpu import compile_cache  # noqa: E402

# Persistent compile cache: the pipeline/sharding programs take minutes to
# build; unchanged programs hit the cache on re-runs.
compile_cache.enable(min_entry_size_bytes=-1)

import gc  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _release_executables_between_modules():
    """Drop compiled executables after each test module.

    Every live XLA executable holds JIT code mappings; across the full suite
    (thousands of distinct f64 CPU programs) the process otherwise crosses
    vm.max_map_count (65530) and the NEXT compilation-cache read segfaults
    inside deserialize_executable when mmap fails — deterministically at
    ~85 tests in, while every file passes in isolation. Clearing between
    modules bounds the live-mapping count; the persistent disk cache (above)
    keeps the recompiles cheap.
    """
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips elsewhere (chip_smoke.py runs it)",
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run
    time, never while test modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py`")
