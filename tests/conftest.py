"""Test config: run on CPU with 8 fake devices (multi-chip sharding tests)
and enable x64 so oracles can be checked at reference tolerances
(SURVEY.md section 4: dense-numpy equivalence + objective dominance).

``ADELIE_TEST_PLATFORM=gpu`` keeps the GPU instead, for the tests marked
``gpu`` (``python -m pytest tests/test_gpu_kernels.py -m gpu`` on a
machine with a card);
everywhere else those tests skip through the ``gpu`` fixture."""

import os

import pytest

ON_GPU = os.environ.get("ADELIE_TEST_PLATFORM") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

# a pytest plugin may import jax before this conftest runs, so the env vars
# above can be too late — the config update below works as long as no
# backend has been initialized yet
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compile cache: ON by default in a SUITE-PRIVATE dir.
# XLA:CPU compile AND executable (de)serialization segfault
# stochastically on the big 8-device SPMD programs, with probability
# growing in the number of live compiles a process performs (r5
# measured: 4/4 no-cache shard-3 attempts crashed; warm-cache attempts
# mostly pass).  The cache makes tests/run_all.py's crash-retries
# CONVERGE: everything compiled before a crash is served from disk on
# the retry, so each attempt faces strictly less compile volume.
# ADELIE_TPU_TEST_NO_CACHE=1 opts out (e.g. when chasing cache bugs).
if os.environ.get("ADELIE_TPU_TEST_NO_CACHE"):
    # also stop the package import from enabling its production cache
    # inside test processes
    os.environ["ADELIE_TPU_NO_CACHE"] = "1"
else:
    # A suite-private cache dir (unless JAX_COMPILATION_CACHE_DIR names
    # one): entries written without jax_persistent_cache_enable_xla_caches
    # = "none" embed host-CPU-feature-pinned XLA:CPU results whose
    # deserialization can crash a later reader.  A private dir only ever
    # written under the settings below cannot contain such entries.
    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), ".jax_cache", "suite"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    # keep XLA:CPU AOT blobs (which pin host CPU feature flags and log
    # SIGILL warnings on reload) out of the cache — the HLO entry is the win
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with ADELIE_TEST_PLATFORM=gpu")
