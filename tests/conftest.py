"""Test configuration: CPU backend, 8 virtual devices, 64-bit mode.

Verification tests need f64 (the reference is double precision); the
virtual 8-device CPU mesh exercises the multi-device sharding paths
without accelerators. Must run before jax initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_ENABLE_X64"] = "true"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


# --- opt-in periodic compile-cache clearing -------------------------
# Hypothesis test for the XLA-CPU crash that forces the chunked full
# suite (tools/run_full_suite.sh): the backend segfaults in
# backend_compile_and_load after ~25-35 min of ACCUMULATED compiles in
# one process. MRHYDE_CLEAR_CACHES_EVERY=N drops every jit/pjit
# executable cache after each N tests (costing recompiles, changing no
# semantics). If a full one-process run survives with this on, the
# crash is cache-growth-driven and the chunked runner can be retired.
import pytest  # noqa: E402

try:
    _CLEAR_EVERY = int(os.environ.get("MRHYDE_CLEAR_CACHES_EVERY", "0"))
except ValueError:                    # bad opt-in: ignore, don't abort
    import warnings

    warnings.warn("MRHYDE_CLEAR_CACHES_EVERY is not an integer; "
                  "disabling periodic cache clearing")
    _CLEAR_EVERY = 0
_TEST_TICK = {"n": 0}


@pytest.fixture(autouse=_CLEAR_EVERY > 0)
def _periodic_cache_clear():
    yield
    _TEST_TICK["n"] += 1
    if _CLEAR_EVERY and _TEST_TICK["n"] % _CLEAR_EVERY == 0:
        jax.clear_caches()
