"""Runtime/dtype configuration.

The reference framework compiles with ScalarT = double by default and
float with MrHyDE_SINGLE_PRECISION (reference: src/preferences.hpp:40-44).
Here the working dtype is float32 unless JAX x64 mode is on (`--fp64`,
or the f64 verification tests); all framework code takes its working
dtype from here rather than hard-coding.
"""

import os as _os

import jax
import jax.numpy as jnp

# FEM assembly einsums and Krylov dot products must be TRUE f32: on a
# GPU the default matmul precision lets f32 contractions run in TF32,
# whose 10-bit mantissa (~1e-3 relative) swamps small residual entries
# and floors Newton residual norms at that noise level. HIGHEST keeps
# every f32 product in full f32.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: deck-CLI runs are separate processes,
# and without an on-disk cache every `python -m mrhyde_tpu.driver
# deck.yaml` recompiles the whole solve. JAX_COMPILATION_CACHE_DIR, when
# set, is JAX's own setting and is left alone; otherwise the cache lives
# at one fixed path in the checkout (the path is part of the cache key,
# so a directory that moves never hits).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def fp64(enable: bool = True) -> None:
    """Enable (or disable) 64-bit mode globally. Call before any tracing."""
    jax.config.update("jax_enable_x64", enable)


def default_dtype():
    """The current default floating dtype (f64 iff x64 mode is on)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
