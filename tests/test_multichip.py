"""Multi-chip sharding dry run on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.mark.slow
def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_after_backend_init():
    """The driver condition that failed rounds 1-2: jax is ALREADY
    imported and a backend initialized before dryrun_multichip is
    called. The subprocess isolation must make this irrelevant."""
    import jax

    jax.devices()  # force backend initialization in this process
    import __graft_entry__ as ge
    ge.dryrun_multichip(4)


@pytest.mark.slow
def test_dryrun_multichip_ignores_hostile_env(monkeypatch):
    """Env pointing at an absent accelerator plugin must be scrubbed by
    the subprocess launcher."""
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("PJRT_NAMES_AND_LIBRARY_PATHS",
                       "cuda:/nonexistent/plugin.so")
    import __graft_entry__ as ge
    ge.dryrun_multichip(2)


def test_sharded_step_matches_single_device():
    import __graft_entry__ as ge
    from mrhyde_tpu.assembly.assembler import TimeCoeffs
    from mrhyde_tpu.parallel.sharding import (make_mesh,
                                              sharded_newton_cg_step)

    p = ge._build_problem(nx=6, ny=6)
    u0 = p.initial_state()
    tc = TimeCoeffs.steady(p.n_dof, dtype=u0.dtype)

    mesh8 = make_mesh(8)
    step8, _ = sharded_newton_cg_step(p.assembler, mesh8, cg_iters=30)
    u8, _ = step8(u0, tc, None)

    mesh1 = make_mesh(1)
    step1, _ = sharded_newton_cg_step(p.assembler, mesh1, cg_iters=30)
    u1, _ = step1(u0, tc, None)

    np.testing.assert_allclose(np.asarray(u8), np.asarray(u1),
                               rtol=1e-10, atol=1e-12)
    assert jnp.isfinite(u8).all()
