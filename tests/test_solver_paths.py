"""The paths an accelerator takes, checked on the CPU: the resident
`lax.while_loop` Newton against the host loop, the dense direct solve,
the compile-cache placement, and the refusal to move a sharded deck to
another platform when the accelerator has too few devices."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from mrhyde_tpu.assembly.assembler import TimeCoeffs
from mrhyde_tpu.problem import Problem
from mrhyde_tpu.solvers import nonlinear
from mrhyde_tpu.solvers.linear import solve_dense

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_THERMAL = {
    "Mesh": {"dimension": 2, "element type": "quad", "NX": 8, "NY": 8},
    "Functions": {"thermal source": "8*(pi*pi)*sin(2*pi*x)*sin(2*pi*y)",
                  "thermal diffusion": "1.0 + e*e"},
    "Physics": {"modules": "thermal",
                "Dirichlet conditions": {"e": {"all boundaries": 0.0}}},
    "Discretization": {"order": {"e": 1}, "quadrature": 2},
    "Solver": {"solver": "steady-state"},
}

_NS = {
    "Mesh": {"dimension": 2, "element type": "quad",
             "xmin": 0.0, "xmax": 5.0, "ymin": 0.0, "ymax": 1.0,
             "NX": 12, "NY": 4},
    "Physics": {"modules": "navier stokes", "usePSPG": True,
                "Dirichlet conditions": {
                    "scalar data": True,
                    "ux": {"bottom": 0.0, "top": 0.0},
                    "uy": {"bottom": 0.0, "top": 0.0}}},
    "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1},
                       "quadrature": 2},
    "Solver": {"solver": "steady-state"},
    "Functions": {"source ux": "10.0"},
}


@pytest.mark.parametrize("cfg,dt", [(_THERMAL, None), (_NS, None),
                                    (_THERMAL, 0.01)],
                         ids=["thermal", "ns", "thermal-bwe-stage"])
def test_resident_newton_matches_host_loop(cfg, dt, monkeypatch):
    p = Problem(cfg)
    tc = TimeCoeffs.steady(p.n_dof)
    u0 = p.initial_state()
    if dt is not None:
        # one backward-Euler stage: u_dot = (u - u_prev) / dt
        u_prev = 0.1 * np.random.RandomState(1).rand(p.n_dof)
        tc = TimeCoeffs(tc.alpha_u, tc.beta_u, np.float64(1.0 / dt),
                        -u_prev / dt, np.float64(dt), np.float64(dt))
    kw = dict(tol=1e-12, maxiter=8, linear_method="direct")
    monkeypatch.setattr(nonlinear, "_use_resident", lambda verbose: False)
    host = nonlinear.newton_solve(p.assembler, u0, tc, None, **kw)
    monkeypatch.setattr(nonlinear, "_use_resident", lambda verbose: True)
    res = nonlinear.newton_solve(p.assembler, u0, tc, None, **kw)
    assert "_resident_newton_cache" in p.assembler.__dict__
    assert host.converged and res.converged
    assert host.iterations == res.iterations >= 2
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(host.u),
                               rtol=0, atol=1e-10)
    assert res.norm0 == pytest.approx(host.norm0, rel=1e-10)


def test_accelerator_takes_resident_newton(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert nonlinear._use_resident(0)
    assert not nonlinear._use_resident(2)      # per-iteration tables
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert not nonlinear._use_resident(0)


def test_solve_dense_matches_numpy():
    p = Problem(_THERMAL)
    tc = TimeCoeffs.steady(p.n_dof)
    rng = np.random.RandomState(0)
    u = 0.3 * rng.randn(p.n_dof)
    J = p.assembler.jacobian(u, tc, None)
    b = rng.randn(p.n_dof)
    A = np.asarray(J.dense())
    assert A.dtype == np.float64
    # Dirichlet rows are identity rows
    fixed = np.asarray(J.fixed)
    np.testing.assert_array_equal(A[fixed][:, fixed],
                                  np.eye(int(fixed.sum())))
    x = np.asarray(solve_dense(J, b))
    ref = np.linalg.solve(A, b)
    assert np.linalg.norm(x - ref) <= 1e-12 * np.linalg.norm(ref)
    # and the dense matrix is the block operator
    v = rng.randn(p.n_dof)
    np.testing.assert_allclose(A @ v, np.asarray(J.apply(v)), atol=1e-12)


def _cache_dir(env_value, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import mrhyde_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("set_env", [False, True],
                         ids=["default", "JAX_COMPILATION_CACHE_DIR"])
def test_compile_cache_placement(set_env, tmp_path):
    want = str(tmp_path / "mine") if set_env else \
        os.path.join(REPO, ".jax_cache")
    assert _cache_dir(want if set_env else None, tmp_path) == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_mesh_for_raises_on_short_accelerator(monkeypatch):
    from mrhyde_tpu.parallel.deck_sharded import _mesh_for
    assert len(jax.devices("cpu")) >= 4      # CPU devices exist...
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeGpu()])
    with pytest.raises(RuntimeError, match="found 1: gpu:NVIDIA H100"):
        _mesh_for(4)                         # ...and are not used


def test_driver_refuses_short_accelerator(monkeypatch):
    from mrhyde_tpu import driver
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeGpu()])

    def no_reexec(*a, **k):
        raise AssertionError("driver re-executed on another platform")
    monkeypatch.setattr(subprocess, "call", no_reexec)
    with pytest.raises(RuntimeError, match="shards: 4 needs 4 devices"):
        driver.main(["deck.yaml", "--shards", "4"])


def test_effective_shard_count_reported(capsys):
    cfg = dict(_THERMAL, Solver={"solver": "steady-state", "shards": 8,
                                 "nonlinear TOL": 1e-10})
    cfg["Mesh"] = {"dimension": 2, "element type": "quad",
                   "NX": 4, "NY": 4}
    p = Problem(cfg)
    u_shd = np.asarray(p.run().u)
    assert 1 <= p.shards < 8
    out = capsys.readouterr().out
    assert "at 8 shards" in out and f"using {p.shards}" in out
    ref = Problem(dict(cfg, Solver={"solver": "steady-state",
                                    "nonlinear TOL": 1e-10}))
    np.testing.assert_allclose(u_shd, np.asarray(ref.run().u), atol=1e-9)
