"""Deck-level DOF-sharded execution: run any standard forward deck
with the solution vector partitioned across a device mesh.

This is the driver-facing layer over parallel/dof_sharding.py (the
owned/overlapped Tpetra-map analog). The reference runs EVERY
regression deck under `mpiexec -n 4`
(regression/*/mrhyde.tst: `mpiexec -n 4 ../../mrhyde`), with halo
Import/Export around assembly and solve
(linearAlgebraInterface.cpp:145-309, solverManager.cpp:1556,1652);
here `Solver: shards: N` (or the CLI `--shards N`) routes the deck's
Newton solves through SPMD shard_map programs:

- assembly, Jacobi-preconditioned CG/GMRES, and all dot products run
  sharded (psum over the mesh axis; halos via ppermute rings);
- the iterate crosses between the global vector and its owned slices
  only at Newton-iteration boundaries (traced gather/segment-sum, no
  host round trip), so time integration, Dirichlet application,
  multiset orchestration, and postprocessing are untouched;
- discretized field params and per-block physics ride the sharded
  per-element `extra` channel (lifting the round-2 exclusions).

Parity contract: identical error norms at 1 and N shards
(tests/test_deck_sharded.py, f64 1e-10).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from mrhyde_tpu.parallel.dof_sharding import DofShardedStep
from mrhyde_tpu.solvers.nonlinear import NewtonResult

__all__ = ["ShardedNewton", "ReplicatedShardedNewton"]


def _mesh_for(n_shards: int):
    """Flat ("dp",) mesh over the first n_shards default devices. Too
    few devices is an error, never a silent move to another platform
    (on the CPU, provision virtual devices with XLA_FLAGS=
    --xla_force_host_platform_device_count=N or the CLI's --cpu)."""
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < n_shards:
        raise RuntimeError(
            f"Solver: shards: {n_shards} needs {n_shards} devices; found "
            f"{len(devs)}: "
            + ", ".join(f"{d.platform}:{d.device_kind}" for d in devs))
    return Mesh(np.array(devs[:n_shards]), ("dp",))


class ShardedNewton:
    """Drop-in for solvers.nonlinear.newton_solve running the
    assemble+solve step as one SPMD program per Newton iteration."""

    def __init__(self, assembler, n_shards: int, *,
                 linear_method="auto", cg_iters=200, gmres_m=60,
                 gmres_restarts=4):
        self.mesh = _mesh_for(n_shards)
        self.dstep = DofShardedStep(assembler, self.mesh)
        self.linear_method = linear_method
        self.cg_iters = cg_iters
        self.gmres_m = gmres_m
        self.gmres_restarts = gmres_restarts
        self._cache = {}

    def _method(self, linear_method):
        if self.linear_method != "auto":
            return self.linear_method
        if linear_method in ("cg",):
            return "cg"
        # direct/gmres/bicgstab and anything else -> sharded GMRES
        # (no sharded direct solver; GMRES covers nonsymmetric decks)
        return "gmres"

    def _step_fns(self, pvec, method):
        struct = tuple(sorted(pvec)) if pvec else ()
        key = (struct, method)
        if key not in self._cache:
            ds = self.dstep
            du_fn = ds.newton_du_fn(struct, method=method,
                                    iters=self.cg_iters,
                                    gmres_m=self.gmres_m,
                                    gmres_restarts=self.gmres_restarts)

            @jax.jit
            def step(u, tc, pvec_):
                u_sh = ds.gather_global(u)
                bu_sh = ds.gather_global(tc.beta_u)
                bt_sh = ds.gather_global(tc.beta_t)
                du_sh, rnorm = du_fn(u_sh, bu_sh, bt_sh, tc, pvec_)
                return ds.scatter_global(du_sh), rnorm

            res_fn = ds.residual_arg_fn(struct)

            @jax.jit
            def res_norm(u, tc, pvec_):
                u_sh = ds.gather_global(u)
                bu_sh = ds.gather_global(tc.beta_u)
                bt_sh = ds.gather_global(tc.beta_t)
                r_sh = res_fn(u_sh, bu_sh, bt_sh, tc, pvec_)
                return jnp.linalg.norm(r_sh)

            self._cache[key] = (step, res_norm)
        return self._cache[key]

    def __call__(self, assembler, u0, tc, pvec=None, *, tol=1e-6,
                 abstol=1e-100, maxiter=10, linear_method="direct",
                 linear_tol=1e-12, linear_maxiter=2000,
                 backtracking=True, verbose=0,
                 precond_variant="jacobi"):
        """newton_solve-compatible host loop over the sharded step."""
        method = self._method(linear_method)
        step, res_norm = self._step_fns(pvec, method)
        u = jnp.asarray(u0)
        norm0 = None
        norm = None
        it = 0
        while it < maxiter:
            du, norm_j = step(u, tc, pvec)
            norm = float(norm_j)
            if norm0 is None:
                norm0 = norm if norm > 0 else 1.0
            if verbose > 1:
                print(f"  Newton iter {it}: ||r|| = {norm:.6e} "
                      f"(sharded {method})")
            if norm < max(tol * norm0, abstol):
                return NewtonResult(u, it, norm0, norm, True)
            if backtracking:
                alpha = 1.0
                for _cut in range(8):
                    rn = float(res_norm(u + alpha * du, tc, pvec))
                    if rn <= norm or alpha < 1e-3:
                        break
                    alpha *= 0.5
                u = u + alpha * du
            else:
                u = u + du
            it += 1
        norm = float(res_norm(u, tc, pvec))
        converged = norm < max(tol * norm0, abstol)
        return NewtonResult(u, it, norm0, norm, converged)


class ReplicatedShardedNewton:
    """newton_solve drop-in for decks the DOF-sharded path cannot take
    (multiscale): elements and subgrid fine solves are sharded over the
    mesh ('dp'), the macro DOF vector stays replicated (the v1 scheme
    — macro systems in multiscale decks are tiny, the fine solves
    dominate and those are what the reference dedicates ranks to,
    split_mpi_communicators.cpp:31-41)."""

    def __init__(self, assembler, n_shards: int, *,
                 linear_method="auto", cg_iters=200, gmres_m=60,
                 gmres_restarts=4):
        self.mesh = _mesh_for(n_shards)
        self.assembler = assembler
        self.linear_method = linear_method
        self.cg_iters = cg_iters
        self.gmres_m = gmres_m
        self.gmres_restarts = gmres_restarts
        self._cache = {}

    def _step_fns(self, method):
        if method not in self._cache:
            from mrhyde_tpu.parallel.sharding import \
                sharded_newton_du_step
            self._cache[method] = sharded_newton_du_step(
                self.assembler, self.mesh, method=method,
                iters=self.cg_iters, gmres_m=self.gmres_m,
                gmres_restarts=self.gmres_restarts)
        return self._cache[method]

    def __call__(self, assembler, u0, tc, pvec=None, *, tol=1e-6,
                 abstol=1e-100, maxiter=10, linear_method="direct",
                 linear_tol=1e-12, linear_maxiter=2000,
                 backtracking=True, verbose=0,
                 precond_variant="jacobi"):
        method = (self.linear_method if self.linear_method != "auto"
                  else ("cg" if linear_method == "cg" else "gmres"))
        step, res_norm = self._step_fns(method)
        u = jnp.asarray(u0)
        norm0 = None
        norm = None
        it = 0
        while it < maxiter:
            du, norm_j = step(u, tc, pvec)
            norm = float(norm_j)
            if norm0 is None:
                norm0 = norm if norm > 0 else 1.0
            if verbose > 1:
                print(f"  Newton iter {it}: ||r|| = {norm:.6e} "
                      f"(element-sharded {method})")
            if norm < max(tol * norm0, abstol):
                return NewtonResult(u, it, norm0, norm, True)
            if backtracking:
                alpha = 1.0
                for _cut in range(8):
                    rn = float(res_norm(u + alpha * du, tc, pvec))
                    if rn <= norm or alpha < 1e-3:
                        break
                    alpha *= 0.5
                u = u + alpha * du
            else:
                u = u + du
            it += 1
        norm = float(res_norm(u, tc, pvec))
        converged = norm < max(tol * norm0, abstol)
        return NewtonResult(u, it, norm0, norm, converged)
