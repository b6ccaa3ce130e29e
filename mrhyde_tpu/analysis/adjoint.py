"""Differentiable implicit solves: the adjoint machinery.

The reference implements adjoints by hand: reverse time sweep over
stored forward states, transposed Jacobian solves, and AD-seeded
parameter sensitivities (reference: src/managers/solverManager.cpp:1181
adjointModel, :1387-1460; src/managers/postprocessManager.cpp:4237
computeSensitivities; SURVEY.md section 3.3).

Here the same mathematics falls out of jax.grad through an
implicit-function custom_vjp on the per-stage Newton solve:

  forward:  z solves Rtilde(z; tc, pvec, g) = 0
            Rtilde = where(fixed, z - g, R(z, tc, pvec))
  backward: lambda = J~^{-T} zbar  (the adjoint solve)
            theta_bar = -(dRtilde/dtheta)^T lambda  (via jax.vjp of R)

Composing stage solves in a traced time loop gives the full transient
adjoint (the reference's reverse sweep) without storing hand-derived
formulas — XLA retains (or rematerializes) the forward states.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["make_stage_solver"]


def _dense_rowfix(J):
    """Dense Jacobian with identity Dirichlet ROWS but live columns.

    (BlockJacobian.dense() also zeroes columns — symmetric elimination —
    which is right for the forward solve but loses the free-row
    dependence on fixed dofs needed for exact adjoints.)
    """
    n = J.n_dof
    A = jnp.zeros((n, n), dtype=J.vol.dtype)
    A = A.at[J.vol_lids[:, :, None], J.vol_lids[:, None, :]].add(J.vol)
    for blocks, lids in zip(J.bnd, J.bnd_lids):
        A = A.at[lids[:, :, None], lids[:, None, :]].add(blocks)
    A = jnp.where(J.fixed[:, None], 0.0, A)
    A = A + jnp.diag(jnp.where(J.fixed, 1.0, 0.0))
    return A


def _gmres_restarted(matvec, b, *, m, restarts, precond):
    """Restarted GMRES(m) as a fixed-shape scan (jit-stable trip
    count; each cycle refines x against the true residual)."""
    from mrhyde_tpu.solvers.krylov import gmres_fixed

    def cycle(x, _):
        r = b - matvec(x)
        dx = gmres_fixed(matvec, r, m=m, precond=precond)
        return x + dx, None

    x0 = jnp.zeros_like(b)
    x, _ = jax.lax.scan(cycle, x0, None, length=restarts)
    return x


def make_stage_solver(assembler, *, tol=1e-10, maxiter=10,
                      linear="auto", dense_cutoff=4096, gmres_m=60,
                      gmres_restarts=5):
    """Returns stage_solve(z0, tc, pvec, g) -> z with exact custom VJP.

    g: Dirichlet values vector (only entries at fixed dofs used).
    pvec: dict of active scalar parameters (differentiable).

    Linear solves inside the implicit function: dense direct at
    regression scale (exact, matches golds to print precision), and
    MATRIX-FREE restarted GMRES with Jacobi preconditioning on
    BlockJacobian.apply / apply_rowfix_T above `dense_cutoff` dofs —
    the reference runs its adjoint through the full Belos stack
    (solverManager.cpp:1181, 1387-1460); here the same Krylov solver
    serves forward and transposed solves without ever materializing
    the Jacobian (O(n) memory, inversion at scale).
    linear: "auto" | "dense" | "iterative".
    """
    fixed = assembler.fixed
    use_dense = (linear == "dense") or (
        linear == "auto" and assembler.n_dof <= dense_cutoff)

    def solve_fwd(J, r):
        if use_dense:
            return jnp.linalg.solve(J.dense(), -r)
        dinv = 1.0 / J.diag()
        return _gmres_restarted(J.apply, -r, m=gmres_m,
                                restarts=gmres_restarts,
                                precond=lambda v: dinv * v)

    def solve_adj(J, zbar):
        if use_dense:
            return jnp.linalg.solve(_dense_rowfix(J).T, zbar)
        dinv = 1.0 / J.diag()
        return _gmres_restarted(J.apply_rowfix_T, zbar, m=gmres_m,
                                restarts=gmres_restarts,
                                precond=lambda v: dinv * v)

    def newton(z0, tc, pvec, g):
        # fixed-trip scan with a convergence freeze (not a while_loop,
        # so the solve stays reverse-differentiable for Hessian-vector
        # products through the custom_vjp residuals)
        z0 = jnp.where(fixed, g, z0)

        def body(z, _):
            r = assembler.residual(z, tc, pvec)
            live = jnp.linalg.norm(r) > tol
            J = assembler.jacobian(z, tc, pvec)
            du = solve_fwd(J, r)
            return jnp.where(live, z + du, z), None

        z, _ = jax.lax.scan(body, z0, None, length=maxiter)
        return z

    @jax.custom_vjp
    def stage_solve(z0, tc, pvec, g):
        return newton(z0, tc, pvec, g)

    def fwd(z0, tc, pvec, g):
        z = newton(z0, tc, pvec, g)
        return z, (z, tc, pvec)

    def bwd(resids, zbar):
        z, tc, pvec = resids
        J = assembler.jacobian(z, tc, pvec)
        lam = solve_adj(J, zbar)
        lam_free = jnp.where(fixed, 0.0, lam)
        _, vjp_fn = jax.vjp(
            lambda tc_, p_: assembler.residual(z, tc_, p_), tc, pvec)
        tc_bar, pvec_bar = vjp_fn(-lam_free)
        g_bar = jnp.where(fixed, lam, 0.0)
        z0_bar = jnp.zeros_like(z)
        return (z0_bar, tc_bar, pvec_bar, g_bar)

    stage_solve.defvjp(fwd, bwd)
    return stage_solve
