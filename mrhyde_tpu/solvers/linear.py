"""Linear solvers: matrix-free Krylov + small dense direct.

JAX replacement for the reference's Belos/MueLu/Ifpack2/Amesos2
stack (reference: src/interfaces/linearAlgebraInterface.cpp:358-500
linearSolver; per-system-class options hpp:475-513). Krylov methods
operate on BlockJacobian.apply (gather + batched einsum + segment-sum);
preconditioning comes from solvers/precond.py (jacobi / chebyshev /
element-Schwarz). Small systems (projections, regression meshes) use a
densified direct solve — the analog of Amesos2 KLU2.

solve_linear_info returns (x, KrylovInfo) so callers can CHECK
convergence (the reference reads this off Belos' status tests);
solve_linear keeps the x-only signature.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.sparse.linalg as jsla

from mrhyde_tpu.solvers.krylov import (KrylovInfo, bicgstab_fixed,
                                       gmres)
from mrhyde_tpu.solvers.precond import build_preconditioner

__all__ = ["solve_linear", "solve_linear_info", "solve_dense", "solve_cg",
           "LinearOptions"]


class LinearOptions:
    """Per-system-class solver options (reference: separate Belos/prec
    option sets for state J / param J / boundary L2 / volume L2,
    linearAlgebraInterface.hpp:475-513). Build from the Solver sublist
    with `from_config`."""

    def __init__(self, method="gmres", tol=1e-10, maxiter=500, restart=40,
                 preconditioner="jacobi"):
        self.method = method
        self.tol = tol
        self.maxiter = maxiter
        self.restart = restart
        self.preconditioner = preconditioner

    @classmethod
    def from_config(cls, solver_cfg: dict, system: str = "state"):
        """system in {state, param, boundary L2, volume L2}; per-system
        overrides live in '<system> solver settings' sublists."""
        sc = dict(solver_cfg or {})
        sc.update(sc.get(f"{system} solver settings", {}) or {})
        method = "gmres"
        if bool(sc.get("use direct solver", False)):
            method = "direct"
        belos = str(sc.get("Belos solver", "Block GMRES")).lower()
        if "cg" in belos and method != "direct":
            method = "cg"
        prec = str(sc.get("preconditioner variant", "jacobi"))
        if not bool(sc.get("use preconditioner", True)):
            prec = "none"
        return cls(method=method,
                   tol=float(sc.get("linear TOL", 1e-10)),
                   maxiter=int(sc.get("max linear iters", 500)),
                   restart=int(sc.get("Belos block size",
                                      sc.get("restart", 40))),
                   preconditioner=prec)


def solve_dense(J, b):
    """Dense LU solve in the working precision (Amesos2 KLU analog)."""
    return jnp.linalg.solve(J.dense(), b)


def solve_cg(J, b, tol=1e-12, maxiter=1000, precond_variant="jacobi"):
    M = build_preconditioner(J, precond_variant)
    x, _ = jsla.cg(J.apply, b, M=M, tol=tol, maxiter=maxiter)
    return x


def solve_linear_info(J, b, method="gmres", tol=1e-10, maxiter=500,
                      restart=40, precond_variant="jacobi",
                      precond_fn=None):
    """Solve J x = b; returns (x, KrylovInfo). Direct solves report a
    computed (not assumed) residual. precond_fn overrides the variant
    (used for assembler-aware preconditioners like multigrid)."""
    if method == "direct":
        x = solve_dense(J, b)
        res = jnp.linalg.norm(b - J.apply(x))
        bn = jnp.linalg.norm(b)
        ok = res <= jnp.maximum(1e-8 * jnp.where(bn > 0, bn, 1.0),
                                jnp.asarray(1e-30, b.dtype))
        return x, KrylovInfo(jnp.asarray(1), res, ok)
    if method == "cg":
        x = solve_cg(J, b, tol=tol, maxiter=maxiter,
                     precond_variant=precond_variant)
        res = jnp.linalg.norm(b - J.apply(x))
        bn = jnp.linalg.norm(b)
        ok = res <= tol * jnp.where(bn > 0, bn, 1.0) * 10
        return x, KrylovInfo(jnp.asarray(maxiter), res, ok)
    if method == "gmres":
        M = precond_fn if precond_fn is not None \
            else build_preconditioner(J, precond_variant)
        m = int(min(restart, maxiter))
        max_restarts = max(-(-maxiter // m), 1)
        return gmres(J.apply, b, m=m, tol=tol, max_restarts=max_restarts,
                     precond=M)
    if method == "bicgstab":
        # Belos BiCGStab / TFQMR analog (linearAlgebraInterface.cpp:
        # 358-500 'Belos solver' option); fixed-shape loop, residual
        # computed (not assumed) afterwards
        M = precond_fn if precond_fn is not None \
            else build_preconditioner(J, precond_variant)
        iters = int(min(maxiter, 200))
        x = bicgstab_fixed(J.apply, b, iters=iters, precond=M)
        res = jnp.linalg.norm(b - J.apply(x))
        bn = jnp.linalg.norm(b)
        ok = res <= tol * jnp.where(bn > 0, bn, 1.0) * 10
        return x, KrylovInfo(jnp.asarray(iters), res, ok)
    raise ValueError(f"unknown linear solver {method!r}")


def solve_linear(J, b, method="direct", tol=1e-12, maxiter=1000,
                 precond_variant="jacobi", restart=40):
    """Solve J x = b. method in {direct, cg, gmres}."""
    x, _ = solve_linear_info(J, b, method=method, tol=tol, maxiter=maxiter,
                             restart=restart,
                             precond_variant=precond_variant)
    return x
