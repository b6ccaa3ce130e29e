"""Newton solver with optional backtracking line search.

Mirrors the reference's SolverManager::nonlinearSolver
(src/managers/solverManager.cpp:1465-1714): residual norm check with
relative+absolute tolerances, J du = -R solve, backtracking halving on
residual increase. On an accelerator the whole solve is one jitted
`lax.while_loop`, so no Newton or backtracking step waits on the host;
on the CPU (and whenever per-iteration output is asked for) the outer
iteration runs on the host, each (assemble J, R; solve) step ONE
jitted XLA program cached on the assembler.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from mrhyde_tpu.solvers.linear import solve_linear_info

__all__ = ["newton_solve", "NewtonResult"]


@dataclass
class NewtonResult:
    u: object
    iterations: int
    norm0: float
    norm: float
    converged: bool
    linear_converged: bool = True   # every inner solve met its tolerance
    linear_resnorm: float = 0.0     # last inner solve's final residual


def _newton_step_fn(assembler, linear_method, linear_tol, linear_maxiter,
                    precond_variant):
    """One fused (residual, Jacobian, linear solve) step, jit-cached."""
    cache = assembler.__dict__.setdefault("_newton_step_cache", {})
    key = (linear_method, linear_tol, linear_maxiter, precond_variant)
    if key not in cache:
        mg_variant = precond_variant in ("multigrid", "mg", "amg")
        if mg_variant:
            # build the (static) hierarchy once, outside the trace:
            # geometric MG on structured p1 grids, aggregation AMG on
            # everything else (the MueLu analog), element-Schwarz as
            # the last resort
            from mrhyde_tpu.solvers.multigrid import StructuredMG
            if "_mg_hierarchy" not in assembler.__dict__:
                hier = None
                if precond_variant != "amg":
                    try:
                        hier = StructuredMG(assembler)
                    except ValueError:
                        hier = None
                if hier is None:
                    from mrhyde_tpu.solvers.amg import AggregationAMG
                    try:
                        hier = AggregationAMG(assembler)
                    except ValueError:
                        hier = None
                assembler.__dict__["_mg_hierarchy"] = hier
            if assembler.__dict__["_mg_hierarchy"] is None:
                mg_variant = False
                precond_variant = "schwarz"

        def step(u, tc, pvec):
            r, J = assembler.res_and_jac(u, tc, pvec)
            pfn = (assembler.__dict__["_mg_hierarchy"].preconditioner(J)
                   if mg_variant else None)
            du, info = solve_linear_info(
                J, -r, method=linear_method, tol=linear_tol,
                maxiter=linear_maxiter, precond_variant=precond_variant,
                precond_fn=pfn)
            return du, jnp.linalg.norm(r), info
        cache[key] = jax.jit(step)
    return cache[key]


def _resident_newton_fn(assembler, linear_method, linear_tol,
                        linear_maxiter, precond_variant, maxiter,
                        backtracking):
    """The WHOLE Newton solve as one jitted lax.while_loop — the
    device-resident path: every host-loop step is a dispatch plus a
    device-to-host read of the residual norm, which this loop never
    pays (the reference has one solver path and it IS the production
    path, solverManager.cpp:1107-1384). Semantics mirror the host loop
    in `newton_solve` below: convergence checked on the residual norm
    at the CURRENT state before updating, backtracking halves on
    residual increase (8 cuts max, alpha floor 1e-3)."""
    cache = assembler.__dict__.setdefault("_resident_newton_cache", {})
    key = (linear_method, linear_tol, linear_maxiter, precond_variant,
           maxiter, backtracking)
    if key not in cache:
        mg_variant = precond_variant in ("multigrid", "mg", "amg")
        pfn_of = None
        if mg_variant:
            _newton_step_fn(assembler, linear_method, linear_tol,
                            linear_maxiter, precond_variant)
            hier = assembler.__dict__.get("_mg_hierarchy")
            if hier is not None:
                pfn_of = hier.preconditioner
            else:
                precond_variant = "schwarz"

        def whole(u0, tc, pvec, tol, abstol):
            def rnorm(u):
                return jnp.linalg.norm(
                    assembler.residual(u, tc, pvec))

            def body(st):
                u, it, norm0, norm, done, lin_ok, lin_res = st
                r, J = assembler.res_and_jac(u, tc, pvec)
                nrm = jnp.linalg.norm(r)
                norm0 = jnp.where(it == 0,
                                  jnp.where(nrm > 0, nrm, 1.0), norm0)
                new_done = nrm < jnp.maximum(tol * norm0, abstol)
                pfn = pfn_of(J) if pfn_of is not None else None
                du, info = solve_linear_info(
                    J, -r, method=linear_method, tol=linear_tol,
                    maxiter=linear_maxiter,
                    precond_variant=precond_variant, precond_fn=pfn)
                upd = ~new_done
                lin_ok = lin_ok & (info.converged | new_done)
                lin_res = jnp.where(upd, info.resnorm, lin_res)
                if backtracking:
                    def bt_cond(c):
                        alpha, rn, k = c
                        return (rn > nrm) & (alpha >= 1e-3) & (k < 8)

                    def bt_body(c):
                        alpha, rn, k = c
                        alpha = alpha * 0.5
                        return alpha, rnorm(u + alpha * du), k + 1

                    one = jnp.asarray(1.0, u.dtype)
                    alpha, _, _ = jax.lax.while_loop(
                        bt_cond, bt_body,
                        (one, rnorm(u + du), jnp.asarray(0)))
                else:
                    alpha = jnp.asarray(1.0, u.dtype)
                u = jnp.where(upd, u + alpha * du, u)
                it = it + jnp.where(upd, 1, 0)
                return (u, it, norm0, nrm, new_done, lin_ok, lin_res)

            def cond(st):
                _, it, _, _, done, _, _ = st
                return (~done) & (it < maxiter)

            z = jnp.asarray(0.0, u0.dtype)
            st = (u0, jnp.asarray(0), z + 1.0, z, jnp.asarray(False),
                  jnp.asarray(True), z)
            u, it, norm0, norm, done, lin_ok, lin_res = \
                jax.lax.while_loop(cond, body, st)
            # maxiter fall-out: report the norm AT the final state
            norm = jax.lax.cond(done, lambda: norm, lambda: rnorm(u))
            conv = norm < jnp.maximum(tol * norm0, abstol)
            return u, it, norm0, norm, conv, lin_ok, lin_res
        cache[key] = jax.jit(whole)
    return cache[key]


def _use_resident(verbose):
    """Resident loop on any accelerator; the host loop on the CPU and
    when per-iteration tables are printed (verbose > 1)."""
    return jax.default_backend() != "cpu" and verbose <= 1


def newton_solve(assembler, u0, tc, pvec=None, *, tol=1e-6, abstol=1e-100,
                 maxiter=10, linear_method="direct", linear_tol=1e-12,
                 linear_maxiter=2000, backtracking=True, verbose=0,
                 precond_variant="jacobi"):
    if _use_resident(verbose):
        fn = _resident_newton_fn(assembler, linear_method, linear_tol,
                                 linear_maxiter, precond_variant,
                                 maxiter, backtracking)
        u, it, norm0, norm, conv, lin_ok, lin_res = fn(
            u0, tc, pvec, jnp.asarray(tol, u0.dtype),
            jnp.asarray(abstol, u0.dtype))
        return NewtonResult(u, int(it), float(norm0), float(norm),
                            bool(conv), bool(lin_ok), float(lin_res))
    u = u0
    step = _newton_step_fn(assembler, linear_method, linear_tol,
                           linear_maxiter, precond_variant)
    res_fn = getattr(assembler, "residual_jit", assembler.residual)
    norm0 = None
    norm = None
    it = 0
    lin_ok = True
    lin_res = 0.0
    while it < maxiter:
        du, norm_j, info = step(u, tc, pvec)
        norm = float(norm_j)
        if norm0 is None:
            norm0 = norm if norm > 0 else 1.0
        if verbose > 1:
            print(f"  Newton iter {it}: ||r|| = {norm:.6e} "
                  f"(linear: {int(info.iters)} its, "
                  f"res {float(info.resnorm):.2e})")
        if norm < max(tol * norm0, abstol):
            return NewtonResult(u, it, norm0, norm, True,
                                lin_ok, lin_res)
        lin_ok = lin_ok and bool(info.converged)
        lin_res = float(info.resnorm)
        if backtracking:
            alpha = 1.0
            for _cut in range(8):
                rn = res_fn(u + alpha * du, tc, pvec)
                if float(jnp.linalg.norm(rn)) <= norm or alpha < 1e-3:
                    break
                alpha *= 0.5
            u = u + alpha * du
        else:
            u = u + du
        it += 1
    rn = res_fn(u, tc, pvec)
    norm = float(jnp.linalg.norm(rn))
    converged = norm < max(tol * norm0, abstol)
    return NewtonResult(u, it, norm0, norm, converged, lin_ok, lin_res)
