"""Differentiable forward model: J(p) and dJ/dp by jax.grad.

This is the JAX replacement for the reference's
forward+adjoint analysis (reference: src/managers/analysisManager.cpp
forwardSolve/adjointSolve; SURVEY.md section 3.3): the entire forward —
initial condition, every time stage (as an implicit-function
custom_vjp solve), and the objective accumulation — is one traced
function of the active parameters. jax.grad then performs exactly the
reference's reverse time sweep with transposed stage solves, without
any hand-written adjoint code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mrhyde_tpu.assembly.assembler import TimeCoeffs
from mrhyde_tpu.analysis.adjoint import make_stage_solver
from mrhyde_tpu.solvers.time_integration import bdf_weights, butcher_tableau

__all__ = ["DifferentiableForward"]


class DifferentiableForward:
    """Builds objective(pvec) as a pure jax function over the full solve.

    objective_fn(u, time, pvec) -> scalar contribution at one record
    time (e.g. ObjectiveManager.value). Transient runs sum over steps.
    """

    def __init__(self, problem, objective_fn, *, newton_tol=1e-10,
                 newton_maxiter=10):
        self.problem = problem
        self.objective_fn = objective_fn
        sc = problem.solver_cfg
        linear = "auto"
        if sc.get("use direct solver", False):
            linear = "dense"
        elif sc.get("matrix free", False):
            linear = "iterative"
        self.stage_solve = make_stage_solver(
            problem.assembler, tol=newton_tol, maxiter=newton_maxiter,
            linear=linear,
            gmres_m=int(sc.get("max linear iters", 60)),
            gmres_restarts=int(sc.get("linear solver restarts", 5)))
        sc = problem.solver_cfg
        self.mode = sc.get("solver", "steady-state")
        self.t0 = float(sc.get("initial time", 0.0))
        self.t_end = float(sc.get("final time", 1.0))
        nsteps = int(sc.get("number of steps", 1))
        dt = sc.get("delta t")
        self.dt = float(dt) if dt is not None else \
            (self.t_end - self.t0) / nsteps
        self.nsteps = nsteps if dt is None else \
            int(round((self.t_end - self.t0) / self.dt))
        self.tableau = sc.get("transient Butcher tableau", "BWE")
        self.bdf_order = int(sc.get("transient BDF order", 1))
        # reference startup defaults (solverManager.cpp:149-152):
        # tableau = main tableau, BDF order = main order, steps = order
        self.startup_tableau = sc.get("transient startup Butcher tableau",
                                      self.tableau)
        self.startup_bdf = sc.get("transient startup BDF order",
                                  self.bdf_order)
        self.startup_steps = int(sc.get("transient startup steps",
                                        self.bdf_order))
        # adjoint memory policy (VERDICT r3 item 7): window the step
        # loop with jax.checkpoint so reverse-mode stores only window
        # boundaries and rematerializes inside — O(sqrt(nsteps)) live
        # states instead of O(nsteps) (the reference stores EVERY
        # accepted step in RAM, solutionStorage.hpp:19-110, and its own
        # TODO at solverManager.cpp:1420 acknowledges the gap).
        # 0 = auto (sqrt windows once the step count is large enough
        # to matter); negative = disabled.
        self.ckpt_window = int(sc.get("adjoint checkpoint window", 0))

    # ------------------------------------------------------------------

    def _tables(self, step):
        if (self.startup_steps and step < self.startup_steps
                and self.startup_tableau is not None):
            A, b, c = butcher_tableau(self.startup_tableau)
            w = bdf_weights(int(self.startup_bdf or 1))
        else:
            A, b, c = butcher_tableau(self.tableau)
            w = bdf_weights(self.bdf_order)
        return A, b, c, w

    def objective(self, pvec) -> jnp.ndarray:
        """Total objective as a traced function of active params."""
        p = self.problem
        u0 = p.initial_state(self.t0)
        n = u0.shape[0]
        dtype = u0.dtype
        if self.mode != "transient":
            tc = TimeCoeffs.steady(n, time=self.t0, dtype=dtype)
            g = p.bcs.dirichlet_values(self.t0).astype(dtype)
            u = self.stage_solve(u0, tc, pvec, g)
            return self.objective_fn(u, self.t0, pvec)

        dt = self.dt
        u = u0
        hist = max(len(bdf_weights(self.bdf_order)) - 1, 1)
        u_prev = jnp.tile(u[None, :], (hist, 1))
        total = jnp.asarray(0.0, dtype=dtype)
        t = self.t0
        dyn = tuple(
            n for n in p.param_manager.discretized_names()
            if p.param_manager.specs[n].dynamic)

        def pvec_at_p(step, pv):
            # dynamic discretized params: row per step (the gradient
            # flows back into the right row through the traced slice)
            out = pv
            if pv and dyn:
                out = dict(pv)
                for nm in dyn:
                    v = out.get(nm)
                    if v is not None and getattr(v, "ndim", 1) == 2:
                        out[nm] = v[min(step, v.shape[0] - 1)]
            return out

        def run_steps(carry, pvec, steps):
            u, u_prev, total = carry
            for step in steps:
                t = self.t0 + step * dt
                pvec_k = pvec_at_p(step, pvec)
                A, b, c, w = self._tables(step)
                nstage = len(b)
                u_prev = jnp.roll(u_prev, 1, axis=0).at[0].set(u)
                u_step_start = u
                u_stages = []
                u_new = u
                for s in range(nstage):
                    alpha_u = A[s, s] / b[s]
                    beta_u = (1.0 - alpha_u) * u_prev[0]
                    for r in range(s):
                        beta_u = beta_u + (A[s, r] / b[r]) * (
                            u_stages[r] - u_prev[0])
                    timewt = 1.0 / (dt * b[s])
                    alpha_t = w[0] * timewt
                    beta_t = jnp.zeros(n, dtype=dtype)
                    for k in range(1, len(w)):
                        beta_t = beta_t + w[k] * u_prev[k - 1]
                    beta_t = beta_t * timewt
                    t_stage = t + c[s] * dt
                    tc = TimeCoeffs(jnp.asarray(alpha_u, dtype), beta_u,
                                    jnp.asarray(alpha_t, dtype), beta_t,
                                    jnp.asarray(t_stage, dtype),
                                    jnp.asarray(dt, dtype))
                    g = p.bcs.dirichlet_values(t_stage).astype(dtype)
                    z = self.stage_solve(u_step_start, tc, pvec_k, g)
                    u_stages.append(z)
                    if nstage > 1:
                        u_new = u_new + z - u_prev[0]
                    else:
                        u_new = z
                u = u_new
                # PARITY QUIRK: the reference records the step objective
                # at the workset time left by the LAST STAGE
                # (t_n + c_last*dt), not the step end t_{n+1} — for BWE
                # (c=1) they coincide, but DIRK-1,2's midpoint stage
                # shifts the target functions by dt/2 (verified
                # digit-exact vs ODE/DIRK-1,2-Optimization iter-0 value
                # 1.705985e-03; the 'correct' time gives 4.772e-04)
                t_obj = t + c[-1] * dt
                total = total + self.objective_fn(u, t_obj, pvec_k)
            return (u, u_prev, total)

        W = self.ckpt_window
        # auto threshold 40: regression-scale inversions (<= ~20 steps)
        # keep the exact one-graph trace the golds were pinned on;
        # long transients get sqrt windows automatically
        if W == 0 and self.nsteps >= 40:
            W = int(np.ceil(np.sqrt(self.nsteps)))
        carry = (u, u_prev, total)
        if W and W > 0 and self.nsteps > W:
            # sqrt-windowed rematerialization: reverse-mode stores only
            # the window-boundary states; forward states inside each
            # window are recomputed during the backward sweep
            for k0 in range(0, self.nsteps, W):
                steps = tuple(range(k0, min(k0 + W, self.nsteps)))

                def block(c_, pv, _steps=steps):
                    return run_steps(c_, pv, _steps)

                carry = jax.checkpoint(block)(carry, pvec)
        else:
            carry = run_steps(carry, pvec, range(self.nsteps))
        _u, _u_prev, total = carry
        return total

    def gradient(self, pvec):
        return jax.grad(self.objective)(pvec)

    def value_and_gradient(self, pvec):
        return jax.value_and_grad(self.objective)(pvec)

    def hvp(self, pvec, vec):
        """Hessian-vector product d2J/dp2 . vec via reverse-over-
        reverse AD through the implicit stage solves (the reference's
        ROL hessVec hook, analysisManager ROL2 bindings; the
        custom_vjp adjoint is itself differentiable because its
        backward pass is plain linear algebra + residual vjps)."""
        def gdot(p):
            g = jax.grad(self.objective)(p)
            return sum(jnp.sum(jnp.asarray(g[k]) * jnp.asarray(vec[k]))
                       for k in vec)
        return jax.grad(gdot)(pvec)

    def fd_hvp(self, pvec, vec, eps=1e-5):
        """Central-difference of the gradient along vec (hessVec
        verification, like ROL checkHessVec)."""
        pp = {k: jnp.asarray(v) + eps * jnp.asarray(vec[k])
              for k, v in pvec.items()}
        pm = {k: jnp.asarray(v) - eps * jnp.asarray(vec[k])
              for k, v in pvec.items()}
        gp = self.gradient(pp)
        gm = self.gradient(pm)
        return {k: (np.asarray(gp[k]) - np.asarray(gm[k])) / (2 * eps)
                for k in pvec}

    def fd_gradient(self, pvec, eps=1e-6):
        """Central finite-difference gradient (the reference's ROL
        checkGradient analog) for verification."""
        out = {}
        for name in pvec:
            base = np.atleast_1d(np.asarray(pvec[name], dtype=float))
            g = np.zeros_like(base)
            for i in range(base.size):
                for sgn in (+1, -1):
                    pp = {k: jnp.asarray(v) for k, v in pvec.items()}
                    pert = base.copy()
                    pert[i] += sgn * eps
                    pp[name] = jnp.asarray(
                        pert if base.size > 1 else pert[0])
                    g[i] += sgn * float(self.objective(pp))
            g /= (2 * eps)
            out[name] = g if base.size > 1 else g[0]
        return out
