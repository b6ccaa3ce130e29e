"""Hand-rolled fixed-shape Krylov solvers for the solve hot path.

These keep every iteration to a handful of elementwise ops, vdots and
the user matvec, with none of the dynamic-slice-heavy Arnoldi
bookkeeping of jax.scipy.sparse.linalg.gmres. They are the production linear solvers
behind the matrix-free Newton (reference counterpart: the Belos
Block-GMRES/BiCGStab instantiations, linearAlgebraInterface.cpp:358-500).

`gmres` is the production path: restarted GMRES(m) with Givens-rotation
recurrence — the rotated rhs gives the residual norm FOR FREE each
Arnoldi step, so the loop exits early under `lax.while_loop` while the
compiled program keeps fully static shapes. It returns the final
residual and iteration count so callers can *check* convergence rather
than assume it (the reference gets this from Belos' convergence tests).

`gmres_fixed` / `bicgstab_fixed` run a fixed iteration count (no
data-dependent exit) for benchmark-style inner loops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["gmres", "gmres_fixed", "bicgstab_fixed", "KrylovInfo"]


class KrylovInfo(NamedTuple):
    """Solver report (traced values; cast with float()/int() on host)."""
    iters: jax.Array       # total matvecs performed
    resnorm: jax.Array     # final (estimated) residual norm
    converged: jax.Array   # bool: resnorm <= max(tol*||b||, atol)


def _gmres_cycle(matvec, M, b_like_dtype, m, n):
    """Build one GMRES(m) Arnoldi cycle with Givens rotations.

    Returns cycle(x0, r0, target) -> (x1, resnorm, steps): runs UNDER a
    lax.while_loop until the rotated-rhs residual estimate drops below
    `target` or m steps elapse. All arrays are statically shaped
    ((m+1, n) basis); the loop index is dynamic.
    """
    dtype = b_like_dtype

    def cycle(x0, r0, target):
        beta = jnp.linalg.norm(r0)
        scale = jnp.where(beta > 0, beta, 1.0)
        V0 = jnp.zeros((m + 1, n), dtype=dtype).at[0].set(r0 / scale)
        R0 = jnp.zeros((m, m), dtype=dtype)
        cs0 = jnp.zeros(m, dtype=dtype)
        sn0 = jnp.zeros(m, dtype=dtype)
        g0 = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)

        def cond(state):
            V, R, cs, sn, g, j, res = state
            return (j < m) & (res > target)

        def body(state):
            V, R, cs, sn, g, j, _ = state
            vj = jax.lax.dynamic_index_in_dim(V, j, 0, keepdims=False)
            w = matvec(M(vj))
            # modified Gram-Schmidt against rows <= j (others are zero)
            h = V @ w                                       # (m+1,)
            h = jnp.where(jnp.arange(m + 1) <= j, h, 0.0)
            w = w - h @ V
            nrm = jnp.linalg.norm(w)
            h = h.at[j + 1].set(nrm)
            V = V.at[j + 1].set(w / jnp.where(nrm > 0, nrm, 1.0))

            # apply the j previous rotations to the new column
            def rot(i, hcol):
                hi = hcol[i]
                hi1 = hcol[i + 1]
                a = cs[i] * hi + sn[i] * hi1
                bb = -sn[i] * hi + cs[i] * hi1
                upd = hcol.at[i].set(a).at[i + 1].set(bb)
                return jnp.where(i < j, upd, hcol)

            h = jax.lax.fori_loop(0, m, rot, h)
            # new rotation annihilating h[j+1]
            hj = h[j]
            hj1 = h[j + 1]
            denom = jnp.sqrt(hj * hj + hj1 * hj1)
            safe = jnp.where(denom > 0, denom, 1.0)
            c = jnp.where(denom > 0, hj / safe, 1.0)
            s = jnp.where(denom > 0, hj1 / safe, 0.0)
            h = h.at[j].set(c * hj + s * hj1).at[j + 1].set(0.0)
            gj = g[j]
            g = g.at[j].set(c * gj).at[j + 1].set(-s * gj)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            R = R.at[:, j].set(h[:m])
            res = jnp.abs(g[j + 1])
            return (V, R, cs, sn, g, j + 1, res)

        state = (V0, R0, cs0, sn0, g0, jnp.asarray(0), beta)
        V, R, cs, sn, g, k, res = jax.lax.while_loop(cond, body, state)

        # solve the k x k triangular system (unused columns j >= k get a
        # unit diagonal + zero rhs so the full-m solve leaves y[j] = 0)
        used = jnp.arange(m) < k
        Rd = jnp.where(jnp.eye(m, dtype=bool) & ~used[None, :], 1.0, R)
        gm = jnp.where(used, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rd, gm, lower=False)
        x1 = x0 + M(y @ V[:m])
        return x1, res, k

    return cycle


def gmres(matvec, b, *, m=40, tol=1e-8, atol=0.0, max_restarts=5,
          precond=None, x0=None):
    """Restarted, right-preconditioned GMRES(m) with convergence check.

    Returns (x, KrylovInfo). Residual norms come from the Givens-rotated
    rhs (exact for the true residual under RIGHT preconditioning, which
    is why the preconditioner is applied on the right). The whole solve
    — restart loop included — is one fixed-shape XLA program.
    """
    n = b.shape[0]
    dtype = b.dtype
    M = precond if precond is not None else (lambda v: v)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bnorm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * jnp.where(bnorm > 0, bnorm, 1.0),
                         jnp.asarray(atol, dtype))
    cycle = _gmres_cycle(matvec, M, dtype, m, n)

    def cond(state):
        x, res, cyc, steps = state
        return (res > target) & (cyc < max_restarts)

    def body(state):
        x, _, cyc, steps = state
        r = b - matvec(x)
        x1, res, k = cycle(x, r, target)
        return (x1, res, cyc + 1, steps + k)

    r0n = jnp.linalg.norm(b - matvec(x0))
    state = (x0, r0n, jnp.asarray(0), jnp.asarray(0))
    x, res, _, steps = jax.lax.while_loop(cond, body, state)
    return x, KrylovInfo(steps, res, res <= target)


def gmres_fixed(matvec, b, *, m=40, precond=None, x0=None):
    """GMRES(m), one fixed-length cycle: scan-built Arnoldi basis, then
    ONE QR-based least squares on the (m+1, m) Hessenberg.

    The per-iteration work is a matvec + two vdots under `lax.scan`
    (no data-dependent exit, no sequential Givens scalar recurrences),
    and the tiny LS solve happens once via jnp.linalg.lstsq (QR — NOT
    the normal equations, which squared the Hessenberg conditioning).
    Use `gmres` when a convergence check is needed."""
    M = precond if precond is not None else (lambda v: v)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    dtype = b.dtype
    r0 = b - matvec(x0)
    beta = jnp.linalg.norm(r0)
    scale = jnp.where(beta > 0, beta, 1.0)
    V0 = jnp.zeros((m + 1, n), dtype=dtype).at[0].set(r0 / scale)
    H0 = jnp.zeros((m + 1, m), dtype=dtype)

    def body(carry, j):
        V, H = carry
        w = matvec(M(V[j]))
        # modified Gram-Schmidt against the full (static) basis with a
        # column mask — rows > j hold zeros so they contribute nothing
        hcol = V @ w                        # (m+1,)
        mask = (jnp.arange(m + 1) <= j)
        hcol = jnp.where(mask, hcol, 0.0)
        w = w - hcol @ V
        hnorm = jnp.linalg.norm(w)
        safe = jnp.where(hnorm > 0, hnorm, 1.0)
        V = V.at[j + 1].set(w / safe)
        hcol = hcol.at[j + 1].set(hnorm)
        H = H.at[:, j].set(hcol)
        return (V, H), None

    (V, H), _ = jax.lax.scan(body, (V0, H0), jnp.arange(m))
    g = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
    y, *_ = jnp.linalg.lstsq(H, g)
    return x0 + M(y @ V[:m])


def pcg_reference(matvec, b, diag, *, tol=1e-2, maxiter=100):
    """Diagonal-preconditioned CG with the reference's exact stopping
    rule (solverManager.cpp:2236 PCG: x0 = 0, iterate while
    ||r|| / ||r0|| > tol and iter < maxiter). Used for the
    fully-explicit consistent-mass solve, where the reference's LOOSE
    default tol (1.0e-2, :1810) is part of the observable gold output
    (thermal/2D_Database_Compression); the iterate sequence is scale-
    invariant, so matching the stopping rule matches the gold."""
    d = jnp.where(diag != 0, diag, 1.0)
    x0 = jnp.zeros_like(b)
    r0 = b
    r0n = jnp.linalg.norm(r0)
    target = tol * jnp.where(r0n > 0, r0n, 1.0)

    def cond(state):
        it, _x, _r, _p, _rho, rnorm = state
        return jnp.logical_and(it < maxiter, rnorm > target)

    def body(state):
        it, x, r, p, rho, _ = state
        z = r / d
        rho1 = rho
        rho_n = jnp.vdot(r, z)
        beta = jnp.where(it == 0, 0.0, rho_n / rho1)
        p = z + beta * p
        q = matvec(p)
        alpha = rho_n / jnp.vdot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        return (it + 1, x, r, p, rho_n, jnp.linalg.norm(r))

    one = jnp.asarray(1.0, dtype=b.dtype)
    state = (jnp.asarray(0), x0, r0, jnp.zeros_like(b), one, r0n)
    _, x, *_ = jax.lax.while_loop(cond, body, state)
    return x


def bicgstab_fixed(matvec, b, *, iters=20, precond=None, x0=None):
    """BiCGStab with a fixed iteration count and right preconditioner."""
    M = precond if precond is not None else (lambda v: v)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    rhat = r0
    eps = jnp.asarray(1e-30, dtype=b.dtype)

    def body(carry, _):
        x, r, p, v, rho, alpha, omega = carry
        rho1 = jnp.vdot(rhat, r)
        beta = (rho1 / (rho + eps)) * (alpha / (omega + eps))
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = matvec(ph)
        alpha = rho1 / (jnp.vdot(rhat, v) + eps)
        s = r - alpha * v
        sh = M(s)
        t = matvec(sh)
        omega = jnp.vdot(t, s) / (jnp.vdot(t, t) + eps)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        return (x, r, p, v, rho1, alpha, omega), None

    one = jnp.asarray(1.0, dtype=b.dtype)
    zero = jnp.zeros_like(b)
    carry = (x0, r0, zero, zero, one, one, one)
    (x, r, *_), _ = jax.lax.scan(body, carry, None, length=iters)
    return x
