"""Preconditioners for the matrix-free Krylov solvers.

JAX stand-ins for the reference's Ifpack2/MueLu choices
(reference: src/interfaces/linearAlgebraInterface.cpp:358-500 builds
MueLu AMG, Ifpack2 RELAXATION (Jacobi), CHEBYSHEV, or SCHWARZ
per system class; hpp:475-513). Each builder takes the assembler's
BlockJacobian and returns `v -> M(v)` suitable as the RIGHT
preconditioner of solvers/krylov.py:

- jacobi:     diagonal scaling (Ifpack2 RELAXATION analog)
- chebyshev:  fixed-degree Chebyshev smoother on the Jacobi-scaled
              operator; the spectral radius is estimated in-trace by
              power iteration (Ifpack2 CHEBYSHEV analog)
- schwarz:    element-block additive Schwarz — batched dense inverses
              of the per-element Jacobian blocks, combined with
              1/multiplicity weights (Ifpack2 SCHWARZ domain
              decomposition analog; the "subdomains" are elements,
              which lowers to one batched
              (E, nd, nd) inverse + gather/einsum/segment-sum)

All of them trace into the caller's jitted program: no host round
trips, everything fuses into the Newton step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["build_preconditioner", "jacobi_precond", "chebyshev_precond",
           "element_schwarz_precond", "fieldsplit_simple_precond"]


def jacobi_precond(J):
    dinv = 1.0 / J.diag()
    return lambda v: dinv * v


def _gershgorin_lmax(J, dinv):
    """Safe upper bound on lambda_max(D^-1 A) from the element blocks:
    sum_e |A_e|'s row sums majorize the assembled |A|'s row sums, so
    max_i dinv_i * rowsum_i >= the Gershgorin bound >= lambda_max.
    (Power iteration UNDER-estimates on clustered spectra and makes
    Chebyshev divergent on the top modes; a guaranteed bound only costs
    a slightly smaller effective degree.)"""
    row_e = jnp.abs(J.vol).sum(axis=2)
    rows = jax.ops.segment_sum(
        row_e.ravel(), J.vol_lids.ravel(),
        num_segments=J.n_dof)
    for blocks, lids in zip(J.bnd, J.bnd_lids):
        rows = rows + jax.ops.segment_sum(
            jnp.abs(blocks).sum(axis=2).ravel(), lids.ravel(),
            num_segments=J.n_dof)
    rows = jnp.where(J.fixed, 1.0, rows)
    return jnp.max(dinv * rows)


def chebyshev_precond(J, *, degree=4, ratio=30.0, boost=1.05):
    """Chebyshev(k) on the Jacobi-scaled operator D^-1 A.

    lambda_max(D^-1 A) is bounded via Gershgorin row sums of the
    element blocks (traced; recomputed whenever J changes, like Ifpack2
    recomputing on a new matrix). lambda_min = lambda_max / ratio.
    Indefinite systems should use schwarz instead.
    """
    dinv = 1.0 / J.diag()

    def dinv_a(v):
        return dinv * J.apply(v)

    lmax = _gershgorin_lmax(J, dinv) * boost
    lmin = lmax / ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    sigma1 = theta / delta

    def apply(r):
        # Chebyshev iteration for z ~= (D^-1 A)^-1 (D^-1 r)
        # (Saad, Iterative Methods, Alg. 12.1, on the Jacobi-scaled op)
        b2 = dinv * r
        x = jnp.zeros_like(b2)
        res = b2
        rho = 1.0 / sigma1
        d = res / theta

        def body(carry, _):
            x, res, rho, d = carry
            x = x + d
            res = res - dinv_a(d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * res
            return (x, res, rho_new, d), None

        (x, res, rho, d), _ = jax.lax.scan(body, (x, res, rho, d), None,
                                           length=max(degree - 1, 0))
        return x + d

    return apply


def element_schwarz_precond(J, damping=1.0):
    """Element-block weighted additive Schwarz.

    M v = sum_e W R_e^T (A_e + shift)^-1 R_e v, where A_e is the
    element's local Jacobian block (Dirichlet rows/cols replaced by
    identity) and W = diag(1/multiplicity). Handles the saddle-point
    blocks (mixed porous, stokes) that plain Jacobi cannot.
    """
    lids = J.vol_lids                               # (E, nd)
    fixed_e = J.fixed[lids]                         # (E, nd) bool
    vol = J.vol
    eye = jnp.eye(vol.shape[1], dtype=vol.dtype)
    mask = (~fixed_e[:, :, None]) & (~fixed_e[:, None, :])
    blocks = jnp.where(mask, vol, 0.0)
    blocks = blocks + eye * fixed_e[:, :, None]
    # replace each block's diagonal with the ASSEMBLED diagonal
    # (gathered): raw element stiffness blocks are singular for
    # elliptic operators (constant nullspace); the assembled diagonal
    # makes them the restriction of diag-corrected A — invertible and
    # strictly better than point Jacobi. Zero assembled diagonals
    # (mixed-method pressure rows) are left to the block's coupling.
    d_elem = jnp.diagonal(blocks, axis1=1, axis2=2)   # (E, nd)
    d_asm = J.diag()[lids]                            # (E, nd)
    use = (~fixed_e) & (d_asm != 0)
    blocks = blocks + eye * jnp.where(use, d_asm - d_elem, 0.0)[:, :, None]
    inv = jnp.linalg.inv(blocks)                    # batched
    # guard: singular element blocks (hybridized trace methods can
    # produce them) fall back to the block's diagonal inverse rather
    # than poisoning the whole preconditioner with NaNs
    ok = jnp.isfinite(inv).all(axis=(1, 2), keepdims=True)
    dd = jnp.diagonal(blocks, axis1=1, axis2=2)
    dinv_blk = eye * (1.0 / jnp.where(dd == 0, 1.0, dd))[:, :, None]
    inv = jnp.where(ok, inv, dinv_blk)
    ones = jnp.ones(lids.shape, dtype=vol.dtype)
    mult = jax.ops.segment_sum(ones.ravel(), lids.ravel(),
                               num_segments=J.n_dof)
    w = damping / jnp.where(mult == 0, 1.0, mult)

    def apply(v):
        ve = v[lids]                                # (E, nd)
        ze = jnp.einsum("eij,ej->ei", inv, ve)
        z = jax.ops.segment_sum(ze.ravel(), lids.ravel(),
                                num_segments=J.n_dof)
        return w * z

    return apply


def fieldsplit_simple_precond(J, p_mask, *, k_A=3, k_S=3, omega=0.7,
                              apply_fn=None):
    """SIMPLE-style pressure-Schur fieldsplit for saddle systems
    (equal-order NS with PSPG): the standard answer to Krylov stalling
    on [[A, B], [C, S]] blocks — the reference reaches it through
    MueLu/Teko block preconditioners on the NS system class
    (linearAlgebraInterface.cpp:358-500, hpp:475-513 'varlist'
    options).

    p_mask marks the pressure dofs. All sub-solves are FIXED-iteration
    damped Jacobi (linear, so plain right-preconditioned GMRES stays
    valid — no FGMRES needed):

      u_hat = A^{-1}~ r_u                 (k_A sweeps on the velocity
                                           block, via masked J applies)
      p     = S_hat^{-1}~ (r_p - C u_hat) (k_S sweeps; S_hat v =
                                           S v - C dinvA B v, the
                                           SIMPLE diag(A) Schur
                                           complement, 2 J-applies per
                                           sweep)
      u     = u_hat - dinvA B p

    Cost: ~(k_A + 2 k_S + 1) operator applies per preconditioner
    application — only wins if the iteration count drops by more.
    Measure before adopting (bench.py BENCH_NS_PRECOND=simple)."""
    Jap = apply_fn if apply_fn is not None else J.apply
    d = J.diag()
    dinv = 1.0 / d
    dinvA = jnp.where(p_mask, 0.0, dinv)
    dinvS = jnp.where(p_mask, dinv, 0.0)

    def mask_u(v):
        return jnp.where(p_mask, 0.0, v)

    def mask_p(v):
        return jnp.where(p_mask, v, 0.0)

    def A_apply(v):            # velocity block: u rows of J on u dofs
        return mask_u(Jap(mask_u(v)))

    def A_solve(r_u):
        x = omega * dinvA * r_u
        for _ in range(k_A - 1):
            x = x + omega * dinvA * (r_u - A_apply(x))
        return x

    def S_apply(yp):           # SIMPLE Schur: S y - C dinvA B y
        Jy = Jap(mask_p(yp))
        By = mask_u(Jy)        # B y (u rows)
        Sy = mask_p(Jy)        # S y (p rows)
        return Sy - mask_p(Jap(dinvA * By))

    def S_solve(r_p):
        y = omega * dinvS * r_p
        for _ in range(k_S - 1):
            y = y + omega * dinvS * (r_p - S_apply(y))
        return y

    def apply(r):
        r_u, r_p = mask_u(r), mask_p(r)
        u_hat = A_solve(r_u)
        r_s = r_p - mask_p(Jap(u_hat))
        p = S_solve(r_s)
        u = u_hat - dinvA * mask_u(Jap(mask_p(p)))
        return u + p

    return apply


def build_preconditioner(J, variant: str = "jacobi", **kw):
    """Deck-facing factory ('preconditioner variant' key)."""
    v = (variant or "jacobi").strip().lower()
    if v in ("none", "identity"):
        return lambda x: x
    if v in ("jacobi", "relaxation", "point relaxation"):
        return jacobi_precond(J)
    if v in ("chebyshev",):
        return chebyshev_precond(J, **kw)
    if v in ("schwarz", "block jacobi", "block-jacobi", "ebe"):
        return element_schwarz_precond(J, **kw)
    raise ValueError(f"unknown preconditioner variant {variant!r}")
