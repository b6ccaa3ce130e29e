"""Compressible Euler equations — hybridized (HDG) conservative form.

Reference: src/physics/euler.cpp. The reference scheme (Peraire 2011
AIAA) is inherently hybridized: state variables S = (rho, rhoux[,
rhouy, rhouz], rhoE) coupled through facet trace variables S_hat
("aux" fields in the reference), with the numerical flux on every
interface
    F_hat . n = F(S_hat) . n + Stab(S, S_hat) (S - S_hat)
where Stab is one of the two Peraire stabilization matrices built from
the flux-Jacobian eigendecomposition (euler.cpp
computeStabilizationTerm, :965-1085):
    "Roe-like stabilization":  Stab = R |Lambda| L   at S_hat
    "max EV stabilization":    Stab = lambda_max I   at S_hat
The reference refuses to run without one (euler.cpp:61-65); so do we.

Design: the reference reads S_hat from the aux/mortar
machinery (only reachable through the multiscale solver); here the
traces are first-class HFACE variables and the whole scheme —
volume terms, per-side numerical fluxes (faceResidual), and the trace
continuity equation sum_{e in f} F_hat . n_e = 0 — assembles inside
ONE vmapped element kernel (face tables ride the volume workset), so
the HDG system is a single jacfwd-differentiated residual. The state
space is broken (HGRAD-DG), the honest Peraire discretization; the
reference's HGRAD declaration is only consumable through per-element
subgrid solves where the distinction is invisible.

Boundary conditions (euler.cpp computeBoundaryTerm, :1091-1285):
  Far-field: B = A+(S_hat)(S - S_hat) - A-(S_hat)(S_inf - S_hat)
  Slip:      trace matches interior density/energy, zero normal
             velocity
replace the trace-continuity equation on boundary facets
(boundary_residual subtracts the interior form and adds B). The state
equation keeps the stabilized numerical flux on every side, matching
euler.cpp boundaryResidual (:472-590).

Nondimensional thermodynamics (euler.cpp computeThermoProps):
  p0 = (gamma-1)(rhoE - 0.5 |rhou|^2 / rho)
  T  = gamma Ma^2 p0 / rho,   a = sqrt(T)/Ma = sqrt(gamma p0 / rho)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mrhyde_tpu.physics.base import PhysicsModule
from mrhyde_tpu.physics.registry import register

__all__ = ["Euler", "normal_flux_jacobian", "eigendecomp_flux_jacobian"]


@register("Euler")
class Euler(PhysicsModule):
    name = "euler"
    # subclasses with their own dissipation (cns viscous fluxes) run as
    # plain CG and do not need the Peraire interface stabilization
    requires_stab = True

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        s = self.settings
        self.gamma = float(s.get("gamma", 1.4))
        self.cp = float(s.get("cp", 1004.5))
        self.RGas = float(s.get("RGas", 287.0))
        self.URef = float(s.get("URef", 3.431143))
        self.TRef = float(s.get("TRef", 293.0))
        # reference Mach number Ma = URef / sqrt(gamma R TRef)
        self.Ma = self.URef / np.sqrt(self.gamma * self.RGas * self.TRef)
        self.roestab = bool(s.get("Roe-like stabilization", False))
        self.maxEVstab = bool(s.get("max EV stabilization", False))
        if self.requires_stab and not (self.roestab or self.maxEVstab):
            # reference: euler.cpp:63-65 — a stabilization method is
            # mandatory ("Error: No stabilization method chosen!
            # Specify in input file!"). The test-only escape hatch
            # exists to DEMONSTRATE the failure mode (singular trace
            # equations); it is not a supported configuration.
            if not s.get("_allow no stabilization", False):
                raise ValueError(
                    "Euler: no stabilization method chosen! Set "
                    "'Roe-like stabilization: true' or "
                    "'max EV stabilization: true' in the Physics "
                    "sublist.")

    # ------------------------------------------------------------------

    def variables(self):
        trace_order = 0 if self.dim == 1 else 1
        out = [("rho", "HGRAD-DG", 1), ("rhoux", "HGRAD-DG", 1)]
        if self.dim > 1:
            out.append(("rhouy", "HGRAD-DG", 1))
        if self.dim > 2:
            out.append(("rhouz", "HGRAD-DG", 1))
        out.append(("rhoE", "HGRAD-DG", 1))
        out += [(v + "_hat", "HFACE", trace_order)
                for v in self._names()]
        return out

    def define_functions(self, fm, fs):
        for v in ("rho", "rhoux", "rhouy", "rhouz", "rhoE"):
            fm.add_function(f"source {v}",
                            self._f(fs, f"source {v}", 0.0), "ip")

    def augment_initial_conditions(self, ics: dict):
        """Default each trace IC to its state IC (the facet trace of
        the initial field) — a zero trace would make the first Newton
        linearization divide by rho_hat = 0."""
        for v in self._names():
            if v + "_hat" not in ics and v in ics:
                ics[v + "_hat"] = ics[v]

    def _mom_names(self):
        return ["rhoux", "rhouy", "rhouz"][:self.dim]

    def _names(self):
        return ["rho"] + self._mom_names() + ["rhoE"]

    # ------------------------------------------------------------------
    # volume terms: (v, S_t) - (grad v, F(S)) - (v, source)
    # (euler.cpp volumeResidual :151-466)
    # ------------------------------------------------------------------

    def volume_residual(self, wk):
        dim = self.dim
        g = self.gamma
        rho = wk.sol("rho")
        rhoE = wk.sol("rhoE")
        mom = [wk.sol(m) for m in self._mom_names()]
        ke = 0.5 * sum(m * m for m in mom) / rho
        p0 = (g - 1.0) * (rhoE - ke)
        vel = [m / rho for m in mom]

        # continuity
        wk.add_source("rho", wk.sol_dot("rho") - wk.qp(wk.f("source rho")))
        wk.add_flux("rho", -jnp.stack(mom, axis=1))
        # momentum
        for d, name in enumerate(self._mom_names()):
            F = jnp.stack([mom[d] * vel[j] + (p0 if j == d else 0.0)
                           for j in range(dim)], axis=1)
            wk.add_source(name, wk.sol_dot(name)
                          - wk.qp(wk.f(f"source {name}")))
            wk.add_flux(name, -F)
        # energy
        FE = jnp.stack([(rhoE + p0) * vel[j] for j in range(dim)], axis=1)
        wk.add_source("rhoE", wk.sol_dot("rhoE")
                      - wk.qp(wk.f("source rhoE")))
        wk.add_flux("rhoE", -FE)

    # ------------------------------------------------------------------
    # numerical flux F_hat.n = F(S_hat).n + Stab(S, S_hat)(S - S_hat)
    # ------------------------------------------------------------------

    def _fhat(self, S, Sh, nn):
        """Stabilized numerical flux at one qp: S, Sh (neq,), nn (dim,)."""
        g = self.gamma
        dim = self.dim
        Fn = _flux_n(Sh, nn, g)
        dS = S - Sh
        if self.roestab:
            # NOTE: exactly the reference's R|Lambda|L form. On a face
            # where the flow is exactly tangential (u.n = 0) the
            # entropy/shear eigenvalues vanish and the trace equation
            # is underdetermined along those characteristics — a
            # property of the scheme itself, not of this
            # implementation; use 'max EV stabilization'
            # (lambda_max >= a > 0) for grid-aligned flows.
            L, lam, R = _eig_jnp(Sh, nn, g, dim)
            stab = R @ (jnp.abs(lam) * (L @ dS))
        elif self.maxEVstab:
            rho = Sh[0]
            momn = Sh[1:1 + dim]
            p0 = (g - 1.0) * (Sh[1 + dim]
                              - 0.5 * jnp.dot(momn, momn) / rho)
            a = jnp.sqrt(g * p0 / rho)
            vn = jnp.dot(momn / rho, nn)
            lam_max = jnp.maximum(jnp.abs(vn + a), jnp.abs(vn - a))
            stab = lam_max * dS
        else:
            stab = 0.0 * dS     # test-only: demonstrates singularity
        return Fn + stab

    def _face_states(self, wk, s):
        names = self._names()
        S = jnp.stack([wk.face_sol(v, s) for v in names], axis=1)
        Qf = S.shape[0]
        Sh = jnp.stack([jnp.broadcast_to(wk.trace(v + "_hat", s), (Qf,))
                        for v in names], axis=1)
        return S, Sh

    def face_residual(self, wk):
        """Per-side numerical flux into BOTH the state equations
        ((F_hat.n, v), euler.cpp boundaryResidual form on every side)
        and the trace continuity equation ((F_hat.n, mu), euler.cpp
        computeFlux 'interface' branch — summing both adjacent
        elements' contributions through the shared HFACE dofs enforces
        flux continuity)."""
        names = self._names()
        for s in range(wk.n_sides()):
            S, Sh = self._face_states(wk, s)
            n = wk.face_normals[s]                       # (Qf, dim)
            fhat = jax.vmap(self._fhat)(S, Sh, n)        # (Qf, neq)
            for i, v in enumerate(names):
                wk.add_face_source(v, s, fhat[:, i])
                wk.add_trace_source(v + "_hat", s, fhat[:, i])

    # ------------------------------------------------------------------
    # boundary facets: replace the trace-continuity equation by the
    # boundary operator B (euler.cpp computeBoundaryTerm)
    # ------------------------------------------------------------------

    def boundary_residual(self, wk):
        bct = wk.bcs.get("rho") or wk.bcs.get("rhoux")
        if bct not in ("Far-field", "Slip"):
            return
        dim = self.dim
        g = self.gamma
        names = self._names()
        S = jnp.stack([wk.sol(v) for v in names], axis=1)       # (Qf,neq)
        Sh = jnp.stack([wk.sol(v + "_hat") for v in names], axis=1)
        n = wk.normals                                          # (Qf,dim)

        # the interior form face_residual already scattered into the
        # trace equation on this side — subtract it and add B instead
        interior = jax.vmap(self._fhat)(S, Sh, n)

        if bct == "Slip":
            rho, rhoh = S[:, 0], Sh[:, 0]
            vn = jnp.einsum("qd,qd->q", S[:, 1:1 + dim] / rho[:, None], n)
            B = [rho - rhoh]
            for d in range(dim):
                B.append((S[:, 1 + d] / rho - vn * n[:, d])
                         - Sh[:, 1 + d] / rhoh)
            B.append(S[:, 1 + dim] - Sh[:, 1 + dim])
            bound = jnp.stack([B[0]] + B[1:1 + dim] + [B[-1]], axis=1)
        else:
            Sinf = jnp.stack(
                [jnp.broadcast_to(
                    wk.qp(wk.f(f"Far-field {v} {wk.side_name}",
                               "side ip")), S.shape[:1])
                 for v in names], axis=1)

            def bterm(s_, sh, sinf, nn):
                L, lam, R = _eig_jnp(sh, nn, g, dim)
                lam_p = 0.5 * (lam + jnp.abs(lam))
                lam_m = 0.5 * (lam - jnp.abs(lam))
                return (R @ (lam_p * (L @ (s_ - sh)))
                        - R @ (lam_m * (L @ (sinf - sh))))

            bound = jax.vmap(bterm)(S, Sh, Sinf, n)

        for i, v in enumerate(names):
            wk.add_source(v + "_hat", bound[:, i] - interior[:, i])


def _flux_n(U, n, gamma):
    """Euler normal flux F(U).n at one state (traceable)."""
    dim = n.shape[0]
    rho = U[0]
    mom = U[1:1 + dim]
    rhoE = U[1 + dim]
    vel = mom / rho
    p0 = (gamma - 1.0) * (rhoE - 0.5 * jnp.dot(mom, mom) / rho)
    un = jnp.dot(vel, n)
    return jnp.concatenate([
        jnp.array([rho * un]), mom * un + p0 * n,
        jnp.array([(rhoE + p0) * un])])


def _eig_jnp(U, n, gamma, dim):
    """Traceable (L, lambda, R) of dF_n/dU (jnp twin of
    eigendecomp_flux_jacobian)."""
    rho = U[0]
    mom = U[1:1 + dim]
    rhoE = U[1 + dim]
    vel = mom / rho
    p0 = (gamma - 1.0) * (rhoE - 0.5 * jnp.dot(mom, mom) / rho)
    a = jnp.sqrt(gamma * p0 / rho)
    un = jnp.dot(vel, n)
    H = (rhoE + p0) / rho
    lam = jnp.concatenate([jnp.array([un - a]),
                           jnp.full((dim,), un),
                           jnp.array([un + a])])
    cols = [jnp.concatenate([jnp.array([1.0]), vel - a * n,
                             jnp.array([H - a * un])])]
    cols.append(jnp.concatenate([jnp.array([1.0]), vel,
                                 jnp.array([0.5 * jnp.dot(vel, vel)])]))
    if dim == 2:
        t = jnp.array([-n[1], n[0]])
        cols.append(jnp.concatenate([jnp.array([0.0]), t,
                                     jnp.array([jnp.dot(vel, t)])]))
    elif dim == 3:
        # robust tangent pair (smooth enough for BC use away from
        # axis-aligned degeneracies)
        ref = jnp.where(jnp.abs(n[0]) < 0.9,
                        jnp.array([1.0, 0.0, 0.0]),
                        jnp.array([0.0, 1.0, 0.0]))
        t1 = jnp.cross(n, ref)
        t1 = t1 / jnp.linalg.norm(t1)
        t2 = jnp.cross(n, t1)
        for t in (t1, t2):
            cols.append(jnp.concatenate(
                [jnp.array([0.0]), t, jnp.array([jnp.dot(vel, t)])]))
    cols.append(jnp.concatenate([jnp.array([1.0]), vel + a * n,
                                 jnp.array([H + a * un])]))
    R = jnp.stack(cols, axis=1)
    L = jnp.linalg.inv(R)
    return L, lam, R


def normal_flux_jacobian(state, n, gamma=1.4):
    """dF_n/dU for the Euler system; state = (rho, rhou..., rhoE).

    Works in 1/2/3 dimensions (reference: euler.hpp
    updateNormalFluxJacobian). Pure jnp; differentiable.
    """
    state = jnp.asarray(state)
    n = jnp.asarray(n)
    dim = n.shape[0]

    def flux_n(U):
        return _flux_n(U, n, gamma)

    return jax.jacfwd(flux_n)(state)


def eigendecomp_flux_jacobian(state, n, gamma=1.4):
    """(L, Lambda, R) with dF_n/dU = R diag(Lambda) L (reference:
    euler.hpp eigendecompFluxJacobian).

    Closed-form eigenvalues (un-a, un, ..., un+a); eigenvector matrices
    computed robustly from the analytic Jacobian so that R @ diag @ L
    reproduces it to machine precision.
    """
    state = np.asarray(state, dtype=float)
    n = np.asarray(n, dtype=float)
    dim = n.shape[0]
    rho = state[0]
    mom = state[1:1 + dim]
    rhoE = state[1 + dim]
    vel = mom / rho
    p0 = (gamma - 1.0) * (rhoE - 0.5 * np.dot(mom, mom) / rho)
    a = np.sqrt(gamma * p0 / rho)
    un = np.dot(vel, n)
    H = (rhoE + p0) / rho                      # total enthalpy
    lam = np.concatenate([[un - a], np.full(dim, un), [un + a]])

    # textbook Roe right eigenvectors in conservative variables:
    # acoustic (un -+ a), entropy (un), and dim-1 shear waves (un)
    cols = [np.concatenate([[1.0], vel - a * n, [H - a * un]])]
    cols.append(np.concatenate([[1.0], vel, [0.5 * np.dot(vel, vel)]]))
    if dim >= 2:
        if dim == 2:
            tangents = [np.array([-n[1], n[0]])]
        else:
            t1 = np.cross(n, [1.0, 0.0, 0.0])
            if np.linalg.norm(t1) < 1e-8:
                t1 = np.cross(n, [0.0, 1.0, 0.0])
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(n, t1)
            tangents = [t1, t2]
        for t in tangents:
            cols.append(np.concatenate([[0.0], t, [np.dot(vel, t)]]))
    cols.append(np.concatenate([[1.0], vel + a * n, [H + a * un]]))
    R = np.stack(cols, axis=1)
    L = np.linalg.inv(R)
    return L, lam, R
