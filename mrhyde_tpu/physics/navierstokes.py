"""Incompressible Navier-Stokes physics module (equal-order SUPG/PSPG).

Weak form (reference: src/physics/navierstokes.cpp:95-520):
  momentum d: (visc grad(u_d) - p e_d, grad v)
              + (rho (u_d_t + u . grad u_d - source_d), v)
              [+ SUPG: (tau stabres_d u, grad v)]
  continuity: (div u, q) [+ PSPG: (tau stabres / rho, grad q)]
  stabres_d = rho u_d_t + rho u . grad u_d + dp/dx_d - rho source_d
  tau = 1/sqrt((C1 visc/h^2)^2 + (C2 |u|/h)^2 + (C3/dt)^2),
  C1=4, C2=2, C3 = 2 if transient else 0 (navierstokes.cpp computeTau).
"""

from __future__ import annotations

import jax.numpy as jnp

from mrhyde_tpu.physics.base import PhysicsModule
from mrhyde_tpu.physics.registry import register

__all__ = ["NavierStokes"]

_VELS = ["ux", "uy", "uz"]


@register("navier stokes")
class NavierStokes(PhysicsModule):
    name = "navierstokes"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.use_supg = bool(self.settings.get("useSUPG", False))
        self.use_pspg = bool(self.settings.get("usePSPG", False))

    def variables(self):
        out = [("ux", "HGRAD", 1), ("pr", "HGRAD", 1)]
        if self.dim > 1:
            out.insert(1, ("uy", "HGRAD", 1))
        if self.dim > 2:
            out.insert(2, ("uz", "HGRAD", 1))
        return out

    def define_functions(self, fm, fs):
        for v in ("ux", "pr", "uy", "uz"):
            fm.add_function(f"source {v}",
                            self._f(fs, f"source {v}", 0.0), "ip")
        fm.add_function("density", self._f(fs, "density", 1.0), "ip")
        fm.add_function("viscosity", self._f(fs, "viscosity", 1.0), "ip")

    def _tau(self, visc, u2, wk):
        c1, c2 = 4.0, 2.0
        c3 = 2.0 if wk.is_transient else 0.0
        nvel = jnp.where(u2 > 1e-12, jnp.sqrt(u2), u2)
        h = wk.h
        t2 = ((c1 * visc / (h * h)) ** 2 + (c2 * nvel / h) ** 2
              + (c3 / wk.deltat) ** 2)
        return 1.0 / jnp.sqrt(t2)

    def volume_residual(self, wk):
        dim = self.dim
        rho = wk.qp(wk.f("density"))
        visc = wk.qp(wk.f("viscosity"))
        vels = _VELS[:dim]
        src = {v: wk.qp(wk.f(f"source {v}")) for v in vels}
        pr = wk.sol("pr")
        uvals = {v: wk.sol(v) for v in vels}
        udots = {v: wk.sol_dot(v) for v in vels}
        grads = {v: wk.grad(v) for v in vels}

        conv = {v: sum(uvals[w] * grads[v][:, d]
                       for d, w in enumerate(vels)) for v in vels}

        # Boussinesq buoyancy when a temperature variable 'e' shares
        # the set (reference: have_energy, navierstokes.cpp:134-147 —
        # F = rho * beta * (T - T_ambient) * source_d added to each
        # momentum equation, with the matching SUPG strong-residual
        # term at :231)
        buoy = None
        if "e" in wk.offsets:
            t_amb = float(self.settings.get("T_ambient", 0.0))
            beta = float(self.settings.get("beta", 1.0))
            buoy = rho * beta * (wk.sol("e") - t_amb)

        for d, v in enumerate(vels):
            flux = visc[:, None] * grads[v]
            flux = flux.at[:, d].add(-pr)
            wk.add_flux(v, flux)
            extra = buoy * src[v] if buoy is not None else 0.0
            wk.add_source(v, rho * (udots[v] + conv[v] - src[v]) + extra)

        divu = sum(grads[v][:, d] for d, v in enumerate(vels))
        wk.add_source("pr", divu)

        if self.use_supg or self.use_pspg:
            u2 = sum(uvals[v] ** 2 for v in vels)
            tau = self._tau(visc, u2, wk)
            gradp = wk.grad("pr")
            stabres = {v: (rho * udots[v] + rho * conv[v] + gradp[:, d]
                           - rho * src[v]
                           + (buoy * src[v] if buoy is not None
                              else 0.0))
                       for d, v in enumerate(vels)}
        if self.use_supg:
            uvec = jnp.stack([uvals[v] for v in vels], axis=1)
            for v in vels:
                wk.add_flux(v, (tau * stabres[v])[:, None] * uvec)
        if self.use_pspg:
            stab = jnp.stack([tau * stabres[v] / rho for v in vels],
                             axis=1)
            wk.add_flux("pr", stab)
