"""Thermal (heat equation) physics module.

Weak form (reference: src/physics/thermal.cpp:71-166):
  (rho cp dT/dt - f, v) + (kappa grad T, grad v)
  + optional advection (b . grad T, v)
Boundary terms (reference: thermal.cpp boundaryResidual): Neumann
-(g, v)_Gamma and weak Dirichlet Nitsche-type terms.
"""

from __future__ import annotations

from mrhyde_tpu.physics.base import PhysicsModule
from mrhyde_tpu.physics.registry import register

__all__ = ["Thermal"]


@register("thermal")
class Thermal(PhysicsModule):
    name = "thermal"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.have_advection = bool(self.settings.get("include advection",
                                                     False))
        self.form_param = float(self.settings.get("form_param", 1.0))

    def variables(self):
        return [("e", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("thermal source", self._f(fs, "thermal source", 0.0),
                        "ip")
        fm.add_function("thermal diffusion",
                        self._f(fs, "thermal diffusion", 1.0), "ip")
        fm.add_function("specific heat", self._f(fs, "specific heat", 1.0),
                        "ip")
        fm.add_function("density", self._f(fs, "density", 1.0), "ip")
        fm.add_function("thermal diffusion",
                        self._f(fs, "thermal diffusion", 1.0), "side ip")
        fm.add_function("robin alpha", self._f(fs, "robin alpha", 0.0),
                        "side ip")
        if self.have_advection:
            fm.add_function("bx", self._f(fs, "advection x", 0.0), "ip")
            fm.add_function("by", self._f(fs, "advection y", 0.0), "ip")
            fm.add_function("bz", self._f(fs, "advection z", 0.0), "ip")

    def volume_residual(self, wk):
        rho = wk.f("density")
        cp = wk.f("specific heat")
        kappa = wk.f("thermal diffusion")
        source = wk.f("thermal source")
        dTdt = wk.sol_dot("e")
        gradT = wk.grad("e")
        sval = rho * cp * dTdt - source
        if self.have_advection:
            b = [wk.f("bx")]
            if self.dim > 1:
                b.append(wk.f("by"))
            if self.dim > 2:
                b.append(wk.f("bz"))
            for d, bd in enumerate(b):
                sval = sval + bd * gradT[:, d]
        wk.add_source("e", sval)
        wk.add_flux("e", wk.qp(kappa)[:, None] * gradT)

    def boundary_residual(self, wk):
        bctype = wk.bcs.get("e")
        if bctype == "Neumann":
            g = wk.f(f"Neumann e {wk.side_name}", "side ip")
            wk.add_source("e", -wk.qp(g))
        elif bctype == "interface":
            # multiscale coupling vs the macro trace lambda ("aux e"):
            # Nitsche terms with epen = 10 (reference: thermal.cpp:227-286)
            kappa = wk.qp(wk.f("thermal diffusion", "side ip"))
            lam = wk.qp(wk.resolve("aux e"))
            T = wk.sol("e")
            gradT = wk.grad("e")
            n = wk.normals
            fluxn = kappa * (gradT * n).sum(axis=1)
            h = wk.side_h
            epen = 10.0
            sf = self.form_param
            wk.add_source("e", epen / h * kappa * (T - lam) - fluxn)
            st, nd = wk.offsets["e"]
            dgn = (wk.basis_grad("e") * n[None, :, :]).sum(axis=2)
            contrib = -sf * (dgn * (kappa * (T - lam) * wk.wts)[None, :]
                             ).sum(axis=1)
            wk._res = wk._res.at[st:st + nd].add(contrib)
        elif bctype == "weak Dirichlet":
            # Nitsche-type weak Dirichlet as in the reference:
            # -(kappa grad T . n, v) - sf*(T - g, kappa grad v . n)
            # + penalty/h handled via robin alpha (reference uses
            # 10/h * kappa weight)
            kappa = wk.f("thermal diffusion", "side ip")
            g = wk.f(f"Dirichlet e {wk.side_name}", "side ip")
            T = wk.sol("e")
            gradT = wk.grad("e")
            n = wk.normals
            fluxn = (kappa * (gradT * n).sum(axis=1))
            wk.add_source("e", -fluxn)
            sf = self.form_param
            # adjoint-consistency term + penalty
            st, nd = wk.offsets["e"]
            dgrad = wk.basis_grad("e")          # (ndof, Q, dim)
            dgn = (dgrad * n[None, :, :]).sum(axis=2)   # (ndof, Q)
            contrib = -sf * (dgn * (kappa * (T - g) * wk.wts)[None, :]
                             ).sum(axis=1)
            wk._res = wk._res.at[st:st + nd].add(contrib)
            h = wk.side_h
            pen = 10.0 / h
            wk.add_source("e", pen * wk.qp(kappa) * (T - g))

    def setup_integrated_quantities(self, dim):
        """Module test IQs (reference: thermal.cpp:422)."""
        if not self.settings.get("test integrated quantities", False):
            return []
        flux = " + ".join(f"n[{c}]*grad(e)[{c}]" for c in "xyz"[:dim])
        return [("e", "thermal vol total e", "volume"),
                ("e", "thermal bnd total e", "boundary"),
                (f"({flux})", "thermal bnd heat flux", "boundary")]

    def compute_flux(self, wk):
        """Upscaled flux for multiscale coupling (reference:
        thermal.cpp:288-345 computeFlux):
        flux = epen/h kappa (lambda - T) + sf kappa grad T . n."""
        kappa = wk.qp(wk.f("thermal diffusion", "side ip"))
        lam = wk.qp(wk.resolve("aux e"))
        T = wk.sol("e")
        gradT = wk.grad("e")
        n = wk.normals
        epen, sf = 10.0, 1.0
        return {"e": epen / wk.side_h * kappa * (lam - T)
                + sf * kappa * (gradT * n).sum(axis=1)}
