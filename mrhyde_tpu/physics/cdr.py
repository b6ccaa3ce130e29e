"""Convection-diffusion-reaction physics module.

Weak form (reference: src/physics/cdr.cpp:63-145):
  (c_t + v . grad c + reaction - source, w)
  + (diffusion/(rho cp) grad c, grad w)
The reaction function may reference the solution (e.g. '0.5*c*c'),
making the problem nonlinear.
"""

from __future__ import annotations

from mrhyde_tpu.physics.base import PhysicsModule
from mrhyde_tpu.physics.registry import register

__all__ = ["CDR"]


@register("cdr")
class CDR(PhysicsModule):
    name = "cdr"

    def variables(self):
        return [("c", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("source", self._f(fs, "source", 0.0), "ip")
        fm.add_function("diffusion", self._f(fs, "diffusion", 1.0), "ip")
        fm.add_function("specific heat", self._f(fs, "specific heat", 1.0),
                        "ip")
        fm.add_function("density", self._f(fs, "density", 1.0), "ip")
        fm.add_function("reaction", self._f(fs, "reaction", 1.0), "ip")
        fm.add_function("xvel", self._f(fs, "xvel", 1.0), "ip")
        fm.add_function("yvel", self._f(fs, "yvel", 1.0), "ip")
        fm.add_function("zvel", self._f(fs, "zvel", 1.0), "ip")
        fm.add_function("SUPG tau", self._f(fs, "SUPG tau", 0.0), "ip")
        fm.add_function("diffusion", self._f(fs, "diffusion", 1.0),
                        "side ip")
        fm.add_function("robin alpha", self._f(fs, "robin alpha", 0.0),
                        "side ip")

    def volume_residual(self, wk):
        source = wk.f("source")
        diff = wk.f("diffusion")
        cp = wk.f("specific heat")
        rho = wk.f("density")
        reax = wk.f("reaction")
        c_t = wk.sol_dot("c")
        gradc = wk.grad("c")
        adv = wk.qp(wk.f("xvel")) * gradc[:, 0]
        if self.dim > 1:
            adv = adv + wk.qp(wk.f("yvel")) * gradc[:, 1]
        if self.dim > 2:
            adv = adv + wk.qp(wk.f("zvel")) * gradc[:, 2]
        wk.add_source("c", c_t + adv + reax - source)
        wk.add_flux("c", wk.qp(diff / (rho * cp))[:, None] * gradc)
