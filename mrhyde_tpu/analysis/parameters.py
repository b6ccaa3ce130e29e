"""Parameter management: inactive / active / stochastic / discretized.

JAX analog of the reference ParameterManager (reference:
src/managers/parameterManager.cpp:154-204 setupParameters; AD seeding
via sacadoizeParams). There is no seeding step here: active parameters
form a pytree `pvec` that flows into the traced residual, and
jax.grad/jacfwd provide d(residual)/d(param) exactly where the
reference reads Sacado derivative lanes.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

__all__ = ["ParameterManager", "ParamSpec"]


@dataclass
class ParamSpec:
    name: str
    usage: str     # inactive | active | stochastic | discrete | discretized
    value: object              # scalar or array (field dofs if discretized)
    distribution: str = "uniform"
    mean: float = 0.0
    variance: float = 1.0
    min: float = 0.0
    max: float = 1.0
    basis: str = "HGRAD"       # discretized params: basis space
    order: int = 1             # discretized params: basis order
    dynamic: bool = False      # time-dependent (one field per step)


class ParameterManager:
    def __init__(self, cfg: dict | None):
        self.specs: dict[str, ParamSpec] = {}
        for name, sub in (cfg or {}).items():
            if not isinstance(sub, dict):
                self.specs[name] = ParamSpec(name, "inactive", float(sub))
                continue
            ptype = sub.get("type", "scalar")
            # discretized params name their BASIS via 'type' and their
            # start value via 'initial_value' (reference deck schema:
            # type: HGRAD / order / initial_value / lower_bound ...)
            val = sub.get("value", sub.get("initial_value", 0.0))
            if "source" in sub:
                # vector parameter values from a text file (reference:
                # parameterManager.cpp 'source' key, e.g. KL coeffs)
                val = np.loadtxt(str(sub["source"])).ravel().tolist()
            if ptype == "vector" and not isinstance(val, (list, tuple)):
                val = [val]
            value = (np.asarray(val, dtype=float)
                     if isinstance(val, (list, tuple)) else float(val))
            self.specs[name] = ParamSpec(
                name=name, usage=sub.get("usage", "inactive"), value=value,
                distribution=sub.get("distribution", "uniform"),
                mean=float(sub.get("mean", 0.0)),
                variance=float(sub.get("variance", 1.0)),
                min=float(sub.get("min", sub.get("lower_bound", 0.0))),
                max=float(sub.get("max", sub.get("upper_bound", 1.0))),
                basis=sub.get("basis",
                              ptype if ptype not in ("scalar", "vector")
                              else "HGRAD"),
                order=int(sub.get("order", 1)),
                dynamic=bool(sub.get("dynamic", False)))

    # -- views ----------------------------------------------------------

    def all_values(self) -> dict:
        """name -> value for scalar/vector params (expression leaves).

        Discretized (field) parameters resolve through the assembler's
        field-parameter registry instead."""
        return {n: s.value for n, s in self.specs.items()
                if s.usage != "discretized"}

    def discretized_names(self) -> list[str]:
        return [n for n, s in self.specs.items()
                if s.usage == "discretized"]

    def active_names(self) -> list[str]:
        """Differentiable parameters: active scalars + discretized fields
        (the reference optimizes both through ROL, MrHyDE_OptVector)."""
        return [n for n, s in self.specs.items()
                if s.usage in ("active", "discretized")]

    def stochastic_names(self) -> list[str]:
        return [n for n, s in self.specs.items() if s.usage == "stochastic"]

    def pvec(self) -> dict:
        """Active parameters as a differentiable pytree."""
        return {n: jnp.asarray(self.specs[n].value)
                for n in self.active_names()}

    def update(self, values: dict):
        for n, v in values.items():
            self.specs[n].value = v

    # -- flat vector interface (for optimizers) -------------------------

    def flatten(self, pvec: dict) -> jnp.ndarray:
        parts = [jnp.atleast_1d(jnp.asarray(pvec[n])).ravel()
                 for n in self.active_names()]
        return (jnp.concatenate(parts) if parts
                else jnp.zeros(0))

    def unflatten(self, vec) -> dict:
        out = {}
        i = 0
        for n in self.active_names():
            v = np.atleast_1d(self.specs[n].value)
            k = v.size
            chunk = vec[i:i + k]
            if v.ndim > 1:
                # dynamic discretized fields: (n_steps, n_dof)
                out[n] = chunk.reshape(v.shape)
            else:
                out[n] = chunk if v.size > 1 else chunk[0]
            i += k
        return out

    def bounds(self):
        lo, hi = [], []
        for n in self.active_names():
            s = self.specs[n]
            k = np.atleast_1d(s.value).size
            lo += [s.min] * k
            hi += [s.max] * k
        return np.array(lo), np.array(hi)
