"""FunctionManager: named user/physics expressions evaluated on worksets.

JAX equivalent of the reference's FunctionManager + DAG + Vista
stack (reference: src/managers/functionManager.cpp:48 addFunction,
:544 evaluate; src/tools/dag.hpp; src/tools/vista.hpp). Expressions are
parsed once at setup; evaluation happens inside the traced element
kernel so XLA fuses everything — there is no interpreter at run time.
"""

from __future__ import annotations

from mrhyde_tpu.functions.parser import Expr, parse_expression

__all__ = ["FunctionManager"]


class FunctionManager:
    """Registry of named expressions per evaluation location.

    Locations mirror the reference: "ip" (volume quadrature),
    "side ip" (face quadrature), "point".
    """

    def __init__(self):
        self._exprs: dict[tuple[str, str], Expr] = {}

    def add_function(self, name: str, expression, location: str = "ip"):
        self._exprs[(name, location)] = parse_expression(expression)

    def has(self, name: str, location: str = "ip") -> bool:
        return (name, location) in self._exprs

    def evaluate(self, name: str, wk, location: str = "ip"):
        """Evaluate a named function against a workset-like resolver.

        `wk` must provide .resolve(leaf_name) for non-function leaves.
        """
        return self._eval(name, wk, location, frozenset())

    def evaluate_expr(self, expression, wk, location: str = "ip"):
        """Evaluate an ad-hoc expression string (parsed and cached)."""
        key = ("__adhoc__:" + str(expression), location)
        if key not in self._exprs:
            self._exprs[key] = parse_expression(expression)
        expr = self._exprs[key]
        return expr.evaluate(lambda leaf: self._resolve(leaf, wk, location,
                                                        frozenset()))

    def _eval(self, name: str, wk, location: str, stack: frozenset):
        if name in stack:
            raise ValueError(f"cyclic function definition involving {name!r}")
        expr = self._exprs.get((name, location))
        if expr is None:
            # fall back to another location's definition (the reference
            # registers e.g. "thermal diffusion" at both ip and side ip)
            for (n, _loc), e in self._exprs.items():
                if n == name:
                    expr = e
                    break
        if expr is None:
            raise KeyError(f"function {name!r} not defined")
        stack = stack | {name}
        return expr.evaluate(lambda leaf: self._resolve(leaf, wk, location,
                                                        stack))

    def _resolve(self, leaf: str, wk, location: str, stack: frozenset):
        if any(n == leaf for (n, _l) in self._exprs):
            return self._eval(leaf, wk, location, stack)
        return wk.resolve(leaf)
