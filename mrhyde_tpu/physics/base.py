"""Physics module base class.

JAX analog of PhysicsBase<EvalT> (reference:
src/physics/physicsBase.hpp:29-211). Modules are stateless residual
definitions: they read solution/function fields from a Workset and
accumulate weak-form contributions. They never see meshes, dof maps, or
linear algebra. There is no EvalT template ladder — the same Python code
is traced for values, Jacobians (jacfwd), and parameter sensitivities.
"""

from __future__ import annotations

__all__ = ["PhysicsModule"]


class PhysicsModule:
    name = "base"

    def __init__(self, settings=None, dim: int = 2):
        self.settings = settings or {}
        self.dim = dim

    # -- setup hooks -----------------------------------------------------

    def variables(self) -> list[tuple[str, str, int]]:
        """[(name, basis space, default order), ...]."""
        raise NotImplementedError

    def define_functions(self, fm, fs: dict):
        """Register default + user expressions with the FunctionManager.

        fs: the 'Functions' sublist of the input deck (name -> expr).
        """

    # -- residual hooks (called per traced element) ----------------------

    def volume_residual(self, wk):
        pass

    def boundary_residual(self, wk):
        pass

    def face_residual(self, wk):
        pass

    def compute_flux(self, wk):
        pass

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _f(fs: dict, key: str, default):
        return fs.get(key, default) if fs else default
