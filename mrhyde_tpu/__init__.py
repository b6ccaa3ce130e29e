"""mrhyde_tpu — a multiphysics finite-element framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of MrHyDE
(Sandia's Multi-resolution Hybridized Differential Equations framework,
reference: /root/reference/src/driver.cpp:1-7):

- coupled steady/transient PDE systems (thermal, CDR, Burgers,
  Navier-Stokes, shallow water, Maxwell, linear elasticity, porous
  media, phase field, Helmholtz, ODEs, ...)
- CG/mixed FEM discretizations on structured + unstructured meshes
- adjoint-based sensitivities and PDE-constrained optimization
- Monte-Carlo UQ and data-consistent inversion
- two-level multiscale (subgrid) solves

Architecture (a redesign, not a port):
- element kernels are pure functions vmapped over element batches; the
  basis contractions are batched einsums that XLA fuses (reference:
  Kokkos parallel_for in e.g. src/physics/thermal.cpp:124-127)
- element Jacobians come from jax.jacfwd of the per-element residual
  (reference: Sacado SFad seeding, src/tools/workset.cpp:559)
- gather/scatter is index-gather + segment-sum (deterministic; reference:
  atomic scatter, src/managers/assemblyManager.cpp:3943-3978)
- linear algebra is matrix-free Krylov on jnp arrays (reference:
  Tpetra/Belos, src/interfaces/linearAlgebraInterface.cpp)
- distribution is jax.sharding over a device Mesh (reference: MPI +
  Tpetra import/export)
"""

__version__ = "0.1.0"

from mrhyde_tpu.runtime import fp64, default_dtype  # noqa: F401
