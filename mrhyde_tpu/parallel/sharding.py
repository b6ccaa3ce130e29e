"""Multi-chip distribution via jax.sharding over a device Mesh.

JAX replacement for the reference's MPI domain decomposition +
Tpetra owned/overlapped Import/Export (reference:
src/interfaces/linearAlgebraInterface.cpp:145-309, SURVEY.md section
2.10): elements are sharded across the 'dp' mesh axis (spatial domain
decomposition), the global DOF vector is replicated, and assembly's
segment-sum scatter becomes a local partial-sum + XLA all-reduce
(the "replicated-assembly + psum" design, SURVEY.md section 5.8).
Krylov dot products reduce over ICI automatically. An optional 'ep'
axis shards UQ ensemble members (the reference's SplitComm analog,
src/tools/split_mpi_communicators.cpp).

XLA inserts all collectives from the sharding annotations — there is no
hand-written communication here, and none is needed until DOF-sharded
halo exchange (v2) for meshes too large to replicate a vector.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_assembler_arrays", "sharded_newton_cg_step",
           "pad_elements"]


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              devices=None) -> Mesh:
    devs = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pad_elements(n_elem: int, n_shards: int) -> int:
    """Elements per shard after padding to an even split."""
    return -(-n_elem // n_shards) * n_shards


def shard_assembler_arrays(assembler, mesh: Mesh, axis: str = "dp"):
    """Pad + shard the assembler's per-element arrays across `axis`.

    Padding elements get zero quadrature weights so they contribute
    nothing to residual/Jacobian, and their LIDs point at dof 0 (the
    segment-sum adds zeros there). Returns a dict of sharded arrays that
    the caller threads into jitted steps.
    """
    n_shards = mesh.shape[axis]
    E = assembler.lids.shape[0]
    Epad = pad_elements(E, n_shards)
    pad = Epad - E

    def padded(x, fill=0):
        if pad == 0:
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    uniform = getattr(assembler, "uniform", False)
    arrays = {
        # padded elements index a dummy dof segment (= n_dof) so their
        # contributions are dropped after the segment-sum
        "lids": jax.device_put(padded(assembler.lids,
                                      fill=assembler.n_dof), shard),
        "ip": jax.device_put(padded(assembler.g_ip), shard),
        "uniform": uniform,
    }
    if uniform:
        # compressed basis database: one shared table, replicated
        arrays["wts"] = jax.device_put(assembler.g_wts, repl)
        arrays["bg"] = {k: jax.device_put(v, repl)
                        for k, v in assembler.g_bg.items()}
    else:
        arrays["wts"] = jax.device_put(padded(assembler.g_wts), shard)
        arrays["bg"] = {k: jax.device_put(padded(v), shard)
                        for k, v in assembler.g_bg.items()}
    return arrays


def _spmd_assemble_builder(assembler, mesh: Mesh, axis: str = "dp"):
    """Element-sharded assembly shared by the v1 step builders.

    Returns (assemble, arrays) where assemble(u, tc, pvec, want_jac)
    -> (r, apply, dinv): the replicated global residual, the
    matrix-free J-apply over the sharded element blocks, and the
    Jacobi diagonal inverse (apply/dinv None when want_jac=False).
    Covers orientation signs + the tet-HCURL>=2 mixing channel, the
    field-param/block-mask extra channel, boundary groups, and
    multiscale decks (fine solves sharded over the same axis via
    SubgridDtN.enable_device_sharding).
    """
    arrays = shard_assembler_arrays(assembler, mesh, axis)
    n_dof = assembler.n_dof
    fixed = assembler.fixed
    if assembler.multiscale is not None:
        assembler.multiscale.enable_device_sharding(mesh, axis)

    from functools import partial

    from mrhyde_tpu.assembly.assembler import (_fold_W, _fold_WT,
                                               _fold_jac_WT_W)

    gax = None if arrays["uniform"] else 0

    # orientation fold channel, padded to the sharded element count
    # (pad rows: signs 1, mix with self at weight 0)
    E = assembler.lids.shape[0]
    Epad = pad_elements(E, mesh.shape[axis])
    shard = NamedSharding(mesh, P(axis))
    if assembler.has_signs:
        nd = assembler.lids.shape[1]
        sg = np.ones((Epad, nd))
        sg[:E] = np.asarray(assembler.signs)
        signs = jax.device_put(jnp.asarray(sg, assembler.signs.dtype),
                               shard)
        if assembler.mixp is not None:
            mp = np.tile(np.arange(nd, dtype=np.int64), (Epad, 1))
            mw = np.zeros((Epad, nd))
            mp[:E] = np.asarray(assembler.mixp)
            mw[:E] = np.asarray(assembler.mixw)
            mixp = jax.device_put(jnp.asarray(mp), shard)
            mixw = jax.device_put(jnp.asarray(mw, signs.dtype), shard)
            mixwT = jax.device_put(
                jnp.asarray(np.take_along_axis(mw, mp, axis=1),
                            signs.dtype), shard)
        else:
            mixp = mixw = mixwT = None
    else:
        signs = mixp = mixw = mixwT = None

    def assemble(u, tc, pvec=None, want_jac=True):
        lids = arrays["lids"]
        zpad = jnp.zeros(1, dtype=u.dtype)

        def gath(vec):
            g = jnp.concatenate([vec, zpad])[lids]
            return g if signs is None else _fold_W(g, signs, mixp, mixw)

        u_e, bu_e, bt_e = gath(u), gath(tc.beta_u), gath(tc.beta_t)
        fn = partial(assembler._elem_residual, alpha_u=tc.alpha_u,
                     alpha_t=tc.alpha_t, time=tc.time, pvec=pvec,
                     deltat=tc.deltat)
        extra = assembler._field_param_values(pvec)
        eax = 0 if extra else None
        extra = extra or None
        res_e = jax.vmap(fn, in_axes=(0, 0, 0, gax, 0, gax, eax))(
            u_e, bu_e, bt_e, arrays["wts"], arrays["ip"], arrays["bg"],
            extra)
        jac_e = jax.vmap(jax.jacfwd(fn, argnums=0),
                         in_axes=(0, 0, 0, gax, 0, gax, eax))(
            u_e, bu_e, bt_e, arrays["wts"], arrays["ip"], arrays["bg"],
            extra) if want_jac else None
        if signs is not None:
            res_e = _fold_WT(res_e, signs, mixp, mixwT)
            if want_jac:
                jac_e = _fold_jac_WT_W(jac_e, signs, mixp, mixwT)
        r = jax.ops.segment_sum(res_e.ravel(), lids.ravel(),
                                num_segments=n_dof + 1)[:n_dof]

        # boundary groups (weak BCs / natural Dirichlet): O(surface),
        # assembled replicated — added once to the replicated residual
        bnd_jacs = []
        for group in assembler._active_bnd_groups():
            u_b, bu_b, bt_b = assembler._gathered(u, tc, group["lids"],
                                                  group=group)
            bfn = partial(assembler._belem_residual, group,
                          alpha_u=tc.alpha_u, alpha_t=tc.alpha_t,
                          time=tc.time, pvec=pvec, deltat=tc.deltat)
            res_b = jax.vmap(bfn)(u_b, bu_b, bt_b, group["wts"],
                                  group["ip"], group["normals"],
                                  group["bg"])
            if assembler.has_signs:
                res_b = _fold_WT(res_b, group["signs"], group["mixp"],
                                 group["mixwT"])
            r = r + jax.ops.segment_sum(
                res_b.ravel(), jnp.asarray(group["lids"]).ravel(),
                num_segments=n_dof)
            if want_jac:
                jac_b = jax.vmap(jax.jacfwd(bfn, argnums=0))(
                    u_b, bu_b, bt_b, group["wts"], group["ip"],
                    group["normals"], group["bg"])
                if assembler.has_signs:
                    jac_b = _fold_jac_WT_W(jac_b, group["signs"],
                                           group["mixp"], group["mixwT"])
                bnd_jacs.append((jac_b, group["lids"]))

        # multiscale: upscaled subgrid contributions; the fine solves
        # themselves are sharded over the same axis (the macro batch
        # axis carries a with_sharding_constraint — see
        # SubgridDtN.enable_device_sharding)
        if assembler.multiscale is not None:
            r = r + assembler.multiscale.residual_contribution(u, tc,
                                                               pvec)
            if want_jac:
                for blk, blids in assembler.multiscale.jacobian_blocks(
                        u, tc, pvec):
                    bnd_jacs.append((blk, blids))
        r = jnp.where(fixed, 0.0, r)
        if not want_jac:
            return r, None, None

        def apply(v):
            # jac_e is already folded to the canonical frame (W^T J W),
            # so the gather here is raw — no sign/mix fold
            vm = jnp.where(fixed, 0.0, v)
            ve = jnp.concatenate([vm, jnp.zeros(1, dtype=v.dtype)])[lids]
            ae = jnp.einsum("eij,ej->ei", jac_e, ve)
            av = jax.ops.segment_sum(ae.ravel(), lids.ravel(),
                                     num_segments=n_dof + 1)[:n_dof]
            for jac_b, blids in bnd_jacs:
                av = av + jax.ops.segment_sum(
                    jnp.einsum("eij,ej->ei", jac_b, vm[blids]).ravel(),
                    jnp.asarray(blids).ravel(), num_segments=n_dof)
            return jnp.where(fixed, v, av)

        diag = jax.ops.segment_sum(
            jnp.diagonal(jac_e, axis1=1, axis2=2).ravel(), lids.ravel(),
            num_segments=n_dof + 1)[:n_dof]
        for jac_b, blids in bnd_jacs:
            diag = diag + jax.ops.segment_sum(
                jnp.diagonal(jac_b, axis1=1, axis2=2).ravel(),
                jnp.asarray(blids).ravel(), num_segments=n_dof)
        dinv = jnp.where(fixed, 1.0, 1.0 / jnp.where(diag == 0, 1.0, diag))
        return r, apply, dinv

    return assemble, arrays


def sharded_newton_cg_step(assembler, mesh: Mesh, axis: str = "dp",
                           cg_iters: int = 25):
    """Build a jitted, element-sharded Newton-CG step: u -> u'.

    One full implicit solver step: assemble the element-block Jacobian
    and residual over sharded elements, then run a fixed-iteration
    Jacobi-preconditioned CG on the matrix-free operator. All
    cross-shard reduction is XLA-inserted (segment-sum over replicated
    dof ids + dot products).
    """
    assemble, arrays = _spmd_assemble_builder(assembler, mesh, axis)
    repl = NamedSharding(mesh, P())

    def step(u, tc, pvec=None):
        r, apply, dinv = assemble(u, tc, pvec)
        from mrhyde_tpu.parallel.dof_sharding import DofShardedStep
        dot = lambda a, b: jnp.vdot(a, b)
        x = DofShardedStep._cg(apply, -r, dinv, dot, cg_iters)
        return u + x, jnp.linalg.norm(r)

    jstep = jax.jit(step, out_shardings=(repl, repl))
    return jstep, arrays


def sharded_newton_du_step(assembler, mesh: Mesh, axis: str = "dp",
                           method: str = "cg", iters: int = 200,
                           gmres_m: int = 60, gmres_restarts: int = 4):
    """Deck-facing element-sharded Newton LINEAR step + residual norm.

    Returns (du_fn, res_norm_fn), both jitted with pvec as a runtime
    pytree argument: du_fn(u, tc, pvec) -> (du, |r|) assembles the
    sharded residual/Jacobian (incl. multiscale upscaled blocks with
    device-sharded fine solves) and runs fixed-iteration Jacobi-CG or
    restarted GMRES; res_norm_fn(u, tc, pvec) -> |r| is the
    residual-only path for backtracking line searches.
    """
    assemble, _arrays = _spmd_assemble_builder(assembler, mesh, axis)
    repl = NamedSharding(mesh, P())
    from mrhyde_tpu.parallel.dof_sharding import DofShardedStep
    dot = lambda a, b: jnp.vdot(a, b)

    def du_step(u, tc, pvec=None):
        r, apply, dinv = assemble(u, tc, pvec)
        if method == "cg":
            du = DofShardedStep._cg(apply, -r, dinv, dot, iters)
        else:
            du = DofShardedStep._gmres(apply, -r, dinv, dot, gmres_m,
                                       gmres_restarts)
        return du, jnp.linalg.norm(r)

    def res_norm(u, tc, pvec=None):
        r, _, _ = assemble(u, tc, pvec, want_jac=False)
        return jnp.linalg.norm(r)

    return (jax.jit(du_step, out_shardings=(repl, repl)),
            jax.jit(res_norm, out_shardings=repl))
