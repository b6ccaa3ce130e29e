"""Assembler: residuals and Jacobians over batched elements.

JAX replacement for the reference AssemblyManager's hot path
(reference: src/managers/assemblyManager.cpp — performGather :3441, AD
seeding via workset.cpp:559, physics volumeResidual, atomic scatter
:3943/:3882, AD-type dispatch :2045):

- gather:    u_elem = u_global[lids]                     (one XLA gather)
- seed:      u_eval = alpha_u*u_stage + beta_u,
             u_dot  = alpha_t*u_stage + beta_t           (SURVEY App. B)
- residual:  pure per-element function, vmapped
- Jacobian:  jax.vmap(jax.jacfwd(...)) — forward-mode over exactly the
             element's dof count; the reference's AD2..AD64 autotune
             ladder is subsumed by trace-time specialization
- scatter:   jax.ops.segment_sum (deterministic; no atomics)

Dirichlet rows use symmetric elimination: residual rows masked, unit
diagonal in operators (reference: isFixedDOF masking,
assemblyManager.cpp:3963, updateJacDBC).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mrhyde_tpu.assembly.discretization import Discretization
from mrhyde_tpu.assembly.workset import Workset

__all__ = ["Assembler", "TimeCoeffs", "BlockJacobian", "PointContext"]


@jax.tree_util.register_dataclass
@dataclass
class TimeCoeffs:
    """Stage-solution seeding coefficients (SURVEY.md Appendix B).

    u_eval = alpha_u * u_stage + beta_u (vector)
    u_dot  = alpha_t * u_stage + beta_t (vector)
    """
    alpha_u: jax.Array
    beta_u: jax.Array
    alpha_t: jax.Array
    beta_t: jax.Array
    time: jax.Array
    deltat: jax.Array

    @staticmethod
    def steady(n_dof, time=0.0, dtype=jnp.float64):
        z = jnp.zeros(n_dof, dtype=dtype)
        one = jnp.asarray(1.0, dtype=dtype)
        zero = jnp.asarray(0.0, dtype=dtype)
        return TimeCoeffs(one, z, zero, z, jnp.asarray(time, dtype=dtype),
                          one)


@jax.tree_util.register_dataclass
@dataclass
class BlockJacobian:
    """Element-block Jacobian consumed matrix-free (or densified).

    The analog of the reference's Tpetra CRS: never a global sparse
    matrix — per-element dense blocks + index arrays. The volume
    scatter uses a precomputed dof -> (element, local dof) incidence
    table, a fixed-fan-in GATHER + sum with no atomics (the reference
    needed Kokkos atomics here, assemblyManager.cpp:3956).
    """
    vol: jax.Array                    # (E, nd, nd)
    vol_lids: jax.Array               # (E, nd)
    bnd: list                         # list of (B, nd, nd)
    bnd_lids: list                    # list of (B, nd)
    fixed: jax.Array                  # (n_dof,) bool
    inc: jax.Array | None = None      # (n_dof, max_deg) into E*nd (+pad)

    @property
    def n_dof(self):
        return self.fixed.shape[0]

    def _vol_mv(self, vm):
        return jnp.einsum("eij,ej->ei", self.vol, vm[self.vol_lids])

    def _vol_mv_T(self, ve):
        return jnp.einsum("eij,ei->ej", self.vol, ve[self.vol_lids])

    def _gather_sum(self, vals):
        """Assemble flattened per-element values -> (n_dof,)."""
        if self.inc is None:
            return _scatter_vec(vals, self.vol_lids, self.n_dof)
        flat = jnp.concatenate(
            [vals.ravel(), jnp.zeros(1, dtype=vals.dtype)])
        return flat[self.inc].sum(axis=1)

    def apply(self, v):
        """J @ v with Dirichlet identity rows."""
        vm = jnp.where(self.fixed, 0.0, v)
        out = self._gather_sum(self._vol_mv(vm))
        for blocks, lids in zip(self.bnd, self.bnd_lids):
            out = out + _scatter_vec(
                jnp.einsum("eij,ej->ei", blocks, vm[lids]),
                lids, self.n_dof)
        return jnp.where(self.fixed, v, out)

    def _apply_raw(self, v):
        out = self._gather_sum(self._vol_mv(v))
        for blocks, lids in zip(self.bnd, self.bnd_lids):
            out = out + _scatter_vec(
                jnp.einsum("eij,ej->ei", blocks, v[lids]),
                lids, self.n_dof)
        return out

    def _apply_raw_T(self, v):
        out = self._gather_sum(self._vol_mv_T(v))
        for blocks, lids in zip(self.bnd, self.bnd_lids):
            out = out + _scatter_vec(
                jnp.einsum("eij,ei->ej", blocks, v[lids]),
                lids, self.n_dof)
        return out

    def apply_rowfix(self, v):
        """A v with A = identity Dirichlet ROWS but LIVE columns —
        the adjoint-consistent operator (free rows keep their
        dependence on fixed dofs; see analysis/adjoint.py)."""
        return jnp.where(self.fixed, v, self._apply_raw(v))

    def apply_rowfix_T(self, v):
        """A^T v for the row-fixed operator above."""
        vm = jnp.where(self.fixed, 0.0, v)
        out = self._apply_raw_T(vm)
        return out + jnp.where(self.fixed, v, 0.0)

    def diag(self):
        d = self._gather_sum(_block_diag(self.vol))
        for blocks, lids in zip(self.bnd, self.bnd_lids):
            d = d + _scatter_vec(_block_diag(blocks), lids, self.n_dof)
        return jnp.where(self.fixed, 1.0, d)

    def dense(self):
        """Assembled (n, n) matrix, Dirichlet rows and columns replaced
        by a unit diagonal. Dirichlet entries are masked in the element
        blocks before the scatter and the diagonal is scattered in
        place, so the result is the only n x n array built."""
        n = self.n_dof
        A = jnp.zeros((n, n), dtype=self.vol.dtype)
        for blocks, lids in [(self.vol, self.vol_lids),
                             *zip(self.bnd, self.bnd_lids)]:
            live = ~self.fixed[lids]
            blocks = jnp.where(live[:, :, None] & live[:, None, :],
                               blocks, 0.0)
            A = A.at[lids[:, :, None], lids[:, None, :]].add(blocks)
        # unit diagonal on Dirichlet rows and on EMPTY ROWS (dofs no
        # module touches, e.g. a variable outside its block under
        # per-block physics) — reference: fixDiagJac,
        # assemblyManager.cpp:2458. Zero diagonals with off-diagonal
        # coupling (saddle points) are left alone.
        empty = jnp.abs(A).sum(axis=1) == 0
        i = jnp.arange(n)
        return A.at[i, i].add(jnp.where(self.fixed | empty, 1.0, 0.0))


def _block_diag(blocks):
    return jnp.diagonal(blocks, axis1=1, axis2=2)


def _scatter_vec(vals, lids, n_dof):
    return jax.ops.segment_sum(vals.ravel(), lids.ravel(), num_segments=n_dof)


def _fold_W(g, signs, mixp, mixw):
    """Gather-side orientation fold u_loc = W g per element: diagonal
    signs plus the optional 2x2 face-pair mixing channel (tet HCURL
    order >= 2; None mixp = pure signs)."""
    out = g * signs
    if mixp is not None:
        out = out + mixw * jnp.take_along_axis(g, mixp, axis=1)
    return out


def _fold_WT(r, signs, mixp, mixwT):
    """Scatter-side fold W^T r (signs are their own transpose; the
    mixing channel uses mixwT[j] = mixw[pair[j]])."""
    out = r * signs
    if mixp is not None:
        out = out + mixwT * jnp.take_along_axis(r, mixp, axis=1)
    return out


def _fold_jac_WT_W(J, signs, mixp, mixwT):
    """Element-block Jacobian fold W^T J W (J rows/cols in the local
    frame -> global canonical frame)."""
    A = J * signs[:, :, None]
    if mixp is not None:
        idx = jnp.broadcast_to(mixp[:, :, None], J.shape)
        A = A + mixwT[:, :, None] * jnp.take_along_axis(J, idx, axis=1)
    B = A * signs[:, None, :]
    if mixp is not None:
        idx = jnp.broadcast_to(mixp[:, None, :], A.shape)
        B = B + mixwT[:, None, :] * jnp.take_along_axis(A, idx, axis=2)
    return B


def build_incidence(lids: np.ndarray, n_dof: int) -> np.ndarray:
    """dof -> positions in lids.ravel() (padded with E*nd = zero slot).

    Turns assembly scatter into a fixed-fan-in gather + sum — a
    deterministic dual of the reference's atomic scatter.
    """
    flat = np.asarray(lids).ravel()
    order = np.argsort(flat, kind="stable")
    sorted_ids = flat[order]
    counts = np.bincount(sorted_ids, minlength=n_dof)
    max_deg = int(counts.max()) if counts.size else 1
    inc = np.full((n_dof, max_deg), flat.size, dtype=np.int64)
    starts = np.zeros(n_dof + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for k in range(max_deg):
        has = counts > k
        inc[has, k] = order[starts[:-1][has] + k]
    return inc


class PointContext:
    """Expression-leaf resolver at bare points (no solution fields).

    Used for true solutions, Dirichlet data, and initial conditions.
    """

    def __init__(self, pts, time=0.0, params=None, extra=None):
        self.pts = pts
        self.time = time
        self.params = params or {}
        self.extra = extra or {}

    def resolve(self, leaf):
        ax = {"x": 0, "y": 1, "z": 2}.get(leaf)
        if ax is not None and ax < self.pts.shape[-1]:
            return self.pts[..., ax]
        if leaf == "t":
            return self.time
        if leaf in self.params:
            return self.params[leaf]
        if leaf in self.extra:
            return self.extra[leaf]
        raise KeyError(f"cannot resolve leaf {leaf!r} at points")


class Assembler:
    """Owns the volume + boundary element kernels for one block."""

    def __init__(self, disc: Discretization, modules, fm, params=None,
                 fixed_dofs=None, dtype=None, assemble_face_terms=None):
        self.disc = disc
        self.modules = modules
        self.fm = fm
        self.params = params or {}
        self.dtype = dtype or jnp.zeros(0).dtype
        dt = self.dtype

        self.lids = jnp.asarray(disc.lids)
        self.n_dof = disc.n_dof
        self.ndof_elem = disc.ndof_elem
        self.inc = jnp.asarray(build_incidence(disc.lids, disc.n_dof))
        self._structured = self._build_structured_index(disc)

        fixed = np.zeros(disc.n_dof, dtype=bool)
        if fixed_dofs is not None and len(fixed_dofs):
            fixed[np.asarray(fixed_dofs)] = True
        self.fixed = jnp.asarray(fixed)

        # static (per-element-batch) geometry as device arrays.
        # Basis-database compression (reference: buildDatabase,
        # assemblyManager.cpp:4249-4310): on affine-uniform meshes every
        # element shares ONE geometry, so quadrature weights and physical
        # basis gradients are stored once and broadcast (vmap in_axes
        # None). XLA then lowers the basis contractions to batched
        # (E,Q)x(Q,nd) matmuls instead of per-element loads.
        # rtol 1e-9: linspace node rounding accumulates ~1e-13
        # relative deviations at NX=512; genuinely non-uniform meshes
        # differ at O(1), so this stays a safe classifier
        wts0 = disc.wts[0]
        self.uniform = bool(
            np.allclose(disc.wts, wts0[None, :], rtol=1e-9, atol=1e-12)
            and all(np.allclose(v, v[0][None], rtol=1e-9, atol=1e-9)
                    for v in disc.basis_grads.values()))
        vec_uniform = all(
            np.allclose(v, v[0][None], rtol=1e-9, atol=1e-9)
            for d in (disc.vec_vals, disc.div_vals, disc.curl_vals)
            for v in d.values())
        self.uniform = self.uniform and vec_uniform
        if self.uniform:
            self.g_wts = jnp.asarray(wts0, dtype=dt)
            tbl = lambda d: {k: jnp.asarray(v[0], dtype=dt)
                             for k, v in d.items()}
            self._wts_ax = None
            self._bg_ax = None
        else:
            self.g_wts = jnp.asarray(disc.wts, dtype=dt)
            tbl = lambda d: {k: jnp.asarray(v, dtype=dt)
                             for k, v in d.items()}
            self._wts_ax = 0
            self._bg_ax = 0
        self.g_bg = {"grad": tbl(disc.basis_grads),
                     "vec": tbl(disc.vec_vals),
                     "div": tbl(disc.div_vals),
                     "curl": tbl(disc.curl_vals)}
        # modules overriding face_residual get the per-side face loop
        # inside the SAME vmapped element kernel (the batched
        # collapse of the reference's 'assemble face terms' per-side
        # workset sweep, assemblyManager.cpp:2414-2425)
        from mrhyde_tpu.physics.base import PhysicsModule as _PB
        self.face_modules = [
            m for m in modules
            if type(m).face_residual is not _PB.face_residual]
        if assemble_face_terms is not None:
            self.assemble_face_terms = bool(assemble_face_terms)
        else:
            self.assemble_face_terms = bool(self.face_modules)
        needs_faces = any(k[0] in ("HFACE", "HDIV-DG", "HDIV_AC-DG")
                          for k in disc.basis_keys.values()) \
            or self.assemble_face_terms
        if needs_faces:
            fb = {"fwts": disc.face_wts_all,
                  "fnorm": disc.face_normals_all}
            if self.uniform:
                uni = all(np.allclose(v, v[0][None]) for v in
                          [disc.face_wts_all, disc.face_normals_all]
                          + list(disc.face_vec_all.values()))
                self.uniform = uni
                # recompute table closure if uniformity changed
            take0 = (lambda a: a[0]) if self.uniform else (lambda a: a)
            self.g_bg["fwts"] = jnp.asarray(take0(disc.face_wts_all),
                                            dtype=dt)
            self.g_bg["fnorm"] = jnp.asarray(
                take0(disc.face_normals_all), dtype=dt)
            self.g_bg["fvec"] = {k: jnp.asarray(take0(v), dtype=dt)
                                 for k, v in disc.face_vec_all.items()}
            # scalar face tables are element-independent; broadcast an
            # element axis only when the bundle dict rides a vmap axis
            fsc = {}
            for k, v in disc.face_scal_all.items():
                if not self.uniform:
                    v = np.broadcast_to(
                        v, (disc.mesh.n_elem,) + v.shape)
                fsc[k] = jnp.asarray(v, dtype=dt)
            self.g_bg["fscal"] = fsc
            # HFACE trace basis at side qps: uniform (flips are folded
            # into the dof numbering); broadcast in the non-uniform case
            hkeys = [k for k in set(disc.basis_keys.values())
                     if k[0] == "HFACE" and k[1] >= 1]
            if hkeys:
                from mrhyde_tpu.fem.vector_basis import (hface_face_vals,
                                                         hface_side_vals)
                E = disc.mesh.n_elem
                hv = {}
                for k in hkeys:
                    if disc.mesh.dim == 2:
                        t = hface_side_vals(k[1], disc.side_pts[:, 0])
                    else:
                        t = hface_face_vals(disc.mesh.cell_type, k[1],
                                            disc.side_pts)
                    if not self.uniform:
                        t = np.broadcast_to(t, (E,) + t.shape)
                    hv[k] = jnp.asarray(t, dtype=dt)
                self.g_bg["hface"] = hv
        self.signs = jnp.asarray(disc.dofmap.signs, dtype=dt)
        # 2x2 orientation mixing channel (tet HCURL order >= 2 face
        # dofs, fem/dofmap.py): u_loc = signs*g + mixw*g[mixp];
        # scatter/Jacobian folds use the transposed weight
        # mixwT[j] = mixw[pair[j]]
        if disc.dofmap.mix_pair is not None:
            self.mixp = jnp.asarray(disc.dofmap.mix_pair,
                                    dtype=jnp.int32)
            self.mixw = jnp.asarray(disc.dofmap.mix_w, dtype=dt)
            self.mixwT = jnp.take_along_axis(self.mixw, self.mixp,
                                             axis=1)
        else:
            self.mixp = self.mixw = self.mixwT = None
        self.has_signs = bool(np.any(disc.dofmap.signs != 1.0)) \
            or self.mixp is not None
        self.g_ip = jnp.asarray(disc.ip, dtype=dt)
        self.g_bv = {k: jnp.asarray(v, dtype=dt)
                     for k, v in disc.basis_vals.items()}

        self._bnd = []
        for bg in disc.boundary_groups:
            bvals, bvecs = {}, {}
            for k, v in bg.basis_vals.items():
                if k[0] in ("HDIV", "HCURL"):
                    # vector face tables are per-element (Piola): slice
                    # to this group's elements
                    bvecs[k] = jnp.asarray(v[bg.elems], dtype=dt)
                else:
                    bvals[k] = jnp.asarray(v, dtype=dt)
            self._bnd.append(dict(
                sideset=bg.sideset, side=bg.side,
                elems=np.asarray(bg.elems),
                lids=jnp.asarray(bg.lids),
                signs=jnp.asarray(disc.dofmap.signs[bg.elems], dtype=dt),
                mixp=(None if disc.dofmap.mix_pair is None else
                      jnp.asarray(disc.dofmap.mix_pair[bg.elems],
                                  dtype=jnp.int32)),
                mixw=(None if disc.dofmap.mix_w is None else
                      jnp.asarray(disc.dofmap.mix_w[bg.elems],
                                  dtype=dt)),
                mixwT=(None if disc.dofmap.mix_w is None else
                       jnp.asarray(np.take_along_axis(
                           disc.dofmap.mix_w[bg.elems],
                           disc.dofmap.mix_pair[bg.elems], axis=1),
                           dtype=dt)),
                wts=jnp.asarray(bg.wts, dtype=dt),
                ip=jnp.asarray(bg.ip, dtype=dt),
                normals=jnp.asarray(bg.normals, dtype=dt),
                bv=bvals,
                bg={"grad": {k: jnp.asarray(v, dtype=dt)
                             for k, v in bg.basis_grads.items()},
                    "vec": bvecs, "div": {}, "curl": {}},
            ))
        # var -> {sideset -> bctype} filled by the physics/solver setup
        self.var_bcs: dict[str, dict[str, str]] = {}
        # static flag: transient solves stabilize with the C3/dt term
        self.is_transient = False
        # optional multiscale (subgrid DtN) model replacing volume terms
        self.multiscale = None
        # subgrid usage = 1.0 REPLACES the macro volume physics with
        # the upscaled DtN flux (reference: group multiscale flag,
        # assemblyManager skips volume terms for multiscale groups)
        self.volume_off = False
        # discretized (field) parameters: name -> {eldofs, phi, face_phi}
        # (reference: ParameterManager discretized params with their own
        # Panzer DOF manager, parameterManager.cpp:272)
        self.field_params: dict = {}
        # static per-element data imported from mesh data files
        # (reference: AssemblyManager::importMeshData,
        # assemblyManager.cpp:8235 — element centers take the value of
        # the closest data point; physics read it as wkset extra_data)
        self.extra_elem_fields: dict = {}
        # per-block physics masks (E, n_modules) or None (single-block)
        self.module_masks = None
        # jitted entry points (traced once per TimeCoeffs/pvec structure)
        self.residual_jit = jax.jit(self.residual)
        self.jacobian_jit = jax.jit(self.jacobian)

    # ------------------------------------------------------------------
    # structured-mesh fast path: on box meshes with nodal p1 / HVOL
    # variables, gather and scatter are pure slice/pad ops with no
    # index arrays at all (the structured-mesh analog of the
    # reference's basis database + workset tiling, SURVEY.md 5.7)
    # ------------------------------------------------------------------

    def _build_structured_index(self, disc):
        mesh = disc.mesh
        info = getattr(mesh, "box_info", None)
        if info is None or mesh.cell_type not in ("quad", "hex", "line") \
                or getattr(mesh, "periodic", False):
            return None
        dims = [b[2] for b in info["bounds"]]
        corners = {
            "line": [(0,), (1,)],
            "quad": [(0, 0), (1, 0), (1, 1), (0, 1)],
            "hex": [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
        }[mesh.cell_type]
        plan = []
        for i, (name, _s, _o) in enumerate(disc.variables):
            key = disc.basis_keys[name]
            start = int(disc.dofmap.var_start[i])
            if key == ("HVOL", 0):
                plan.append(("hvol", name, start))
            elif key == ("HGRAD", 1):
                plan.append(("p1", name, start))
            else:
                return None
        return {"dims": dims, "corners": corners, "plan": plan,
                "grid": [d + 1 for d in dims]}

    def _gather_structured(self, u):
        s = self._structured
        dims, grid, corners = s["dims"], s["grid"], s["corners"]
        E = int(np.prod(dims))
        cols = []
        for kind, name, start in s["plan"]:
            if kind == "hvol":
                cols.append(u[start:start + E])
                continue
            g = u[start:start + int(np.prod(grid))].reshape(grid)
            for c in corners:
                sl = tuple(slice(c[d], c[d] + dims[d])
                           for d in range(len(dims)))
                cols.append(g[sl].reshape(E))
        return jnp.stack(cols, axis=1)

    def _scatter_structured(self, vals):
        s = self._structured
        dims, grid, corners = s["dims"], s["grid"], s["corners"]
        E = int(np.prod(dims))
        out = jnp.zeros(self.n_dof, dtype=vals.dtype)
        col = 0
        for kind, name, start in s["plan"]:
            if kind == "hvol":
                out = out.at[start:start + E].add(vals[:, col])
                col += 1
                continue
            # pad+sum, NOT a chain of .at[slice].add: the sequential
            # dynamic-update-slices defeat XLA fusion (each pays a full
            # acc read+write pass — measured 24.5 us of a 52 us 512^2
            # assembly); the padded adds fuse into ONE pass
            acc = None
            for c in corners:
                part = jnp.pad(
                    vals[:, col].reshape(dims),
                    [(c[d], grid[d] - dims[d] - c[d])
                     for d in range(len(dims))])
                acc = part if acc is None else acc + part
                col += 1
            out = out.at[start:start + int(np.prod(grid))].add(acc.ravel())
        return out

    # ------------------------------------------------------------------
    # element kernels
    # ------------------------------------------------------------------

    def _make_workset(self, u_eval, u_dot, wts, ip, bg_slices, time, pvec,
                      normals=None, side_name=None, bcs=None, deltat=1.0,
                      basis_vals=None, extra_fields=None):
        params = dict(self.params)
        params.update(pvec or {})
        # discretized params resolve through per-qp extra fields, not
        # as raw dof vectors; reserved "__field:" keys (cross-set
        # solution fields) ride the same channel
        for fp in self.field_params:
            params.pop(fp, None)
        for k in [k for k in params if str(k).startswith("__field:")]:
            params.pop(k)
        params.pop("__ms", None)   # multiscale fine state rides pvec
        return Workset(
            dim=self.disc.mesh.dim, wts=wts, ip=ip,
            basis_vals=self.g_bv if basis_vals is None else basis_vals,
            basis_grads=bg_slices["grad"],
            basis_vecs=bg_slices.get("vec"),
            basis_divs=bg_slices.get("div"),
            basis_curls=bg_slices.get("curl"),
            face_wts=bg_slices.get("fwts"),
            face_normals=bg_slices.get("fnorm"),
            face_vecs=bg_slices.get("fvec"),
            face_scals=bg_slices.get("fscal"),
            hface_vals=bg_slices.get("hface"),
            offsets=self.disc.offsets, var_keys=self.disc.basis_keys,
            u_eval=u_eval, u_dot=u_dot, time=time, fm=self.fm,
            params=params, normals=normals, side_name=side_name, bcs=bcs,
            deltat=deltat, is_transient=self.is_transient,
            extra_fields=extra_fields)

    def set_module_masks(self, masks):
        """Per-block physics assignment (reference:
        physicsInterface.cpp:38-54): masks is (E, n_modules) with 1
        where module k owns the element's block. Each module's volume
        AND boundary contribution is scaled by its mask — branch-free
        dispatch over ONE batched element array."""
        self.module_masks = jnp.asarray(masks, dtype=self.dtype)

    def _elem_residual_uv(self, u_eval, u_dot, wts, ip, bg_slices,
                          time, pvec, deltat=1.0, extra=None):
        bm = None
        if extra is not None and "__blockmask" in extra:
            extra = dict(extra)
            bm = extra.pop("__blockmask")
        wk = self._make_workset(u_eval, u_dot, wts, ip, bg_slices, time,
                                pvec, deltat=deltat, extra_fields=extra)
        if not self.volume_off:
            if bm is None:
                for m in self.modules:
                    m.volume_residual(wk)
                    if self.assemble_face_terms \
                            and m in self.face_modules:
                        m.face_residual(wk)
            else:
                prev = wk.res
                for k, m in enumerate(self.modules):
                    m.volume_residual(wk)
                    if self.assemble_face_terms \
                            and m in self.face_modules:
                        m.face_residual(wk)
                    wk._res = prev + bm[k] * (wk.res - prev)
                    prev = wk._res
        return wk.res

    def _elem_residual(self, u_st, beta_u, beta_t, wts, ip, bg_slices,
                       extra=None, alpha_u=1.0, alpha_t=0.0, time=0.0,
                       pvec=None, deltat=1.0):
        u_eval = alpha_u * u_st + beta_u
        u_dot = alpha_t * u_st + beta_t
        return self._elem_residual_uv(u_eval, u_dot, wts, ip, bg_slices,
                                      time, pvec, deltat=deltat,
                                      extra=extra)

    def _field_param_values(self, pvec):
        """Evaluate discretized params at volume qps: name -> (E, Q).
        Per-block module masks ride the same vmapped channel."""
        out = {}
        if pvec:
            axes = "xyz"[:self.disc.mesh.dim]
            for name, fp in self.field_params.items():
                if name in pvec:
                    pe = pvec[name][fp["eldofs"]]      # (E, ndp)
                    out[name] = jnp.einsum("ei,iq->eq", pe, fp["phi"])
                    if "gphi" in fp:
                        g = jnp.einsum("ei,eiqd->eqd", pe, fp["gphi"])
                        for ax, c in enumerate(axes):
                            out[f"grad({name})[{c}]"] = g[..., ax]
        if self.module_masks is not None:
            out["__blockmask"] = self.module_masks     # (E, n_modules)
        out.update(self.extra_elem_fields)
        if pvec:
            # traced '__field:' entries LAST: per-sample regenerated
            # fields (e.g. UQ 'regenerate grains' stiffness) must
            # override the static setup-time import
            for name, val in pvec.items():
                if str(name).startswith("__field:"):
                    out[name[8:]] = val                # already (E, Q)
        return out or None

    def _field_param_boundary_values(self, pvec, group):
        """Discretized params at a boundary group's side qps:
        name -> (B, Qf), plus physical-gradient channels. The same
        traced-extra channel the volume path uses (reference: side-ip
        evaluation of discretized params, e.g. Neumann 'xtrac*ny' in
        le/2d_sparse_simul_inversion)."""
        out = {}
        if pvec:
            axes = "xyz"[:self.disc.mesh.dim]
            for name, fp in self.field_params.items():
                if name not in pvec:
                    continue
                key = fp.get("key")
                phi = group["bv"].get(key)
                if phi is None:
                    raise NotImplementedError(
                        f"no face basis table for field param {name!r} "
                        f"({key}) on sideset {group['sideset']!r}")
                pe = pvec[name][fp["eldofs"][group["elems"]]]  # (B, ndp)
                out[name] = jnp.einsum("bi,iq->bq", pe, phi)
                gph = group["bg"]["grad"].get(key)
                if gph is not None:
                    g = jnp.einsum("bi,biqd->bqd", pe, gph)
                    for ax, c in enumerate(axes):
                        out[f"grad({name})[{c}]"] = g[..., ax]
        return out or None

    def _belem_residual(self, group, u_st, beta_u, beta_t, wts, ip, normals,
                        bg_slices, extra=None, bmask=None, alpha_u=1.0,
                        alpha_t=0.0, time=0.0, pvec=None, deltat=1.0):
        u_eval = alpha_u * u_st + beta_u
        u_dot = alpha_t * u_st + beta_t
        bcs = {v: self.var_bcs.get(v, {}).get(group["sideset"])
               for v in self.disc.var_names}
        wk = self._make_workset(u_eval, u_dot, wts, ip, bg_slices, time,
                                pvec, normals=normals,
                                side_name=group["sideset"], bcs=bcs,
                                deltat=deltat, basis_vals=group["bv"],
                                extra_fields=extra)
        if bmask is None:
            for m in self.modules:
                m.boundary_residual(wk)
        else:
            # per-block physics: module k's boundary contribution only
            # on its own block's elements (physicsInterface.cpp:38-54
            # dispatches boundaryResidual per block)
            prev = wk.res
            for k, m in enumerate(self.modules):
                m.boundary_residual(wk)
                wk._res = prev + bmask[k] * (wk.res - prev)
                prev = wk._res
        # physics-agnostic 'Flux conditions' (reference:
        # physicsInterface.cpp:1703 fluxConditions -- res += -flux*w*phi
        # applied by the assembly manager for any module)
        for v in self.disc.var_names:
            if bcs.get(v) == "Flux":
                g = wk.f(f"Flux {v} {group['sideset']}", "side ip")
                wk.add_source(v, -wk.qp(g))
        return wk.res

    # ------------------------------------------------------------------
    # global assembly
    # ------------------------------------------------------------------

    def _gathered(self, u_st, tc: TimeCoeffs, lids, signs=None,
                  group=None):
        if signs is None and group is None:
            signs = self.signs if lids is self.lids else None
            mixp, mixw = self.mixp, self.mixw
        elif group is not None:
            signs = group["signs"]
            mixp, mixw = group["mixp"], group["mixw"]
        else:
            mixp = mixw = None
        if lids is self.lids and self._structured is not None \
                and not self.has_signs:
            return (self._gather_structured(u_st),
                    self._gather_structured(tc.beta_u),
                    self._gather_structured(tc.beta_t))
        if signs is not None and self.has_signs:
            return (_fold_W(u_st[lids], signs, mixp, mixw),
                    _fold_W(tc.beta_u[lids], signs, mixp, mixw),
                    _fold_W(tc.beta_t[lids], signs, mixp, mixw))
        return u_st[lids], tc.beta_u[lids], tc.beta_t[lids]

    def residual(self, u_st, tc: TimeCoeffs, pvec=None):
        """Global residual (n_dof,) with Dirichlet rows zeroed."""
        u_e, bu_e, bt_e = self._gathered(u_st, tc, self.lids)
        fn = partial(self._elem_residual, alpha_u=tc.alpha_u,
                     alpha_t=tc.alpha_t, time=tc.time, pvec=pvec,
                     deltat=tc.deltat)
        extra = self._field_param_values(pvec)
        res_e = jax.vmap(fn, in_axes=(0, 0, 0, self._wts_ax, 0,
                                      self._bg_ax, 0))(
            u_e, bu_e, bt_e, self.g_wts, self.g_ip, self.g_bg, extra)
        if self.has_signs:
            res_e = _fold_WT(res_e, self.signs, self.mixp, self.mixwT)
        if self._structured is not None and not self.has_signs:
            r = self._scatter_structured(res_e)
        else:
            flat = jnp.concatenate([res_e.ravel(),
                                    jnp.zeros(1, dtype=res_e.dtype)])
            r = flat[self.inc].sum(axis=1)
        r = r + self._bnd_res_scatter(u_st, tc, pvec)
        if self.multiscale is not None:
            r = r + self.multiscale.residual_contribution(u_st, tc, pvec)
        return jnp.where(self.fixed, 0.0, r)

    def _bnd_res_scatter(self, u_st, tc: TimeCoeffs, pvec=None):
        """Summed boundary-group residual contribution (n_dof,), zero
        when no group is active."""
        r = jnp.zeros(self.n_dof, dtype=u_st.dtype)
        for group in self._active_bnd_groups():
            u_b, bu_b, bt_b = self._gathered(u_st, tc, group["lids"],
                                             group=group)
            bfn = partial(self._belem_residual, group, alpha_u=tc.alpha_u,
                          alpha_t=tc.alpha_t, time=tc.time, pvec=pvec,
                          deltat=tc.deltat)
            bex = self._field_param_boundary_values(pvec, group)
            bmask_g = None if self.module_masks is None else \
                self.module_masks[np.asarray(group["elems"])]
            res_b = jax.vmap(bfn, in_axes=(0, 0, 0, 0, 0, 0, 0,
                                           None if bex is None else 0,
                                           None if bmask_g is None
                                           else 0))(
                u_b, bu_b, bt_b, group["wts"], group["ip"],
                group["normals"], group["bg"], bex, bmask_g)
            if self.has_signs:
                res_b = _fold_WT(res_b, group["signs"], group["mixp"],
                                 group["mixwT"])
            r = r + _scatter_vec(res_b, group["lids"], self.n_dof)
        return r

    def res_and_jac(self, u_st, tc: TimeCoeffs, pvec=None):
        """(residual, BlockJacobian) — the Newton-loop entry point."""
        return (self.residual(u_st, tc, pvec),
                self.jacobian(u_st, tc, pvec))

    def jacobian(self, u_st, tc: TimeCoeffs, pvec=None) -> BlockJacobian:
        """Element-block Jacobian d(residual)/d(u_stage)."""
        u_e, bu_e, bt_e = self._gathered(u_st, tc, self.lids)
        fn = partial(self._elem_residual, alpha_u=tc.alpha_u,
                     alpha_t=tc.alpha_t, time=tc.time, pvec=pvec,
                     deltat=tc.deltat)
        extra = self._field_param_values(pvec)
        jac_e = jax.vmap(jax.jacfwd(fn, argnums=0),
                         in_axes=(0, 0, 0, self._wts_ax, 0,
                                  self._bg_ax, 0))(
            u_e, bu_e, bt_e, self.g_wts, self.g_ip, self.g_bg, extra)
        if self.has_signs:
            jac_e = _fold_jac_WT_W(jac_e, self.signs, self.mixp,
                                   self.mixwT)
        bnd_blocks, bnd_lids = self._bnd_jac_parts(u_st, tc, pvec)
        if self.multiscale is not None:
            for blk, blids in self.multiscale.jacobian_blocks(u_st, tc,
                                                              pvec):
                bnd_blocks.append(blk)
                bnd_lids.append(blids)
        return BlockJacobian(vol=jac_e, vol_lids=self.lids, bnd=bnd_blocks,
                             bnd_lids=bnd_lids, fixed=self.fixed,
                             inc=self.inc)

    def _bnd_jac_parts(self, u_st, tc: TimeCoeffs, pvec=None):
        """(bnd_blocks, bnd_lids) lists for the active boundary groups —
        additive Jacobian contributions."""
        bnd_blocks, bnd_lids = [], []
        for group in self._active_bnd_groups():
            u_b, bu_b, bt_b = self._gathered(u_st, tc, group["lids"],
                                             group=group)
            bfn = partial(self._belem_residual, group, alpha_u=tc.alpha_u,
                          alpha_t=tc.alpha_t, time=tc.time, pvec=pvec,
                          deltat=tc.deltat)
            bex = self._field_param_boundary_values(pvec, group)
            bmask_g = None if self.module_masks is None else \
                self.module_masks[np.asarray(group["elems"])]
            jac_b = jax.vmap(jax.jacfwd(bfn, argnums=0),
                             in_axes=(0, 0, 0, 0, 0, 0, 0,
                                      None if bex is None else 0,
                                      None if bmask_g is None else 0))(
                u_b, bu_b, bt_b, group["wts"], group["ip"],
                group["normals"], group["bg"], bex, bmask_g)
            if self.has_signs:
                jac_b = _fold_jac_WT_W(jac_b, group["signs"],
                                       group["mixp"], group["mixwT"])
            bnd_blocks.append(jac_b)
            bnd_lids.append(group["lids"])
        return bnd_blocks, bnd_lids

    def _active_bnd_groups(self):
        """Boundary groups with at least one non-strong BC to assemble."""
        out = []
        for g in self._bnd:
            for v in self.disc.var_names:
                bct = self.var_bcs.get(v, {}).get(g["sideset"])
                if bct in ("Neumann", "weak Dirichlet", "Robin", "Far-field",
                           "Slip", "Flux"):
                    out.append(g)
                    break
                if bct == "Dirichlet":
                    # natural Dirichlet: vars without trace CONTINUITY
                    # (HVOL / broken -DG pressures in mixed methods)
                    # get a boundary integral instead of a row fix
                    vdm = self.disc.dofmap.var(v)
                    vsp = getattr(vdm.basis, "space", "")
                    broken = vsp.endswith("-DG") or vsp == "HVOL"
                    if broken or not any(
                            vdm.basis.side_dofs(s)
                            for s in range(self.disc.topo.n_side)):
                        out.append(g)
                        break
        return out

    def matfree_apply_fn(self, J):
        """v -> J v, using the structured slice path when available
        (drop-in faster replacement for BlockJacobian.apply inside
        Krylov loops)."""
        if self._structured is None or self.has_signs:
            return J.apply

        def apply(v):
            vm = jnp.where(J.fixed, 0.0, v)
            ve = self._gather_structured(vm)
            prods = jnp.einsum("eij,ej->ei", J.vol, ve)
            out = self._scatter_structured(prods)
            for blocks, lids in zip(J.bnd, J.bnd_lids):
                out = out + _scatter_vec(
                    jnp.einsum("eij,ej->ei", blocks, vm[lids]),
                    lids, self.n_dof)
            return jnp.where(J.fixed, v, out)
        return apply

    # ------------------------------------------------------------------
    # mass / projections
    # ------------------------------------------------------------------

    def mass_jacobian(self, var=None) -> BlockJacobian:
        """Block mass matrix as a BlockJacobian (no Dirichlet rows)."""
        M = jnp.asarray(self.disc.mass_blocks(var), dtype=self.dtype)
        if var is None:
            if self.has_signs:
                M = _fold_jac_WT_W(M, self.signs, self.mixp, self.mixwT)
            return BlockJacobian(vol=M, vol_lids=self.lids, bnd=[],
                                 bnd_lids=[],
                                 fixed=jnp.zeros(self.n_dof, dtype=bool),
                                 inc=self.inc)
        # single-var mass over the var's OWN dof numbering
        # (0..n_dof_var-1), for per-variable L2 projections
        dm = self.disc.dofmap
        vdm = dm.var(var)
        st, nd = self.disc.offsets[var]
        lids = jnp.asarray(vdm.eldofs)
        if self.has_signs:
            s = self.signs[:, st:st + nd]
            mp = None if self.mixp is None else self.mixp[:, st:st + nd] - st
            mwT = None if self.mixwT is None else self.mixwT[:, st:st + nd]
            M = _fold_jac_WT_W(M, s, mp, mwT)
        return BlockJacobian(vol=M, vol_lids=lids, bnd=[], bnd_lids=[],
                             fixed=jnp.zeros(vdm.n_dof, dtype=bool))

    def weighted_mass_blocks(self, u_st, tc: TimeCoeffs, pvec=None):
        """Physics-weighted mass blocks M = d(residual)/d(u_dot).

        The reference assembles these separately per module
        (getWeightedMass, assemblyManager.cpp); here they are the exact
        jacfwd of the element residual wrt the time-derivative argument,
        so any rho*cp-style weights come along automatically.
        """
        u_e, bu_e, bt_e = self._gathered(u_st, tc, self.lids)
        u_eval = tc.alpha_u * u_e + bu_e
        u_dot = tc.alpha_t * u_e + bt_e

        def fn(udot_e, ueval_e, wts, ip, bg):
            return self._elem_residual_uv(ueval_e, udot_e, wts, ip, bg,
                                          tc.time, pvec, tc.deltat)

        M = jax.vmap(jax.jacfwd(fn, argnums=0),
                     in_axes=(0, 0, self._wts_ax, 0, self._bg_ax))(
            u_dot, u_eval, self.g_wts, self.g_ip, self.g_bg)
        if self.has_signs:
            M = _fold_jac_WT_W(M, self.signs, self.mixp, self.mixwT)
        return M

    def lumped_mass(self, u_st, tc: TimeCoeffs, pvec=None):
        """Row-sum lumped weighted mass vector (n_dof,)."""
        M = self.weighted_mass_blocks(u_st, tc, pvec)
        rows = jnp.sum(M, axis=2)
        flat = jnp.concatenate([rows.ravel(),
                                jnp.zeros(1, dtype=rows.dtype)])
        d = flat[self.inc].sum(axis=1)
        return jnp.where(self.fixed, 1.0, jnp.where(d == 0, 1.0, d))

    def l2_rhs(self, exprs: dict, time=0.0):
        """RHS for global L2 projection: b_i = sum_q f(x_q) phi_i w_q.

        exprs: var -> expression string (missing vars get 0).
        """
        disc = self.disc
        b = jnp.zeros(self.n_dof, dtype=self.dtype)
        ctx = PointContext(self.g_ip, time=time, params=self.params)
        wtsE = jnp.asarray(disc.wts, dtype=self.dtype)     # (E, Q)
        for var in disc.var_names:
            key = disc.basis_keys[var]
            st, nd = disc.offsets[var]
            lids_v = self.lids[:, st:st + nd]
            if key[0] in ("HDIV", "HCURL"):
                # component expressions like 'E[x]'
                comps = {}
                for ax, lbl in enumerate("xyz"[:disc.mesh.dim]):
                    k = f"{var}[{lbl}]"
                    if k in exprs:
                        comps[ax] = exprs[k]
                if not comps:
                    continue
                f = jnp.zeros(wtsE.shape + (disc.mesh.dim,),
                              dtype=self.dtype)
                for ax, expr in comps.items():
                    vals = jnp.broadcast_to(
                        self.fm.evaluate_expr(expr, ctx), wtsE.shape)
                    f = f.at[:, :, ax].set(vals)
                vv = jnp.asarray(disc.vec_vals[key], dtype=self.dtype)
                contrib = jnp.einsum("eiqd,eqd->ei", vv,
                                     f * wtsE[:, :, None])
                sg = self.signs[:, st:st + nd]
                mp = None if self.mixp is None \
                    else self.mixp[:, st:st + nd] - st
                mwT = None if self.mixwT is None \
                    else self.mixwT[:, st:st + nd]
                b = b + _scatter_vec(_fold_WT(contrib, sg, mp, mwT),
                                     lids_v, self.n_dof)
                continue
            if var not in exprs:
                continue
            if key[0] == "HFACE":
                # facet L2 rhs: b_k = sum_sides int f psi_k w_f (pairs
                # with the facet mass in disc.mass_blocks)
                contrib = jnp.zeros((wtsE.shape[0], nd),
                                    dtype=self.dtype)
                for s, fg in enumerate(disc.faces):
                    psi = jnp.asarray(disc.face_basis_vals[s][key],
                                      dtype=self.dtype)   # (nd, Qf)
                    ctxf = PointContext(jnp.asarray(fg.ip,
                                                    dtype=self.dtype),
                                        time=time, params=self.params)
                    vals = jnp.broadcast_to(
                        self.fm.evaluate_expr(exprs[var], ctxf),
                        fg.wts.shape)
                    contrib = contrib + jnp.einsum(
                        "iq,eq->ei", psi,
                        vals * jnp.asarray(fg.wts, dtype=self.dtype))
                b = b + _scatter_vec(contrib, lids_v, self.n_dof)
                continue
            vals = self.fm.evaluate_expr(exprs[var], ctx)  # (E, Q) or scalar
            vals = jnp.broadcast_to(vals, wtsE.shape)
            phi = self.g_bv[disc.basis_keys[var]]          # (nd, Q)
            contrib = jnp.einsum("iq,eq->ei", phi, vals * wtsE)
            b = b + _scatter_vec(contrib, lids_v, self.n_dof)
        return b
