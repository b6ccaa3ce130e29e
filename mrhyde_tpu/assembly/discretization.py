"""Discretization cache: everything static the assembly loop consumes.

Combines mesh + bases + quadrature + geometry + DOF maps into batched
arrays. This plays the role of the reference's DiscretizationInterface +
GroupMetaData + stored Group basis values (reference:
src/interfaces/discretizationInterface.cpp, src/tools/groupMetaData.hpp),
with one crucial difference: instead of workset-size chunks iterated
serially (assemblyManager.cpp:2356 "Cannot parallelize over groups"),
ALL elements live in one batched array so the device sees a single
large contraction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mrhyde_tpu.fem.basis import get_basis
from mrhyde_tpu.fem.vector_basis import get_vector_basis
from mrhyde_tpu.fem.dofmap import DofMap, build_dofmap
from mrhyde_tpu.fem.geometry import (FaceGeometry, face_geometry,
                                     physical_grad, volume_geometry)
from mrhyde_tpu.fem.quadrature import cell_quadrature, side_quadrature
from mrhyde_tpu.fem.topology import cell_topology
from mrhyde_tpu.mesh.structured import Mesh

__all__ = ["Discretization", "BoundaryGroup"]


@dataclass
class BoundaryGroup:
    """All sides of one sideset sharing a local side index.

    The analog of the reference's BoundaryGroup (src/tools/boundaryGroup.hpp)
    — grouping by local side keeps every array in the batch the same shape.
    """
    sideset: str
    side: int
    elems: np.ndarray                  # (B,)
    lids: np.ndarray                   # (B, ndof_total)
    ip: np.ndarray                     # (B, Qf, dim)
    wts: np.ndarray                    # (B, Qf)
    normals: np.ndarray                # (B, Qf, dim)
    basis_vals: dict[tuple, np.ndarray]    # key -> (ndof, Qf)
    basis_grads: dict[tuple, np.ndarray]   # key -> (B, ndof, Qf, dim)


class Discretization:
    """Per-block discretization data.

    variables: list of (name, basis_space, order).
    """

    def __init__(self, mesh: Mesh, variables: list[tuple[str, str, int]],
                 quadrature_degree: int | None = None,
                 side_quadrature_degree: int | None = None):
        self.mesh = mesh
        self.variables = list(variables)
        self.topo = cell_topology(mesh.cell_type)
        max_order = max(v[2] for v in variables)
        if quadrature_degree is None:
            quadrature_degree = 2 * max_order
        self.quadrature_degree = int(quadrature_degree)
        if side_quadrature_degree is None:
            # reference default: 'side quadrature' falls back to
            # 2*max_order, NOT to the volume 'quadrature' key
            # (discretizationInterface.cpp:203) — a p0 trace variable
            # gets a 1-point face rule even when quadrature: 2 is set
            side_quadrature_degree = 2 * max_order
        self.side_quadrature_degree = int(side_quadrature_degree)

        self.dofmap: DofMap = build_dofmap(mesh, variables)
        self.lids = self.dofmap.lids
        self.offsets = self.dofmap.offsets
        self.n_dof = self.dofmap.n_dof
        self.ndof_elem = self.lids.shape[1]
        self.var_names = [v[0] for v in variables]

        # distinct bases in play
        self.basis_keys = {}
        for (name, space, order) in variables:
            self.basis_keys[name] = (space.upper(), order)
        unique_keys = sorted(set(self.basis_keys.values()))

        # volume quadrature + geometry
        ref_pts, ref_wts = cell_quadrature(mesh.cell_type,
                                           self.quadrature_degree)
        self.ref_pts, self.ref_wts = ref_pts, ref_wts
        coords = mesh.nodes[mesh.conn]                # (E, nc, dim)
        self.coords = coords
        vol = volume_geometry(coords, mesh.cell_type, ref_pts, ref_wts)
        self.ip = vol.ip                              # (E, Q, dim)
        self.wts = vol.wts                            # (E, Q)
        self.nqp = ref_pts.shape[0]

        self.basis_vals: dict[tuple, np.ndarray] = {}
        self.basis_grads: dict[tuple, np.ndarray] = {}
        # vector bases (HDIV/HCURL): Piola-transformed physical tables
        self.vec_vals: dict[tuple, np.ndarray] = {}    # (E, nd, Q, dim)
        self.div_vals: dict[tuple, np.ndarray] = {}    # (E, nd, Q)
        self.curl_vals: dict[tuple, np.ndarray] = {}   # (E,nd,Q[,3])
        for key in unique_keys:
            if key[0] == "HFACE":
                continue    # trace space: no volumetric support
            if key[0] in ("HDIV", "HDIV-DG") and mesh.cell_type == "line":
                # 1D HDIV = nodal line basis (reference factory,
                # discretizationInterface.cpp:380-382); values are the
                # scalar flux, "div" is the physical x-derivative
                b = get_basis("line", "HGRAD", max(key[1], 1))
                vals = b.eval(ref_pts)                 # (nd, Q)
                E = mesh.n_elem
                self.vec_vals[key] = np.broadcast_to(
                    vals[None, :, :, None],
                    (E,) + vals.shape + (1,)).copy()
                self.div_vals[key] = physical_grad(
                    b, ref_pts, vol.jac_inv)[..., 0]
                continue
            if key[0] in ("HDIV", "HCURL", "HDIV-DG", "HDIV_AC", "HDIV_AC-DG"):
                vb = get_vector_basis(mesh.cell_type, key[0], key[1])
                ref_v = vb.eval(ref_pts)               # (nd, Q, dim)
                det = vol.jac_det                      # (E, Q)
                if key[0] in ("HDIV", "HDIV-DG", "HDIV_AC", "HDIV_AC-DG"):
                    # contravariant Piola: v = J v_ref / det J
                    self.vec_vals[key] = np.einsum(
                        "eqdr,iqr->eiqd", vol.jac, ref_v) / det[:, None, :,
                                                                None]
                    self.div_vals[key] = (vb.div(ref_pts)[None, :, :]
                                          / det[:, None, :])
                else:
                    # covariant: v = J^{-T} v_ref
                    self.vec_vals[key] = np.einsum(
                        "eqrd,iqr->eiqd", vol.jac_inv, ref_v)
                    c = vb.curl(ref_pts)
                    if self.topo.dim == 2:
                        self.curl_vals[key] = (c[None, :, :]
                                               / det[:, None, :])
                    else:
                        self.curl_vals[key] = np.einsum(
                            "eqdr,iqr->eiqd", vol.jac, c[:, :, :]
                        ) / det[:, None, :, None]
                continue
            b = get_basis(mesh.cell_type, key[0], key[1])
            self.basis_vals[key] = b.eval(ref_pts)            # (nd, Q)
            self.basis_grads[key] = physical_grad(b, ref_pts, vol.jac_inv)

        # face quadrature per local side (for face norms / face terms)
        s_pts, s_wts = side_quadrature(mesh.cell_type,
                                       self.side_quadrature_degree)
        self.side_pts, self.side_wts = s_pts, s_wts
        self.faces: list[FaceGeometry] = []
        self.face_basis_vals: list[dict] = []
        self.face_basis_grads: list[dict] = []
        for s in range(self.topo.n_side):
            fg = face_geometry(coords, mesh.cell_type, s, s_pts, s_wts)
            self.faces.append(fg)
            bv, bg = {}, {}
            for key in unique_keys:
                gvol = volume_geometry(coords, mesh.cell_type, fg.ref_pts,
                                       np.ones(fg.ref_pts.shape[0]))
                if key[0] == "HFACE":
                    # full-element trace table: zero except this side's
                    # psi rows (used by face norms / face projections)
                    if self.topo.dim == 2:
                        from mrhyde_tpu.fem.vector_basis import \
                            hface_side_vals
                        npe = key[1] + 1
                        t = hface_side_vals(key[1], s_pts[:, 0])
                        full = np.zeros((self.topo.n_side * npe,
                                         t.shape[1]))
                        full[s * npe:(s + 1) * npe] = t
                        bv[key] = full
                    elif key[1] == 0:
                        # 3D facet constants: this side's dof = 1
                        full = np.zeros((self.topo.n_side,
                                         fg.ref_pts.shape[0]))
                        full[s] = 1.0
                        bv[key] = full
                    else:
                        # 3D order >= 1: lattice trace rows on this side
                        from mrhyde_tpu.fem.vector_basis import (
                            hface_face_vals, hface_npf)
                        npf = hface_npf(mesh.cell_type, key[1])
                        t = hface_face_vals(mesh.cell_type, key[1],
                                            s_pts)
                        full = np.zeros((self.topo.n_side * npf,
                                         t.shape[1]))
                        full[s * npf:(s + 1) * npf] = t
                        bv[key] = full
                    continue
                if (key[0] in ("HDIV", "HDIV-DG")
                        and mesh.cell_type == "line"):
                    b = get_basis("line", "HGRAD", max(key[1], 1))
                    vals = b.eval(fg.ref_pts)          # (nd, Qf)
                    bv[key] = np.broadcast_to(
                        vals[None, :, :, None],
                        (self.mesh.n_elem,) + vals.shape + (1,)).copy()
                    continue
                if key[0] in ("HDIV", "HCURL", "HDIV-DG", "HDIV_AC", "HDIV_AC-DG"):
                    vb = get_vector_basis(mesh.cell_type, key[0], key[1])
                    ref_v = vb.eval(fg.ref_pts)
                    if key[0] in ("HDIV", "HDIV-DG", "HDIV_AC", "HDIV_AC-DG"):
                        bv[key] = np.einsum(
                            "eqdr,iqr->eiqd", gvol.jac, ref_v)                             / gvol.jac_det[:, None, :, None]
                    else:
                        bv[key] = np.einsum(
                            "eqrd,iqr->eiqd", gvol.jac_inv, ref_v)
                    continue
                b = get_basis(mesh.cell_type, key[0], key[1])
                bv[key] = b.eval(fg.ref_pts)
                bg[key] = physical_grad(b, fg.ref_pts, gvol.jac_inv)
            self.face_basis_vals.append(bv)
            self.face_basis_grads.append(bg)

        # stacked per-side face bundles (hybridized/DG methods iterate
        # all element sides inside the volume kernel)
        self.face_wts_all = np.stack([fg.wts for fg in self.faces],
                                     axis=1)        # (E, n_sides, Qf)
        self.face_normals_all = np.stack(
            [fg.normals for fg in self.faces], axis=1)
        self.face_vec_all = {}
        for key in unique_keys:
            if key[0] in ("HDIV", "HDIV-DG", "HCURL", "HDIV_AC", "HDIV_AC-DG"):
                self.face_vec_all[key] = np.stack(
                    [self.face_basis_vals[s][key]
                     for s in range(self.topo.n_side)], axis=1)
                # (E, n_sides, nd, Qf, dim)
        # scalar basis values at every side's quadrature points —
        # element-INDEPENDENT (reference-element evaluation), used by
        # DG/HDG face terms to read broken state traces inside the
        # volume kernel (reference: the 'assemble face terms' side
        # worksets, assemblyManager.cpp:2414-2425)
        self.face_scal_all = {}
        for key in unique_keys:
            if key[0] in ("HDIV", "HDIV-DG", "HCURL", "HDIV_AC",
                          "HDIV_AC-DG", "HFACE"):
                continue
            self.face_scal_all[key] = np.stack(
                [self.face_basis_vals[s][key]
                 for s in range(self.topo.n_side)], axis=0)
            # (n_sides, nd, Qf)

        # boundary groups per sideset, split by local side
        self.boundary_groups: list[BoundaryGroup] = []
        for name, ss in mesh.sidesets.items():
            if ss.shape[0] == 0:
                continue
            for s in np.unique(ss[:, 1]):
                elems = ss[ss[:, 1] == s, 0]
                s = int(s)
                fg = self.faces[s]
                self.boundary_groups.append(BoundaryGroup(
                    sideset=name, side=s, elems=elems,
                    lids=self.lids[elems],
                    ip=fg.ip[elems], wts=fg.wts[elems],
                    normals=fg.normals[elems],
                    basis_vals=self.face_basis_vals[s],
                    basis_grads={k: v[elems] for k, v in
                                 self.face_basis_grads[s].items()},
                ))

    # ---- helpers ----

    def var_basis(self, var: str):
        return self.basis_keys[var]

    def mass_blocks(self, var: str | None = None,
                    weight: np.ndarray | None = None) -> np.ndarray:
        """Per-element mass blocks.

        With var=None: (E, ndof_total, ndof_total) block-diagonal over all
        variables. weight: optional (E, Q) density at quadrature points.
        """
        w = self.wts if weight is None else self.wts * weight

        def var_mass(key):
            if key[0] == "HFACE":
                # trace dofs: facet L2 mass (order 0: facet measure, so
                # projections of facet data behave like averages)
                vb = get_vector_basis(self.mesh.cell_type, "HFACE",
                                      key[1])
                n = vb.ndof
                if self.mesh.dim == 2:
                    npe = key[1] + 1
                else:
                    from mrhyde_tpu.fem.vector_basis import hface_npf
                    npe = hface_npf(self.mesh.cell_type, key[1])
                M = np.zeros((self.mesh.n_elem, n, n))
                if npe == 1:
                    for s in range(n):
                        M[:, s, s] = self.face_wts_all[:, s, :].sum(
                            axis=1)
                    return M
                if self.mesh.dim == 2:
                    from mrhyde_tpu.fem.vector_basis import \
                        hface_side_vals
                    tbl = hface_side_vals(key[1], self.side_pts[:, 0])
                else:
                    from mrhyde_tpu.fem.vector_basis import \
                        hface_face_vals
                    tbl = hface_face_vals(self.mesh.cell_type, key[1],
                                          self.side_pts)
                for s in range(n // npe):
                    blk = np.einsum("kq,lq,eq->ekl", tbl, tbl,
                                    self.face_wts_all[:, s, :])
                    M[:, s * npe:(s + 1) * npe,
                      s * npe:(s + 1) * npe] = blk
                return M
            if key[0] in ("HDIV", "HCURL", "HDIV-DG", "HDIV_AC", "HDIV_AC-DG"):
                vv = self.vec_vals[key]
                return np.einsum("eiqd,ejqd,eq->eij", vv, vv, w)
            phi = self.basis_vals[key]
            return np.einsum("iq,jq,eq->eij", phi, phi, w)

        if var is not None:
            return var_mass(self.basis_keys[var])
        E = self.mesh.n_elem
        M = np.zeros((E, self.ndof_elem, self.ndof_elem))
        for vname in self.var_names:
            st, nd = self.offsets[vname]
            M[:, st:st + nd, st:st + nd] = var_mass(self.basis_keys[vname])
        return M
