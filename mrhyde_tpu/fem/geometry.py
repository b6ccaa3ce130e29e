"""Element geometry: Jacobians, measures, physical gradients, face data.

JAX replacement for the reference's Intrepid2 CellTools geometry
path (reference: src/interfaces/discretizationInterface.cpp:781-836
element Jacobians/measures; :882-1148 physical volumetric basis;
:1432/:1795 face & boundary basis). All arrays are batched over elements
so downstream contractions are batched matmuls.

Everything here runs in numpy at setup time. For uniform structured
meshes the per-element arrays are highly redundant; the basis-database
compression of the reference (assemblyManager.cpp:4249) is reproduced by
`mrhyde_tpu.assembly.database`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mrhyde_tpu.fem.basis import Basis, get_basis
from mrhyde_tpu.fem.topology import cell_topology

__all__ = ["VolumeGeometry", "FaceGeometry", "volume_geometry",
           "face_geometry", "physical_grad", "map_to_physical"]


@dataclass
class VolumeGeometry:
    ip: np.ndarray        # (n_elem, nqp, dim) physical quadrature points
    wts: np.ndarray       # (n_elem, nqp) physical quadrature weights
    jac: np.ndarray       # (n_elem, nqp, dim, dim) dx/dxi
    jac_inv: np.ndarray   # (n_elem, nqp, dim, dim)
    jac_det: np.ndarray   # (n_elem, nqp)


@dataclass
class FaceGeometry:
    """Geometry of one local side across an element batch."""
    ip: np.ndarray        # (n_elem, nqp_f, dim)
    wts: np.ndarray       # (n_elem, nqp_f)
    normals: np.ndarray   # (n_elem, nqp_f, dim) outward unit normals
    ref_pts: np.ndarray   # (nqp_f, dim) side qps in cell reference coords


def _cell_map_tables(cell_type: str, ref_pts: np.ndarray):
    geo = get_basis(cell_type, "HGRAD", 1)
    return geo.eval(ref_pts), geo.grad(ref_pts)   # (nc, nq), (nc, nq, dim)


def map_to_physical(coords: np.ndarray, cell_type: str,
                    ref_pts: np.ndarray) -> np.ndarray:
    """coords: (n_elem, n_corner, dim) -> (n_elem, nq, dim)."""
    gvals, _ = _cell_map_tables(cell_type, ref_pts)
    return np.einsum("ecd,cq->eqd", coords, gvals)


def volume_geometry(coords: np.ndarray, cell_type: str,
                    ref_pts: np.ndarray, ref_wts: np.ndarray
                    ) -> VolumeGeometry:
    gvals, ggrad = _cell_map_tables(cell_type, ref_pts)
    ip = np.einsum("ecd,cq->eqd", coords, gvals)
    jac = np.einsum("ecd,cqr->eqdr", coords, ggrad)
    det = np.linalg.det(jac)
    inv = np.linalg.inv(jac)
    wts = np.abs(det) * ref_wts[None, :]
    return VolumeGeometry(ip=ip, wts=wts, jac=jac, jac_inv=inv, jac_det=det)


def physical_grad(basis: Basis, ref_pts: np.ndarray,
                  jac_inv: np.ndarray) -> np.ndarray:
    """Physical gradients (n_elem, ndof, nqp, dim).

    grad_phys = J^{-T} grad_ref.
    """
    dphi = basis.grad(ref_pts)   # (ndof, nqp, dim_ref)
    return np.einsum("eqrd,iqr->eiqd", jac_inv, dphi)


def side_ref_points(cell_type: str, side: int,
                    side_pts: np.ndarray) -> np.ndarray:
    """Map side-cell quadrature points into cell reference coordinates."""
    topo = cell_topology(cell_type)
    side_nodes = list(topo.sides[side])
    side_corner_coords = topo.corners[side_nodes]    # (n_sc, dim)
    if topo.side_cell == "point":                    # 1D: side is a vertex
        return side_corner_coords.reshape(1, -1)
    sgeo = get_basis(topo.side_cell, "HGRAD", 1)
    svals = sgeo.eval(side_pts)                      # (n_sc, nq)
    return np.einsum("cd,cq->qd", side_corner_coords, svals)


def face_geometry(coords: np.ndarray, cell_type: str, side: int,
                  side_pts: np.ndarray, side_wts: np.ndarray) -> FaceGeometry:
    """Face quadrature geometry for local side `side` of every element."""
    topo = cell_topology(cell_type)
    ref_pts = side_ref_points(cell_type, side, side_pts)
    gvals, ggrad = _cell_map_tables(cell_type, ref_pts)
    ip = np.einsum("ecd,cq->eqd", coords, gvals)
    jac = np.einsum("ecd,cqr->eqdr", coords, ggrad)  # (e, q, dim, dim)

    if topo.dim == 1:
        # a side is a single vertex: unit weight, normal = +-1 outward
        E = coords.shape[0]
        wts = np.ones((E, 1))
        cell_cent = coords.mean(axis=1)
        sign = np.sign(ip[:, 0, 0] - cell_cent[:, 0])
        normals = np.where(sign == 0, 1.0, sign)[:, None, None]
        return FaceGeometry(ip=ip, wts=wts, normals=normals,
                            ref_pts=ref_pts)

    # tangents of the side embedding in reference space
    sgeo = get_basis(topo.side_cell, "HGRAD", 1)
    side_nodes = list(topo.sides[side])
    sc = topo.corners[side_nodes]                    # (n_sc, dim)
    sgrad = sgeo.grad(side_pts)                      # (n_sc, nq, sdim)
    ref_tan = np.einsum("cd,cqs->qds", sc, sgrad)    # (nq, dim, sdim)
    tan = np.einsum("eqdr,qrs->eqds", jac, ref_tan)  # physical tangents

    dim = topo.dim
    if dim == 1:
        wts = side_wts[None, :] * np.ones((coords.shape[0], 1))
        normals = np.ones((coords.shape[0], side_pts.shape[0], 1))
    elif dim == 2:
        t = tan[..., 0]                              # (e, q, 2)
        mag = np.linalg.norm(t, axis=-1)
        wts = mag * side_wts[None, :]
        normals = np.stack([t[..., 1], -t[..., 0]], axis=-1) / mag[..., None]
    else:
        t1, t2 = tan[..., 0], tan[..., 1]
        cr = np.cross(t1, t2)
        mag = np.linalg.norm(cr, axis=-1)
        wts = mag * side_wts[None, :]
        normals = cr / mag[..., None]

    # orient normals outward: compare with (face centroid - cell centroid)
    cell_cent = coords.mean(axis=1)                  # (e, dim)
    outward = ip.mean(axis=1) - cell_cent            # (e, dim)
    sign = np.sign(np.einsum("eqd,ed->eq", normals, outward).mean(axis=1))
    sign = np.where(sign == 0, 1.0, sign)
    normals = normals * sign[:, None, None]
    return FaceGeometry(ip=ip, wts=wts, normals=normals, ref_pts=ref_pts)
