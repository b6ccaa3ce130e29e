"""Fine-mesh templates and per-macro-element subgrid geometry.

The JAX analog of the reference's subgridTools fine-mesh
generation (reference: src/subgrid/subgridTools.cpp — buildSubGridMesh
maps a template mesh into every macro element via the macro geometric
map). Here the template lives in the MACRO REFERENCE cell:

- `refinements: n` on quad/hex -> a 2^n uniform box refinement of
  [-1,1]^d (the existing uniform path's template)
- tri/tet macro cells -> the reference simplex (refinements 0; red
  refinement of simplices not yet needed by any regression deck)
- `mesh type: Exodus` -> an arbitrary template mesh read from an
  Exodus file, expressed in the macro reference cell (e.g. the
  cube_tet.e tet mesh of [-1,1]^3 in
  regression/thermal/3D_verification_multiscale_exodusmesh)

Every template's boundary faces are classified geometrically by which
MACRO face plane contains them, giving the sidesets the DtN interface
coupling integrates over and the macro side index each group's trace
basis is evaluated on.

For non-uniform macro meshes the physical fine tables are batched per
macro element: the template is instantiated in every macro element at
once as ONE disjoint stacked mesh, run through the standard
Discretization (all geometry code reused, vectorized numpy), and the
tables reshaped to a leading macro axis that the subgrid solver vmaps
over.
"""

from __future__ import annotations

import os

import numpy as np

from mrhyde_tpu.fem.basis import get_basis
from mrhyde_tpu.fem.topology import cell_topology
from mrhyde_tpu.mesh.structured import Mesh, box_mesh

__all__ = ["fine_template", "classify_macro_sides", "build_batched_geo"]


def classify_macro_sides(mesh: Mesh, macro_cell: str):
    """Label each boundary face of a template mesh (in macro REFERENCE
    coords) with the macro local side it lies on.

    Returns (sidesets, side_map): sidesets {name: (B, 2) (elem, side)}
    suitable for Mesh.sidesets, and side_map {name: macro_side_index}.
    """
    topo = cell_topology(mesh.cell_type)
    mtopo = cell_topology(macro_cell)
    dim = topo.dim

    # boundary faces: (elem, local side) pairs whose node set is unique
    keys = {}
    for s, side_nodes in enumerate(topo.sides):
        fn = mesh.conn[:, list(side_nodes)]            # (E, k)
        for e in range(mesh.conn.shape[0]):
            key = tuple(sorted(fn[e]))
            keys.setdefault(key, []).append((e, s))
    bnd = [v[0] for v in keys.values() if len(v) == 1]

    # macro face planes from the macro reference corners
    planes = []
    for side_nodes in mtopo.sides:
        C = mtopo.corners[list(side_nodes)]
        c0 = C[0]
        A = C[1:] - c0                                 # (k-1, dim)
        if A.shape[0] == 0:                            # 1D: side = point
            n = np.ones(1)
        else:
            # normal = null space of A
            _u, _s, vt = np.linalg.svd(A)
            n = vt[-1]
        planes.append((c0, n))

    sidesets = {}
    side_map = {}
    for (e, s) in bnd:
        pts = mesh.nodes[mesh.conn[e, list(topo.sides[s])]]
        hit = None
        for ms, (c0, n) in enumerate(planes):
            if np.max(np.abs((pts - c0) @ n)) < 1e-8:
                hit = ms
                break
        if hit is None:
            raise ValueError(
                "subgrid template boundary face not on any macro face "
                f"(elem {e} side {s})")
        name = f"mside{hit}"
        sidesets.setdefault(name, []).append((e, s))
        side_map[name] = hit
    sidesets = {k: np.asarray(v, dtype=np.int32)
                for k, v in sidesets.items()}
    return sidesets, side_map


def fine_template(mesh_cfg: dict, macro_cell: str, dim: int,
                  deck_dir: str = "."):
    """Template fine mesh in macro reference coordinates.

    Returns (Mesh, side_map {sideset_name: macro side index}).
    """
    refine = int(mesh_cfg.get("refinements", 1))
    n1 = 2 ** refine
    if str(mesh_cfg.get("mesh type", "")).lower() == "exodus":
        from mrhyde_tpu.mesh.exodus import read_exodus
        path = mesh_cfg.get("mesh file", "mesh.exo")
        if not os.path.isabs(path):
            path = os.path.join(deck_dir, path)
        tmpl, _info = read_exodus(path)
        ss, side_map = classify_macro_sides(tmpl, macro_cell)
        tmpl.sidesets = ss
        return tmpl, side_map
    if macro_cell == "line":
        tmpl = box_mesh("line", nx=n1, xmin=-1.0, xmax=1.0)
        ss, side_map = classify_macro_sides(tmpl, "line")
        tmpl.sidesets = ss
        return tmpl, side_map
    if macro_cell in ("quad", "hex"):
        cell = mesh_cfg.get("element type", macro_cell)
        if cell == macro_cell:
            if macro_cell == "hex":
                tmpl = box_mesh("hex", nx=n1, ny=n1, nz=n1,
                                xmin=-1.0, xmax=1.0, ymin=-1.0,
                                ymax=1.0, zmin=-1.0, zmax=1.0)
            else:
                tmpl = box_mesh("quad", nx=n1, ny=n1, xmin=-1.0,
                                xmax=1.0, ymin=-1.0, ymax=1.0)
            ss, side_map = classify_macro_sides(tmpl, macro_cell)
            tmpl.sidesets = ss
            return tmpl, side_map
        raise NotImplementedError(
            f"subgrid template cell {cell!r} inside {macro_cell!r} "
            "(use 'mesh type: Exodus' for mixed-topology templates)")
    if macro_cell in ("tri", "tet"):
        if refine != 0:
            raise NotImplementedError(
                "simplex subgrid refinement (no regression deck "
                "exercises it; refinements: 0 embeds the macro cell)")
        topo = cell_topology(macro_cell)
        tmpl = Mesh(dim=dim, cell_type=macro_cell,
                    nodes=np.array(topo.corners, dtype=np.float64),
                    conn=np.arange(len(topo.corners),
                                   dtype=np.int32)[None, :],
                    sidesets={})
        ss, side_map = classify_macro_sides(tmpl, macro_cell)
        tmpl.sidesets = ss
        return tmpl, side_map
    raise NotImplementedError(f"subgrid on {macro_cell!r} macro cells")


def build_batched_geo(sub_coords: np.ndarray, tmpl: Mesh,
                      macro_cell: str, variables, qdeg):
    """Per-macro-element physical fine geometry tables.

    sub_coords: (E, n_macro_corners, dim) macro element nodes. The
    template is mapped into every macro element (macro HGRAD p1
    geometric map), instantiated as one disjoint stacked mesh, and all
    Discretization tables are reshaped to a leading macro axis.

    Returns a pytree of numpy arrays:
      wts (E, Ef, Q), ip (E, Ef, Q, dim),
      bg {grad/vec/div/curl: {key: (E, Ef, ...)}},
      bnd [per boundary group: {wts, ip, normals, bg}],
      mass (E, Ef, ndt, ndt).
    """
    from mrhyde_tpu.assembly.discretization import Discretization

    gb = get_basis(macro_cell, "HGRAD", 1)
    gvals = gb.eval(tmpl.nodes)                        # (nv, nfn)
    phys = np.einsum("ecd,cn->end", sub_coords, gvals)  # (E, nfn, dim)
    E, nfn, dim = phys.shape
    Ef, nc = tmpl.conn.shape
    conn_s = (tmpl.conn[None, :, :]
              + (np.arange(E) * nfn)[:, None, None]).reshape(E * Ef, nc)
    ss_s = {}
    for name, ss in tmpl.sidesets.items():
        reps = (ss[None, :, :]
                + np.array([Ef, 0])[None, None, :]
                * np.arange(E)[:, None, None]).reshape(-1, 2)
        ss_s[name] = reps.astype(np.int32)
    mesh_s = Mesh(dim=dim, cell_type=tmpl.cell_type,
                  nodes=phys.reshape(-1, dim),
                  conn=conn_s.astype(np.int32), sidesets=ss_s)
    disc_s = Discretization(mesh_s, variables,
                            None if qdeg is None else int(qdeg))

    def r(a):
        return np.ascontiguousarray(a.reshape((E, Ef) + a.shape[1:]))

    geo = {
        "wts": r(disc_s.wts),
        "ip": r(disc_s.ip),
        "bg": {"grad": {k: r(v) for k, v in disc_s.basis_grads.items()},
               "vec": {k: r(v) for k, v in disc_s.vec_vals.items()},
               "div": {k: r(v) for k, v in disc_s.div_vals.items()},
               "curl": {k: r(v) for k, v in disc_s.curl_vals.items()}},
        "bnd": [],
        "mass": r(disc_s.mass_blocks()),
    }
    for bg in disc_s.boundary_groups:
        B = bg.elems.shape[0] // E

        def rb(a):
            return np.ascontiguousarray(
                a.reshape((E, B) + a.shape[1:]))

        gb_ = {"grad": {k: rb(v) for k, v in bg.basis_grads.items()},
               "vec": {}, "div": {}, "curl": {}}
        for k, v in bg.basis_vals.items():
            if k[0] in ("HDIV", "HCURL", "HDIV-DG",
                        "HDIV_AC", "HDIV_AC-DG"):
                gb_["vec"][k] = rb(v[bg.elems])
        geo["bnd"].append({"wts": rb(bg.wts), "ip": rb(bg.ip),
                           "normals": rb(bg.normals), "bg": gb_})
    return geo
