"""Structured box meshes (line/quad/tri/hex/tet).

JAX replacement for the reference's inline Panzer-STK mesh
factories and SimpleMeshManager (reference:
src/interfaces/meshInterface.cpp:15-140, src/tools/simplemeshmanager.hpp).
All connectivity is built with numpy at setup time; the compute path only
ever sees the resulting index arrays.

Sideset naming follows the reference's inline-mesh convention:
left/right = x min/max, bottom/top = y min/max, front/back = z min/max.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Mesh", "box_mesh", "apply_periodic"]


@dataclass
class Mesh:
    dim: int
    cell_type: str                     # line | quad | tri | hex | tet
    nodes: np.ndarray                  # (n_nodes, dim) float64
    conn: np.ndarray                   # (n_elem, n_corner) int32
    sidesets: dict[str, np.ndarray] = field(default_factory=dict)
    # each sideset value: (n_sides, 2) int32 of (elem, local_side)
    block_ids: np.ndarray | None = None  # (n_elem,) element-block index
    block_names: list[str] = field(default_factory=lambda: ["eblock-0_0"])
    nodesets: dict[str, np.ndarray] = field(default_factory=dict)
    # each nodeset value: (n,) int32 node ids (Exodus point-BC sets)

    @property
    def n_elem(self) -> int:
        return self.conn.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    def all_boundary_sides(self) -> np.ndarray:
        if not self.sidesets:
            return np.zeros((0, 2), dtype=np.int32)
        return np.concatenate(list(self.sidesets.values()), axis=0)


def box_mesh(cell_type: str, *, nx: int = 1, ny: int = 1, nz: int = 1,
             xmin: float = 0.0, xmax: float = 1.0,
             ymin: float = 0.0, ymax: float = 1.0,
             zmin: float = 0.0, zmax: float = 1.0) -> Mesh:
    """Uniform box mesh with boundary sidesets."""
    if cell_type == "line":
        mesh = _line_mesh(nx, xmin, xmax)
        mesh.box_info = {"bounds": [(xmin, xmax, nx)]}
    elif cell_type in ("quad", "tri"):
        mesh = _quad_or_tri_mesh(cell_type, nx, ny, xmin, xmax, ymin, ymax)
        mesh.box_info = {"bounds": [(xmin, xmax, nx), (ymin, ymax, ny)]}
    elif cell_type in ("hex", "tet"):
        mesh = _hex_or_tet_mesh(cell_type, nx, ny, nz, xmin, xmax,
                                ymin, ymax, zmin, zmax)
        mesh.box_info = {"bounds": [(xmin, xmax, nx), (ymin, ymax, ny),
                                    (zmin, zmax, nz)]}
    else:
        raise ValueError(f"unknown cell type {cell_type!r}")
    return mesh


def _line_mesh(nx, xmin, xmax):
    nodes = np.linspace(xmin, xmax, nx + 1)[:, None]
    conn = np.stack([np.arange(nx), np.arange(1, nx + 1)], axis=1)
    sidesets = {
        "left": np.array([[0, 0]], dtype=np.int32),
        "right": np.array([[nx - 1, 1]], dtype=np.int32),
    }
    return Mesh(1, "line", nodes, conn.astype(np.int32), sidesets)


def _quad_or_tri_mesh(cell_type, nx, ny, xmin, xmax, ymin, ymax):
    xs = np.linspace(xmin, xmax, nx + 1)
    ys = np.linspace(ymin, ymax, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    # corners CCW to match the quad reference cell
    n0, n1 = nid(I, J), nid(I + 1, J)
    n2, n3 = nid(I + 1, J + 1), nid(I, J + 1)
    quad_conn = np.stack([n0, n1, n2, n3], axis=1).astype(np.int32)

    if cell_type == "quad":
        conn = quad_conn
        # local sides of the quad ref cell: 0=(0,1) bottom, 1=(1,2) right,
        # 2=(2,3) top, 3=(3,0) left
        eid = np.arange(nx * ny).reshape(nx, ny)
        sidesets = {
            "bottom": _ss(eid[:, 0], 0),
            "right": _ss(eid[-1, :], 1),
            "top": _ss(eid[:, -1], 2),
            "left": _ss(eid[0, :], 3),
        }
        return Mesh(2, "quad", nodes, conn, sidesets)

    # tri: split each quad along the (n0, n2) diagonal:
    # T0 = (n0, n1, n2), T1 = (n0, n2, n3)
    t0 = np.stack([n0, n1, n2], axis=1)
    t1 = np.stack([n0, n2, n3], axis=1)
    conn = np.empty((2 * nx * ny, 3), dtype=np.int32)
    conn[0::2] = t0
    conn[1::2] = t1
    # tri local sides: 0=(0,1), 1=(1,2), 2=(2,0)
    qid = np.arange(nx * ny).reshape(nx, ny)
    sidesets = {
        "bottom": _ss(2 * qid[:, 0], 0),        # T0 side (n0,n1)
        "right": _ss(2 * qid[-1, :], 1),        # T0 side (n1,n2)
        "top": _ss(2 * qid[:, -1] + 1, 1),      # T1 side (n2,n3)
        "left": _ss(2 * qid[0, :] + 1, 2),      # T1 side (n3,n0)
    }
    return Mesh(2, "tri", nodes, conn, sidesets)


def _hex_or_tet_mesh(cell_type, nx, ny, nz, xmin, xmax, ymin, ymax,
                     zmin, zmax):
    xs = np.linspace(xmin, xmax, nx + 1)
    ys = np.linspace(ymin, ymax, ny + 1)
    zs = np.linspace(zmin, zmax, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    c = [nid(I, J, K), nid(I + 1, J, K), nid(I + 1, J + 1, K),
         nid(I, J + 1, K), nid(I, J, K + 1), nid(I + 1, J, K + 1),
         nid(I + 1, J + 1, K + 1), nid(I, J + 1, K + 1)]
    hex_conn = np.stack(c, axis=1).astype(np.int32)

    if cell_type == "hex":
        # hex ref sides: 0=z- 1=z+ 2=y- 3=x+ 4=y+ 5=x-
        eid = np.arange(nx * ny * nz).reshape(nx, ny, nz)
        sidesets = {
            "back": _ss(eid[:, :, 0].ravel(), 0),
            "front": _ss(eid[:, :, -1].ravel(), 1),
            "bottom": _ss(eid[:, 0, :].ravel(), 2),
            "right": _ss(eid[-1, :, :].ravel(), 3),
            "top": _ss(eid[:, -1, :].ravel(), 4),
            "left": _ss(eid[0, :, :].ravel(), 5),
        }
        return Mesh(3, "hex", nodes, hex_conn, sidesets)

    # tet: 12 tets per hex — one centroid node per hex, each of the six
    # faces split into two triangles along the diagonal through the
    # face's SMALLEST global node id (conforming across cells), each
    # triangle + centroid = one tet. This reproduces the Panzer-STK
    # CubeTetMeshFactory meshes the reference regression golds were
    # generated on (porous/Mixed_3D_tet p/u errors match digit-for-
    # digit with this split; Kuhn and 5-tet splits do not).
    h = hex_conn
    E = h.shape[0]
    cents = nodes[h].mean(axis=1)
    cid = nodes.shape[0] + np.arange(E)
    nodes = np.vstack([nodes, cents])
    # outward-ordered hex faces in our conn convention
    hfaces = [[0, 3, 2, 1], [4, 5, 6, 7], [0, 1, 5, 4],
              [1, 2, 6, 5], [2, 3, 7, 6], [3, 0, 4, 7]]
    tets = []
    for f in hfaces:
        q = h[:, f]                                   # (E, 4)
        pick02 = (np.minimum(q[:, 0], q[:, 2])
                  < np.minimum(q[:, 1], q[:, 3]))
        t1 = np.where(pick02[:, None],
                      np.stack([q[:, 0], q[:, 1], q[:, 2], cid], axis=1),
                      np.stack([q[:, 1], q[:, 2], q[:, 3], cid], axis=1))
        t2 = np.where(pick02[:, None],
                      np.stack([q[:, 0], q[:, 2], q[:, 3], cid], axis=1),
                      np.stack([q[:, 1], q[:, 3], q[:, 0], cid], axis=1))
        tets.extend([t1, t2])
    conn = np.stack(tets, axis=1).reshape(-1, 4).astype(np.int32)
    # boundary sidesets for tets: find boundary faces by node coordinates
    mesh = Mesh(3, "tet", nodes, conn, {})
    mesh.sidesets = _coordinate_sidesets(
        mesh, {"left": (0, xmin), "right": (0, xmax),
               "bottom": (1, ymin), "top": (1, ymax),
               "back": (2, zmin), "front": (2, zmax)})
    return mesh


def _ss(elems, side):
    elems = np.asarray(elems).ravel()
    out = np.empty((elems.size, 2), dtype=np.int32)
    out[:, 0] = elems
    out[:, 1] = side
    return out


def apply_periodic(mesh: Mesh, conditions: list[str]) -> Mesh:
    """Identify dofs across periodic sideset pairs.

    Condition syntax follows the reference (discretizationInterface.cpp
    periodic BC parsing): '<axes>-all <tol>: <side1>;<side2>', e.g.
    'y-all 1e-8: left;right' matches left/right nodes by y coordinate.
    Geometry is untouched (slave nodes keep their coordinates); only the
    DOF numbering identifies the paired nodes, via mesh.dof_node_map.
    """
    from mrhyde_tpu.fem.topology import cell_topology
    topo = cell_topology(mesh.cell_type)
    remap = np.arange(mesh.n_nodes, dtype=np.int64)
    for cond in conditions:
        head, sides = cond.split(":")
        parts = head.split()
        axes = parts[0].split("-")[0]
        tol = float(parts[1]) if len(parts) > 1 else 1e-8
        ax_ids = [{"x": 0, "y": 1, "z": 2}[a] for a in axes]
        ss1, ss2 = [s.strip() for s in sides.split(";")]

        def side_nodes(ssname):
            ss = mesh.sidesets[ssname]
            out = set()
            for e, s in ss:
                for ln in topo.sides[s]:
                    out.add(int(mesh.conn[e, ln]))
            return np.array(sorted(out))

        n1 = side_nodes(ss1)
        n2 = side_nodes(ss2)
        key1 = mesh.nodes[n1][:, ax_ids]
        key2 = mesh.nodes[n2][:, ax_ids]
        d2 = ((key2[:, None, :] - key1[None, :, :]) ** 2).sum(axis=2)
        j = np.argmin(d2, axis=1)
        ok = d2[np.arange(len(n2)), j] < tol * tol
        remap[n2[ok]] = n1[j[ok]]
        # raw slave -> master node map for edge/face dof identification
        # (endpoint pairs alone alias distinct edges on 2-cell-wide
        # periodic directions)
        pm = getattr(mesh, "periodic_maps", [])
        pm.append(dict(zip(n2[ok].tolist(), n1[j[ok]].tolist())))
        mesh.periodic_maps = pm
    # resolve chains, then compact to contiguous dof-node ids
    while not np.array_equal(remap, remap[remap]):
        remap = remap[remap]
    keep = np.unique(remap)
    compact = np.full(mesh.n_nodes, -1, dtype=np.int64)
    compact[keep] = np.arange(keep.size)
    mesh.node_dof_map = compact[remap]
    mesh.n_dof_nodes = keep.size
    mesh.periodic = True
    return mesh


def _coordinate_sidesets(mesh: Mesh, planes: dict[str, tuple[int, float]],
                         tol: float = 1e-12) -> dict[str, np.ndarray]:
    """Find boundary (elem, side) pairs lying on axis-aligned planes."""
    from mrhyde_tpu.fem.topology import cell_topology
    topo = cell_topology(mesh.cell_type)
    out = {name: [] for name in planes}
    for s, side_nodes in enumerate(topo.sides):
        side_coords = mesh.nodes[mesh.conn[:, list(side_nodes)]]
        for name, (axis, val) in planes.items():
            on = np.all(np.abs(side_coords[:, :, axis] - val) < tol, axis=1)
            elems = np.nonzero(on)[0]
            if elems.size:
                out[name].append(_ss(elems, s))
    return {name: (np.concatenate(v) if v else np.zeros((0, 2), np.int32))
            for name, v in out.items()}
