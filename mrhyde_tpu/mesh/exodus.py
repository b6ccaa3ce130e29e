"""Exodus II mesh/solution IO via scipy's NetCDF3 backend.

JAX replacement for the reference's STK/SEACAS Exodus path
(reference: src/interfaces/meshInterface.hpp:129-147 writeToExodus,
Exodus file reading in meshInterface.cpp via 'source: Exodus').
Exodus II "classic" files are NetCDF3, which scipy.io reads/writes
without external dependencies.
"""

from __future__ import annotations

import numpy as np

from mrhyde_tpu.mesh.structured import Mesh

__all__ = ["write_exodus", "read_exodus"]

_ELEM_TYPE = {"line": "BEAM2", "quad": "QUAD4", "tri": "TRI3",
              "hex": "HEX8", "tet": "TETRA4"}
_FROM_EXO = {"QUAD": "quad", "QUAD4": "quad", "TRI": "tri", "TRI3": "tri",
             "HEX": "hex", "HEX8": "hex", "TETRA": "tet", "TETRA4": "tet",
             "TET4": "tet", "BEAM2": "line", "BAR2": "line"}


def write_exodus(path: str, mesh: Mesh, *, node_fields: dict | None = None,
                 cell_fields: dict | None = None, times=None):
    """Write mesh + time-series fields to an Exodus II file.

    node_fields/cell_fields: name -> (n_times, n_nodes/n_elem) arrays.
    """
    from scipy.io import netcdf_file
    node_fields = node_fields or {}
    cell_fields = cell_fields or {}
    times = np.atleast_1d(np.asarray(times if times is not None else [0.0],
                                     dtype=float))
    nt = times.shape[0]
    dim = mesh.dim
    f = netcdf_file(path, "w", version=1)
    f.title = b"mrhyde_tpu"
    f.api_version = 5.22
    f.version = 5.22
    f.floating_point_word_size = 8
    f.file_size = 0

    # scipy's netcdf requires the unlimited dimension to be created first
    f.createDimension("time_step", None)
    f.createDimension("len_string", 33)
    f.createDimension("len_line", 81)
    f.createDimension("four", 4)
    f.createDimension("num_dim", dim)
    f.createDimension("num_nodes", mesh.n_nodes)
    f.createDimension("num_elem", mesh.n_elem)
    f.createDimension("num_el_blk", 1)
    f.createDimension("num_el_in_blk1", mesh.n_elem)
    f.createDimension("num_nod_per_el1", mesh.conn.shape[1])

    tv = f.createVariable("time_whole", "d", ("time_step",))
    tv[:nt] = times

    for i, ax in enumerate("xyz"[:dim]):
        v = f.createVariable(f"coord{ax}", "d", ("num_nodes",))
        v[:] = mesh.nodes[:, i]

    status = f.createVariable("eb_status", "i", ("num_el_blk",))
    status[:] = [1]
    prop = f.createVariable("eb_prop1", "i", ("num_el_blk",))
    prop[:] = [1]
    conn = f.createVariable("connect1", "i",
                            ("num_el_in_blk1", "num_nod_per_el1"))
    conn[:] = mesh.conn + 1       # exodus is 1-based
    conn.elem_type = _ELEM_TYPE[mesh.cell_type].encode()

    def _names(prefix, names, dimname):
        f.createDimension(dimname, max(len(names), 1))
        nv = f.createVariable(prefix, "c", (dimname, "len_string"))
        arr = np.zeros((max(len(names), 1), 33), dtype="S1")
        for i, n in enumerate(names):
            for j, ch in enumerate(n[:32]):
                arr[i, j] = ch.encode()
        nv[:] = arr

    if node_fields:
        _names("name_nod_var", list(node_fields), "num_nod_var")
        for i, (name, data) in enumerate(node_fields.items()):
            v = f.createVariable(f"vals_nod_var{i + 1}", "d",
                                 ("time_step", "num_nodes"))
            v[:nt] = np.asarray(data, dtype=float).reshape(nt, -1)
    if cell_fields:
        _names("name_elem_var", list(cell_fields), "num_elem_var")
        for i, (name, data) in enumerate(cell_fields.items()):
            v = f.createVariable(f"vals_elem_var{i + 1}eb1", "d",
                                 ("time_step", "num_el_in_blk1"))
            v[:nt] = np.asarray(data, dtype=float).reshape(nt, -1)
    f.close()


def read_exodus(path: str) -> tuple[Mesh, dict]:
    """Read an Exodus II (NetCDF3 classic) mesh.

    Returns (Mesh, info) where info carries names/time steps. Multiple
    element blocks are concatenated with block_ids recorded. Sidesets
    are read as (elem, local_side) pairs (0-based, reference local-side
    ordering is the writer's convention).
    """
    from scipy.io import netcdf_file
    f = netcdf_file(path, "r", mmap=False)
    dim = f.dimensions["num_dim"]
    coords = []
    for ax in "xyz"[:dim]:
        key = f"coord{ax}"
        if key in f.variables:
            coords.append(f.variables[key][:])
        else:  # older files use a single 'coord' variable
            coords = [f.variables["coord"][:][i] for i in range(dim)]
            break
    nodes = np.stack([np.asarray(c, dtype=float) for c in coords], axis=1)

    n_blk = f.dimensions.get("num_el_blk", 1)
    conns, block_ids, cell_type = [], [], None
    for b in range(1, n_blk + 1):
        cv = f.variables[f"connect{b}"]
        et = cv.elem_type.decode() if isinstance(cv.elem_type, bytes) \
            else str(cv.elem_type)
        ct = _FROM_EXO.get(et.upper().rstrip("0123456789")
                           + et[len(et.rstrip("0123456789")):], None)
        ct = _FROM_EXO.get(et.upper(), ct)
        if ct is None:
            raise ValueError(f"unsupported exodus elem type {et!r}")
        if cell_type is None:
            cell_type = ct
        elif cell_type != ct:
            raise NotImplementedError("mixed element types")
        c = np.asarray(cv[:], dtype=np.int64) - 1
        conns.append(c)
        block_ids.append(np.full(c.shape[0], b - 1, dtype=np.int32))
    conn = np.concatenate(conns, axis=0).astype(np.int32)
    block_ids = np.concatenate(block_ids)

    def _names(var, n, fallback):
        """Decode an exodus char-array name table."""
        out = []
        raw = f.variables[var][:] if var in f.variables else None
        for i in range(n):
            name = ""
            if raw is not None:
                name = bytes(raw[i]).split(b"\x00")[0].decode(
                    "ascii", "ignore").strip()
            out.append(name or fallback(i))
        return out

    n_ss = f.dimensions.get("num_side_sets", 0) or 0
    ss_names = _names("ss_names", n_ss, lambda i: f"surface_{i + 1}")
    sidesets = {}
    # Exodus local-side ordering -> ours. HEX8 Exodus sides are
    # (0,1,5,4),(1,2,6,5),(2,3,7,6),(0,4,7,3),(0,3,2,1),(4,5,6,7);
    # quad/tri/tet match our topology ordering directly.
    perm = {"hex": np.array([2, 3, 4, 5, 0, 1])}.get(cell_type)
    for s in range(1, n_ss + 1):
        elems = np.asarray(f.variables[f"elem_ss{s}"][:]) - 1
        sides = np.asarray(f.variables[f"side_ss{s}"][:]) - 1
        if perm is not None:
            sides = perm[sides]
        sidesets[ss_names[s - 1]] = np.stack(
            [elems, sides], axis=1).astype(np.int32)

    n_ns = f.dimensions.get("num_node_sets", 0) or 0
    ns_names = _names("ns_names", n_ns, lambda i: f"nodelist_{i + 1}")
    nodesets = {}
    for s in range(1, n_ns + 1):
        nodesets[ns_names[s - 1]] = (
            np.asarray(f.variables[f"node_ns{s}"][:]) - 1).astype(np.int32)

    info = {"n_steps": (f.variables["time_whole"].shape[0]
                        if "time_whole" in f.variables else 0)}
    # element variables (reference: meshInterface::readExodusData,
    # meshInterface.cpp:950 — efield_names/efield_vals used by
    # 'have element data' decks and sensors-from-mesh objectives)
    n_ev = f.dimensions.get("num_elem_var", 0) or 0
    if n_ev:
        ev_names = _names("name_elem_var", n_ev, lambda i: f"evar{i + 1}")
        elem_vars = {}
        for v in range(1, n_ev + 1):
            vals = []
            for b in range(1, n_blk + 1):
                key = f"vals_elem_var{v}eb{b}"
                if key in f.variables:
                    arr = np.asarray(f.variables[key][:], dtype=float)
                    vals.append(arr[-1] if arr.ndim == 2 else arr)
            if vals:
                elem_vars[ev_names[v - 1]] = np.concatenate(vals)
        info["elem_vars"] = elem_vars
    mesh = Mesh(dim=dim, cell_type=cell_type, nodes=nodes, conn=conn,
                sidesets=sidesets, block_ids=block_ids,
                block_names=[f"eblock-{b}" for b in range(n_blk)],
                nodesets=nodesets)
    f.close()
    return mesh, info
