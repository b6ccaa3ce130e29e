"""DOF management: global numbering, element LIDs, offsets, boundary dofs.

The JAX replacement for the Panzer DOFManager the reference builds
per physics set (reference: src/interfaces/discretizationInterface.cpp:2324
buildDOFManagers; LID/offset layout described in SURVEY.md Appendix B).
Everything is a static numpy index array produced at setup; assembly
consumes them via gather (u_local = u_global[lids]) and
scatter (segment_sum over lids), replacing the reference's
gather/atomic-scatter (src/managers/assemblyManager.cpp:3441, 3943).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mrhyde_tpu.fem.basis import Basis, get_basis
from mrhyde_tpu.fem.topology import cell_topology
from mrhyde_tpu.mesh.structured import Mesh

__all__ = ["VarDofMap", "DofMap", "build_dofmap"]


@dataclass
class VarDofMap:
    name: str
    basis: object              # Basis or VectorBasis
    n_dof: int                 # number of global dofs for this variable
    eldofs: np.ndarray         # (n_elem, ndof_per_elem) within-var global ids
    dof_coords: np.ndarray     # (n_dof, dim) physical coords (nodal bases)
    signs: np.ndarray | None = None   # (n_elem, ndof_per_elem) +-1 for
    #                                   HDIV/HCURL orientation
    # 2x2 orientation MIXING (tet HCURL order >= 2 face dofs, whose
    # frame change is not a signed permutation): local coefficient
    # u_loc[j] = signs[j] * g[j] + mix_w[j] * g[mix_pair[j]], where g
    # is the gathered global coefficient vector. mix_pair is a LOCAL
    # slot index (self where no mixing, with mix_w = 0); pairing is
    # symmetric (pair[pair[j]] == j).
    mix_pair: np.ndarray | None = None   # (n_elem, ndof_per_elem) int
    mix_w: np.ndarray | None = None      # (n_elem, ndof_per_elem)


@dataclass
class DofMap:
    mesh: Mesh
    vars: list[VarDofMap]
    var_start: np.ndarray      # (n_var,) offset of each var's dof block
    n_dof: int                 # total global dofs
    lids: np.ndarray           # (n_elem, ndof_total) global dof ids
    offsets: dict[str, tuple[int, int]]  # var -> (start, ndof) in element vec
    signs: np.ndarray = None   # (n_elem, ndof_total) orientation signs
    mix_pair: np.ndarray = None   # (n_elem, ndof_total) local partner
    mix_w: np.ndarray = None      # (n_elem, ndof_total) partner weight

    @property
    def has_mix(self):
        return self.mix_pair is not None

    def fold(self, g, st=0, nd=None):
        """Gather-side orientation fold of element coefficient arrays
        g (..., n_elem, nd_slice): u_loc = signs * g + mix_w * g[pair].
        st/nd select a within-element dof slice (one variable); pairs
        never cross variables. Works on numpy or jax arrays (the dof
        axis is last, the element axis second-to-last)."""
        sl = slice(st, (st + nd) if nd is not None else None)
        s = self.signs[:, sl]
        if self.mix_pair is None:
            return g * s
        pr = self.mix_pair[:, sl] - st
        w = self.mix_w[:, sl]
        if isinstance(g, np.ndarray):
            gp = np.take_along_axis(
                g, np.broadcast_to(pr, g.shape), axis=-1)
        else:
            import jax.numpy as jnp
            gp = jnp.take_along_axis(
                g, jnp.broadcast_to(pr, g.shape), axis=-1)
        return g * s + w * gp

    def var(self, name: str) -> VarDofMap:
        for v in self.vars:
            if v.name == name:
                return v
        raise KeyError(name)

    def var_index(self, name: str) -> int:
        for i, v in enumerate(self.vars):
            if v.name == name:
                return i
        raise KeyError(name)

    def global_dofs(self, var: str, within_var_ids: np.ndarray) -> np.ndarray:
        return self.var_start[self.var_index(var)] + within_var_ids

    def sideset_dofs(self, var: str, sideset: np.ndarray) -> np.ndarray:
        """Unique global dof ids of `var` on a sideset ((n,2) elem/side)."""
        v = self.var(var)
        if sideset.shape[0] == 0:
            return np.zeros(0, dtype=np.int64)
        ids = []
        for side in np.unique(sideset[:, 1]):
            elems = sideset[sideset[:, 1] == side, 0]
            cols = v.basis.side_dofs(int(side))
            if cols:
                ids.append(v.eldofs[elems][:, cols].ravel())
        if not ids:
            return np.zeros(0, dtype=np.int64)
        return self.global_dofs(var, np.unique(np.concatenate(ids)))

    def all_dofs(self, var: str) -> np.ndarray:
        i = self.var_index(var)
        return self.var_start[i] + np.arange(self.vars[i].n_dof)


def _dof_conn(mesh: Mesh) -> np.ndarray:
    """Connectivity in DOF-node numbering (periodic meshes identify
    paired nodes while keeping their geometry)."""
    nmap = getattr(mesh, "node_dof_map", None)
    return mesh.conn if nmap is None else nmap[mesh.conn]


def _n_dof_nodes(mesh: Mesh) -> int:
    return getattr(mesh, "n_dof_nodes", mesh.n_nodes)


def _edge_numbering(mesh: Mesh):
    """Global edge ids. Returns (n_edges, elem_edges (n_elem, n_loc_edges),
    edge_flipped (n_elem, n_loc_edges) bool, edge_nodes (n_edges, 2)).

    On periodic meshes, edges are built from RAW node ids and then
    identified through the explicit periodic node maps (an edge whose
    endpoints both lie on a slave face maps to the master-face edge).
    Keying by dof-node endpoint pairs alone would alias DISTINCT edges
    when a periodic direction is only two cells wide."""
    topo = cell_topology(mesh.cell_type)
    le = np.array(topo.edges)                        # (n_loc_edges, 2)
    pmaps = getattr(mesh, "periodic_maps", None)
    if not pmaps:
        from mrhyde_tpu.native import unique_rows
        pairs = _dof_conn(mesh)[:, le]               # (n_elem, n_le, 2)
        flipped = pairs[:, :, 0] > pairs[:, :, 1]
        sorted_pairs = np.sort(pairs, axis=2)
        flat = sorted_pairs.reshape(-1, 2)
        uniq, inv = unique_rows(flat)       # C++ sort path (native.py)
        elem_edges = inv.reshape(pairs.shape[0], pairs.shape[1])
        return uniq.shape[0], elem_edges, flipped, uniq

    raw = mesh.conn[:, le]                           # (n_elem, n_le, 2)
    rs = np.sort(raw, axis=2).reshape(-1, 2)
    uniq, inv = np.unique(rs, axis=0, return_inverse=True)
    n_raw = uniq.shape[0]
    # orientation-carrying union-find: off[i] = does edge i's
    # canonical (low, high) direction appear REVERSED relative to its
    # parent's canonical direction
    parent = list(range(n_raw))
    off = np.zeros(n_raw, dtype=bool)

    def find(i):
        if parent[i] == i:
            return i, False
        r, o = find(parent[i])
        parent[i] = r
        off[i] = off[i] ^ o
        return r, off[i]

    key = {(int(a), int(b)): i for i, (a, b) in enumerate(uniq)}
    for m in pmaps:
        for i, (a, b) in enumerate(uniq):
            a, b = int(a), int(b)
            if a in m and b in m:
                ma, mb = m[a], m[b]
                j = key.get((min(ma, mb), max(ma, mb)))
                if j is None:
                    continue
                ri, oi = find(i)
                rj, oj = find(j)
                if ri != rj:
                    # direction a->b (= low->high of i) maps to ma->mb
                    rel = (ma > mb)          # reversed vs j's canonical
                    parent[rj] = ri
                    off[rj] = oj ^ rel ^ oi
    roots = np.empty(n_raw, dtype=np.int64)
    orient = np.zeros(n_raw, dtype=bool)
    for i in range(n_raw):
        roots[i], orient[i] = find(i)
    keep, compact = np.unique(roots, return_inverse=True)
    elem_edges = compact[inv].reshape(raw.shape[0], raw.shape[1])
    local_rev = raw[:, :, 0] > raw[:, :, 1]
    flipped = local_rev ^ orient[inv].reshape(local_rev.shape)
    edge_nodes = uniq[keep]
    return keep.shape[0], elem_edges, flipped, edge_nodes


def _face_numbering(mesh: Mesh):
    """Global face ids for 3D cells. Returns (n_faces, elem_faces
    (n_elem, n_loc_faces), face_flip (n_elem, n_loc_faces) bool) where
    face_flip marks element-face instances whose raw sorted-node normal
    is REVERSED relative to the global face's canonical normal.

    On periodic meshes, faces are keyed by RAW node ids and identified
    through the explicit periodic node maps with an orientation-carrying
    union-find — the same scheme _edge_numbering uses. Keying by
    dof-node tuples would alias geometrically DISTINCT faces whenever a
    periodic direction is only two cells wide (the 2-cell face analog of
    the edge-aliasing bug)."""
    topo = cell_topology(mesh.cell_type)
    lf = [list(f) for f in topo.faces]
    n_fn = max(len(f) for f in lf)
    pmaps = getattr(mesh, "periodic_maps", None)
    conn = mesh.conn if pmaps else _dof_conn(mesh)
    keys = []
    for f in lf:
        fk = np.sort(conn[:, f], axis=1)
        if fk.shape[1] < n_fn:
            fk = np.pad(fk, ((0, 0), (0, n_fn - fk.shape[1])),
                        constant_values=-1)
        keys.append(fk)
    flat = np.stack(keys, axis=1).reshape(-1, n_fn)   # (n_elem*n_lf, n_fn)
    from mrhyde_tpu.native import unique_rows
    if n_fn == 3:                    # tet tri-faces: pad for the
        flat4 = np.pad(flat, ((0, 0), (0, 1)),       # 4-wide C++ path
                       constant_values=-1)
        uniq, inv = unique_rows(flat4)
        uniq = uniq[:, :3]
    else:
        uniq, inv = unique_rows(flat)
    n_raw = uniq.shape[0]
    if not pmaps:
        elem_faces = inv.reshape(mesh.n_elem, len(lf))
        flip = np.zeros_like(elem_faces, dtype=bool)
        return n_raw, elem_faces, flip

    def canon_normal(nodes, pts=None):
        """Normal of the first three (sorted-order) face nodes."""
        p = mesh.nodes[nodes] if pts is None else pts
        return np.cross(p[1] - p[0], p[2] - p[0])

    norms = np.stack([canon_normal(u[u >= 0]) for u in uniq])
    parent = list(range(n_raw))
    off = np.zeros(n_raw, dtype=bool)   # normal reversed vs parent's

    def find(i):
        if parent[i] == i:
            return i, False
        r, o = find(parent[i])
        parent[i] = r
        off[i] = off[i] ^ o
        return r, off[i]

    key = {tuple(int(x) for x in u): i for i, u in enumerate(uniq)}
    for m in pmaps:
        for i, u in enumerate(uniq):
            nn = [int(x) for x in u if x >= 0]
            if not all(a in m for a in nn):
                continue
            mapped = [m[a] for a in nn]
            tk = sorted(mapped) + [-1] * (n_fn - len(mapped))
            j = key.get(tuple(tk))
            if j is None:
                continue
            # normal at the master positions taken in i's sorted order,
            # compared with j's own canonical normal
            ni = canon_normal(None, pts=mesh.nodes[np.array(mapped[:3])])
            rel = bool(np.dot(ni, norms[j]) < 0)
            ri, oi = find(i)
            rj, oj = find(j)
            if ri != rj:
                parent[rj] = ri
                off[rj] = oj ^ rel ^ oi
    roots = np.empty(n_raw, dtype=np.int64)
    orient = np.zeros(n_raw, dtype=bool)
    for i in range(n_raw):
        roots[i], orient[i] = find(i)
    keep, compact = np.unique(roots, return_inverse=True)
    elem_faces = compact[inv].reshape(mesh.n_elem, len(lf))
    flip = orient[inv].reshape(mesh.n_elem, len(lf))
    return keep.shape[0], elem_faces, flip


def _build_vector_var(mesh: Mesh, name: str, basis) -> VarDofMap:
    """HDIV/HCURL: one dof per edge/face with orientation signs."""
    topo = cell_topology(mesh.cell_type)
    n_elem = mesh.n_elem
    ents = basis.dof_entity
    need_edges = any(k == "edge" for k, _ in ents)
    need_faces = any(k == "face" for k, _ in ents)
    n_faces = 0
    elem_edges = edge_flip = None
    n_edges = n_faces = 0
    if need_edges:
        n_edges, elem_edges, edge_flip, _ = _edge_numbering(mesh)
    if need_faces:
        n_faces, elem_faces, face_flip = _face_numbering(mesh)

    n_cell_dofs = sum(1 for k, _ in ents if k == "cell")
    only_cell = n_cell_dofs == basis.ndof
    eldofs = np.zeros((n_elem, basis.ndof), dtype=np.int64)
    signs = np.ones((n_elem, basis.ndof))
    mix_pair = None
    mix_w = None
    coords = mesh.nodes[mesh.conn]                 # (E, nc, dim)
    dof_coords = None
    scalar_trace = getattr(basis, "space", "") == "HFACE"
    # dofs per edge (arbitrary-order bases carry several, listed
    # CONSECUTIVELY in traversal order; a flipped element uses the
    # reversed within-edge index — symmetric node sets make this exact)
    npe = max((sum(1 for k, i in ents if k == "edge" and i == e)
               for e in range(len(topo.edges))), default=1) or 1
    npf = max((sum(1 for k, i in ents if k == "face" and i == f)
               for f in range(len(topo.sides))), default=1) or 1
    edge_sub = {}
    face_sub = {}
    # continuous entity dofs: edges first, faces next, interior after
    edge_count = n_edges * npe if need_edges else 0
    face_base = edge_count
    cell_base = edge_count + (n_faces * npf if need_faces else 0)
    cell_seen = 0
    face_tables = {}
    if need_faces and npf > 1:
        if getattr(mesh, "periodic_maps", None):
            raise NotImplementedError(
                "periodic meshes with order >= 2 HDIV/HCURL face dofs")
        space = getattr(basis, "space", "HDIV").replace("-DG", "")
        dconn = _dof_conn(mesh)
        from mrhyde_tpu.fem.vector_basis import (face_perm_sign,
                                                 hex_face_axis_orientation)
        for fidx in range(len(topo.sides)):
            f = list(topo.sides[fidx])
            cyc = dconn[:, f]                          # (E, 3|4)
            perm_e = np.zeros((n_elem, npf), dtype=np.int64)
            sgn_e = np.ones((n_elem, npf))
            if mesh.cell_type == "tet" and space == "HCURL":
                # 2x2 tangential-frame mixing per face lattice slot
                # (vector_basis.tet_hcurl_face_mix): instance s = 2m+a
                # holds canonical component a at canonical slot
                # permlat[m], gathering with weights M[a, a] (self) and
                # M[a, 1-a] (its local partner 2m+(1-a))
                from mrhyde_tpu.fem.vector_basis import \
                    tet_hcurl_face_mix
                mixw_e = np.zeros((n_elem, npf))
                sig = np.argsort(cyc, axis=1, kind="stable")
                keys = sig[:, 0] * 9 + sig[:, 1] * 3 + sig[:, 2]
                for kv in np.unique(keys):
                    rows = keys == kv
                    desc = tuple(int(x) for x in sig[np.argmax(rows)])
                    permlat, M = tet_hcurl_face_mix(basis.order, desc)
                    for s in range(npf):
                        m, a = s // 2, s % 2
                        perm_e[rows, s] = 2 * permlat[m] + a
                        sgn_e[rows, s] = M[a, a]
                        mixw_e[rows, s] = M[a, 1 - a]
                face_tables[fidx] = (perm_e, sgn_e, mixw_e)
                continue
            if mesh.cell_type == "tet":
                sig = np.argsort(cyc, axis=1, kind="stable")
                keys = sig[:, 0] * 9 + sig[:, 1] * 3 + sig[:, 2]
                for kv in np.unique(keys):
                    rows = keys == kv
                    desc = tuple(int(x) for x in
                                 sig[np.argmax(rows)])
                    p, s = face_perm_sign("tet", space, basis.order,
                                          desc)
                    perm_e[rows] = p
                    sgn_e[rows] = s
            else:
                k0 = np.argmin(cyc, axis=1)
                nxt = cyc[np.arange(n_elem), (k0 + 1) % 4]
                prv = cyc[np.arange(n_elem), (k0 - 1) % 4]
                d = np.where(nxt < prv, 1, -1)
                keys = k0 * 2 + (d > 0)
                ax_or = (hex_face_axis_orientation(fidx)
                         if space == "HDIV" else 1.0)
                for kv in np.unique(keys):
                    rows = keys == kv
                    r0 = int(np.argmax(rows))
                    p, s = face_perm_sign("hex", space, basis.order,
                                          (fidx, int(k0[r0]),
                                           int(d[r0])))
                    perm_e[rows] = p
                    sgn_e[rows] = s * ax_or
            face_tables[fidx] = (perm_e, sgn_e)
    for j, (kind, idx) in enumerate(ents):
        if kind == "cell":
            if only_cell:
                # broken/DG dofs: element-local, never shared
                eldofs[:, j] = np.arange(n_elem) * n_cell_dofs + idx
            else:
                eldofs[:, j] = (cell_base
                                + np.arange(n_elem) * n_cell_dofs
                                + cell_seen)
                cell_seen += 1
            continue
        if kind == "edge":
            s = edge_sub.get(idx, 0)
            edge_sub[idx] = s + 1
            sub = np.where(edge_flip[:, idx], npe - 1 - s, s)
            eldofs[:, j] = elem_edges[:, idx] * npe + sub
            # global convention: lower global node id -> higher;
            # local direction disagrees where edge_flip is set
            if not scalar_trace:
                signs[:, j] = np.where(edge_flip[:, idx], -1.0, 1.0)
        elif npf > 1:   # order >= 2 face dofs: lattice perm + sign
            s = face_sub.get(idx, 0)
            face_sub[idx] = s + 1
            tab = face_tables[idx]
            perm_e, sgn_e = tab[0], tab[1]
            eldofs[:, j] = (face_base + elem_faces[:, idx] * npf
                            + perm_e[:, s])
            if not scalar_trace:
                signs[:, j] = sgn_e[:, s]
            if len(tab) == 3:      # tet HCURL 2x2 mixing channel
                if mix_pair is None:
                    mix_pair = np.tile(np.arange(basis.ndof),
                                       (n_elem, 1))
                    mix_w = np.zeros((n_elem, basis.ndof))
                # pairs are consecutive in the ents walk: instance
                # s = 2m is followed by its partner 2m+1
                mix_pair[:, j] = j + 1 if s % 2 == 0 else j - 1
                mix_w[:, j] = tab[2][:, s]
        else:  # single-dof face (lowest-order 3D HDIV)
            eldofs[:, j] = face_base + elem_faces[:, idx]
            # sign = local outward normal . global sorted-node normal
            f = list(topo.sides[idx])
            pf = coords[:, f, :]                   # (E, nf, dim)
            n_loc = np.cross(pf[:, 1] - pf[:, 0], pf[:, 2] - pf[:, 0])
            gf = np.sort(mesh.conn[:, f], axis=1)  # (E, nf) sorted ids
            pg = mesh.nodes[gf]                    # (E, nf, dim)
            n_glob = np.cross(pg[:, 1] - pg[:, 0], pg[:, 2] - pg[:, 0])
            if not scalar_trace:
                # face_flip: this instance's raw canonical normal is
                # reversed vs the (periodic-root) global face's normal
                signs[:, j] = (np.sign(np.einsum("ed,ed->e", n_loc, n_glob))
                               * np.where(face_flip[:, idx], -1.0, 1.0))
    if only_cell and n_cell_dofs:
        n_dof = n_elem * n_cell_dofs
    else:
        n_dof = cell_base + n_elem * n_cell_dofs
    # dof coords = facet/element centroids (for Dirichlet data etc.)
    dof_coords = np.zeros((n_dof, topo.dim))
    for j, (kind, idx) in enumerate(ents):
        if kind == "cell":
            mid = coords.mean(axis=1)
        elif kind == "edge":
            mid = coords[:, list(topo.edges[idx]), :].mean(axis=1)
        else:
            mid = coords[:, list(topo.sides[idx]), :].mean(axis=1)
        dof_coords[eldofs[:, j]] = mid
    return VarDofMap(name, basis, n_dof, eldofs, dof_coords, signs=signs,
                     mix_pair=mix_pair, mix_w=mix_w)


def _build_hface1d_var(mesh: Mesh, name: str, basis) -> VarDofMap:
    """1D HFACE: one trace dof per mesh VERTEX (facets of line cells),
    shared between the two adjacent elements. eldofs[:, s] is the
    global node id of local side s."""
    if getattr(mesh, "periodic_maps", None):
        raise NotImplementedError("periodic 1D meshes with HFACE traces")
    n_dof = mesh.nodes.shape[0]
    eldofs = mesh.conn[:, :2].astype(np.int64).copy()
    return VarDofMap(name, basis, n_dof, eldofs,
                     mesh.nodes.astype(float).copy())


def _build_hface_var(mesh: Mesh, name: str, basis) -> VarDofMap:
    """HFACE order >= 1 (2D): (order+1) dofs per mesh edge, numbered
    low-corner -> high-corner in global node order; elements whose
    local edge direction disagrees use the reversed index (the nodal
    line basis is symmetric, so this yields a continuous-per-facet
    global trace function)."""
    topo = cell_topology(mesh.cell_type)
    n_elem = mesh.n_elem
    npe = basis.order + 1
    n_edges, elem_edges, edge_flip, _ = _edge_numbering(mesh)
    n_loc = len(topo.edges)
    eldofs = np.zeros((n_elem, n_loc * npe), dtype=np.int64)
    coords = mesh.nodes[mesh.conn]                   # (E, nc, dim)
    n_dof = n_edges * npe
    dof_coords = np.zeros((n_dof, topo.dim))
    # equally-spaced node parameters along the edge
    xi = np.linspace(-1.0, 1.0, npe)
    for idx in range(n_loc):
        a, b = topo.edges[idx]
        pa, pb = coords[:, a, :], coords[:, b, :]
        for k in range(npe):
            j = idx * npe + k
            kk = np.where(edge_flip[:, idx], npe - 1 - k, k)
            eldofs[:, j] = elem_edges[:, idx] * npe + kk
            lam = 0.5 * (1.0 + xi[k])
            dof_coords[eldofs[:, j]] = (1 - lam) * pa + lam * pb
    return VarDofMap(name, basis, n_dof, eldofs, dof_coords)


def _hface3d_permutation(cell_type: str, order: int, cyc: np.ndarray):
    """Local facet-lattice index -> canonical (global) lattice index
    for a face whose corner GLOBAL ids are `cyc` (in the local
    topo.sides order). The canonical frame starts at the smallest
    global id; the nodal lattice is invariant under the face symmetry
    group, so this is a pure permutation (the 3D generalization of the
    2D edge reversal; reference analog: Intrepid2 OrientationTools)."""
    n = order
    if cell_type == "hex":
        npf = (n + 1) ** 2
        L = np.array([(0, 0), (n, 0), (n, n), (0, n)])
        k0 = int(np.argmin(cyc))
        d = 1 if cyc[(k0 + 1) % 4] < cyc[(k0 - 1) % 4] else -1
        o = L[k0]
        e1 = (L[(k0 + d) % 4] - o) // max(n, 1)
        e2 = (L[(k0 - d) % 4] - o) // max(n, 1)
        perm = np.zeros(npf, dtype=np.int64)
        for a in range(n + 1):
            for b in range(n + 1):
                p = np.array([a, b]) - o
                a2 = int(p @ e1)
                b2 = int(p @ e2)
                perm[a * (n + 1) + b] = a2 * (n + 1) + b2
        return perm
    # tet face (tri): barycentric weight reordering by sorted ids
    npf = (n + 1) * (n + 2) // 2
    flat = {}
    k = 0
    for i in range(n + 1):
        for j in range(n + 1 - i):
            flat[(i, j)] = k
            k += 1
    sigma = np.argsort(cyc, kind="stable")       # canonical corner order
    perm = np.zeros(npf, dtype=np.int64)
    for (i, j), k in flat.items():
        m = (n - i - j, i, j)                    # weights on local v0..v2
        mc = [m[sigma[0]], m[sigma[1]], m[sigma[2]]]
        perm[k] = flat[(mc[1], mc[2])]
    return perm


def _build_hface3d_var(mesh: Mesh, name: str, basis) -> VarDofMap:
    """HFACE order >= 1 on hex/tet: npf lattice dofs per mesh face,
    numbered in each face's canonical frame (smallest-global-id
    corner origin); every element maps its local lattice index through
    _hface3d_permutation."""
    from mrhyde_tpu.fem.vector_basis import _facet_lattice, hface_npf
    topo = cell_topology(mesh.cell_type)
    n_elem = mesh.n_elem
    order = basis.order
    npf = hface_npf(mesh.cell_type, order)
    n_faces, elem_faces, _flip = _face_numbering(mesh)
    n_loc = len(topo.sides)
    eldofs = np.zeros((n_elem, n_loc * npf), dtype=np.int64)
    side_cell = "quad" if mesh.cell_type == "hex" else "tri"
    lat = _facet_lattice(side_cell, order)       # (npf, 2) facet params
    sgeo = get_basis(side_cell, "HGRAD", 1)
    lat_sv = sgeo.eval(lat)                      # (n_sc, npf)
    coords = mesh.nodes[mesh.conn]
    n_dof = n_faces * npf
    dof_coords = np.zeros((n_dof, topo.dim))
    conn = mesh.conn
    for s in range(n_loc):
        f = list(topo.sides[s])
        cycs = conn[:, f]                        # (E, n_sc) global ids
        # physical lattice points of this face
        pts = np.einsum("ecd,cq->eqd", coords[:, f, :], lat_sv)
        for e in range(n_elem):
            perm = _hface3d_permutation(mesh.cell_type, order, cycs[e])
            gds = elem_faces[e, s] * npf + perm
            eldofs[e, s * npf:(s + 1) * npf] = gds
            dof_coords[gds] = pts[e]
    return VarDofMap(name, basis, n_dof, eldofs, dof_coords)


def _build_dg_scalar_var(mesh: Mesh, name: str, basis) -> VarDofMap:
    """Broken scalar space (HGRAD-DG): every dof is element-local."""
    n_elem = mesh.n_elem
    nd = basis.ndof
    eldofs = (np.arange(n_elem, dtype=np.int64)[:, None] * nd
              + np.arange(nd, dtype=np.int64)[None, :])
    geo = get_basis(mesh.cell_type, "HGRAD", 1)
    gvals = geo.eval(basis.dof_coords)               # (n_corner, nd)
    coords_el = np.einsum("ecd,cj->ejd", mesh.nodes[mesh.conn], gvals)
    dof_coords = coords_el.reshape(-1, mesh.dim)
    return VarDofMap(name, basis, n_elem * nd, eldofs, dof_coords)


def _build_var(mesh: Mesh, name: str, basis: Basis) -> VarDofMap:
    topo = cell_topology(mesh.cell_type)
    ents = basis.dof_entities()
    n_elem = mesh.n_elem

    if basis.space == "HVOL":
        eldofs = np.arange(n_elem, dtype=np.int64)[:, None]
        # dof coord = element centroid
        cent = mesh.nodes[mesh.conn].mean(axis=1)
        return VarDofMap(name, basis, n_elem, eldofs, cent)

    per_edge = basis.order - 1
    need_edges = any(k == "edge" for k, _, _ in ents)
    need_faces = any(k == "face" for k, _, _ in ents)
    elem_edges = edge_flip = None
    n_edges = 0
    if need_edges:
        n_edges, elem_edges, edge_flip, _ = _edge_numbering(mesh)
    if need_faces:
        n_faces, elem_faces, _face_flip = _face_numbering(mesh)
        per_face = sum(1 for k, i, _ in ents if k == "face" and i == 0)
    else:
        n_faces, per_face = 0, 0
    per_cell = sum(1 for k, _, _ in ents if k == "cell")

    node_base = 0
    edge_base = _n_dof_nodes(mesh)
    face_base = edge_base + n_edges * per_edge
    cell_base = face_base + n_faces * per_face
    n_dof = cell_base + n_elem * per_cell

    dconn = _dof_conn(mesh)
    eldofs = np.zeros((n_elem, basis.ndof), dtype=np.int64)
    for j, (kind, idx, k) in enumerate(ents):
        if kind == "node":
            eldofs[:, j] = dconn[:, idx]
        elif kind == "edge":
            # orientation: interior edge dofs are numbered low-corner ->
            # high-corner in global node order; flip k where the element's
            # local direction disagrees (matters for order >= 3)
            kk = np.where(edge_flip[:, idx], per_edge - 1 - k, k)
            eldofs[:, j] = edge_base + elem_edges[:, idx] * per_edge + kk
        elif kind == "face":
            if per_face > 1:
                raise NotImplementedError(
                    "face-interior dof orientation for order >= 3 in 3D")
            eldofs[:, j] = face_base + elem_faces[:, idx] * per_face + k
        else:  # cell
            eldofs[:, j] = cell_base + np.arange(n_elem) * per_cell + k

    # dof physical coordinates via the linear geometric map
    geo = get_basis(mesh.cell_type, "HGRAD", 1)
    gvals = geo.eval(basis.dof_coords)               # (n_corner, ndof)
    coords_el = np.einsum("ecd,cj->ejd", mesh.nodes[mesh.conn], gvals)
    dof_coords = np.zeros((n_dof, topo.dim))
    dof_coords[eldofs.ravel()] = coords_el.reshape(-1, topo.dim)
    return VarDofMap(name, basis, n_dof, eldofs, dof_coords)


def build_dofmap(mesh: Mesh, variables: list[tuple[str, str, int]]) -> DofMap:
    """variables: list of (name, basis space, order)."""
    from mrhyde_tpu.fem.vector_basis import get_vector_basis
    vars_ = []
    for (name, space, order) in variables:
        if space.upper() == "HFACE":
            # order 0 = facet constants; order n = per-facet degree n
            vbasis = get_vector_basis(mesh.cell_type, space,
                                      max(order, 0))
            topo3d = cell_topology(mesh.cell_type).dim == 3
            if cell_topology(mesh.cell_type).dim == 1:
                vars_.append(_build_hface1d_var(mesh, name, vbasis))
            elif vbasis.order >= 1 and topo3d:
                vars_.append(_build_hface3d_var(mesh, name, vbasis))
            elif vbasis.order >= 1:
                vars_.append(_build_hface_var(mesh, name, vbasis))
            else:
                vars_.append(_build_vector_var(mesh, name, vbasis))
        elif (space.upper() in ("HDIV", "HDIV-DG")
              and mesh.cell_type == "line"):
            # 1D HDIV is the nodal line basis in the reference factory
            # (discretizationInterface.cpp:380-382 uses
            # Basis_HGRAD_LINE_Cn for dimension-1 HDIV)
            basis = get_basis("line", "HGRAD", max(order, 1))
            vars_.append(_build_var(mesh, name, basis))
        elif space.upper() in ("HDIV", "HCURL", "HDIV-DG",
                               "HDIV_AC", "HDIV_AC-DG"):
            vbasis = get_vector_basis(mesh.cell_type, space, max(order, 1))
            vars_.append(_build_vector_var(mesh, name, vbasis))
        elif space.upper() == "HGRAD-DG":
            basis = get_basis(mesh.cell_type, space, max(order, 1))
            vars_.append(_build_dg_scalar_var(mesh, name, basis))
        else:
            basis = get_basis(mesh.cell_type, space, order)
            vars_.append(_build_var(mesh, name, basis))
    var_start = np.zeros(len(vars_), dtype=np.int64)
    tot = 0
    offsets = {}
    estart = 0
    for i, v in enumerate(vars_):
        var_start[i] = tot
        tot += v.n_dof
        offsets[v.name] = (estart, v.basis.ndof)
        estart += v.basis.ndof
    lids = np.concatenate(
        [var_start[i] + v.eldofs for i, v in enumerate(vars_)], axis=1)
    signs = np.concatenate(
        [v.signs if v.signs is not None
         else np.ones_like(v.eldofs, dtype=float) for v in vars_], axis=1)
    mix_pair = mix_w = None
    if any(v.mix_pair is not None for v in vars_):
        pairs, ws = [], []
        for v in vars_:
            st = offsets[v.name][0]
            if v.mix_pair is not None:
                pairs.append(v.mix_pair + st)
                ws.append(v.mix_w)
            else:
                pairs.append(np.tile(
                    np.arange(st, st + v.basis.ndof),
                    (v.eldofs.shape[0], 1)))
                ws.append(np.zeros_like(v.eldofs, dtype=float))
        mix_pair = np.concatenate(pairs, axis=1)
        mix_w = np.concatenate(ws, axis=1)
    return DofMap(mesh=mesh, vars=vars_, var_start=var_start, n_dof=tot,
                  lids=lids.astype(np.int64), offsets=offsets, signs=signs,
                  mix_pair=mix_pair, mix_w=mix_w)
