"""Geometric multigrid preconditioner for structured p1 meshes.

The JAX analog of the reference's MueLu AMG preconditioner
(reference: src/interfaces/linearAlgebraInterface.cpp:358-430 builds
MueLu with SA defaults / Chebyshev smoothing). On structured quad/hex
meshes with p1 HGRAD variables there is no need for algebraic
aggregation — the grid hierarchy is geometric (halve each axis), the
transfer operators are (bi/tri)linear interpolation expressed as
strided slice adds on the per-variable node grids, and the coarse
operators come from GALERKIN coarsening of the per-element Jacobian
blocks:

    A_C[ce] = sum_{sub} P_sub^T A_f[fine(ce, sub)] P_sub

a single batched (Ec, 2^dim, nd, nd) einsum per level — no
sparse matrices anywhere. The coarsest level is factored dense (LU)
once per Jacobian; smoothing is damped Jacobi. The whole V-cycle traces
into the caller's jitted Newton step.

All index machinery (level dims, fine->coarse element maps, fixed-dof
masks) is static numpy built once per assembler; the traced part
consumes only the current element blocks.
"""

from __future__ import annotations

from functools import partial
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["StructuredMG", "build_mg_preconditioner"]


def _hat(c, xi):
    return 1.0 - xi if c == 0 else xi


class StructuredMG:
    """Grid hierarchy + transfer operators for one assembler."""

    def __init__(self, assembler, coarse_dofs=600, max_levels=10):
        s = assembler._structured
        if s is None or any(k != "p1" for (k, _n, _st) in s["plan"]):
            raise ValueError("multigrid needs a structured all-p1 mesh")
        self.asm = assembler
        self.dim = len(s["dims"])
        self.corners = s["corners"]
        self.nc = len(self.corners)
        self.vars = [n for (_k, n, _st) in s["plan"]]
        self.n_var = len(self.vars)
        nd = self.n_var * self.nc

        # level 0 = fine
        dims = [tuple(int(d) for d in s["dims"])]
        while (len(dims) < max_levels
               and all(d % 2 == 0 and d >= 4 for d in dims[-1])):
            nxt = tuple(d // 2 for d in dims[-1])
            ndof_next = self.n_var * int(np.prod([d + 1 for d in nxt]))
            dims.append(nxt)
            if ndof_next <= coarse_dofs:
                break
        self.dims = dims
        self.n_levels = len(dims)

        # per-level dof layout: var-major blocks of node grids
        self.grids = [tuple(d + 1 for d in dd) for dd in dims]
        self.ndof = [self.n_var * int(np.prod(g)) for g in self.grids]
        self.starts = [[v * int(np.prod(g)) for v in range(self.n_var)]
                       for g in self.grids]

        # per-level element lids (E_l, nd), same corner pattern
        self.lids = []
        for li, dd in enumerate(dims):
            g = self.grids[li]
            idx = np.arange(int(np.prod(g))).reshape(g)
            el = []
            for off in self.corners:
                sl = tuple(slice(o, o + d) for o, d in zip(off, dd))
                el.append(idx[sl].ravel())
            el = np.stack(el, axis=1)                   # (E_l, nc)
            lids = np.concatenate(
                [self.starts[li][v] + el for v in range(self.n_var)],
                axis=1)
            self.lids.append(jnp.asarray(lids))

        # fixed masks per level (injection: coarse node (I,)=fine (2I,))
        f0 = np.asarray(assembler.fixed)
        # level-0 global dof order must match assembler's: var-major
        # node grids — true by construction of the structured plan
        self.fixed = [f0]
        for li in range(1, self.n_levels):
            gc, gf = self.grids[li], self.grids[li - 1]
            fc = np.zeros(self.ndof[li], dtype=bool)
            ff = self.fixed[li - 1]
            for v in range(self.n_var):
                fv = ff[self.starts[li - 1][v]:
                        self.starts[li - 1][v] + int(np.prod(gf))]
                fv = fv.reshape(gf)
                sl = tuple(slice(None, None, 2) for _ in gf)
                fc[self.starts[li][v]:
                   self.starts[li][v] + int(np.prod(gc))] = \
                    fv[sl].ravel()
            self.fixed.append(fc)
        self.fixed_j = [jnp.asarray(f) for f in self.fixed]

        # fine->coarse element grouping (Ec, 2^dim) and Galerkin P
        subs = list(product((0, 1), repeat=self.dim))
        self.group = []
        for li in range(1, self.n_levels):
            ddc, ddf = dims[li], dims[li - 1]
            Ic = np.indices(ddc).reshape(self.dim, -1).T   # (Ec, dim)
            cols = []
            for sub in subs:
                fidx = (2 * Ic + np.asarray(sub))          # (Ec, dim)
                flat = np.zeros(len(fidx), dtype=np.int64)
                for a in range(self.dim):
                    flat = flat * ddf[a] + fidx[:, a]
                cols.append(flat)
            self.group.append(jnp.asarray(np.stack(cols, axis=1)))

        # static local interpolation P_sub (nc, nc): fine corner value
        # of sub-element `sub` from coarse corner values
        P = np.zeros((len(subs), self.nc, self.nc))
        for si, sub in enumerate(subs):
            for fi, foff in enumerate(self.corners):
                xi = [(sub[a] + foff[a]) / 2.0 for a in range(self.dim)]
                for ci, coff in enumerate(self.corners):
                    w = 1.0
                    for a in range(self.dim):
                        w *= _hat(coff[a], xi[a])
                    P[si, fi, ci] = w
        # expand to block (var-major) layout: nd x nd
        Pb = np.zeros((len(subs), nd, nd))
        for v in range(self.n_var):
            Pb[:, v * self.nc:(v + 1) * self.nc,
               v * self.nc:(v + 1) * self.nc] = P
        self.P_sub = jnp.asarray(Pb)
        self.nd = nd

    # ---- vector transfers (per-var node grids) -----------------------

    def prolong(self, li, vc):
        """Level li+1 (coarse) vector -> level li (fine)."""
        gc, gf = self.grids[li + 1], self.grids[li]
        out = []
        for v in range(self.n_var):
            c = vc[self.starts[li + 1][v]:
                   self.starts[li + 1][v] + int(np.prod(gc))].reshape(gc)
            f = jnp.zeros(gf, dtype=vc.dtype)
            for parity in product((0, 1), repeat=self.dim):
                w = 0.5 ** sum(parity)
                acc = 0.0
                for delta in product(*[(0, 1) if pa else (0,)
                                       for pa in parity]):
                    sl = tuple(
                        slice(d, d + gc[a] - pa)
                        for a, (d, pa) in enumerate(zip(delta, parity)))
                    acc = acc + c[sl]
                dst = tuple(slice(pa, None, 2) for pa in parity)
                f = f.at[dst].set(w * acc)
            out.append(f.ravel())
        return jnp.concatenate(out)

    def restrict(self, li, vf):
        """Level li (fine) vector -> level li+1 (coarse), = prolong^T."""
        gc, gf = self.grids[li + 1], self.grids[li]
        out = []
        for v in range(self.n_var):
            f = vf[self.starts[li][v]:
                   self.starts[li][v] + int(np.prod(gf))].reshape(gf)
            c = jnp.zeros(gc, dtype=vf.dtype)
            for parity in product((0, 1), repeat=self.dim):
                w = 0.5 ** sum(parity)
                src = f[tuple(slice(pa, None, 2) for pa in parity)]
                for delta in product(*[(0, 1) if pa else (0,)
                                       for pa in parity]):
                    sl = tuple(
                        slice(d, d + gc[a] - pa)
                        for a, (d, pa) in enumerate(zip(delta, parity)))
                    c = c.at[sl].add(w * src)
            out.append(c.ravel())
        return jnp.concatenate(out)

    # ---- operator hierarchy ------------------------------------------

    def _fold_boundary(self, J):
        """Add boundary-group Jacobian blocks into a copy of the volume
        blocks (groups share the owning element's dof set)."""
        vol = J.vol
        if not J.bnd:
            return vol
        disc_groups = list(self.asm.disc.boundary_groups)
        active = self.asm._active_bnd_groups()
        elems = [np.asarray(bg.elems) for g, bg in
                 zip(self.asm._bnd, disc_groups)
                 if any(g is a for a in active)]
        for blk, el in zip(J.bnd, elems):
            vol = vol.at[jnp.asarray(el)].add(blk)
        return vol

    def operators(self, J):
        """Element-block operators per level via Galerkin coarsening."""
        blocks = [self._fold_boundary(J)]
        for li in range(1, self.n_levels):
            bf = blocks[-1]
            grp = self.group[li - 1]                    # (Ec, 2^dim)
            sub_blocks = bf[grp]                        # (Ec, S, nd, nd)
            bc = jnp.einsum("sik,eskl,slj->eij",
                            self.P_sub, sub_blocks, self.P_sub)
            blocks.append(bc)
        return blocks

    def _apply(self, li, blocks, v):
        fixed = self.fixed_j[li]
        lids = self.lids[li]
        vm = jnp.where(fixed, 0.0, v)
        av = jax.ops.segment_sum(
            jnp.einsum("eij,ej->ei", blocks, vm[lids]).ravel(),
            lids.ravel(), num_segments=self.ndof[li])
        return jnp.where(fixed, v, av)

    def _diag(self, li, blocks):
        d = jax.ops.segment_sum(
            jnp.diagonal(blocks, axis1=1, axis2=2).ravel(),
            self.lids[li].ravel(), num_segments=self.ndof[li])
        d = jnp.where(self.fixed_j[li], 1.0, d)
        return jnp.where(d == 0, 1.0, d)

    def _node_block_inv(self, li, blocks):
        """Inverted per-node (n_var, n_var) diagonal blocks — the
        smoother must couple the variables (point Jacobi fails when a
        variable's own diagonal degenerates but the cross coupling
        doesn't, e.g. complex-coefficient Helmholtz, saddle points)."""
        nv, nc = self.n_var, self.nc
        nn = self.ndof[li] // nv
        node_ids = self.lids[li][:, :nc] - self.starts[li][0]  # (E, nc)
        D = jnp.zeros((nn, nv, nv), dtype=blocks.dtype)
        for v in range(nv):
            for w in range(nv):
                vals = jnp.diagonal(blocks[:, v * nc:(v + 1) * nc,
                                           w * nc:(w + 1) * nc],
                                    axis1=1, axis2=2)       # (E, nc)
                D = D.at[:, v, w].add(jax.ops.segment_sum(
                    vals.ravel(), node_ids.ravel(), num_segments=nn))
        # fixed dofs: decouple with a unit diagonal
        fx = jnp.stack(
            [self.fixed_j[li][self.starts[li][v]:
                              self.starts[li][v] + nn]
             for v in range(nv)], axis=1)                    # (nn, nv)
        keep = (~fx[:, :, None]) & (~fx[:, None, :])
        eye = jnp.eye(nv, dtype=blocks.dtype)
        D = jnp.where(keep, D, 0.0) + eye * fx[:, :, None]
        dd = jnp.diagonal(D, axis1=1, axis2=2)
        D = D + eye * jnp.where(dd == 0, 1.0, 0.0)[:, :, None]
        return jnp.linalg.inv(D)

    def _block_smooth_apply(self, li, Dinv, r):
        nv = self.n_var
        nn = self.ndof[li] // nv
        rv = r.reshape(nv, nn)                               # var-major
        z = jnp.einsum("nvw,wn->vn", Dinv, rv)
        return z.reshape(-1)

    def _coarse_dense(self, blocks):
        li = self.n_levels - 1
        n = self.ndof[li]
        lids = self.lids[li]
        A = jnp.zeros((n, n), dtype=blocks.dtype)
        A = A.at[lids[:, :, None], lids[:, None, :]].add(blocks)
        fixed = self.fixed_j[li]
        mask = fixed[:, None] | fixed[None, :]
        A = jnp.where(mask, 0.0, A)
        A = A + jnp.diag(jnp.where(fixed, 1.0, 0.0))
        # guard empty rows (dofs untouched at this level)
        d = jnp.diagonal(A)
        A = A + jnp.diag(jnp.where(d == 0, 1.0, 0.0))
        return A

    def preconditioner(self, J, nu1=2, nu2=2, omega=0.8, cycles=1):
        """v -> MG-V(v), a traced closure over the current Jacobian."""
        blocks = self.operators(J)
        dinvs = [self._node_block_inv(li, blocks[li])
                 for li in range(self.n_levels)]
        lu = jax.scipy.linalg.lu_factor(self._coarse_dense(blocks[-1]))

        def smooth(li, x, b, nu):
            for _ in range(nu):
                r = b - self._apply(li, blocks[li], x)
                x = x + omega * self._block_smooth_apply(li, dinvs[li], r)
            return x

        def vcycle(li, b):
            if li == self.n_levels - 1:
                return jax.scipy.linalg.lu_solve(lu, b)
            x = smooth(li, jnp.zeros_like(b), b, nu1)
            r = b - self._apply(li, blocks[li], x)
            r = jnp.where(self.fixed_j[li], 0.0, r)
            rc = self.restrict(li, r)
            rc = jnp.where(self.fixed_j[li + 1], 0.0, rc)
            ec = vcycle(li + 1, rc)
            ec = jnp.where(self.fixed_j[li + 1], 0.0, ec)
            x = x + self.prolong(li, ec)
            return smooth(li, x, b, nu2)

        def M(v):
            x = vcycle(0, v)
            for _ in range(cycles - 1):
                x = x + vcycle(0, v - self._apply(0, blocks[0], x))
            return x

        return M


def build_mg_preconditioner(assembler, J, **kw):
    """Convenience: StructuredMG cached on the assembler + V-cycle."""
    mg = assembler.__dict__.get("_mg_hierarchy")
    if mg is None:
        mg = StructuredMG(assembler)
        assembler.__dict__["_mg_hierarchy"] = mg
    return mg.preconditioner(J, **kw)
