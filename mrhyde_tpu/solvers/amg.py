"""Algebraic multigrid for unstructured meshes (aggregation-based).

JAX analog of the reference's MueLu AMG option
(linearAlgebraInterface.cpp:358-430 builds a MueLu hierarchy when the
deck asks for multigrid-class preconditioning); StructuredMG
(solvers/multigrid.py) covers structured quad/hex grids, this covers
everything else (tri/tet/Exodus meshes, high-order layouts).

Design: plain (piecewise-constant) aggregation with a Galerkin product
that NEVER materializes intermediate sparse matrices. Because the
tentative prolongator P0 is a one-hot aggregate map, the coarse
operator P0^T A P0 keeps the ELEMENT-BLOCK form of the fine one: the
(E, nd, nd) element blocks are unchanged and only the dof ids coarsen
(lids -> agg[lids]). Every level's operator apply is therefore the same
gather + batched einsum + segment-sum kernel the fine BlockJacobian
uses — the shape XLA tiles well — instead of an unstructured SpMV.
The coarsest level (<= coarse_dofs) is materialized dense and solved
directly inside the trace.

The aggregation GRAPH is built once per assembler on the host (numpy,
setup time); the numeric hierarchy (diagonals, coarse dense matrix)
re-derives from each Newton iterate's BlockJacobian inside the jitted
step, so the preconditioner tracks the current linearization exactly.

Smoother: damped Jacobi (fixed weight 2/3) — cheap, traceable, and
robust as a V-cycle smoother; fixed (Dirichlet) dofs are excluded from
aggregation and corrected only by the fine-level identity.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import ops as jops

__all__ = ["AggregationAMG"]


def _greedy_aggregate(n, adj_ptr, adj_idx, allowed):
    """Root-based greedy aggregation (MIS of the graph, then attach).

    Returns agg (n,) int: aggregate id, or -1 for excluded dofs."""
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    # pass 1: roots with fully unaggregated allowed neighborhoods
    for i in range(n):
        if not allowed[i] or agg[i] >= 0:
            continue
        nb = adj_idx[adj_ptr[i]:adj_ptr[i + 1]]
        nb = nb[allowed[nb]]
        if np.any(agg[nb] >= 0):
            continue
        agg[i] = n_agg
        agg[nb] = n_agg
        n_agg += 1
    # pass 2: attach leftovers to an adjacent aggregate (or make a
    # singleton when isolated)
    for i in range(n):
        if not allowed[i] or agg[i] >= 0:
            continue
        nb = adj_idx[adj_ptr[i]:adj_ptr[i + 1]]
        hit = agg[nb[allowed[nb]]]
        hit = hit[hit >= 0]
        if hit.size:
            agg[i] = hit[0]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _adjacency(lids, n):
    """CSR dof-dof adjacency from element dof lists (numpy)."""
    E, nd = lids.shape
    src = np.repeat(lids, nd, axis=1).ravel()
    dst = np.tile(lids, (1, nd)).ravel()
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], axis=1), axis=0)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, pairs[:, 0] + 1, 1)
    ptr = np.cumsum(ptr)
    return ptr, pairs[:, 1]


class AggregationAMG:
    """Aggregation-AMG hierarchy for one assembler (any mesh)."""

    def __init__(self, assembler, coarse_dofs=600, max_levels=12,
                 nu=2, omega=2.0 / 3.0):
        lids = np.asarray(assembler.lids)
        fixed = np.asarray(assembler.fixed)
        n = fixed.shape[0]
        self.nu = nu
        self.omega = omega

        # level maps: aggs[l] maps level-l dof -> level-(l+1) dof
        # (fixed dofs only exist at level 0 and map nowhere: they are
        # handled by the fine identity and masked out of the cycle)
        self.aggs = []
        self.sizes = [n]
        cur_lids = lids
        cur_n = n
        allowed = ~fixed
        while cur_n > coarse_dofs and len(self.aggs) < max_levels - 1:
            ptr, idx = _adjacency(cur_lids, cur_n)
            agg, n_agg = _greedy_aggregate(cur_n, ptr, idx, allowed)
            if n_agg >= cur_n or n_agg == 0:
                break                      # no coarsening progress
            self.aggs.append(agg)
            # coarse "element" dof lists: aggregate ids of the fine
            # ones; excluded (fixed) slots park on aggregate 0 and are
            # masked numerically by the zeroed blocks
            cur_lids = np.where(agg[cur_lids] >= 0, agg[cur_lids], 0)
            allowed = np.ones(n_agg, dtype=bool)
            cur_n = n_agg
            self.sizes.append(n_agg)
        self.n_levels = len(self.sizes)
        if self.n_levels < 2:
            raise ValueError("mesh too small for AMG")
        # device-side per-level element dof ids (E, nd) — level 0 uses
        # J.vol_lids directly
        maps = []
        ll = lids
        for agg in self.aggs:
            ll = np.where(agg[ll] >= 0, agg[ll], 0)
            maps.append(jnp.asarray(ll))
        self.level_lids = maps
        self.agg_dev = [jnp.asarray(np.maximum(a, 0)) for a in self.aggs]
        self.agg_valid = [jnp.asarray(a >= 0) for a in self.aggs]

    # -- numeric hierarchy (traced per BlockJacobian) ------------------

    def _masked_vol(self, J):
        """Element blocks with fixed rows/cols zeroed (the V-cycle
        corrects only free dofs; fine fixed rows ride the identity)."""
        vol = J.vol
        fe = J.fixed[J.vol_lids]                       # (E, nd)
        mask = (~fe[:, :, None]) & (~fe[:, None, :])
        vol = jnp.where(mask, vol, 0.0)
        for blocks, lids in zip(J.bnd, J.bnd_lids):
            # fold boundary-group blocks into copies of the volume
            # blocks is NOT possible generally (different E); handled
            # by leaving them to the fine smoother only — boundary
            # blocks are lower-order perturbations
            pass
        return vol

    def preconditioner(self, J):
        """Return v -> V-cycle(v), traced against this J."""
        vol0 = self._masked_vol(J)
        lids0 = J.vol_lids
        levels = [(vol0, lids0, self.sizes[0])]
        for lvl in range(1, self.n_levels):
            levels.append((vol0, self.level_lids[lvl - 1],
                           self.sizes[lvl]))

        # per-level assembled diagonals (+1 guard on empty/fixed rows)
        diags = []
        for vol, ll, sz in levels:
            d = jops.segment_sum(
                jnp.diagonal(vol, axis1=1, axis2=2).ravel(),
                ll.ravel(), num_segments=sz)
            diags.append(jnp.where(jnp.abs(d) > 1e-300, d, 1.0))

        # coarsest dense matrix
        volc, llc, szc = levels[-1]
        Ac = jnp.zeros((szc, szc), dtype=vol0.dtype)
        Ac = Ac.at[llc[:, :, None], llc[:, None, :]].add(volc)
        empty = jnp.abs(jnp.diagonal(Ac)) < 1e-300
        Ac = Ac + jnp.diag(jnp.where(empty, 1.0, 0.0))
        import jax.scipy.linalg as jsl
        lu_piv = jsl.lu_factor(Ac)         # factor ONCE per Jacobian

        def apply_l(lvl, v):
            vol, ll, sz = levels[lvl]
            prods = jnp.einsum("eij,ej->ei", vol, v[ll])
            return jops.segment_sum(prods.ravel(), ll.ravel(),
                                    num_segments=sz)

        def restrict(lvl, r):
            agg = self.agg_dev[lvl]
            r = jnp.where(self.agg_valid[lvl], r, 0.0)
            return jops.segment_sum(r, agg,
                                    num_segments=self.sizes[lvl + 1])

        def prolong(lvl, e):
            return jnp.where(self.agg_valid[lvl],
                             e[self.agg_dev[lvl]], 0.0)

        nu, om = self.nu, self.omega

        def smooth(lvl, x, b):
            for _ in range(nu):
                x = x + om * (b - apply_l(lvl, x)) / diags[lvl]
            return x

        def vcycle(lvl, b):
            if lvl == self.n_levels - 1:
                return jsl.lu_solve(lu_piv, b)
            x = smooth(lvl, jnp.zeros_like(b), b)
            r = b - apply_l(lvl, x)
            e = vcycle(lvl + 1, restrict(lvl, r))
            x = x + prolong(lvl, e)
            return smooth(lvl, x, b)

        def M(v):
            vm = jnp.where(J.fixed, 0.0, v)
            x = vcycle(0, vm)
            return jnp.where(J.fixed, v, x)

        return M
