"""Workset: the per-element view physics modules read from and write to.

JAX analog of the reference Workset (src/tools/workset.hpp:22-588):
solution/gradient/time-derivative fields at quadrature points, basis
tables, residual accumulation. One Workset instance exists per *traced
element* inside vmap — all arrays here carry no element dimension, and
all "mutation" is functional accumulation into `self._res`.

Field-name resolution matches the reference's getSolutionField labels:
"e", "grad(e)[x]", "e_t", "x", "y", "z", "t", "n[x]" (side normals),
plus parameter and user-function names via the FunctionManager.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["Workset"]

_AXES = {"x": 0, "y": 1, "z": 2}


class Workset:
    def __init__(self, *, dim, wts, ip, basis_vals, basis_grads, offsets,
                 var_keys, u_eval, u_dot=None, time=0.0, fm=None,
                 params=None, normals=None, side_name=None, bcs=None,
                 extra_fields=None, dtype=None, deltat=1.0,
                 is_transient=False, basis_vecs=None, basis_divs=None,
                 basis_curls=None, face_wts=None, face_normals=None,
                 face_vecs=None, face_scals=None, hface_vals=None):
        self.dim = dim
        self.deltat = deltat
        self.is_transient = is_transient
        self._bvec = basis_vecs or {}       # key -> (ndof, Q, dim)
        self._bdiv = basis_divs or {}       # key -> (ndof, Q)
        self._bcurl = basis_curls or {}     # key -> (ndof, Q[,3])
        self.face_wts = face_wts            # (n_sides, Qf)
        self.face_normals = face_normals    # (n_sides, Qf, dim)
        self._fvec = face_vecs or {}        # key -> (n_sides, nd, Qf, dim)
        self._fscal = face_scals or {}      # key -> (n_sides, nd, Qf)
        self._hface = hface_vals or {}      # key -> (npe, Qf) trace basis
        self.wts = wts                      # (Q,)
        self.ip = ip                        # (Q, dim)
        self._bv = basis_vals               # key -> (ndof, Q)
        self._bg = basis_grads              # key -> (ndof, Q, dim)
        self.offsets = offsets              # var -> (start, ndof)
        self._var_keys = var_keys           # var -> basis key
        self.u = u_eval                     # (ndof_total,)
        self.u_dot = u_dot                  # (ndof_total,) or None
        self.time = time
        self.fm = fm
        self.params = params or {}
        self.normals = normals              # (Q, dim) on side worksets
        self.side_name = side_name
        self.bcs = bcs or {}                # var -> bctype (side worksets)
        self.extra_fields = extra_fields or {}
        ndof_total = sum(nd for (_s, nd) in offsets.values())
        self._res = jnp.zeros(ndof_total, dtype=u_eval.dtype)
        self._sol_cache = {}

    # ---- field access (used by physics + expression leaves) ----

    def basis(self, var):
        return self._bv[self._var_keys[var]]

    def basis_grad(self, var):
        return self._bg[self._var_keys[var]]

    def basis_vec(self, var):
        return self._bvec[self._var_keys[var]]

    def basis_div(self, var):
        return self._bdiv[self._var_keys[var]]

    def basis_curl(self, var):
        return self._bcurl[self._var_keys[var]]

    def is_vector_var(self, var):
        return self._var_keys[var][0] in ("HDIV", "HCURL", "HDIV-DG", "HDIV_AC", "HDIV_AC-DG")

    def _dofs(self, vec, var):
        st, nd = self.offsets[var]
        return vec[st:st + nd]

    def sol(self, var):
        """Solution at quadrature points: (Q,), or (Q, dim) for
        HDIV/HCURL variables."""
        key = ("sol", var)
        if key not in self._sol_cache:
            if self.is_vector_var(var):
                self._sol_cache[key] = jnp.einsum(
                    "i,iqd->qd", self._dofs(self.u, var),
                    self.basis_vec(var))
            else:
                self._sol_cache[key] = (self._dofs(self.u, var)
                                        @ self.basis(var))
        return self._sol_cache[key]

    def div(self, var):
        """Divergence of an HDIV variable, (Q,)."""
        key = ("div", var)
        if key not in self._sol_cache:
            self._sol_cache[key] = jnp.einsum(
                "i,iq->q", self._dofs(self.u, var), self.basis_div(var))
        return self._sol_cache[key]

    def curl(self, var):
        """Curl of an HCURL variable: (Q,) in 2D, (Q, 3) in 3D."""
        key = ("curl", var)
        if key not in self._sol_cache:
            bc = self.basis_curl(var)
            sub = "iq->q" if bc.ndim == 2 else "iqd->qd"
            self._sol_cache[key] = jnp.einsum(
                "i," + sub, self._dofs(self.u, var), bc)
        return self._sol_cache[key]

    def sol_dot(self, var):
        key = ("dot", var)
        if key not in self._sol_cache:
            if self.u_dot is None:
                self._sol_cache[key] = jnp.zeros_like(self.sol(var))
            elif self.is_vector_var(var):
                self._sol_cache[key] = jnp.einsum(
                    "i,iqd->qd", self._dofs(self.u_dot, var),
                    self.basis_vec(var))
            else:
                self._sol_cache[key] = (self._dofs(self.u_dot, var)
                                        @ self.basis(var))
        return self._sol_cache[key]

    def grad(self, var):
        """Solution gradient at quadrature points, (Q, dim)."""
        key = ("grad", var)
        if key not in self._sol_cache:
            self._sol_cache[key] = jnp.einsum(
                "i,iqd->qd", self._dofs(self.u, var), self.basis_grad(var))
        return self._sol_cache[key]

    def f(self, name, location="ip"):
        """Evaluate a FunctionManager expression at this workset."""
        return self.fm.evaluate(name, self, location)

    def resolve(self, leaf: str):
        """Leaf resolution for the expression DSL."""
        if leaf in _AXES and _AXES[leaf] < self.dim:
            return self.ip[:, _AXES[leaf]]
        if leaf == "t":
            return self.time
        if leaf in self.offsets:
            return self.sol(leaf)
        if leaf.endswith("]") and "[" in leaf \
                and leaf[:leaf.index("[")] in self.offsets:
            var = leaf[:leaf.index("[")]
            ax = _AXES[leaf[-2]]
            return self.sol(var)[:, ax]
        if leaf.startswith("div(") and leaf.endswith(")"):
            return self.div(leaf[4:-1])
        if leaf.startswith("curl(") and leaf.endswith(")"):
            return self.curl(leaf[5:-1])
        if leaf.startswith("curl(") and leaf.endswith("]"):
            var = leaf[5:leaf.index(")")]
            return self.curl(var)[:, _AXES[leaf[-2]]]
        if leaf.startswith("grad(") and leaf.endswith("]") \
                and leaf[5:leaf.index(")")] in self.offsets:
            # non-solution grads (field params) fall through to the
            # precomputed extra_fields channels
            var = leaf[5:leaf.index(")")]
            ax = _AXES[leaf[-2]]
            return self.grad(var)[:, ax]
        if leaf.endswith("_t") and leaf[:-2] in self.offsets:
            return self.sol_dot(leaf[:-2])
        if leaf.startswith("n[") and self.normals is not None:
            return self.normals[:, _AXES[leaf[2]]]
        if leaf in ("nx", "ny", "nz") and self.normals is not None:
            return self.normals[:, _AXES[leaf[1]]]
        if leaf in self.params:
            return self.params[leaf]
        if leaf in self.extra_fields:
            return self.extra_fields[leaf]
        raise KeyError(f"cannot resolve expression leaf {leaf!r}")

    def qp(self, v):
        """Broadcast a scalar-or-(Q,) value to quadrature-point shape."""
        return jnp.broadcast_to(jnp.asarray(v, dtype=self.u.dtype),
                                self.wts.shape)

    # ---- residual accumulation (used by physics) ----

    def add_source(self, var, svals):
        """res_i += sum_q svals(q) * phi_i(q) * w(q)   (i.e. (s, v))."""
        st, nd = self.offsets[var]
        contrib = self.basis(var) @ (self.qp(svals) * self.wts)
        self._res = self._res.at[st:st + nd].add(contrib)

    def add_flux(self, var, fvals):
        """res_i += sum_q f(q,:) . grad(phi_i)(q,:) * w(q)  ((F, grad v))."""
        st, nd = self.offsets[var]
        contrib = jnp.einsum("iqd,qd->i", self.basis_grad(var),
                             fvals * self.wts[:, None])
        self._res = self._res.at[st:st + nd].add(contrib)

    def add_vec_source(self, var, fvals):
        """res_i += sum_q f(q,:) . phi_i(q,:) * w(q) for vector bases."""
        st, nd = self.offsets[var]
        contrib = jnp.einsum("iqd,qd->i", self.basis_vec(var),
                             fvals * self.wts[:, None])
        self._res = self._res.at[st:st + nd].add(contrib)

    def add_div_source(self, var, svals):
        """res_i += sum_q s(q) * div(phi_i)(q) * w(q) (HDIV)."""
        st, nd = self.offsets[var]
        contrib = self.basis_div(var) @ (self.qp(svals) * self.wts)
        self._res = self._res.at[st:st + nd].add(contrib)

    def add_curl_source(self, var, cvals):
        """res_i += sum_q c(q[,:]) * curl(phi_i)(q[,:]) * w(q) (HCURL)."""
        st, nd = self.offsets[var]
        bc = self.basis_curl(var)
        if bc.ndim == 2:
            contrib = bc @ (self.qp(cvals) * self.wts)
        else:
            contrib = jnp.einsum("iqd,qd->i", bc,
                                 cvals * self.wts[:, None])
        self._res = self._res.at[st:st + nd].add(contrib)

    # ---- per-side access (hybridized/DG methods) ----

    def n_sides(self):
        return self.face_wts.shape[0]

    def trace(self, var, side):
        """HFACE trace on a local side: (Qf,) values (a scalar
        broadcast for order-0 facet constants)."""
        st, nd = self.offsets[var]
        key = self._var_keys[var]
        tbl = self._hface.get(key)
        if tbl is None or tbl.shape[0] == 1:
            npe = 1 if tbl is None else tbl.shape[0]
            return self.u[st + side * npe]
        npe = tbl.shape[0]
        dofs = self.u[st + side * npe: st + (side + 1) * npe]
        return jnp.einsum("k,kq->q", dofs, tbl)

    def face_sol(self, var, side):
        """Scalar (HGRAD/HGRAD-DG/HVOL) solution at side quadrature
        points, (Qf,) — the broken-state trace DG/HDG face terms read
        (reference: side workset solution fields in faceResidual,
        assemblyManager.cpp:2414-2425)."""
        st, nd = self.offsets[var]
        tbl = self._fscal[self._var_keys[var]][side]   # (nd, Qf)
        return jnp.einsum("i,iq->q", self.u[st:st + nd], tbl)

    def add_face_source(self, var, side, svals):
        """res_i += sum_q s(q) phi_i(q) w_f(q) on one side, for a
        scalar variable (the DG/HDG numerical-flux face term)."""
        st, nd = self.offsets[var]
        tbl = self._fscal[self._var_keys[var]][side]
        contrib = jnp.einsum("iq,q->i", tbl,
                             svals * self.face_wts[side])
        self._res = self._res.at[st:st + nd].add(contrib)

    def face_sol_vec(self, var, side):
        """HDIV(-DG) solution at side quadrature points, (Qf, dim)."""
        st, nd = self.offsets[var]
        fv = self._fvec[self._var_keys[var]][side]     # (nd, Qf, dim)
        return jnp.einsum("i,iqd->qd", self.u[st:st + nd], fv)

    def add_face_vec_source(self, var, side, fvals):
        """res_i += sum_q f(q,:) . phi_i(q,:) w_f(q) on one side."""
        st, nd = self.offsets[var]
        fv = self._fvec[self._var_keys[var]][side]
        contrib = jnp.einsum("iqd,qd->i", fv,
                             fvals * self.face_wts[side][:, None])
        self._res = self._res.at[st:st + nd].add(contrib)

    def add_trace_source(self, var, side, svals):
        """res[trace dofs of side] += sum_q s(q) psi_k(q) w_f(q)."""
        st, nd = self.offsets[var]
        key = self._var_keys[var]
        tbl = self._hface.get(key)
        if tbl is None or tbl.shape[0] == 1:
            npe = 1 if tbl is None else tbl.shape[0]
            contrib = jnp.sum(svals * self.face_wts[side])
            self._res = self._res.at[st + side * npe].add(contrib)
            return
        npe = tbl.shape[0]
        contrib = jnp.einsum("kq,q->k", tbl,
                             svals * self.face_wts[side])
        self._res = self._res.at[st + side * npe:
                                 st + (side + 1) * npe].add(contrib)

    @property
    def res(self):
        return self._res

    @property
    def h(self):
        """Element size h = volume^(1/dim) (reference:
        workset.cpp:2666 getElementSize). Scalar per element."""
        return jnp.sum(self.wts) ** (1.0 / self.dim)

    @property
    def side_h(self):
        """Side element size = measure^(1/(dim-1)) (reference:
        workset.cpp getSideElementSize). Scalar, side worksets only."""
        if self.dim == 1:
            return 1.0
        return jnp.sum(self.wts) ** (1.0 / (self.dim - 1))

    # convenience coordinates
    @property
    def x(self):
        return self.ip[:, 0]

    @property
    def y(self):
        return self.ip[:, 1]

    @property
    def z(self):
        return self.ip[:, 2]
