"""Analysis-mode dispatch: forward / forward+adjoint / UQ / ROL / DCI.

JAX analog of AnalysisManager (reference:
src/managers/analysisManager.cpp:62-95 run, :269 UQSolve, :417 ROLSolve,
:798 DCISolve, :831 restartSolve).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mrhyde_tpu.analysis.forward_ad import DifferentiableForward
from mrhyde_tpu.analysis.optimization import check_gradient, lbfgs_solve  # noqa: F401 (lbfgs kept for library use)
from mrhyde_tpu.analysis.trust_region import rol_fd_check
from mrhyde_tpu.analysis.uq import UQManager, kde, rejection_sampling

__all__ = ["AnalysisManager"]


class AnalysisManager:
    def __init__(self, problem):
        self.problem = problem
        self.cfg = problem.cfg.get("Analysis", {}) or {}
        self.mode = self.cfg.get("analysis type", "forward")

    def run(self):
        mode = self.mode
        if mode == "dry run":
            return self.dry_run()
        if mode == "forward":
            return self.problem.forward()
        if mode == "forward+adjoint":
            return self.adjoint_solve()
        if mode in ("UQ", "SOL"):
            # SOL = ensemble sampling with the LA/sample comm split in
            # the reference (split_mpi_communicators.cpp); here the
            # ensemble axis is just the sample dimension
            return self.uq_solve()
        if mode in ("ROL", "ROL2"):
            return self.rol_solve()
        if mode == "DCI":
            return self.dci_solve()
        if mode == "restart":
            return self.restart_solve()
        raise NotImplementedError(f"analysis type {mode!r}")

    # ------------------------------------------------------------------

    def dry_run(self):
        """Setup-only mode (reference: analysisManager.cpp 'dry run' —
        build everything, report the mesh/DOF/storage summary, solve
        nothing; regression/le/3D_DryRun)."""
        p = self.problem
        mesh = p.mesh
        lines = []
        blocks = " ".join(f'"{b}"' for b in getattr(
            mesh, "block_names", ["eblock-0_0"]))
        lines.append("STK Meta data:")
        lines.append(f"   Element blocks = {blocks}")
        lines.append("   Sidesets = "
                     + " ".join(f'"{s}"' for s in sorted(mesh.sidesets)))
        lines.append("DOFManager Field Information: ")
        for i, v in enumerate(p.disc.var_names):
            lines.append(f'      "{v}" is field ID {i}')
        n_elem = mesh.conn.shape[0]
        n_bnd = sum(ss.shape[0] for ss in mesh.sidesets.values())
        lines.append(f" - {n_elem} elements")
        lines.append(f" - {n_bnd} boundary elements")
        asm = p.assembler
        vol_mb = sum(np.asarray(t).nbytes
                     for t in [asm.g_wts, asm.g_ip]
                     ) / 1e6 + sum(
            np.asarray(v).nbytes for v in asm.g_bv.values()) / 1e6
        bnd_mb = sum(np.asarray(g["wts"]).nbytes
                     + np.asarray(g["ip"]).nbytes
                     + np.asarray(g["normals"]).nbytes
                     for g in asm._bnd) / 1e6
        lines.append(f" - {vol_mb:.4g} MB of volumetric data")
        lines.append(f" - {bnd_mb:.4g} MB of boundary data")
        lines.append(" **** MrHyDE has completed the dry run")
        report = "\n".join(lines)
        print(report)
        return report

    def _differentiable(self):
        p = self.problem
        if p.objective_manager is None:
            raise ValueError("no 'Objective functions' defined in "
                             "Postprocess for gradient-based analysis")
        return DifferentiableForward(p, p.objective_manager.value)

    def adjoint_solve(self):
        """Forward + objective gradient wrt active scalar params."""
        p = self.problem
        fwd_result = p.forward()
        dfwd = self._differentiable()
        pvec = p.param_manager.pvec()
        value, grad = dfwd.value_and_gradient(pvec)
        fwd_result.objective = float(value)
        fwd_result.gradient = {k: np.asarray(v) for k, v in grad.items()}
        return fwd_result

    def uq_solve(self, verbose=0):
        """Monte-Carlo sampling loop (reference UQSolve)."""
        p = self.problem
        uq_cfg = self.cfg.get("UQ", {}) or {}
        uq = UQManager(p.param_manager, uq_cfg)
        regen = bool(self.cfg.get(
            "regenerate grains", uq_cfg.get("regenerate grains", False)))
        counter = {"i": 0}

        def forward_sample(sample):
            # samples flow through the traced pvec argument, so the
            # jitted assembly is compiled ONCE and reused per sample
            # (unlike the reference's per-sample re-assembly)
            p.param_manager.update(sample)
            pvec = {k: jnp.asarray(v) for k, v in sample.items()}
            if regen:
                # per-sample random microstructure (reference:
                # analysisManager.cpp:336-339 generateNewMicrostructure
                # + importNewMicrostructure); the rotated stiffness
                # rides the traced '__field:' channel so the compiled
                # step is reused across samples
                ce = self._sample_microstructure(counter["i"])
                if ce is not None:
                    pvec["__field:crystal_C"] = ce
                counter["i"] += 1
            res = p.forward(pvec=pvec)
            return self._collect_response(res, pvec)

        samples, responses = uq.run(forward_sample,
                                    verbose=int(uq_cfg.get(
                                        "verbosity", verbose)) or verbose)
        stats = uq.moments(responses)
        if uq_cfg.get("write samples", False):
            cols = [samples[k] for k in sorted(samples)]
            np.savetxt("sample_output.dat",
                       np.column_stack(cols + [responses]))
        return {"samples": samples, "responses": responses, "stats": stats}

    def _sample_microstructure(self, sample_idx):
        """(E, d^4) rotated crystal stiffness for a fresh Voronoi
        microstructure seeded by the sample index, or None when no
        CrystalElasticity module is active."""
        from mrhyde_tpu.mesh.microstructure import generate_microstructure
        from mrhyde_tpu.physics.crystal_elasticity import (
            CrystalElasticity, rotate_stiffness)
        p = self.problem
        mod = next((m for m in p.modules
                    if isinstance(m, CrystalElasticity)), None)
        if mod is None:
            return None
        mesh_cfg = p.cfg.get("Mesh", {}) or {}
        ms = generate_microstructure(
            p.mesh, n_seeds=int(mesh_cfg.get("number of seeds", 10)),
            seed=1234 + sample_idx)
        dim = p.mesh.dim
        n_seeds = ms["seed_points"].shape[0]
        Cg = np.zeros((n_seeds,) + mod.C_ref.shape)
        for g in range(n_seeds):
            if dim == 2:
                th = float(ms["angles"][g])
                R = np.array([[np.cos(th), -np.sin(th)],
                              [np.sin(th), np.cos(th)]])
            else:
                a, b, c = ms["angles"][g]
                Rz = np.array([[np.cos(a), -np.sin(a), 0],
                               [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                               [-np.sin(b), 0, np.cos(b)]])
                Rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)],
                               [0, np.sin(c), np.cos(c)]])
                R = Rz @ Ry @ Rx
            Cg[g] = rotate_stiffness(mod.C_ref, R)
        Ce = Cg[ms["grain_ids"]]
        return jnp.asarray(Ce.reshape(Ce.shape[0], -1))

    def _collect_response(self, res, pvec=None):
        p = self.problem
        if p.objective_manager is not None:
            return float(p.objective_manager.value(
                res.u, res.time, pvec or p.param_manager.pvec()))
        return float(jnp.linalg.norm(res.u))

    def generate_data(self):
        """Data-generation mode (reference: analysisManager.cpp:495-526
        'Generate data'): flip the 'datagen' switch parameter to 1, run
        the forward model with the data-generating source, store the
        solution history for discrete-misfit objectives, then flip
        'datagen' back to 0 so the inversion sees the unknown source."""
        p = self.problem
        pm = p.param_manager
        # the generating forward still references every active /
        # discretized parameter leaf; ride them all through the traced
        # pvec channel (NOT baked constants) so the flip back to
        # datagen=0 reuses the same compiled programs
        gen_pvec = dict(pm.pvec())
        if "datagen" in pm.specs:
            pm.update({"datagen": 1.0})
            gen_pvec["datagen"] = jnp.asarray(1.0)
        res = p.forward(pvec=gen_pvec)
        for t, uvec in zip(p.solution_storage.times,
                           p.solution_storage.data):
            if p.objective_manager is not None:
                p.objective_manager.datagen[round(float(t), 12)] = \
                    jnp.asarray(uvec)
        if "datagen" in pm.specs:
            pm.update({"datagen": 0.0})
        return res

    def _inversion_pvec_extra(self):
        """Constant pvec entries every inversion evaluation needs: the
        'datagen' switch pinned to 0 after data generation."""
        pm = self.problem.param_manager
        if "datagen" in pm.specs:
            return {"datagen": jnp.asarray(float(
                pm.specs["datagen"].value))}
        return {}

    def rol_solve(self, verbose=0):
        """ROL-semantics trust-region optimization over active params
        (reference: analysisManager.cpp:417-630 ROLSolve -> ROL
        TrustRegionStep; trajectory tables reproduce the regression
        golds to print precision — see analysis/trust_region.py)."""
        from mrhyde_tpu.analysis.trust_region import (TRSettings,
                                                      trust_region_solve)
        p = self.problem
        pm = p.param_manager
        rol_cfg = self.cfg.get("ROL", self.cfg.get("ROL2", {})) or {}
        # reference decks nest the knobs under ROL->General and
        # ROL->Status Test (input_rol2.yaml layout); accept both the
        # nested and flat forms
        gen_cfg = {**rol_cfg, **(rol_cfg.get("General", {}) or {})}
        st_cfg = {**rol_cfg, **(rol_cfg.get("Status Test", {}) or {})}
        if gen_cfg.get("Generate data", False):
            self.generate_data()
        dfwd = self._differentiable()

        extra = self._inversion_pvec_extra()

        def vag(xflat):
            pvec = pm.unflatten(jnp.asarray(xflat))
            pvec.update(extra)
            v, g = dfwd.value_and_gradient(pvec)
            g = {k: v2 for k, v2 in g.items() if k not in extra}
            return float(v), np.asarray(pm.flatten(g))

        def value_only(xflat):
            pvec = pm.unflatten(jnp.asarray(xflat))
            pvec.update(extra)
            return float(dfwd.objective(pvec))

        x0 = np.asarray(pm.flatten(pm.pvec()))
        if gen_cfg.get("Do grad+hessvec check", False) or \
                gen_cfg.get("check gradient", False):
            if gen_cfg.get("FD Check Use Ones Vector", False):
                d = np.ones_like(x0)
            else:
                rng = np.random.RandomState(
                    int(gen_cfg.get("FD Check Seed", 1)))
                d = rng.uniform(-1.0, 1.0, size=x0.shape) \
                    * float(gen_cfg.get("FD Scale", 1.0))
            errs = rol_fd_check(vag, value_only, x0, d)
            if min(errs) > 1e-3 * max(1.0, abs(vag(x0)[0])):
                raise AssertionError(f"gradient check failed: {errs}")
        bounds = None
        if gen_cfg.get("Bound Optimization Variables", False) or \
                gen_cfg.get("bound constraints", False):
            bounds = pm.bounds()

        settings = TRSettings.from_rol(rol_cfg)
        if "Iteration Limit" not in (rol_cfg.get("Status Test", {})
                                     or {}):
            settings.maxiter = int(st_cfg.get(
                "Iteration Limit",
                st_cfg.get("Maximum Number of Iterations",
                           st_cfg.get("max iterations", 100))))
            settings.gtol = float(st_cfg.get("Gradient Tolerance", 1e-8))
            settings.stol = float(st_cfg.get("Step Tolerance", 1e-14))

        lines = []

        def out(msg):
            lines.append(msg)
            print(msg)

        result = trust_region_solve(vag, x0, settings, bounds=bounds,
                                    out=out, value_only=value_only)
        if gen_cfg.get("Write Final Parameters", False):
            # reference: analysisManager.cpp:577-584 reprints ROL's
            # captured output and the final OptVector
            for ln in lines:
                print(ln)
            for i, v in enumerate(np.asarray(result.x).ravel()):
                print(f"param {i} = {v:g}")
        pm.update(pm.unflatten(result.x))
        return result

    def restart_solve(self):
        """Recover state/adjoint/parameters from text dumps and resume
        per the restart `mode` (reference: analysisManager.cpp:831-889
        restartSolve — state/adjoint/discretized/scalar parameter files
        + mode in {forward, ROL, ROL2})."""
        p = self.problem
        rcfg = self.cfg.get("Restart", {}) or {}
        mode = str(rcfg.get("mode", "forward"))
        start = rcfg.get("start time")
        if start is not None:
            p.solver_cfg["initial time"] = float(start)

        u0 = None
        fname = rcfg.get("state file name", "none")
        if fname == "none":
            fname = rcfg.get("state file", "restart_state.dat")
        if fname and fname != "none":
            u0 = np.loadtxt(fname)

        # scalar / discretized parameter recovery
        sp_file = rcfg.get("scalar parameter file name", "none")
        if sp_file != "none":
            vals = np.atleast_1d(np.loadtxt(sp_file))
            pm = p.param_manager
            for name, v in zip(pm.active_names(), vals):
                pm.specs[name].value = float(v)
            p.params.update(pm.all_values())
        dp_file = rcfg.get("discretized parameter file name", "none")
        if dp_file != "none":
            vals = np.loadtxt(dp_file)
            pm = p.param_manager
            names = pm.discretized_names()
            if len(names) == 1:
                pm.specs[names[0]].value = np.asarray(vals)

        # adjoint recovery: stored for warm-starting adjoint sweeps
        adj_file = rcfg.get("adjoint file name", "none")
        self.restart_adjoint = (np.loadtxt(adj_file)
                                if adj_file != "none" else None)

        if mode in ("ROL", "ROL2"):
            return self.rol_solve()
        return p.forward(u0=u0)

    def dci_solve(self):
        """Data-consistent inversion: UQ ensemble -> predicted density ->
        rejection sampling against the observed density
        (reference: analysisManager.cpp:798 DCISolve)."""
        dci_cfg = self.cfg.get("DCI", {}) or {}
        uq_out = self.uq_solve()
        pred = np.asarray(uq_out["responses"], dtype=float).reshape(-1)
        obs_type = dci_cfg.get("observed type", "Gaussian")
        if obs_type == "Gaussian":
            mean = float(dci_cfg.get("observed mean", 0.0))
            var = float(dci_cfg.get("observed variance", 1.0))
            obs_dens = (np.exp(-0.5 * (pred - mean) ** 2 / var)
                        / np.sqrt(2 * np.pi * var))
        elif obs_type == "uniform":
            lo = float(dci_cfg.get("observed min", 0.0))
            hi = float(dci_cfg.get("observed max", 1.0))
            obs_dens = ((pred >= lo) & (pred <= hi)) / max(hi - lo, 1e-300)
        else:
            raise NotImplementedError(f"observed type {obs_type!r}")
        pred_dens = kde(pred, pred)
        ratios = obs_dens / np.maximum(pred_dens, 1e-300)
        accept = rejection_sampling(ratios,
                                    seed=int(dci_cfg.get("seed", 1234)))
        uq_out["dci"] = {"ratios": ratios, "accepted": accept,
                         "acceptance_rate": float(accept.mean())}
        return uq_out
