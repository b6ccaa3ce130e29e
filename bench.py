"""Benchmark: element-Jacobian assembly throughput on an NVIDIA GPU.

The BASELINE.json headline metric. Assembles the full element-block
Jacobian + residual (gather -> AD seeding -> physics kernel -> jacfwd ->
scatter) for a 2D thermal problem, and reports throughput in
GDOF/s = (n_elem * ndof_per_elem) / wall_time / 1e9 — global element-dof
rows assembled per second.

The reference publishes no numbers (BASELINE.md); vs_baseline is
measured against a fixed reference target of 1 GDOF/s so the ratio is
comparable across rounds. Runs on a GPU only: any other backend, or a
card missing from HBM_PEAK_BYTES_S, is refused.

Prints one JSON line per metric.
"""

import json
import os
import time

# Peak HBM bandwidth by jax device_kind, bytes/s (NVIDIA H100 data
# sheets: SXM5 3.35 TB/s, PCIe 2.0 TB/s).
HBM_PEAK_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def _hbm_peak():
    """Peak HBM bytes/s of the default device; refuses anything else."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py runs on a GPU; found {dev.platform}")
    if dev.device_kind not in HBM_PEAK_BYTES_S:
        raise SystemExit(f"no HBM peak known for {dev.device_kind!r}; "
                         "add it to HBM_PEAK_BYTES_S")
    return HBM_PEAK_BYTES_S[dev.device_kind]


def ns_solve_bench():
    """Navier-Stokes nonlinear solve TIME-TO-TOLERANCE (BASELINE.json
    metric 2): steady PSPG channel, matrix-free Newton iterated until
    ||r|| / ||r0|| <= tol (default 1e-8) inside one jitted
    lax.while_loop — the reference contract is Belos' tolerance-driven
    solves (linearAlgebraInterface.cpp:358-500), not a fixed iteration
    budget. Reports tol, Newton iters used, and device seconds to
    tolerance (slope-measured to remove the fixed dispatch cost)."""
    import time
    import jax
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import TimeCoeffs
    from mrhyde_tpu.problem import Problem

    nx = int(os.environ.get("BENCH_NX", "256"))
    ny = max(nx // 4, 8)
    # achievable tolerance is precision-bound. In f32 the NEWTON
    # residual was seen to plateau at 1.32e-2 relative on this problem
    # (25 iterations never improved past it), so the f32 target sits
    # just above that plateau; the metric stays time-to-tolerance with
    # the tolerance printed in the JSON.
    f64 = jnp.zeros(0).dtype == jnp.dtype("float64")
    tol = float(os.environ.get("BENCH_NS_TOL",
                               "1e-8" if f64 else "2e-2"))
    max_newton = int(os.environ.get("BENCH_NEWTON_MAX", "25"))
    cfg = {
        "Mesh": {"dimension": 2, "element type": "quad",
                 "xmin": 0.0, "xmax": 5.0, "ymin": 0.0, "ymax": 1.0,
                 "NX": nx, "NY": ny},
        "Physics": {"modules": "navier stokes", "usePSPG": True,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"bottom": 0.0, "top": 0.0},
                        "uy": {"bottom": 0.0, "top": 0.0}}},
        "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1},
                           "quadrature": 2},
        "Solver": {"solver": "steady-state"},
        "Functions": {"source ux": "1.0"},
    }
    p = Problem(cfg)
    asm = p.assembler
    dtype = jnp.zeros(0).dtype
    tc = TimeCoeffs.steady(p.n_dof, dtype=dtype)

    from mrhyde_tpu.solvers.krylov import gmres
    from mrhyde_tpu.solvers.precond import build_preconditioner

    # linear solve per Newton step: tolerance-driven restarted
    # GMRES(m). m=10 STALLS on the PSPG saddle system (stagnates at
    # ~8x reduction, measured 400 matvecs without progress); larger m
    # costs orthogonalization V-reads that scale as m^2 n, so m=20 is
    # the default. BENCH_NS_PRECOND selects jacobi|chebyshev|simple|
    # mg|amg.
    variant = os.environ.get("BENCH_NS_PRECOND", "jacobi")
    gmres_m = int(os.environ.get("BENCH_NS_M", "20"))

    hier = None
    if variant in ("mg", "amg"):
        # measure the in-tree hierarchies on the PSPG saddle system
        if variant == "mg":
            from mrhyde_tpu.solvers.multigrid import StructuredMG
            hier = StructuredMG(asm)
        else:
            from mrhyde_tpu.solvers.amg import AggregationAMG
            hier = AggregationAMG(asm)

    p_mask = None
    if variant == "simple":
        import numpy as np
        vs = np.asarray(asm.disc.dofmap.var_start)
        i = asm.disc.var_names.index("pr")
        lo = int(vs[i])
        hi = int(vs[i + 1]) if i + 1 < len(vs) else p.n_dof
        pm = np.zeros(p.n_dof, bool)
        pm[lo:hi] = True
        p_mask = jnp.asarray(pm)

    # the ENTIRE tolerance-driven Newton solve is ONE device program
    # (the reference pays an MPI round per Belos solve; here the host
    # never intervenes)
    @jax.jit
    def newton_to_tol(u0):
        r0n = jnp.linalg.norm(asm.residual(u0, tc, None))

        def cond(s):
            _u, rn, it = s
            return (rn > tol * r0n) & (it < max_newton)

        def body(s):
            u, _rn_prev, it = s
            r, J = asm.res_and_jac(u, tc, None)
            apply_fn = asm.matfree_apply_fn(J)
            if variant == "simple":
                from mrhyde_tpu.solvers.precond import (
                    fieldsplit_simple_precond)
                M = fieldsplit_simple_precond(J, p_mask,
                                              apply_fn=apply_fn)
            elif hier is not None:
                M = hier.preconditioner(J)
            else:
                M = build_preconditioner(J, variant)
            # forcing term: two orders below the Newton target — an
            # f32-unreachable 1e-6 forcing makes every Newton step burn
            # all max_restarts (measured: 25x20 restarts at 1.35 s)
            du, _info = gmres(apply_fn, -r, m=gmres_m,
                              tol=1e-6 if f64 else 1e-4,
                              max_restarts=20, precond=M)
            u = u + du
            rn = jnp.linalg.norm(asm.residual(u, tc, None))
            return (u, rn, it + 1)

        u, rn, it = jax.lax.while_loop(
            cond, body, (u0, jnp.asarray(jnp.inf, u0.dtype), 0))
        return u, rn, r0n, it

    u0 = p.initial_state()
    un, rn, r0n, iters = newton_to_tol(u0)
    float(jnp.sum(un))          # compile + warm (forces host pull)
    t0 = time.perf_counter()
    u, rn, r0n, iters = newton_to_tol(u0)
    float(jnp.sum(u))           # host pull = real completion barrier
    dt = time.perf_counter() - t0
    iters = int(iters)
    rel = float(rn / r0n)

    # device time via the two-length slope (removes the fixed
    # per-dispatch cost of a single call)
    from functools import partial

    @partial(jax.jit, static_argnames="length")
    def solve_many(u, length):
        def body(c, _):
            un_, rn_, _r0, _it = newton_to_tol(u0 + 1e-20 * c)
            return un_, rn_
        c, nl = jax.lax.scan(body, u, None, length=length)
        return jnp.sum(c) + jnp.sum(nl)

    def timed(length, reps=4):
        # min-of-reps: dispatch-latency spikes otherwise corrupt the
        # slope
        float(solve_many(u0, length))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(solve_many(u0, length))
            best = min(best, time.perf_counter() - t0)
        return best

    # noise band: >=3 independent slope estimates (a single point
    # estimate hides the run-to-run spread)
    devs = []
    for _ in range(3):
        t1, t2 = timed(2), timed(6)
        if t2 <= t1:
            t1, t2 = timed(2), timed(6)
        devs.append(max(t2 - t1, 1e-9) / 4)
    devs.sort()
    dev = devs[len(devs) // 2]

    print(json.dumps({
        "metric": "ns_nonlinear_solve",
        "value": round(dt, 4),
        "unit": "seconds",
        "vs_baseline": round(dt, 4),
        "device_s_to_tol": round(dev, 4),
        "device_s_band": [round(devs[0], 4), round(devs[-1], 4)],
        "tol": tol,
        "iters": iters,
        "final_rel_residual": float(f"{rel:.3e}"),
        # time-to-max-iters must not masquerade as time-to-tolerance
        "converged": bool(rel <= tol),
        "precond": variant,
    }))


def _assembly_measure(cfg, u_init=None):
    """Measure the production res_and_jac on one deck config.
    Returns (dt_seconds, asm, problem)."""
    import jax
    import jax.numpy as jnp

    reps = int(os.environ.get("BENCH_REPS", "5"))

    from mrhyde_tpu.assembly.assembler import TimeCoeffs
    from mrhyde_tpu.problem import Problem

    p = Problem(cfg)
    asm = p.assembler
    dtype = jnp.zeros(0).dtype
    tc = TimeCoeffs.steady(p.n_dof, dtype=dtype)
    u = jnp.zeros(p.n_dof, dtype=dtype) if u_init is None \
        else jnp.asarray(u_init, dtype=dtype)

    inner = int(os.environ.get("BENCH_INNER", "100"))

    # measure the PRODUCTION entry point — Assembler.res_and_jac — the
    # same call the deck driver's Newton loop makes.
    from functools import partial

    @partial(jax.jit, static_argnames="length")
    def assemble_loop(u, tc, length):
        # chain assemblies inside ONE device program so the measurement
        # reflects device throughput, not host dispatch
        def body(carry, _):
            u = carry
            r, J = asm.res_and_jac(u, tc, None)
            # DCE guard: thread a TINY jac slice into the carry so the
            # Jacobian stays live without charging the bench an extra
            # full jac read per assembly (a consumer cost, not an
            # assembly cost).
            u = u + 1e-12 * r + 0.0 * J.vol.ravel()[0]
            return u, None
        u, _ = jax.lax.scan(body, u, None, length=length)
        return jnp.sum(u)

    # two-length slope estimate: dt = (T(L2) - T(L1)) / (L2 - L1)
    # removes the fixed per-dispatch cost, which is NOT device time
    # (float() forces a host pull as the completion barrier).
    # min-of-reps, not mean: a latency spike on one dispatch can push
    # T(L1) above T(L2) and collapse the slope.
    L1, L2 = inner, 5 * inner

    def timed(length):
        float(assemble_loop(u, tc, length))        # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(assemble_loop(u, tc, length))
            best = min(best, time.perf_counter() - t0)
        return best

    # noise band: N_SLOPES independent slope estimates (each already
    # min-of-reps); report the median and carry the band
    n_slopes = int(os.environ.get("BENCH_SLOPES", "5"))
    dts = []
    for _ in range(n_slopes):
        t1, t2 = timed(L1), timed(L2)
        if t2 <= t1:                  # residual spike: one remeasure
            t1, t2 = timed(L1), timed(L2)
        dts.append(max(t2 - t1, 1e-9) / (L2 - L1))
    dts.sort()
    dt = dts[len(dts) // 2]
    return dt, asm, p, (dts[0], dts[-1])


def _assembly_stats(asm, p, dt):
    """(gdofs, roofline_frac) for one measured assembly.

    HBM roofline floor: the input node grid (u) plus the residual and
    Jacobian rows written per element, at itemsize bytes, against the
    card's peak HBM bandwidth. roofline_frac = floor_time /
    measured_time (1.0 = memory-bound speed of light).
    """
    import jax.numpy as jnp

    n_elem = asm.lids.shape[0]
    nd = asm.lids.shape[1]
    gdofs = n_elem * nd / dt / 1e9
    itemsize = jnp.zeros(0).dtype.itemsize
    bytes_per = (asm.n_dof + (nd + nd * nd) * n_elem) * itemsize
    floor = bytes_per / _hbm_peak()
    return gdofs, floor / dt


def assembly_bench():
    nx = int(os.environ.get("BENCH_NX", "512"))
    # BENCH_CASE=const skips the varying-Jacobian case (fast iteration
    # on the headline kernel); default runs both
    case = os.environ.get("BENCH_CASE", "both")

    def mesh_phys(kappa, source):
        return {
            "Mesh": {"dimension": 2, "element type": "quad",
                     "NX": nx, "NY": nx},
            "Functions": {"thermal source": source,
                          "thermal diffusion": kappa},
            "Physics": {"modules": "thermal",
                        "Dirichlet conditions": {
                            "e": {"all boundaries": 0.0}}},
            "Discretization": {"order": {"e": 1}, "quadrature": 2},
            "Solver": {"solver": "steady-state"},
        }

    # 1) VARYING-JACOBIAN case: nonlinear conductivity 1 + u^2 makes
    # every element-Jacobian entry depend on the state — the
    # "element-Jacobian assembly" of every assembleJacRes call in a
    # nonlinear solve (reference: assemblyManager.cpp:2356-2510).
    # Measured at a nonconstant state.
    import numpy as np
    g_v = roof_v = None
    def band_gdofs(asm_, band):
        n_elem = asm_.lids.shape[0]
        nd_ = asm_.lids.shape[1]
        # dt band inverts: min dt -> max GDOF/s
        return [round(n_elem * nd_ / band[1] / 1e9, 4),
                round(n_elem * nd_ / band[0] / 1e9, 4)]

    if case in ("both", "varying"):
        rng = np.random.RandomState(7)
        n_nodes = (nx + 1) * (nx + 1)
        u_init = 0.5 + 0.1 * rng.rand(n_nodes)
        dt_v, asm_v, p_v, band_v = _assembly_measure(
            mesh_phys("1.0 + e*e", "8*(pi*pi)*sin(2*pi*x)*sin(2*pi*y)"),
            u_init=u_init)
        g_v, roof_v = _assembly_stats(asm_v, p_v, dt_v)
        print(json.dumps({
            "metric": "element_jacobian_assembly_varying",
            "value": round(g_v, 4),
            "unit": "GDOF/s",
            "vs_baseline": round(g_v / 1.0, 4),
            "gdofs_band": band_gdofs(asm_v, band_v),
            "roofline_frac": round(roof_v, 3),
        }))
    if case == "varying":
        return

    # 2) HEADLINE: constant-coefficient steady thermal
    dt, asm, p, band = _assembly_measure(
        mesh_phys("1.0", "8*(pi*pi)*sin(2*pi*x)*sin(2*pi*y)"))
    gdofs, roof = _assembly_stats(asm, p, dt)
    print(json.dumps({
        "metric": "element_jacobian_assembly",
        "value": round(gdofs, 4),
        "unit": "GDOF/s",
        "vs_baseline": round(gdofs / 1.0, 4),
        "gdofs_band": band_gdofs(asm, band),
        "roofline_frac": round(roof, 3),
        **({} if g_v is None else {
            "varying_gdofs": round(g_v, 4),
            "varying_roofline_frac": round(roof_v, 3)}),
    }))


def main():
    # A plain `python bench.py` emits BOTH BASELINE.json metrics, one
    # JSON line each; the headline (assembly GDOF/s) prints LAST since
    # the driver parses the tail. BENCH_MODE selects a single metric.
    mode = os.environ.get("BENCH_MODE", "all")
    _hbm_peak()                 # refuse a non-GPU or unknown device
    if mode in ("ns_solve", "all"):
        ns_solve_bench()
    if mode in ("assembly", "all"):
        assembly_bench()


if __name__ == "__main__":
    main()
