#!/usr/bin/env python3
"""Smoke test of the deck path on one NVIDIA GPU.

    python chip_smoke.py            # phases P0-P4 on one card
    python chip_smoke.py --four     # DOF-sharded deck on four cards only

Each phase runs in its own child process, one after another, so only
one process ever holds the card (a JAX process reserves most of its
memory). Every phase prints one line of numbers; any failing phase
makes the script exit non-zero without printing a result. The last
line is one JSON object naming the device as JAX reports it.

P0 device  the default JAX backend is a GPU; there is no CPU fallback.
P1 gold    steady manufactured thermal, 40x40 p1 quads (1,681 DOFs), f64,
           direct solve: L2(e) equals the reference gold to 1e-5.
P2 size    the same problem at 1024x1024 (1,050,625 DOFs), f64, GMRES
           with geometric multigrid: Newton and every linear solve
           converge and L2(e) lies within [0.5, 2] x the h^2
           extrapolation of the gold. f64 because in f32 the residual of
           this operator is evaluated only to ~1e-3 of its first norm, so
           Newton cannot report convergence at the accuracy the bound needs.
P3 parity  res_and_jac at real widths (512^2 thermal with k = 1 + u^2 at a
           seeded state; the 256x64 PSPG Navier-Stokes channel) in f32 on
           the GPU against the general path on the CPU in f64: residual,
           J.apply(v) and J.diag() agree to 1e-5 relative to the
           reference norm. The bound is f32 rounding (eps 6e-8) grown by
           summation order over the element sums; TF32 is excluded by
           jax_default_matmul_precision="highest".
P4 NS      the 256x64 PSPG channel (50,115 DOFs), f64, through
           make_problem(cfg).run() with the deck's direct solver: Newton
           to ||r||/||r0|| <= 1e-8. The dense matrix is 20 GB and its LU
           factor another 20 GB, so this child may take 95 % of the
           card's memory (XLA_PYTHON_CLIENT_MEM_FRACTION) instead of 75 %.
--four     steady thermal in f64 at 1024x1024 with
           `Solver: shards: 4` on four cards (effective shard count must
           be 4) against the same deck on one card: the solutions (O(1)
           values) agree to max |du| <= 1e-10.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# reference gold: regression/thermal/2D_verification/mrhyde.gold,
# NX = NY = 40, p1 -> L2(e) = 0.00102776
GOLD_L2_40 = 1.02776e-3

P2_N = 1024
P3_THERMAL_N = 512
NS_NX = 256
FOUR_N = 1024
PHASE_TIMEOUT_S = 900


def card():
    """GPU name and power limit, one entry per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def thermal_cfg(n, solver):
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": {"thermal source": "8*(pi*pi)*sin(2*pi*x)*sin(2*pi*y)"},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {"e": {"all boundaries": 0.0}}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": dict({"solver": "steady-state"}, **solver),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": "sin(2*pi*x)*sin(2*pi*y)"}},
    }


def thermal_kappa_cfg(n):
    cfg = thermal_cfg(n, {})
    cfg["Functions"]["thermal diffusion"] = "1.0 + e*e"
    del cfg["Postprocess"]
    return cfg


def ns_cfg(nx, solver):
    return {
        "Mesh": {"dimension": 2, "element type": "quad",
                 "xmin": 0.0, "xmax": 5.0, "ymin": 0.0, "ymax": 1.0,
                 "NX": nx, "NY": max(nx // 4, 8)},
        "Physics": {"modules": "navier stokes", "usePSPG": True,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"bottom": 0.0, "top": 0.0},
                        "uy": {"bottom": 0.0, "top": 0.0}}},
        "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1},
                           "quadrature": 2},
        "Solver": dict({"solver": "steady-state"}, **solver),
        "Functions": {"source ux": "1.0"},
    }


def emit(phase, ok, **numbers):
    print(f"{phase} {'ok' if ok else 'FAIL'} " + json.dumps(numbers),
          flush=True)
    if not ok:
        raise SystemExit(1)


class CompileClock:
    """Sums JAX's compile-duration events (tracing, lowering, backend
    compile) so compilation is reported as set-up, not solve time."""

    def __init__(self):
        import jax
        self.total = 0.0
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.total += duration
            if event.endswith("backend_compile_duration"):
                self.count += 1


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------- phases

def phase_p0():
    import jax
    backend = jax.default_backend()
    d = jax.devices()
    emit("P0", backend == "gpu", backend=backend,
         kind=d[0].device_kind, count=len(d), card=card())
    print("DEVICE " + json.dumps({"platform": d[0].platform,
                                  "kind": d[0].device_kind,
                                  "count": len(d)}), flush=True)


def phase_p1(n=40):
    from mrhyde_tpu.problem import make_problem
    t0 = time.perf_counter()
    p = make_problem(thermal_cfg(n, {}))
    res = p.run()
    wall = time.perf_counter() - t0
    l2 = float(res.errors[("L2", "e")])
    rel = abs(l2 - GOLD_L2_40) / GOLD_L2_40
    nr = p.newton_result
    emit("P1", rel <= 1e-5 and nr.converged, n_dof=p.n_dof,
         linear=p._linear_method(), dtype=str(res.u.dtype), l2_e=l2,
         gold=GOLD_L2_40, rel_to_gold=rel, newton_iters=nr.iterations,
         wall_s=wall, card=card())


def phase_p2(n=P2_N):
    import jax
    from mrhyde_tpu.problem import make_problem
    clock = CompileClock()
    solver = {"preconditioner variant": "multigrid",
              "linear TOL": 1e-10, "nonlinear TOL": 1e-8}
    t0 = time.perf_counter()
    p = make_problem(thermal_cfg(n, solver))
    setup = time.perf_counter() - t0
    c0 = clock.total
    t0 = time.perf_counter()
    p.run()
    cold = time.perf_counter() - t0
    compile_s = clock.total - c0
    n_compiles = clock.count
    t0 = time.perf_counter()
    res = p.run()
    jax.block_until_ready(res.u)
    warm = time.perf_counter() - t0
    l2 = float(res.errors[("L2", "e")])
    pred = GOLD_L2_40 * (40.0 / n) ** 2
    nr = p.newton_result
    ok = (nr.converged and nr.linear_converged
          and 0.5 * pred <= l2 <= 2.0 * pred)
    emit("P2", ok, n_dof=p.n_dof, n_elem=int(p.assembler.lids.shape[0]),
         dtype=str(res.u.dtype), l2_e=l2, h2_pred=pred, ratio=l2 / pred,
         newton_iters=nr.iterations, newton_rel=nr.norm / nr.norm0,
         newton_converged=nr.converged,
         linear_converged=nr.linear_converged, setup_s=setup,
         first_run_s=cold, compile_s=compile_s, compiles=n_compiles,
         warm_run_s=warm, compiles_in_warm_run=clock.count - n_compiles,
         peak_device_bytes=peak_bytes(), card=card())


def p3_cases(n_thermal=P3_THERMAL_N, nx_ns=NS_NX):
    import numpy as np

    def th_state(n_dof):
        return 0.5 + 0.1 * np.random.RandomState(7).rand(n_dof)

    def ns_state(n_dof):
        return 0.1 * np.random.RandomState(7).randn(n_dof)
    return [("thermal_k1u2", thermal_kappa_cfg(n_thermal), th_state),
            ("ns_pspg", ns_cfg(nx_ns, {}), ns_state)]


def phase_p3_device(tmp, **sizes):
    """The deck's assembly path (res_and_jac) on the GPU in f32; results
    go to tmp for the CPU f64 reference child."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mrhyde_tpu.assembly.assembler import TimeCoeffs
    from mrhyde_tpu.problem import Problem
    for name, cfg, state in p3_cases(**sizes):
        p = Problem(cfg)
        asm = p.assembler
        dt = jnp.zeros(0).dtype
        tc = TimeCoeffs.steady(p.n_dof, dtype=dt)
        u = np.asarray(state(p.n_dof), dt)
        v = np.random.RandomState(11).randn(p.n_dof).astype(dt)

        @jax.jit
        def f(u, v):
            r, J = asm.res_and_jac(u, tc, None)
            return r, J.apply(v), J.diag()
        out = jax.block_until_ready(f(u, v))
        t0 = time.perf_counter()
        jax.block_until_ready(f(u, v))
        np.savez(os.path.join(tmp, f"p3_{name}.npz"), u=u, v=v,
                 *[np.asarray(x) for x in out])
        print(f"P3 device {name}: path=general vmap(jacfwd) dtype={dt} "
              f"n_dof={p.n_dof} res_jac_apply_diag_s="
              f"{time.perf_counter() - t0:.6f} card={card()}", flush=True)


def phase_p3_reference(tmp, tol=1e-5, **sizes):
    """General path on the CPU in f64 at the same (f32-rounded) state."""
    import jax
    import numpy as np
    from mrhyde_tpu.assembly.assembler import TimeCoeffs
    from mrhyde_tpu.problem import Problem
    assert jax.config.jax_enable_x64 and jax.default_backend() == "cpu"
    for name, cfg, _state in p3_cases(**sizes):
        data = np.load(os.path.join(tmp, f"p3_{name}.npz"))
        p = Problem(cfg)
        asm = p.assembler
        tc = TimeCoeffs.steady(p.n_dof)
        u = data["u"].astype(np.float64)
        v = data["v"].astype(np.float64)

        @jax.jit
        def f(u, v):
            J = asm.jacobian(u, tc, None)
            return asm.residual(u, tc, None), J.apply(v), J.diag()
        ref = [np.asarray(x) for x in f(u, v)]
        got = [data[f"arr_{i}"].astype(np.float64) for i in range(3)]
        rel = {k: float(np.linalg.norm(g - r) / np.linalg.norm(r))
               for k, g, r in zip(("residual", "J_apply_v", "J_diag"),
                                  got, ref)}
        emit("P3", max(rel.values()) <= tol, case=name, n_dof=p.n_dof,
             rel_err=rel, tol=tol)


def phase_p4(nx=NS_NX):
    from mrhyde_tpu.problem import make_problem
    # dense LU: restarted GMRES with the deck's jacobi, schwarz or
    # multigrid preconditioners stagnates on this PSPG saddle system
    solver = {"nonlinear TOL": 1e-8, "max nonlinear iters": 10,
              "use direct solver": True}
    t0 = time.perf_counter()
    p = make_problem(ns_cfg(nx, solver))
    res = p.run()
    wall = time.perf_counter() - t0
    nr = p.newton_result
    emit("P4", nr.converged and nr.linear_converged, n_dof=p.n_dof,
         dtype=str(res.u.dtype), newton_iters=nr.iterations,
         newton_rel=nr.norm / nr.norm0, linear_converged=nr.linear_converged,
         wall_s=wall, card=card())


def phase_four(n=FOUR_N, shards=4):
    """DOF-sharded deck on `shards` devices vs the same deck on one."""
    import jax
    import numpy as np
    from mrhyde_tpu.problem import make_problem
    solver = {"Belos solver": "Block CG", "preconditioner variant": "jacobi",
              "linear TOL": 1e-12, "max linear iters": 2000,
              "nonlinear TOL": 1e-11, "max nonlinear iters": 40}
    out = {}
    for s in (shards, 0):
        cfg = thermal_cfg(n, dict(solver, shards=s))
        t0 = time.perf_counter()
        p = make_problem(cfg)
        res = p.run()
        jax.block_until_ready(res.u)
        out[s] = dict(u=np.asarray(res.u), l2=float(res.errors[("L2", "e")]),
                      nr=p.newton_result, shards=p.shards,
                      wall=time.perf_counter() - t0)
    a, b = out[shards], out[0]
    du = float(np.max(np.abs(a["u"] - b["u"])))
    l2_rel = abs(a["l2"] - b["l2"]) / b["l2"]
    ok = (a["shards"] == shards and a["nr"].converged and b["nr"].converged
          and du <= 1e-10)
    emit("FOUR", ok, n_dof=int(a["u"].size), devices=len(jax.devices()),
         effective_shards=a["shards"], l2_sharded=a["l2"], l2_one=b["l2"],
         l2_rel_diff=l2_rel, max_abs_du=du,
         newton_iters=[a["nr"].iterations, b["nr"].iterations],
         wall_s=[a["wall"], b["wall"]], card=card())
    print("DEVICE " + json.dumps({"platform": jax.devices()[0].platform,
                                  "kind": jax.devices()[0].device_kind,
                                  "count": len(jax.devices())}), flush=True)


# ----------------------------------------------------------- orchestration

def child(phase, tmp):
    """Run inside a child process: the accelerator check, then one phase."""
    if phase != "p3ref":
        import jax
        if jax.default_backend() != "gpu":
            print(f"{phase.upper()} FAIL no GPU: default JAX backend is "
                  f"{jax.default_backend()!r}", flush=True)
            raise SystemExit(2)
    {"p0": phase_p0, "p1": phase_p1, "p2": phase_p2,
     "p3dev": lambda: phase_p3_device(tmp),
     "p3ref": lambda: phase_p3_reference(tmp),
     "p4": phase_p4, "four": phase_four}[phase]()


def run_child(phase, tmp, x64, cpu=False, mem_fraction=None):
    env = dict(os.environ)
    env.pop("JAX_ENABLE_X64", None)
    if x64:
        env["JAX_ENABLE_X64"] = "1"
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    if mem_fraction:
        env["XLA_PYTHON_CLIENT_MEM_FRACTION"] = mem_fraction
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", phase,
         "--tmp", tmp],
        cwd=HERE, env=env, stdout=subprocess.PIPE, text=True,
        timeout=PHASE_TIMEOUT_S)
    device = None
    for line in proc.stdout.splitlines():
        if line.startswith("DEVICE "):
            device = json.loads(line[len("DEVICE "):])
        else:
            print(line, flush=True)
    if proc.returncode != 0:
        print(f"phase {phase} failed (exit {proc.returncode})", flush=True)
        raise SystemExit(1)
    return device


def main(argv):
    if "--phase" in argv:
        child(argv[argv.index("--phase") + 1],
              argv[argv.index("--tmp") + 1])
        return
    with tempfile.TemporaryDirectory() as tmp:
        try:
            if "--four" in argv:
                device = run_child("four", tmp, x64=True)
            else:
                device = run_child("p0", tmp, x64=False)
                run_child("p1", tmp, x64=True)
                run_child("p2", tmp, x64=True)
                run_child("p3dev", tmp, x64=False)
                run_child("p3ref", tmp, x64=True, cpu=True)
                run_child("p4", tmp, x64=True, mem_fraction="0.95")
        except subprocess.TimeoutExpired as e:
            print(f"phase timed out after {e.timeout} s", flush=True)
            raise SystemExit(1)
    print(f"card: {card()}", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
