"""CLI driver: `mrhyde-tpu input.yaml` (or `python -m mrhyde_tpu.driver`).

The analog of the reference driver (src/driver.cpp:24-233): parse the
input deck, build the problem, dispatch the analysis mode, print the
postprocess report, and optionally dump a timer profile.

Supports the reference's split-deck convention: `<Sublist> input file`
keys merge per-subsystem YAML files into the master deck
(reference: src/interfaces/userInterface.hpp:93-388).
"""

from __future__ import annotations

import os
import sys

__all__ = ["load_input_deck", "main"]

_SUBLISTS = ("Mesh", "Physics", "Discretization", "Solver", "Analysis",
             "Postprocess", "Parameters", "Functions", "Subgrid",
             "Aux Physics", "Aux Discretization")


def _load_yaml(path: str):
    """yaml.safe_load with the reference reader's indentation tolerance:
    Teuchos accepts stray odd-space indents (e.g. the WeakGalerkin_3D
    deck's 3-space ' Functions:' line); PyYAML does not, so on a parse
    error retry with odd leading indents rounded down to even."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "reading a YAML input deck needs PyYAML (`pip install "
            "pyyaml`); config dicts passed to make_problem() do not"
        ) from e
    text = open(path).read()
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        pass
    fixed = []
    for line in text.splitlines(keepends=True):
        ns = len(line) - len(line.lstrip(" "))
        if ns % 2 == 1 and line.strip():
            line = line[1:]
        fixed.append(line)
    try:
        return yaml.safe_load("".join(fixed))
    except yaml.YAMLError:
        pass
    # second fallback: a key over-indented relative to its SIBLING
    # scalar (e.g. '        ROL:' after '    write output: false' in
    # 2d_gradient_check_ms/input_rol2.yaml) dedents to the sibling's
    # level, its subtree shifting with it
    out, shift_from, shift_by = [], None, 0
    prev_indent = 0
    for line in fixed:
        s = line.strip()
        if not s or s.startswith("#"):
            out.append(line)
            continue
        ns = len(line) - len(line.lstrip(" "))
        if shift_from is not None:
            if ns >= shift_from:
                out.append(line[shift_by:])
                continue
            shift_from = None
        if (ns > prev_indent + 2 and out
                and out[-1].strip()
                and not out[-1].rstrip().endswith(":")):
            shift_by = ns - prev_indent
            shift_from = ns
            out.append(line[shift_by:])
            prev_indent = ns - shift_by
            continue
        out.append(line)
        prev_indent = ns
    return yaml.safe_load("".join(out))


def load_input_deck(path: str) -> dict:
    cfg = _load_yaml(path)
    # the reference wraps everything in an ANONYMOUS root
    if isinstance(cfg, dict) and set(cfg) == {"ANONYMOUS"}:
        cfg = cfg["ANONYMOUS"]
    base = os.path.dirname(os.path.abspath(path))
    cfg.setdefault("_deck_dir", base)
    for sub in _SUBLISTS:
        key = f"{sub} input file"
        if key in cfg:
            inc = os.path.join(base, cfg.pop(key))
            if not os.path.exists(inc):
                # the reference silently skips missing include files
                # (userInterface.hpp:160-163 ifstream fn.good() guard;
                # e.g. ODE/BDF3 names an input_mesh.yaml that is absent)
                continue
            extra = _load_yaml(inc)
            if isinstance(extra, dict) and set(extra) == {"ANONYMOUS"}:
                extra = extra["ANONYMOUS"]
            merged = extra.get(sub, extra) if isinstance(extra, dict) else {}
            cfg.setdefault(sub, {}).update(merged or {})
    return cfg


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: mrhyde-tpu <input.yaml> [--profile] [--fp64] "
              "[--cpu] [--shards N]")
        return 0
    path = argv[0]
    opts = set(argv[1:])

    shards = 0
    rest = argv[1:]
    for i, a in enumerate(rest):
        if a == "--shards" and i + 1 < len(rest):
            shards = int(rest[i + 1])
        elif a.startswith("--shards="):
            shards = int(a.split("=", 1)[1])
    if "--cpu" in opts:
        import jax
        jax.config.update("jax_platforms", "cpu")
        if (shards > len(jax.devices("cpu"))
                and os.environ.get("_MRHYDE_SHARDS_CHILD") != "1"):
            # re-exec with N virtual host devices provisioned BEFORE
            # jax initializes (importing mrhyde_tpu already pulled in
            # jax, so an env flag in this process is too late)
            import subprocess
            env = {k: v for k, v in os.environ.items()
                   if not any(t in k.upper() for t in ("PJRT", "JAX"))}
            env["_MRHYDE_SHARDS_CHILD"] = "1"
            env["JAX_PLATFORMS"] = "cpu"
            env["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={shards}")
            return subprocess.call(
                [sys.executable, "-m", "mrhyde_tpu.driver"] + list(argv),
                env=env)
    if "--fp64" in opts:
        from mrhyde_tpu.runtime import fp64
        fp64(True)
    if shards > 1:
        # no fallback: too few devices fails here, naming what it found
        from mrhyde_tpu.parallel.deck_sharded import _mesh_for
        _mesh_for(shards)

    from mrhyde_tpu.problem import make_problem
    from mrhyde_tpu.utils.profiling import timer_report, timed

    cfg = load_input_deck(path)
    if shards:
        cfg.setdefault("Solver", {})["shards"] = shards
    verbosity = int(cfg.get("verbosity", 0))

    with timed("driver::total"):
        with timed("driver::setup"):
            problem = make_problem(cfg)
        with timed("driver::run"):
            result = problem.run()

    if problem.compute_errors and hasattr(result, "report"):
        print(result.report())
    if "--profile" in opts or cfg.get("profile", False):
        report = timer_report()
        print(report)
        with open("mrhyde_tpu.profile", "w") as f:
            f.write(report)
    if verbosity > 0 and hasattr(problem, "n_dof") \
            and hasattr(result, "time"):
        print(f"n_dof = {problem.n_dof}, final time = {result.time}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
