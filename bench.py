"""Headline benchmark: full Newton estimation on a 10k-element VdP mesh.

TWO measurements, one JSON line on stdout:

  * fixed-work (``metric``/``value``): exactly 15 LM iterations, matched to
    baseline_cpu/run_baseline.py's fixed-work run; ``vs_baseline`` = that
    CPU reference wall / this device wall (the CPU wall was taken on
    another machine, baseline_cpu/results.json).
  * converged (``converged_*`` keys): TIME-TO-SOLUTION — the multilevel
    ladder (625 -> 2500 -> 10000 elements, warm-started nested iteration,
    refine.estimate_multilevel's schedule with each level's solver built
    and compiled up front) from the cold initial guess until the recovered
    parameters satisfy ‖p − p_true‖∞ < 1e-4.

Walls are the median (with quartiles) over ``REPS`` repetitions, each
bounded by ``jax.block_until_ready`` on its result; compilation is timed
separately as set-up.  Needs a GPU: the script exits non-zero when JAX's
default backend is anything else, and when a quality check fails.  Runs in
float32; the 1e-9 f64 parity criterion is covered by
tests/test_baseline_parity.py on CPU.

Usage: python bench.py [--no-converged]   (BENCH_ELEMENTS overrides N)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ITERS = 15
REPS = 5
ELEMENTS = int(os.environ.get("BENCH_ELEMENTS", "10000"))
P_TRUE = np.array([1.0, 1.0])
P_ERR_TARGET = 1e-4


def _setup(elements):
    from baseline_cpu.run_baseline import build_headline_problem
    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.problem import EstimationProblem

    mesh, t_meas, y, u_nodes = build_headline_problem(elements)
    prob = EstimationProblem.build(
        VanDerPol(), mesh, t_meas, defect_weight=100.0
    )
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
    return prob, z0, data, (t_meas, y)


def wall_stats(fn, reps=REPS):
    """Median and quartiles of ``reps`` walls of ``fn()``; each rep ends in
    ``jax.block_until_ready`` on fn's result."""
    import jax

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    return {"median_s": float(med), "q1_s": float(q1), "q3_s": float(q3),
            "reps": reps}


def memory_summary(compiled):
    """The byte counts of ``compiled.memory_analysis()`` as a dict."""
    mem = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(mem, k)) for k in keys if hasattr(mem, k)}


def run_fixed(elements, reps=REPS):
    """Exactly ITERS LM iterations from the cold guess (no early exit).

    Returns a dict: compile_s, wall (wall_stats), memory, cost0, cost, p,
    ok (finite p and cost down by more than 10x)."""
    import jax

    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import make_gn_solver

    prob, z0, data, _ = _setup(elements)

    # kkt_refine=0 matches the CPU baseline's work per iteration (plain LM
    # steps); the gain-ratio LM rejects degraded steps, so it is safe.
    # lam0=3e-6 (dimensionless, see solve.kkt) starts at the productive
    # damping level for this mesh so the fixed-work run spends its budget
    # on accepted steps; the lam rail is disabled because fixed work means
    # fixed work.
    opts = SolverOptions(
        maxiter=ITERS, gtol=0.0, ftol=0.0, xtol=0.0, kkt_refine=0,
        lam0=3e-6, lam_max=1e30,
    )
    solve = make_gn_solver(prob, opts)

    t0 = time.perf_counter()
    compiled = solve.lower(z0, data).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(z0, data))          # warm-up run

    wall = wall_stats(lambda: compiled(z0, data), reps)

    # 15 cold iterations do NOT pin the weakly-identified parameters on
    # this landscape (that is the ladder's job); they must do real
    # optimization work: finite state, cost down >10x.
    z, stats = compiled(z0, data)
    p = np.asarray(z.p, dtype=np.float64)
    c0 = float(np.asarray(prob.cost(z0, data)))
    cn = float(np.asarray(stats.cost))
    ok = bool(np.all(np.isfinite(p))) and bool(
        np.all(np.isfinite(np.asarray(z.V)))) and cn < 0.1 * c0
    return {"compile_s": compile_s, "wall": wall,
            "memory": memory_summary(compiled), "cost0": c0, "cost": cn,
            "p": p.tolist(), "ok": ok}


def run_converged(elements, reps=REPS, coarsen=4, levels=3):
    """Time-to-solution: the warm-started multilevel ladder.

    Every level's solver is compiled (ahead of time) before timing.  The
    single-shot f32 solve is conditioning-limited at K ~ 10^4 (cond ~ K²,
    past the f32 Cholesky cliff); nested iteration converges each mesh and
    prolongs.  The inter-level prolongation is a jitted device op with
    static gather tables (ops.mesh.make_prolongation), so the timed region
    has no host interpolation or host round-trips.

    Returns a dict: compile_s (all levels), first_run_s, wall, p, p_err,
    level_split_s, memory (finest level), ok (p_err < P_ERR_TARGET).
    """
    import jax

    from baseline_cpu.run_baseline import TF, build_headline_problem
    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.ops.mesh import make_prolongation, uniform_mesh
    from collocfem_tpu.problem import Decision, EstimationProblem
    from collocfem_tpu.refine import CR_DW_CHAIN
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import make_gn_solver

    _, t_meas, y, _ = build_headline_problem(elements)

    if elements + 1 > CR_DW_CHAIN:
        # Past the f32 STATE-STORAGE cliff every plain-f32 level converges
        # to a stationary point of its own noise landscape.  Schedule: cold
        # f32 coarse -> SAME-mesh double-word-state polish -> fine level on
        # the full DW tier (state_dw + cr_dw steps + DW arrowhead
        # reductions).
        nc = max(2, elements // 16)
        schedule = [
            (nc, SolverOptions(maxiter=60, gtol=0.0, lam0=3e-6)),
            (nc, SolverOptions(maxiter=80, gtol=0.0, lam0=1e-9,
                               state_dw=True)),
            (elements, SolverOptions(maxiter=40, gtol=0.0, lam0=1e-9,
                                     method="cr_dw", state_dw=True)),
        ]
    else:
        ns = [max(2, int(np.ceil(elements / coarsen ** (levels - 1 - i))))
              for i in range(levels)]
        ns[-1] = elements
        # Cold coarse level starts at the productive damping; warm levels
        # start in the quadratic basin (lam ~ 0).  Termination: λ-railed
        # exit at the f32 progress floor (no tolerance tuning).
        schedule = [
            (n, SolverOptions(maxiter=60 if i == 0 else 30, gtol=0.0,
                              lam0=3e-6 if i == 0 else 1e-9))
            for i, n in enumerate(ns)
        ]

    lvls = []
    prev_mesh = None
    compile_s = 0.0
    for n, opts in schedule:
        mesh = uniform_mesh(0.0, TF, n, 4)
        prob = EstimationProblem.build(
            VanDerPol(), mesh, t_meas, defect_weight=100.0
        )
        u_nodes = np.sin(0.9 * mesh.elem_times)[..., None]
        data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
        z_shape = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
        t0 = time.perf_counter()
        solve = make_gn_solver(prob, opts).lower(z_shape, data).compile()
        prolong = None
        if prev_mesh is not None and prev_mesh.num_elements != n:
            prolong = jax.jit(make_prolongation(prev_mesh, mesh.node_times))
        compile_s += time.perf_counter() - t0
        lvls.append((prob, data, solve, prolong))
        if prev_mesh is None:
            z_cold = z_shape               # the cold guess: set-up, untimed
        prev_mesh = mesh

    def ladder(marks=None):
        z = None
        for prob, data, solve, prolong in lvls:
            if z is None:
                z0 = z_cold
            elif prolong is None:          # same-mesh polish level
                z0 = z
            else:
                z0 = Decision(V=prolong(z.V).astype(prob.dtype), p=z.p)
            z, stats = solve(z0, data)
            if marks is not None:          # per-level split (adds syncs)
                jax.block_until_ready(z)
                marks.append(time.perf_counter())
        return z, stats

    t0 = time.perf_counter()
    jax.block_until_ready(ladder())        # prolongation compiles + warm-up
    first_run_s = time.perf_counter() - t0

    wall = wall_stats(ladder, reps)
    marks = [time.perf_counter()]
    z, _ = ladder(marks)
    splits = np.diff(np.asarray(marks))
    p = np.asarray(z.p, dtype=np.float64)
    p_err = float(np.max(np.abs(p - P_TRUE)))
    return {"compile_s": compile_s, "first_run_s": first_run_s,
            "wall": wall, "p": p.tolist(), "p_err": p_err,
            "level_split_s": splits.tolist(),
            "memory": memory_summary(lvls[-1][2]),
            "ok": bool(np.isfinite(p_err)) and p_err < P_ERR_TARGET}


def _baseline_ref(elements):
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline_cpu", "results.json")
    if os.path.exists(base_path):
        with open(base_path) as fh:
            ref = json.load(fh)
        if ref.get("config", {}).get("elements") == elements:
            return ref
    return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from collocfem_tpu.utils.cache import enable_persistent_cache
    from collocfem_tpu.utils.device import card_line, require_gpu

    devs = require_gpu()
    card = card_line()
    print(f"platform={devs[0].platform} device_kind={devs[0].device_kind} "
          f"count={len(devs)} card=[{card}]", file=sys.stderr)
    enable_persistent_cache()

    fixed = run_fixed(ELEMENTS)
    print(f"[{card}] fixed-work N={ELEMENTS}: compile {fixed['compile_s']:.2f}"
          f" s, wall {fixed['wall']}, cost {fixed['cost0']:.3e} -> "
          f"{fixed['cost']:.3e}, p={fixed['p']}, memory {fixed['memory']}",
          file=sys.stderr)
    if not fixed["ok"]:
        raise SystemExit("fixed-work run did no useful work "
                         "(non-finite state or cost not down >10x)")
    ref = _baseline_ref(ELEMENTS)
    wall = fixed["wall"]["median_s"]
    out = {
        "metric": f"vdp_newton{ITERS}_{ELEMENTS}elem_wall",
        "value": wall,
        "unit": "s",
        "q1_s": fixed["wall"]["q1_s"],
        "q3_s": fixed["wall"]["q3_s"],
        "compile_s": fixed["compile_s"],
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
    }
    if ref is not None:
        out["vs_baseline"] = ref["newton_wall_s"] / wall

    if "--no-converged" not in argv:
        conv = run_converged(ELEMENTS)
        print(f"[{card}] converged ladder N={ELEMENTS}: compile "
              f"{conv['compile_s']:.2f} s, wall {conv['wall']}, p={conv['p']}"
              f", p-err {conv['p_err']:.3e}, level split "
              f"{conv['level_split_s']}", file=sys.stderr)
        if not conv["ok"]:
            raise SystemExit(f"converged ladder missed p-err < "
                             f"{P_ERR_TARGET}: {conv['p_err']:.3e}")
        out["converged_wall_s"] = conv["wall"]["median_s"]
        out["converged_p_err"] = conv["p_err"]
        if ref is not None and "converged_wall_s" in ref:
            out["converged_vs_baseline"] = (
                ref["converged_wall_s"] / conv["wall"]["median_s"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
