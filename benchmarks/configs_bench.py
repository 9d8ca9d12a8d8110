"""GPU wall-clock for BASELINE.json configs 2-5.

One JSON line per config:
  {"config": "...", "wall_s": ..., "detail": {...}}

Measured quantity per config (compile excluded, median of --reps, each rep
bounded by ``jax.block_until_ready`` on its result — bench.wall_stats):

  2. Duffing joint MAP, N=1000 x degree 4: one full LM estimation
     (time to the λ-rail stall, maxiter=40).
  3. Pendulum swing-up OCP (25 elements): the full AL + barrier solve
     (14 outer stages).
  4. Aircraft output-error, N=200: full LM estimation (maxiter=40).
  5. Batched multi-experiment: --experiments x 10-element shared-parameter
     LM (maxiter=15 fixed work).

Needs a GPU.  Exits non-zero when any config fails.

Usage: python benchmarks/configs_bench.py [--configs 2,3,4,5]
         [--experiments 1024] [--reps 5]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def _bench(solve, args_, reps):
    """(median wall, compile + first-run seconds, output) of solve(*args_)."""
    import jax

    from bench import wall_stats

    t0 = time.perf_counter()
    out = jax.block_until_ready(solve(*args_))
    compile_s = time.perf_counter() - t0
    wall = wall_stats(lambda: solve(*args_), reps)
    return wall["median_s"], compile_s, out


def config2_duffing(reps):
    import jax.numpy as jnp

    from collocfem_tpu.models import Duffing
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import make_gn_solver

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    from duffing_joint import (ALPHA, BETA, DELTA, GAMMA, MEAS_NOISE, OMEGA,
                               PROC_NOISE, TF, simulate_sde)

    rng = np.random.default_rng(7)
    ts, xs = simulate_sde(rng, TF)
    t_meas = np.linspace(0.05, TF - 0.05, 2000)
    y = np.interp(t_meas, ts, xs[:, 0])[:, None]
    y += MEAS_NOISE * rng.standard_normal(y.shape)
    mesh = uniform_mesh(0.0, TF, 1000, 4)
    prob = EstimationProblem.build(
        Duffing(gamma=GAMMA, omega=OMEGA), mesh, t_meas,
        defect_weight=1.0 / PROC_NOISE,
    )
    data = prob.pack_data(y, t_meas, meas_weight=1.0 / MEAS_NOISE,
                          p_prior=[0.0, 0.0, 0.0], p_weight=1e-3)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 1.0, 0.5])
    # Time-to-quality protocol on BOTH sides (round-4 verdict item 4): the
    # CPU counterpart's Levenberg loop stalls at its own no-acceptable-step
    # criterion; here the λ-rail exit is the same notion of "no further
    # progress at working precision".  Both sides report their actual
    # iteration counts and the SAME noise-limited p_rel_err (~0.098).
    solve = make_gn_solver(
        prob, SolverOptions(maxiter=40, gtol=0.0, lam0=1e-6)
    )
    wall, compile_s, (z, stats) = _bench(solve, (z0, data), reps)
    p = np.asarray(z.p)
    return wall, compile_s, {
        "elements": 1000, "iters": int(stats.iterations),
        "p_rel_err": float(np.max(np.abs(
            p / np.array([ALPHA, BETA, DELTA]) - 1.0))),
    }


def config3_pendulum(reps):
    from collocfem_tpu.models import Pendulum
    from collocfem_tpu.ocp import OptimalControlProblem
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.solve.auglag import ALBarrierOptions, make_ocp_solver

    model = Pendulum(m=1.0, l=0.5, grav=9.81, u_max=2.0)
    mesh = uniform_mesh(0.0, 2.5, 25, 4)
    prob = OptimalControlProblem.build(
        model, mesh, x0=[0.0, 0.0], xf=[np.pi, 0.0]
    )
    solve = make_ocp_solver(prob, ALBarrierOptions())
    z0 = prob.initial_guess()
    wall, compile_s, (z, stats) = _bench(solve, (z0,), reps)
    return wall, compile_s, {
        "elements": 25, "outer": 14,
        "objective": float(stats.objective),
        "cviol": float(stats.cviol),
    }


def config3_large(reps, elements=500):
    """Swing-up at N >= 500 elements: the constrained stack's scaling
    benchmark.  Same continuous problem as config 3, solved cold."""
    from collocfem_tpu.models import Pendulum
    from collocfem_tpu.ocp import OptimalControlProblem
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.solve.auglag import ALBarrierOptions, make_ocp_solver

    model = Pendulum(m=1.0, l=0.5, grav=9.81, u_max=2.0)
    mesh = uniform_mesh(0.0, 2.5, elements, 4)
    prob = OptimalControlProblem.build(
        model, mesh, x0=[0.0, 0.0], xf=[np.pi, 0.0]
    )
    solve = make_ocp_solver(prob, ALBarrierOptions())
    z0 = prob.initial_guess()
    wall, compile_s, (z, stats) = _bench(solve, (z0,), reps)
    return wall, compile_s, {
        "elements": elements, "outer": 14,
        "objective": float(stats.objective),
        "cviol": float(stats.cviol),
    }


def config4_aircraft(reps):
    from collocfem_tpu.models import AircraftLongitudinal
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import make_gn_solver
    from collocfem_tpu.utils.io import load_measurements

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                        "aircraft_doublet.csv")
    t_meas, vals = load_measurements(path)
    y, u_rec = vals[:, :3], vals[:, 3]
    NOISE = np.array([0.002, 0.005, 0.05])
    mesh = uniform_mesh(0.0, 8.0, 200, 4)
    prob = EstimationProblem.build(
        AircraftLongitudinal(V=60.0, g0=9.81), mesh, t_meas,
        defect_weight=1e4,
    )
    u_nodes = np.interp(mesh.elem_times, t_meas, u_rec)[..., None]
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes, meas_weight=1.0 / NOISE)
    z0 = prob.initial_guess_from_data(
        t_meas, y[:, :2], p0=[-1.0, -5.0, -1.0, -0.1, -5.0]
    )
    solve = make_gn_solver(
        prob, SolverOptions(maxiter=40, gtol=0.0, lam0=1e-6, lam_max=1e30)
    )
    wall, compile_s, (z, stats) = _bench(solve, (z0, data), reps)
    P_TRUE = np.array([-1.2, -8.0, -2.5, -0.15, -12.0])
    return wall, compile_s, {
        "elements": 200, "iters": 40,
        "p_rel_err": float(np.max(np.abs(np.asarray(z.p) / P_TRUE - 1.0))),
    }


def config5_batched(reps, n_exp, elements=10, layout="auto"):
    import jax
    import jax.numpy as jnp

    from baseline_cpu.configs_baseline import (C5_B_TRUE, C5_MU_TRUE,
                                               make_config5_data)
    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.parallel.batch import (BatchDecision,
                                              make_multi_experiment_solver)
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions

    MU_TRUE, B_TRUE = C5_MU_TRUE, C5_B_TRUE
    # Shared generator => the CPU counterpart (baseline_cpu.configs_baseline
    # run_config5) measures the IDENTICAL data and initial guess.
    mesh, t_meas, y_all, u_nodes_all = make_config5_data(n_exp, elements)
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=300.0)

    datas, v0s = [], []
    for e in range(n_exp):
        datas.append(prob.pack_data(y_all[e], t_meas,
                                    u_nodes=u_nodes_all[e],
                                    meas_weight=100.0))
        v0s.append(prob.initial_guess_from_data(t_meas, y_all[e],
                                                p0=[0, 0]).V)
    data_batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)
    z0 = BatchDecision(V=jnp.stack(v0s),
                       p=jnp.asarray([2.0, 0.2], prob.dtype))
    p_prior = jnp.zeros(2, prob.dtype)
    p_w = jnp.full((2,), 1e-3, prob.dtype)
    solve = make_multi_experiment_solver(
        prob, SolverOptions(maxiter=15, gtol=0.0, lam0=1e-6, lam_max=1e30),
        layout=layout,
    )
    wall, compile_s, (z, stats) = _bench(
        solve, (z0, data_batch, p_prior, p_w), reps)
    p = np.asarray(z.p)
    return wall, compile_s, {
        "experiments": n_exp, "elements_each": elements, "iters": 15,
        "total_elements": n_exp * elements, "layout": layout,
        "p_rel_err": float(np.max(np.abs(
            p / np.array([MU_TRUE, B_TRUE]) - 1.0))),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="2,3,4,5")
    ap.add_argument("--experiments", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--c5-layout", default="auto",
                    help="config 5 pipeline: auto|soa|blocks (before/after "
                    "for the batched-SoA-assembly change)")
    args = ap.parse_args()

    from collocfem_tpu.utils.cache import enable_persistent_cache
    from collocfem_tpu.utils.device import card_line, require_gpu

    devs = require_gpu()
    print(f"card: {card_line()}", file=sys.stderr)
    enable_persistent_cache()
    kind = devs[0].device_kind
    runners = {
        "2": ("duffing_joint_n1000", lambda: config2_duffing(args.reps)),
        "3": ("pendulum_swingup_ocp", lambda: config3_pendulum(args.reps)),
        "3L": ("pendulum_swingup_ocp_n500",
               lambda: config3_large(args.reps)),
        "4": ("aircraft_oe_n200", lambda: config4_aircraft(args.reps)),
        "5": (f"batched_{args.experiments}exp",
              lambda: config5_batched(args.reps, args.experiments,
                                      layout=args.c5_layout)),
    }
    failed = []
    for key in args.configs.split(","):
        name, fn = runners[key.strip()]
        try:
            wall, compile_s, detail = fn()
        except Exception as e:  # report every config, then fail the run
            print(json.dumps({"config": name, "error": str(e)[:300]}),
                  flush=True)
            failed.append(name)
            continue
        print(json.dumps({
            "config": name, "device_kind": kind,
            "wall_s": wall, "compile_s": compile_s, "detail": detail,
        }), flush=True)
    if failed:
        raise SystemExit(f"configs failed: {failed}")


if __name__ == "__main__":
    main()
