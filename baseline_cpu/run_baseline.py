"""Measure the CPU reference pipeline on the headline config and write
``baseline_cpu/results.json`` (consumed by bench.py's vs_baseline).

Headline config (BASELINE.json north_star): full Newton estimation on a
10k-element Van der Pol mesh.  Work is made deterministic by running a
fixed number of LM iterations (no early exit), so CPU and device timings
compare the same amount of assemble/factorize/solve work.

Usage: python -m baseline_cpu.run_baseline [--elements 10000] [--iters 15]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import time

import numpy as np
from scipy.integrate import solve_ivp

from baseline_cpu.pipeline import BaselineProblem, gauss_newton_baseline
from collocfem_tpu.ops.mesh import uniform_mesh

MU_TRUE, B_TRUE = 1.0, 1.0
TF = 10.0


def build_headline_problem(num_elements: int, degree: int = 4):
    """Shared by bench.py: same mesh/data/guess on CPU and device."""
    mesh = uniform_mesh(0.0, TF, num_elements, degree)
    t_meas = np.linspace(0.02, TF - 0.02, num_elements)
    sol = solve_ivp(
        lambda t, x: [
            x[1],
            MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0] + B_TRUE * np.sin(0.9 * t),
        ],
        (0, TF), [1.0, 0.0], rtol=1e-10, atol=1e-11, dense_output=True,
    )
    y = sol.sol(t_meas)[0][:, None]
    u_nodes = np.sin(0.9 * mesh.elem_times)[..., None]
    return mesh, t_meas, y, u_nodes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=10000)
    ap.add_argument("--iters", type=int, default=15)
    args = ap.parse_args()

    mesh, t_meas, y, u_nodes = build_headline_problem(args.elements)
    base = BaselineProblem.build(mesh, t_meas, y, u_nodes, defect_weight=100.0)
    V0 = np.zeros((mesh.num_nodes, 2))
    V0[:, 0] = np.interp(mesh.node_times, t_meas, y[:, 0])

    # Residual+Jacobian evaluation throughput (collocation points / s).
    p0 = np.array([0.5, 0.5])
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        base.residuals(V0, p0)
        base.jacobian(V0, p0)
    eval_s = (time.perf_counter() - t0) / reps
    points_per_s = mesh.num_elements * mesh.degree / eval_s

    # Fixed-work Newton solve (gtol=0/xtol=0: always runs --iters LM steps).
    t0 = time.perf_counter()
    V, p, info = gauss_newton_baseline(
        base, V0, p0, maxiter=args.iters, gtol=0.0, xtol=0.0
    )
    wall = time.perf_counter() - t0

    # Converged (time-to-solution) solve: early exit on gradient/step
    # tolerances, from the same cold start — the honest counterpart of the
    # device converged ladder (bench.py converged mode, north_star's "full
    # Newton ESTIMATION" sentence).
    t0 = time.perf_counter()
    Vc, pc, infoc = gauss_newton_baseline(
        base, V0, p0, maxiter=50, gtol=1e-10, xtol=1e-12
    )
    conv_wall = time.perf_counter() - t0
    conv_err = float(np.max(np.abs(pc - np.array([MU_TRUE, B_TRUE]))))

    out = {
        "config": {
            "model": "vdp", "elements": args.elements, "degree": 4,
            "iters": args.iters, "defect_weight": 100.0, "dtype": "float64",
        },
        "newton_wall_s": wall,
        "resjac_evals_points_per_s": points_per_s,
        "final_cost": float(info["cost"]),
        "iterations": info["iterations"],
        "p_estimate": [float(v) for v in p],
        "converged_wall_s": conv_wall,
        "converged_iterations": infoc["iterations"],
        "converged_p_err": conv_err,
        "converged_p": [float(v) for v in pc],
        "machine": platform.processor() or platform.machine(),
        "backend": "scipy-SuperLU",
    }
    path = os.path.join(os.path.dirname(__file__), "results.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
