"""Config 2 — Duffing joint MAP state-path + parameter estimation, N=1k.

BASELINE.json configs[1]; SURVEY.md §3.2.  The truth is simulated as an SDE
(process noise on the acceleration), so the measured path is NOT an exact
ODE solution: the defect residuals act as the process-noise prior and the
state path at every collocation node is itself a MAP decision variable —
joint state-path + parameter estimation (the Automatica-2017 line of work
per SURVEY.md §0).  The KKT system is the large block-banded one; this is
the config that stresses the sparse solver.

Usage: python examples/duffing_joint.py [--platform cpu|gpu] [--plot]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples._common import make_parser, print_history, setup_jax

ALPHA, BETA, DELTA = 1.0, 5.0, 0.2      # truth
GAMMA, OMEGA = 8.0, 0.5                 # known forcing
TF, N_ELEMENTS, DEGREE = 20.0, 1000, 4
PROC_NOISE = 0.05                       # SDE diffusion on x2
MEAS_NOISE = 0.01


def simulate_sde(rng, tf, dt=1e-3):
    """Euler-Maruyama simulation of the noisy Duffing oscillator."""
    n = int(tf / dt)
    ts = np.linspace(0.0, tf, n + 1)
    x = np.zeros((n + 1, 2))
    x[0] = [1.0, 0.0]
    for i in range(n):
        t, (x1, x2) = ts[i], x[i]
        drift = np.array([
            x2,
            -DELTA * x2 - ALPHA * x1 - BETA * x1**3
            + GAMMA * np.cos(OMEGA * t),
        ])
        x[i + 1] = x[i] + dt * drift
        x[i + 1, 1] += PROC_NOISE * np.sqrt(dt) * rng.standard_normal()
    return ts, x


def main():
    ap = make_parser(__doc__)
    ap.add_argument("--elements", type=int, default=N_ELEMENTS)
    args = ap.parse_args()
    setup_jax(args)

    from collocfem_tpu.models import Duffing
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import HISTORY_COLS, make_gn_solver

    rng = np.random.default_rng(7)
    ts, xs = simulate_sde(rng, TF)
    t_meas = np.linspace(0.05, TF - 0.05, 2000)
    y = np.interp(t_meas, ts, xs[:, 0])[:, None]
    y += MEAS_NOISE * rng.standard_normal(y.shape)

    mesh = uniform_mesh(0.0, TF, args.elements, DEGREE)
    model = Duffing(gamma=GAMMA, omega=OMEGA)
    # MAP weighting: defects weighted by the process-noise information
    # 1/sigma_w, measurements by 1/sigma_v (SURVEY.md §3.2).
    prob = EstimationProblem.build(
        model, mesh, t_meas, defect_weight=1.0 / PROC_NOISE
    )
    data = prob.pack_data(
        y, t_meas, meas_weight=1.0 / MEAS_NOISE,
        p_prior=[0.0, 0.0, 0.0], p_weight=1e-3,
    )
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 1.0, 0.5])

    solve = make_gn_solver(
        prob, SolverOptions(maxiter=80, gtol=1e-6, xtol=1e-10)
    )
    z, stats = solve(z0, data)

    print_history(stats.history, HISTORY_COLS, stats.iterations)
    p = np.asarray(z.p)
    print(f"\nconverged={bool(stats.converged)} in {int(stats.iterations)} its")
    print(f"estimate  alpha={p[0]:.4f}  beta={p[1]:.4f}  delta={p[2]:.4f}")
    print(f"truth     alpha={ALPHA:.4f}  beta={BETA:.4f}  delta={DELTA:.4f}")

    if args.plot:
        import matplotlib.pyplot as plt

        tt = np.asarray(mesh.node_times)
        plt.plot(t_meas, y[:, 0], ".", ms=2, alpha=0.3, label="measured")
        plt.plot(tt, np.asarray(z.V)[:, 0], label="MAP x1 path")
        plt.legend(); plt.xlabel("t"); plt.show()


if __name__ == "__main__":
    main()
