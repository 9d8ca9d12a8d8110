"""Config 1 — Van der Pol parameter estimation, LGL collocation, N=100.

BASELINE.json configs[0].  Simulates a forced Van der Pol oscillator with
known parameters, adds measurement noise, and recovers [mu, b] by damped
Gauss-Newton on the collocation least-squares problem — the whole solve is
one jitted on-device loop.

Usage: python examples/vdp_estimation.py [--platform cpu|gpu] [--plot]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from scipy.integrate import solve_ivp

from examples._common import make_parser, print_history, setup_jax

MU_TRUE, B_TRUE = 1.0, 1.0
TF, N_ELEMENTS, DEGREE = 10.0, 100, 4
NOISE = 0.02


def main():
    ap = make_parser(__doc__)
    ap.add_argument("--elements", type=int, default=N_ELEMENTS)
    args = ap.parse_args()
    setup_jax(args)

    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import HISTORY_COLS, make_gn_solver

    # Simulate truth + noisy position measurements.
    rng = np.random.default_rng(0)
    t_meas = np.linspace(0.05, TF - 0.05, 200)
    sol = solve_ivp(
        lambda t, x: [
            x[1],
            MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0] + B_TRUE * np.sin(0.9 * t),
        ],
        (0, TF), [1.0, 0.0], rtol=1e-10, atol=1e-11, dense_output=True,
    )
    y = sol.sol(t_meas)[0][:, None] + NOISE * rng.standard_normal(
        (t_meas.size, 1)
    )

    mesh = uniform_mesh(0.0, TF, args.elements, DEGREE)
    prob = EstimationProblem.build(
        VanDerPol(), mesh, t_meas, defect_weight=100.0
    )
    u_nodes = np.sin(0.9 * mesh.elem_times)[..., None]
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes, meas_weight=1.0 / NOISE)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.3, 0.3])

    solve = make_gn_solver(
        prob, SolverOptions(maxiter=50, gtol=1e-8, xtol=1e-12)
    )
    z, stats = solve(z0, data)

    print_history(stats.history, HISTORY_COLS, stats.iterations)
    p = np.asarray(z.p)
    print(f"\nconverged={bool(stats.converged)} in {int(stats.iterations)} its")
    from collocfem_tpu.solve import parameter_std, state_std

    p_sd = np.asarray(parameter_std(prob, z, data))
    print(f"estimate  mu={p[0]:.6f} +- {p_sd[0]:.6f}  "
          f"b={p[1]:.6f} +- {p_sd[1]:.6f}")
    print(f"truth     mu={MU_TRUE:.6f}  b={B_TRUE:.6f}")
    sd = np.asarray(state_std(prob, z, data))
    print(f"state band (x1): max +-{sd[:, 0].max():.4f}, "
          f"median +-{np.median(sd[:, 0]):.4f}")

    if args.plot:
        import matplotlib.pyplot as plt

        tt = np.asarray(mesh.node_times)
        x1 = np.asarray(z.V)[:, 0]
        plt.plot(t_meas, y[:, 0], ".", label="measured", alpha=0.4)
        plt.plot(tt, x1, label="estimated x1")
        plt.fill_between(tt, x1 - 2 * sd[:, 0], x1 + 2 * sd[:, 0],
                         alpha=0.25, label="+-2 sd band")
        plt.plot(tt, sol.sol(tt)[0], "--", label="true x1")
        plt.legend(); plt.xlabel("t"); plt.show()


if __name__ == "__main__":
    main()
