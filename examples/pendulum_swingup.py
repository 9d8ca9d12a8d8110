"""Config 3 — Pendulum swing-up trajectory optimization with path constraints.

BASELINE.json configs[2]; SURVEY.md §3.3.  Torque-limited swing-up from
hanging (theta=0) to upright (theta=pi) minimizing integrated torque^2,
|u| <= u_max enforced at every collocation node.  The reference lineage
hands this to IPOPT (C++ callbacks); here the augmented-Lagrangian +
log-barrier Gauss-Newton solve is one jitted on-device program.

Usage: python examples/pendulum_swingup.py [--platform cpu|gpu] [--plot]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples._common import make_parser, print_history, setup_jax

TF, N_ELEMENTS, DEGREE = 2.5, 25, 4
U_MAX = 2.0


def main():
    ap = make_parser(__doc__)
    ap.add_argument("--elements", type=int, default=N_ELEMENTS)
    ap.add_argument("--u-max", type=float, default=U_MAX)
    args = ap.parse_args()
    setup_jax(args)

    from collocfem_tpu.models import Pendulum
    from collocfem_tpu.ocp import OptimalControlProblem
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.solve.auglag import (
        ALBarrierOptions,
        OUTER_HISTORY_COLS,
        make_ocp_solver,
    )

    model = Pendulum(m=1.0, l=0.5, grav=9.81, u_max=args.u_max)
    mesh = uniform_mesh(0.0, TF, args.elements, DEGREE)
    prob = OptimalControlProblem.build(
        model, mesh, x0=[0.0, 0.0], xf=[np.pi, 0.0]
    )
    solve = make_ocp_solver(prob, ALBarrierOptions())
    z, stats = solve(prob.initial_guess())

    print_history(stats.history, OUTER_HISTORY_COLS, stats.history.shape[0])
    x, u = prob.split(z.V)
    x, u = np.asarray(x), np.asarray(u)
    print(f"\nobjective (0.5 int u^2 dt) = {float(stats.objective):.6f}")
    print(f"equality violation         = {float(stats.cviol):.2e}")
    print(f"max path constraint        = {float(stats.gviol):.2e} (<= 0 ok)")
    print(f"theta(tf)={x[-1, 0]:.8f} (pi={np.pi:.8f})  w(tf)={x[-1, 1]:.2e}")
    print(f"torque range [{u.min():.4f}, {u.max():.4f}]  (limit {args.u_max})")

    if args.plot:
        import matplotlib.pyplot as plt

        tt = np.asarray(mesh.node_times)
        _, axs = plt.subplots(2, 1, sharex=True)
        axs[0].plot(tt, x[:, 0], label="theta")
        axs[0].plot(tt, x[:, 1], label="omega")
        axs[0].axhline(np.pi, ls="--", c="gray"); axs[0].legend()
        axs[1].plot(tt, u[:, 0], label="torque")
        for s in (-args.u_max, args.u_max):
            axs[1].axhline(s, ls="--", c="r")
        axs[1].legend(); axs[1].set_xlabel("t")
        plt.show()


if __name__ == "__main__":
    main()
