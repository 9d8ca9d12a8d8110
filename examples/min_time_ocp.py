"""Minimum-time double-integrator transfer (free final time).

Free-final-time trajectory optimization on a STATIC normalized-time mesh
(collocfem_tpu.ocp_time): the horizon rides the parameter arrowhead as
tf = tf_ref·exp(θ) with a log-barrier bracket, so the same block-tridiagonal
AL/barrier solver used for fixed-horizon OCP (pendulum swing-up) handles the
problem unchanged.  Analytic optimum for rest-to-rest distance d with
|u| ≤ u_max: T* = 2·sqrt(d/u_max) (bang-bang).

Usage: python examples/min_time_ocp.py [--platform cpu|gpu] [--plot]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples._common import make_parser, setup_jax

DIST = 1.0
U_MAX = 1.0


def main():
    ap = make_parser(__doc__)
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from collocfem_tpu import free_time_ocp
    from collocfem_tpu.model import Model
    from collocfem_tpu.solve.auglag import ALBarrierOptions, solve_ocp

    class DoubleIntegrator(Model):
        nx, nu, nq, ng = 2, 1, 0, 2

        def f(self, x, u, p, t):
            return jnp.stack([x[1], u[0]])

        def g(self, x, u, p, t):
            return jnp.stack([u[0] - U_MAX, -u[0] - U_MAX])

    prob, ftm = free_time_ocp(
        DoubleIntegrator(), num_elements=16, degree=4,
        x0=[0.0, 0.0], xf=[DIST, 0.0], tf_ref=3.0, time_weight=1.0,
    )
    z, stats = solve_ocp(prob, options=ALBarrierOptions(n_outer=16))
    tf = float(ftm.final_time(z.p))
    t_star = 2.0 * np.sqrt(DIST / U_MAX)
    print(f"optimized final time tf = {tf:.5f}  (bang-bang optimum {t_star})")
    print(f"objective {float(stats.objective):.6f}  "
          f"max|c| {float(stats.cviol):.2e}  max g {float(stats.gviol):.2e}")

    if args.plot:
        import matplotlib.pyplot as plt

        s = np.asarray(prob.mesh.node_times)
        x = np.asarray(z.V[:, :2])
        u = np.asarray(z.V[:, 2])
        fig, axes = plt.subplots(3, 1, sharex=True)
        for i, name in enumerate(["position", "velocity"]):
            axes[i].plot(s * tf, x[:, i])
            axes[i].set_ylabel(name)
        axes[2].step(s * tf, u, where="mid")
        axes[2].axhline(U_MAX, color="r", ls=":")
        axes[2].axhline(-U_MAX, color="r", ls=":")
        axes[2].set_ylabel("u")
        axes[2].set_xlabel("t")
        plt.show()


if __name__ == "__main__":
    main()
