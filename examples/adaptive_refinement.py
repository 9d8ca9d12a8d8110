"""Adaptive mesh refinement: VdP estimation with defect-driven h-refinement.

Demonstrates the mesh-refinement + warm-start workflow (SURVEY.md §5): solve
on a coarse uniform mesh, concentrate elements where the collocation
polynomial violates the ODE between nodes, interpolate the previous solution
onto the refined mesh, and re-solve.

Usage: python examples/adaptive_refinement.py [--platform cpu|gpu]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples._common import make_parser, setup_jax

MU, B, TF = 2.0, 0.0, 8.0


def main():
    ap = make_parser(__doc__)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    setup_jax(args)
    import jax.numpy as jnp

    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.refine import estimate_adaptive
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.utils import rk4_trajectory

    model = VanDerPol()
    ts = np.linspace(0.0, TF, 20001)
    xs = rk4_trajectory(
        model.f, jnp.asarray([2.0, 0.0]), ts,
        u_fn=lambda t: jnp.zeros(1), p=jnp.asarray([MU, B]),
    )
    t_meas = np.linspace(0.02, TF - 0.02, 200)
    y = np.interp(t_meas, ts, np.asarray(xs[:, 0]))[:, None]

    mesh0 = uniform_mesh(0.0, TF, 24, 4)
    prob, z, stats, history = estimate_adaptive(
        model, mesh0, t_meas, y, p0=[1.0, 0.0],
        rounds=args.rounds, growth=1.6, defect_weight=300.0,
        options=SolverOptions(maxiter=80, gtol=1e-8, xtol=1e-10),
    )
    print(f"{'round':>5} {'elements':>9} {'mu est':>10} {'indicator':>11} "
          f"{'w_max/w_min':>12}")
    for i, (m, p, ind) in enumerate(history):
        w = m.widths
        print(f"{i:>5} {m.num_elements:>9} {p[0]:>10.6f} {ind:>11.3e} "
              f"{w.max() / w.min():>12.1f}")
    print(f"\ntruth mu = {MU}")

    if args.plot:
        import matplotlib.pyplot as plt

        m = history[-1][0]
        plt.plot(m.breakpoints[:-1], m.widths, drawstyle="steps-post")
        plt.xlabel("t"); plt.ylabel("element width"); plt.show()


if __name__ == "__main__":
    main()
