"""Config 5 — Batched multi-experiment estimation: 1024 vmapped trajectories.

BASELINE.json configs[4]; SURVEY.md §3.5.  1024 Van der Pol experiments with
different initial conditions and forcing frequencies share one parameter
vector; every per-experiment Gauss-Newton system is assembled and solved
batched (vmap), coupled only through the tiny shared-parameter Schur
complement.  The reference loops over experiments in one Python process —
here one batched solve replaces that loop.  With ``--devices dp`` the
batch is additionally sharded over a data-parallel device mesh axis
(a psum per iteration is the only cross-device traffic).

Usage: python examples/batched_multi_experiment.py
         [--platform cpu|gpu] [--experiments 1024] [--elements 10]
         [--devices 1]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples._common import make_parser, print_history, setup_jax

MU_TRUE, B_TRUE = 1.3, 0.5
TF, DEGREE = 8.0, 4


def main():
    ap = make_parser(__doc__)
    ap.add_argument("--experiments", type=int, default=1024)
    ap.add_argument("--elements", type=int, default=10)
    ap.add_argument("--devices", type=int, default=1,
                    help="shard experiments over this many devices (dp axis)")
    args = ap.parse_args()
    if args.devices > 1 and args.platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.devices}"
            ).strip()
    jax = setup_jax(args)
    import jax.numpy as jnp

    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.ops.mesh import interpolate_trajectory, uniform_mesh
    from collocfem_tpu.parallel.batch import (
        BatchDecision,
        make_multi_experiment_solver,
    )
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import HISTORY_COLS

    n_exp = args.experiments
    mesh = uniform_mesh(0.0, TF, args.elements, DEGREE)
    t_meas = np.linspace(0.05, TF - 0.05, 8 * args.elements)
    model = VanDerPol()
    prob = EstimationProblem.build(model, mesh, t_meas, defect_weight=300.0)

    # Synthesize all experiments at once with a fine batched RK4 (host numpy).
    rng = np.random.default_rng(1)
    x0s = rng.uniform(-2, 2, size=(n_exp, 2))
    freqs = rng.uniform(0.6, 1.4, size=n_exp)

    def rk4_batch(x0, freqs, tt):
        dt = tt[1] - tt[0]
        out = np.empty((tt.size,) + x0.shape)
        out[0] = x = x0.copy()
        def f(x, t):
            u = np.sin(freqs * t)
            return np.stack(
                [x[:, 1],
                 MU_TRUE * (1 - x[:, 0] ** 2) * x[:, 1] - x[:, 0] + B_TRUE * u],
                axis=1,
            )
        for i in range(tt.size - 1):
            t = tt[i]
            k1 = f(x, t); k2 = f(x + 0.5 * dt * k1, t + 0.5 * dt)
            k3 = f(x + 0.5 * dt * k2, t + 0.5 * dt); k4 = f(x + dt * k3, t + dt)
            x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            out[i + 1] = x
        return out

    tt_fine = np.linspace(0.0, TF, 4001)
    paths = rk4_batch(x0s, freqs, tt_fine)          # (T, n_exp, 2)
    y_all = np.empty((n_exp, t_meas.size, 1))
    for e in range(n_exp):
        y_all[e, :, 0] = np.interp(t_meas, tt_fine, paths[:, e, 0])
    y_all += 0.01 * rng.standard_normal(y_all.shape)

    datas, v0s = [], []
    for e in range(n_exp):
        u_nodes = np.sin(freqs[e] * mesh.elem_times)[..., None]
        datas.append(prob.pack_data(y_all[e], t_meas, u_nodes=u_nodes,
                                    meas_weight=100.0))
        v0s.append(
            prob.initial_guess_from_data(t_meas, y_all[e], p0=[0, 0]).V
        )
    data_batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)
    z0 = BatchDecision(V=jnp.stack(v0s), p=jnp.asarray([2.0, 0.2], prob.dtype))
    p_prior = jnp.zeros(2, prob.dtype)
    p_w = jnp.full((2,), 1e-3, prob.dtype)

    opts = SolverOptions(maxiter=60, gtol=1e-6, xtol=1e-9)
    if args.devices > 1:
        from jax.sharding import PartitionSpec as P

        from collocfem_tpu.parallel.meshes import DP_AXIS, make_device_mesh
        from collocfem_tpu.solve.newton import SolveStats

        dev_mesh = make_device_mesh(dp=args.devices, sp=1)
        inner = make_multi_experiment_solver(prob, opts, dp_axis=DP_AXIS)
        solve = jax.jit(jax.shard_map(
            inner, mesh=dev_mesh,
            in_specs=(
                BatchDecision(V=P(DP_AXIS), p=P()),
                jax.tree_util.tree_map(lambda _: P(DP_AXIS), data_batch),
                P(), P(),
            ),
            out_specs=(BatchDecision(V=P(DP_AXIS), p=P()),
                       SolveStats(*([P()] * 6))),
        ))
    else:
        solve = make_multi_experiment_solver(prob, opts)

    import time

    z, stats = solve(z0, data_batch, p_prior, p_w)   # compile + solve
    jax.block_until_ready(z)
    t0 = time.perf_counter()
    z, stats = solve(z0, data_batch, p_prior, p_w)
    jax.block_until_ready(z)
    wall = time.perf_counter() - t0

    print_history(stats.history, HISTORY_COLS, stats.iterations)
    p = np.asarray(z.p)
    total_elems = n_exp * args.elements
    print(f"\n{n_exp} experiments x {args.elements} elements "
          f"= {total_elems} total elements, {args.devices} device(s)")
    print(f"converged={bool(stats.converged)} in {int(stats.iterations)} its, "
          f"solve wall {wall:.3f} s (post-compile)")
    print(f"shared estimate  mu={p[0]:.5f}  b={p[1]:.5f}")
    print(f"truth            mu={MU_TRUE:.5f}  b={B_TRUE:.5f}")


if __name__ == "__main__":
    main()
