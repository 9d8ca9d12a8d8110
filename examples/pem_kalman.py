"""Kalman-stack workflow: PEM (ML) estimation + smoother warm starts.

The reference lineage's filtering companion to the collocation estimators
(SURVEY.md §0 [R]: the ceacoest line ships a `kalman` module used both as
an estimator and to initialize joint MAP problems).  Three stages on the
noisy Duffing oscillator:

  1. PEM: maximize the innovations likelihood of a CD-EKF over the model
     parameters (L-BFGS on the differentiable NLL — no collocation mesh).
  2. Smoother: run the CD-EKF/UKF + RTS pass at the PEM estimate.
  3. MAP: hand the smoothed state path to the joint collocation problem
     as its warm start and polish with Gauss-Newton; report parameter
     standard errors from the GN Fisher matrix.

Usage: python examples/pem_kalman.py [--platform cpu|gpu] [--plot]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples._common import make_parser, setup_jax

ALPHA, BETA, DELTA = 1.0, 5.0, 0.2      # truth
GAMMA, OMEGA = 8.0, 0.5                 # known forcing
TF = 20.0
PROC_NOISE = 0.05
MEAS_NOISE = 0.01


def simulate_sde(rng, tf, dt=1e-3):
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
    ap.add_argument("--elements", type=int, default=200)
    args = ap.parse_args()
    jax = setup_jax(args)
    import jax.numpy as jnp

    from collocfem_tpu.kalman import (
        cd_smoother, ekf_filter, make_ekf_nll, run_lbfgs,
        smoother_initial_guess,
    )
    from collocfem_tpu.models import Duffing
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.covariance import parameter_std
    from collocfem_tpu.solve.newton import make_gn_solver

    rng = np.random.default_rng(11)
    ts, xs = simulate_sde(rng, TF)
    t_meas = np.linspace(0.05, TF - 0.05, 400)
    y = np.interp(t_meas, ts, xs[:, 0])[:, None]
    y += MEAS_NOISE * rng.standard_normal(y.shape)

    model = Duffing(gamma=GAMMA, omega=OMEGA)
    R = np.array([[MEAS_NOISE**2]])
    Qc = np.diag([1e-8, PROC_NOISE**2])
    m0 = np.array([float(y[0, 0]), 0.0])
    P0 = np.diag([0.1, 4.0])

    # --- 1. PEM: ML estimation from EKF innovations -----------------------
    nll = make_ekf_nll(model, t_meas, y, R, Qc, m0, P0, substeps=4)
    p0 = jnp.array([0.5, 1.0, 0.5])
    p_pem, (val, gnorm, it) = run_lbfgs(jax.jit(nll), p0, maxiter=150)
    p_pem_np = np.asarray(p_pem)
    print(f"PEM (EKF innovations ML), {int(it)} L-BFGS iterations, "
          f"NLL {float(val):.2f}:")
    print(f"  alpha={p_pem_np[0]:.4f}  beta={p_pem_np[1]:.4f}  "
          f"delta={p_pem_np[2]:.4f}")

    # --- 2. Smoothed state path at the PEM estimate -----------------------
    res = ekf_filter(model, p_pem, t_meas, y, R, Qc, m0, P0, substeps=4)
    ms, Ps = cd_smoother(res)
    rms2 = float(np.sqrt(np.mean(
        (np.asarray(ms)[:, 1] - np.interp(t_meas, ts, xs[:, 1])) ** 2)))
    print(f"smoothed x2 (unmeasured) RMS error: {rms2:.4f}")

    # --- 3. Joint MAP collocation polish from the smoothed path -----------
    mesh = uniform_mesh(0.0, TF, args.elements, 4)
    prob = EstimationProblem.build(
        model, mesh, t_meas, defect_weight=1.0 / PROC_NOISE)
    data = prob.pack_data(y, t_meas, meas_weight=1.0 / MEAS_NOISE,
                          p_prior=[0.0, 0.0, 0.0], p_weight=1e-3)
    z0 = smoother_initial_guess(prob, t_meas, y, p_pem_np, R=R, Qc=Qc,
                                m0=m0, P0=P0)
    z_cold = prob.initial_guess_from_data(t_meas, y, p0=np.asarray(p0))
    print(f"initial cost: smoother start {float(prob.cost(z0, data)):.4e} "
          f"vs data-interp start {float(prob.cost(z_cold, data)):.4e}")

    solve = make_gn_solver(prob, SolverOptions(maxiter=60, gtol=1e-6,
                                               xtol=1e-10))
    z, stats = solve(z0, data)
    p = np.asarray(z.p)
    sd = np.asarray(parameter_std(prob, z, data))
    print(f"\nMAP polish: converged={bool(stats.converged)} "
          f"in {int(stats.iterations)} iterations")
    for name, val_i, sd_i, truth in zip(
            ["alpha", "beta", "delta"], p, sd, [ALPHA, BETA, DELTA]):
        print(f"  {name:>6} = {val_i:8.4f} +- {sd_i:.4f}   (truth {truth})")

    if args.plot:
        import matplotlib.pyplot as plt

        plt.plot(t_meas, np.interp(t_meas, ts, xs[:, 1]), label="true x2")
        plt.plot(t_meas, np.asarray(ms)[:, 1], label="smoothed x2")
        plt.legend(); plt.xlabel("t"); plt.show()


if __name__ == "__main__":
    main()
