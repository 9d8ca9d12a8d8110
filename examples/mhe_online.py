"""Online moving-horizon estimation of a Van der Pol oscillator.

Serving-style workflow on top of the batch collocation machinery
(collocfem_tpu.mhe): a stream of noisy position measurements arrives one
sample at a time; each `mhe.step` runs ONE jitted program (EKF arrival-cost
update + sliding-window MAP solve) and emits the newest-state estimate.
The reference has no online estimator (SURVEY.md §2) — this is the rebuild's
extension for deployment use.

Usage: python examples/mhe_online.py [--platform cpu|gpu] [--plot]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples._common import make_parser, setup_jax

DT = 0.05
HORIZON = 12
SIG_V = 0.02     # measurement noise std
SIG_W = 0.5      # assumed process-noise density
T_TOTAL = 12.0
MU_TRUE = [1.0, 1.0]


def main():
    ap = make_parser(__doc__)
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from collocfem_tpu.mhe import MovingHorizonEstimator
    from collocfem_tpu.models.vdp import VanDerPol
    from collocfem_tpu.solve.newton import SolverOptions
    from collocfem_tpu.utils.simulate import rk4_trajectory

    rng = np.random.default_rng(0)
    n = int(T_TOTAL / DT)
    ts = np.arange(n) * DT
    model = VanDerPol()
    xs = np.asarray(
        rk4_trajectory(
            model.f, jnp.asarray([2.0, 0.0]), jnp.asarray(ts),
            u_fn=lambda t: jnp.zeros((1,)), p=jnp.asarray(MU_TRUE),
        )
    )
    ys = xs[:, :1] + SIG_V * rng.standard_normal((n, 1))

    mhe = MovingHorizonEstimator(
        model, horizon=HORIZON, dt=DT, sig_w=SIG_W, sig_v=SIG_V,
        degree=3, p_fixed=np.asarray(MU_TRUE),
        options=SolverOptions(maxiter=20, gtol=1e-9),
    )
    state = mhe.init(ys[:HORIZON], m0=np.array([1.5, 0.5]), P0=np.eye(2))

    ests = [np.asarray(mhe.estimate(state))]
    for k in range(HORIZON, n):
        state, est = mhe.step(state, ys[k])
        ests.append(np.asarray(est))
    ests = np.asarray(ests)
    truth = xs[HORIZON - 1 : n]
    rmse = np.sqrt(((ests - truth) ** 2).mean(axis=0))
    cov = np.asarray(mhe.current_covariance(state))
    print(f"processed {n - HORIZON + 1} online samples "
          f"(window={HORIZON}, dt={DT})")
    print(f"state RMSE vs truth: position {rmse[0]:.4f}  "
          f"velocity {rmse[1]:.4f}  (meas noise {SIG_V})")
    print(f"posterior std at newest sample: {np.sqrt(np.diag(cov))}")

    if args.plot:
        import matplotlib.pyplot as plt

        tt = ts[HORIZON - 1 : n]
        fig, axes = plt.subplots(2, 1, sharex=True)
        for i, name in enumerate(["position", "velocity"]):
            axes[i].plot(tt, truth[:, i], "k-", label="truth")
            axes[i].plot(tt, ests[:, i], "C0--", label="MHE")
            axes[i].set_ylabel(name)
        axes[0].plot(ts, ys[:, 0], "r.", ms=2, alpha=0.4, label="meas")
        axes[0].legend()
        axes[1].set_xlabel("t")
        plt.show()


if __name__ == "__main__":
    main()
