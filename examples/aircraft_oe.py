"""Config 4 — Aircraft longitudinal output-error estimation from flight data.

BASELINE.json configs[3]; SURVEY.md §3.4.  Short-period output-error
identification: elevator doublet input, measured [alpha, q, az] channels
with realistic per-channel noise, unknown dimensional derivatives
p = [Z_a, M_a, M_q, Z_d, M_d].  Flight-test data is synthesized with a
fixed seed (zero-egress environment; SURVEY.md §0) through the same
measurement map used for estimation.  Per-channel weights come from the
assumed measurement covariance — the output-error method — and the state
path is pinned to the dynamics by a stiff defect weight.

Data can come from a FILE (the reference workflow: load flight-test
records, estimate): ``--data examples/data/aircraft_doublet.csv`` (the
default, committed with the repo; fixed-seed synthesis, truth in its
header) flows through ``collocfem_tpu.utils.io.load_measurements`` —
columns t, alpha, q, az, elevator.  ``--data ""`` (or a missing file)
falls back to in-process synthesis with the same seed.

Usage: python examples/aircraft_oe.py [--platform cpu|gpu]
         [--data PATH] [--plot]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from scipy.integrate import solve_ivp

from examples._common import make_parser, print_history, setup_jax

# Truth: representative small-aircraft short-period derivatives.
P_TRUE = np.array([-1.2, -8.0, -2.5, -0.15, -12.0])  # Za, Ma, Mq, Zd, Md
TF, N_ELEMENTS, DEGREE = 8.0, 200, 4
V_AIR, G0 = 60.0, 9.81
NOISE = np.array([0.002, 0.005, 0.05])  # alpha, q, az channel sigmas


def doublet(t):
    """Elevator doublet: +3 deg for 1 s, -3 deg for 1 s."""
    d = np.deg2rad(3.0)
    return np.where((t >= 0.5) & (t < 1.5), d,
                    np.where((t >= 1.5) & (t < 2.5), -d, 0.0))


def _synthesize():
    """In-process fallback: same fixed-seed record as the committed file."""
    Za, Ma, Mq, Zd, Md = P_TRUE
    rng = np.random.default_rng(11)
    sol = solve_ivp(
        lambda t, x: [
            Za * x[0] + x[1] + Zd * doublet(t),
            Ma * x[0] + Mq * x[1] + Md * doublet(t),
        ],
        (0, TF), [0.0, 0.0], rtol=1e-10, atol=1e-12, dense_output=True,
        max_step=0.05,
    )
    t_meas = np.linspace(0.02, TF - 0.02, 400)
    alpha, q = sol.sol(t_meas)
    az = V_AIR / G0 * (Za * alpha + Zd * doublet(t_meas))
    y = np.stack([alpha, q, az], axis=1)
    y += NOISE[None, :] * rng.standard_normal(y.shape)
    return t_meas, y, doublet(t_meas)


def main():
    ap = make_parser(__doc__)
    ap.add_argument(
        "--data",
        default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "aircraft_doublet.csv"),
        help="flight record (t, alpha, q, az, elevator columns; csv/npz); "
        "'' = synthesize in-process",
    )
    args = ap.parse_args()
    setup_jax(args)

    from collocfem_tpu.models import AircraftLongitudinal
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import HISTORY_COLS, make_gn_solver
    from collocfem_tpu.utils.io import load_measurements

    model = AircraftLongitudinal(V=V_AIR, g0=G0)

    if args.data and os.path.exists(args.data):
        # Reference workflow: file -> load_measurements -> pack_data.  The
        # last channel is the recorded input (elevator); everything else
        # is a measured output.
        t_meas, vals = load_measurements(args.data)
        y, u_rec = vals[:, :3], vals[:, 3]
        print(f"loaded {t_meas.size} samples from {args.data}")
        u_of_t = lambda t: np.interp(t, t_meas, u_rec)
    else:
        if args.data:
            print(f"{args.data} not found; synthesizing in-process")
        t_meas, y, _ = _synthesize()
        u_of_t = doublet

    mesh = uniform_mesh(0.0, TF, N_ELEMENTS, DEGREE)
    prob = EstimationProblem.build(model, mesh, t_meas, defect_weight=1e4)
    u_nodes = u_of_t(mesh.elem_times)[..., None]
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes, meas_weight=1.0 / NOISE)
    z0 = prob.initial_guess_from_data(
        t_meas, y[:, :2], p0=[-1.0, -5.0, -1.0, -0.1, -5.0]
    )

    solve = make_gn_solver(
        prob, SolverOptions(maxiter=60, gtol=1e-6, xtol=1e-12)
    )
    z, stats = solve(z0, data)

    print_history(stats.history, HISTORY_COLS, stats.iterations)
    p = np.asarray(z.p)
    names = ["Z_a", "M_a", "M_q", "Z_d", "M_d"]
    print(f"\nconverged={bool(stats.converged)} in {int(stats.iterations)} its")
    print(f"{'deriv':>6} {'estimate':>12} {'truth':>12} {'rel err':>10}")
    for nm, est, tr in zip(names, p, P_TRUE):
        print(f"{nm:>6} {est:>12.5f} {tr:>12.5f} {abs(est/tr-1):>10.2e}")

    if args.plot:
        import matplotlib.pyplot as plt

        _, axs = plt.subplots(3, 1, sharex=True)
        for i, (ax, nm) in enumerate(zip(axs, ["alpha", "q", "az"])):
            ax.plot(t_meas, y[:, i], ".", ms=2, alpha=0.4)
            ax.set_ylabel(nm)
        axs[-1].set_xlabel("t"); plt.show()


if __name__ == "__main__":
    main()
