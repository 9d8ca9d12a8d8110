"""Constrained aircraft ID — nonlinear inequality constraints on estimation.

The reference lineage hands ANY NLP with inequality constraints to IPOPT
(SURVEY.md §2a "Inequality handling"), including ESTIMATION problems —
e.g. requiring the identified model to satisfy a handling-qualities spec.
This example runs the config-4 aircraft output-error problem (same data
file / synthesis as examples/aircraft_oe.py) with a short-period
damping-ratio constraint

    zeta(p) = -(Z_a + M_q) / (2 sqrt(Z_a M_q - M_a)) >= ZETA_MIN

— nonlinear in the parameters, ACTIVE at the solution (the data's true
damping is ~0.56 < ZETA_MIN = 0.6), solved on-device by the log-barrier
interior-point estimator ``solve.constrained`` (on-device IPOPT stand-in:
no callbacks, the whole outer x inner loop is one jitted program).

The script prints the unconstrained estimate (violates the spec), the
constrained estimate (rides zeta = ZETA_MIN), and the external KKT
check: multiplier nu = mu/(-g) >= 0 and stationarity of the true
estimation gradient, grad_p cost + nu grad_p g ~ 0.

Usage: python examples/constrained_estimation.py [--platform cpu|gpu]
         [--data PATH] [--zeta-min 0.6]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples._common import make_parser, setup_jax
from examples.aircraft_oe import (DEGREE, G0, N_ELEMENTS, NOISE, P_TRUE, TF,
                                  V_AIR, _synthesize, doublet)


def zeta_np(p):
    Za, Ma, Mq = p[0], p[1], p[2]
    return -(Za + Mq) / (2.0 * np.sqrt(Za * Mq - Ma))


def main():
    ap = make_parser(__doc__)
    ap.add_argument(
        "--data",
        default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "aircraft_doublet.csv"),
        help="flight record (t, alpha, q, az, elevator columns); "
        "'' = synthesize in-process",
    )
    ap.add_argument("--zeta-min", type=float, default=0.6,
                    help="required short-period damping ratio")
    args = ap.parse_args()
    jax = setup_jax(args)
    import jax.numpy as jnp

    from collocfem_tpu.models import AircraftLongitudinal
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import (ConstrainedOptions, SolverOptions,
                                     constrained_gauss_newton, gauss_newton)
    from collocfem_tpu.utils.io import load_measurements

    model = AircraftLongitudinal(V=V_AIR, g0=G0)
    if args.data and os.path.exists(args.data):
        t_meas, vals = load_measurements(args.data)
        y, u_rec = vals[:, :3], vals[:, 3]
        print(f"loaded {t_meas.size} samples from {args.data}")
        u_of_t = lambda t: np.interp(t, t_meas, u_rec)
    else:
        t_meas, y, _ = _synthesize()
        u_of_t = doublet

    mesh = uniform_mesh(0.0, TF, N_ELEMENTS, DEGREE)
    prob = EstimationProblem.build(model, mesh, t_meas, defect_weight=1e4)
    u_nodes = u_of_t(mesh.elem_times)[..., None]
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes, meas_weight=1.0 / NOISE)

    # Strictly feasible start (zeta(p0) ~ 0.88 > ZETA_MIN; the barrier
    # merit is +inf outside the feasible set).
    p0 = [-1.0, -4.0, -4.0, -0.1, -5.0]
    z0 = prob.initial_guess_from_data(t_meas, y[:, :2], p0=p0)
    print(f"start: zeta(p0) = {zeta_np(np.asarray(p0)):.4f} "
          f"(spec: >= {args.zeta_min})")

    # Unconstrained reference: best fit, violates the spec.
    z_ref, st_ref = gauss_newton(
        prob, z0, data, SolverOptions(maxiter=60, gtol=1e-6, xtol=1e-12)
    )
    p_ref = np.asarray(z_ref.p)
    print(f"\nunconstrained: p = {np.array2string(p_ref, precision=5)}")
    print(f"  zeta = {zeta_np(p_ref):.4f}  cost = {float(st_ref.cost):.6e}")

    # Spec as g(p) <= 0 (traceable; sqrt argument Z_a M_q - M_a stays
    # positive on the feasible path from p0).
    def g_param(p):
        Za, Ma, Mq = p[0], p[1], p[2]
        zeta = -(Za + Mq) / (2.0 * jnp.sqrt(Za * Mq - Ma))
        return jnp.atleast_1d(args.zeta_min - zeta)

    z, stats = constrained_gauss_newton(
        prob, z0, data,
        ConstrainedOptions(n_outer=12, inner_maxiter=40, mu_min=1e-12),
        g_param=g_param,
    )
    p = np.asarray(z.p)
    gval = float(g_param(z.p)[0])
    print(f"\nconstrained:   p = {np.array2string(p, precision=5)}")
    print(f"  zeta = {zeta_np(p):.6f}  cost = {float(stats.cost):.6e}  "
          f"g = {gval:.2e}")

    # External KKT check (same form as tests/test_constrained.py): the
    # multiplier from the final barrier subproblem certifies optimality of
    # the TRUE estimation problem, computed with jax.grad, not solver
    # internals.
    nu = float(stats.mu) / (-gval)
    grad_p = np.asarray(
        jax.grad(lambda pp: prob.cost(z._replace(p=pp), data))(z.p)
    )
    jg = np.asarray(jax.jacfwd(g_param)(z.p))[0]
    resid = grad_p + nu * jg
    scale = max(np.max(np.abs(grad_p)), np.max(np.abs(nu * jg)))
    print(f"\nKKT: nu = {nu:.4e} >= 0; "
          f"max|grad L| / scale = {np.max(np.abs(resid)) / scale:.2e}")

    names = ["Z_a", "M_a", "M_q", "Z_d", "M_d"]
    print(f"\n{'deriv':>6} {'unconstrained':>14} {'constrained':>12} "
          f"{'truth':>10}")
    for nm, pu, pc, tr in zip(names, p_ref, p, P_TRUE):
        print(f"{nm:>6} {pu:>14.5f} {pc:>12.5f} {tr:>10.5f}")


if __name__ == "__main__":
    main()
