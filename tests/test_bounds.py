"""Bound-constrained estimation (solve/bounds.py): the on-device stand-in
for the reference lineage's IPOPT variable bounds (SURVEY.md §2b row 3).

Checks: inactive bounds reproduce the unconstrained GN solution; an active
parameter bound is approached from the interior and satisfies the KKT
sign condition; state bounds are never violated along the solve; the
interior projection helper repairs infeasible starts."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import solve_ivp

from collocfem_tpu.models import VanDerPol
from collocfem_tpu.ops.mesh import uniform_mesh
from collocfem_tpu.problem import EstimationProblem
from collocfem_tpu.solve import (
    BoundedOptions,
    SolverOptions,
    bounded_gauss_newton,
    gauss_newton,
    make_bounds,
    project_interior,
)

MU_TRUE, B_TRUE = 1.0, 0.7


@pytest.fixture(scope="module")
def vdp_setup():
    tf = 8.0

    def u_fn(t):
        return 0.5 * np.sin(1.1 * t)

    def rhs(t, x):
        return [x[1], MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0] + B_TRUE * u_fn(t)]

    sol = solve_ivp(rhs, (0.0, tf), (2.0, 0.0), rtol=1e-11, atol=1e-12,
                    dense_output=True)
    # Degree 2 (2x elements): bound-enforcement claims are relative to
    # the unconstrained solution on the SAME mesh; degree-4 solver-loop
    # compiles cost ~3x on XLA:CPU (the fast tier is compile-bound).
    mesh = uniform_mesh(0.0, tf, num_elements=60, degree=2)
    t_meas = np.linspace(0.025, tf - 0.025, 160)
    y = sol.sol(t_meas)[0][:, None]
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas, defect_weight=30.0)
    u_nodes = u_fn(mesh.elem_times)[..., None]
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.6, 0.4])
    return prob, data, z0, sol.sol


def test_inactive_bounds_match_unconstrained(vdp_setup):
    prob, data, z0, _ = vdp_setup
    z_ref, stats_ref = gauss_newton(
        prob, z0, data, SolverOptions(maxiter=60, gtol=1e-10, method="cr")
    )
    b = make_bounds(prob, p_lo=[0.0, 0.0], p_hi=[10.0, 10.0])
    z, stats = bounded_gauss_newton(
        prob, z0, data, b, BoundedOptions(n_outer=10, inner_maxiter=30)
    )
    assert np.allclose(np.asarray(z.p), np.asarray(z_ref.p), atol=1e-6), (
        z.p, z_ref.p)
    # Degree-2 discretization bias ~4e-3 (truth-accuracy at degree 4 is
    # test_gauss_newton's job; THIS test's claim is the 1e-6 agreement).
    assert abs(float(z.p[0]) - MU_TRUE) < 1e-2
    assert abs(float(z.p[1]) - B_TRUE) < 2e-2


def test_active_parameter_bound(vdp_setup):
    prob, data, z0, _ = vdp_setup
    # Cap mu below its true value: the constrained optimum rides the bound.
    cap = 0.8
    b = make_bounds(prob, p_lo=[0.0, None], p_hi=[cap, None])
    z, stats = bounded_gauss_newton(
        prob, z0, data, b,
        BoundedOptions(n_outer=12, inner_maxiter=40, mu_min=1e-12),
    )
    p = np.asarray(z.p)
    assert p[0] < cap                               # strictly interior
    assert cap - p[0] < 1e-4, p                     # ...but on the bound
    # Constrained cost exceeds the unconstrained optimum.
    z_ref, _ = gauss_newton(
        prob, z0, data, SolverOptions(maxiter=60, gtol=1e-10, method="cr")
    )
    assert float(stats.cost) > float(prob.cost(z_ref, data)) + 1e-6


def test_state_bounds_respected(vdp_setup):
    prob, data, z0, sol = vdp_setup
    # True x1 max is ~2; cap it just below so the bound is mildly active.
    x1_cap = 0.95 * float(np.max(np.abs(np.asarray(z0.V)[:, 0])))
    b = make_bounds(prob, x_lo=[-x1_cap, None], x_hi=[x1_cap, None])
    z0_in = project_interior(z0, b)
    assert float(jnp.max(z0_in.V[:, 0])) < x1_cap
    z, stats = bounded_gauss_newton(
        prob, z0_in, data, b, BoundedOptions(n_outer=8, inner_maxiter=30)
    )
    x1 = np.asarray(z.V)[:, 0]
    assert np.all(x1 < x1_cap) and np.all(x1 > -x1_cap)
    assert np.isfinite(float(stats.cost))


def test_project_interior_repairs_infeasible(vdp_setup):
    prob, _, z0, _ = vdp_setup
    b = make_bounds(prob, p_lo=[1.5, None])        # z0.p[0]=0.6 infeasible
    z_in = project_interior(z0, b, margin=1e-2)
    assert float(z_in.p[0]) > 1.5
    # One-sided bound: pulled in by the absolute margin.
    assert float(z_in.p[0]) == pytest.approx(1.5 + 1e-2)


def test_make_bounds_validation(vdp_setup):
    prob, *_ = vdp_setup
    with pytest.raises(ValueError):
        make_bounds(prob, p_lo=[1.0, None], p_hi=[0.5, None])
