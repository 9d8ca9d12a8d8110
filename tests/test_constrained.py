"""General inequality-constrained estimation (solve/constrained.py): the
On-device stand-in for the reference lineage's IPOPT on estimation NLPs
with nonlinear g(x,u,p,t) <= 0 / g(p) <= 0 (SURVEY.md §2a "Inequality
handling" — IPOPT served ALL problem classes, not just OCP).

Checks: inactive constraints reproduce the unconstrained GN solution; an
active nonlinear parameter constraint is approached from the interior and
satisfies an EXTERNAL KKT check (multiplier from the barrier, stationarity
of the true estimation gradient); state path constraints from ``model.g``
stay feasible and ride the active envelope."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import solve_ivp

from collocfem_tpu.models import VanDerPol
from collocfem_tpu.ops.mesh import uniform_mesh
from collocfem_tpu.problem import EstimationProblem
from collocfem_tpu.solve import (
    ConstrainedOptions,
    SolverOptions,
    constrained_gauss_newton,
    gauss_newton,
)

MU_TRUE, B_TRUE = 1.0, 0.7


class VdPWithEnvelope(VanDerPol):
    """VdP with a position-envelope path constraint |x1| <= x_cap."""

    ng = 2

    def __init__(self, x_cap):
        super().__init__()
        self.x_cap = float(x_cap)

    def g(self, x, u, p, t):
        return jnp.stack([x[0] - self.x_cap, -self.x_cap - x[0]])


@pytest.fixture(scope="module")
def vdp_setup():
    tf = 8.0

    def u_fn(t):
        return 0.5 * np.sin(1.1 * t)

    def rhs(t, x):
        return [x[1], MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0] + B_TRUE * u_fn(t)]

    sol = solve_ivp(rhs, (0.0, tf), (2.0, 0.0), rtol=1e-11, atol=1e-12,
                    dense_output=True)
    # Degree 2: every claim here is relative (unconstrained agreement,
    # external KKT stationarity, feasibility) — degree-4 fidelity is
    # test_gauss_newton's job, and degree-4 solver-loop compiles cost ~3x.
    mesh = uniform_mesh(0.0, tf, num_elements=48, degree=2)
    t_meas = np.linspace(0.025, tf - 0.025, 120)
    y = sol.sol(t_meas)[0][:, None]
    u_nodes = u_fn(mesh.elem_times)[..., None]
    z0_p = [0.6, 0.4]
    return mesh, t_meas, y, u_nodes, z0_p


def _build(mesh, t_meas, y, u_nodes, p0, model=None):
    prob = EstimationProblem.build(
        model or VanDerPol(), mesh, t_meas, defect_weight=30.0
    )
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=p0)
    return prob, data, z0


@pytest.mark.slow  # two extra solver-loop compiles (GN reference + far-
# constraint IP); the active-constraint KKT test below is the fast anchor
def test_inactive_constraints_match_unconstrained(vdp_setup):
    mesh, t_meas, y, u_nodes, p0 = vdp_setup
    prob, data, z0 = _build(mesh, t_meas, y, u_nodes, p0)
    z_ref, _ = gauss_newton(
        prob, z0, data, SolverOptions(maxiter=60, gtol=1e-10, method="cr")
    )
    # Far-away circle constraint ||p||^2 <= 100: inactive at p* ~ (1, 0.7).
    g_param = lambda p: jnp.atleast_1d(jnp.vdot(p, p) - 100.0)
    z, stats = constrained_gauss_newton(
        prob, z0, data,
        ConstrainedOptions(n_outer=10, inner_maxiter=30),
        g_param=g_param,
    )
    assert np.allclose(np.asarray(z.p), np.asarray(z_ref.p), atol=1e-6), (
        z.p, z_ref.p)
    assert float(stats.gviol) < 0.0


def test_active_nonlinear_param_constraint_kkt(vdp_setup):
    mesh, t_meas, y, u_nodes, p0 = vdp_setup
    prob, data, z0 = _build(mesh, t_meas, y, u_nodes, p0)
    # Nonlinear cap ||p||^2 <= r2 with r2 < ||p_true||^2 = 1.49: active.
    r2 = 1.2
    g_param = lambda p: jnp.atleast_1d(jnp.vdot(p, p) - r2)
    z, stats = constrained_gauss_newton(
        prob, z0, data,
        ConstrainedOptions(n_outer=12, inner_maxiter=40, mu_min=1e-12),
        g_param=g_param,
    )
    p = np.asarray(z.p)
    gval = float(g_param(z.p)[0])
    assert gval < 0.0                                # strictly feasible
    assert -gval < 1e-3 * r2, p                      # ...riding the bound
    # EXTERNAL KKT check: nu = mu / (-g) >= 0 and the TRUE estimation
    # gradient satisfies grad_p cost + nu * grad_p g ~ 0 (stationarity of
    # the Lagrangian, computed with jax.grad — not the solver's internals).
    nu = float(stats.mu) / (-gval)
    grad_p = np.asarray(jax.grad(lambda pp: prob.cost(z._replace(p=pp), data))(z.p))
    jg = np.asarray(jax.jacfwd(g_param)(z.p))[0]
    resid = grad_p + nu * jg
    scale = max(np.max(np.abs(grad_p)), np.max(np.abs(nu * jg)))
    assert np.max(np.abs(resid)) < 5e-3 * scale, (resid, scale, nu)
    # Constrained cost exceeds the unconstrained optimum.
    z_ref, _ = gauss_newton(
        prob, z0, data, SolverOptions(maxiter=60, gtol=1e-10, method="cr")
    )
    assert float(stats.cost) > float(prob.cost(z_ref, data)) + 1e-8


def test_state_envelope_from_model_g(vdp_setup):
    mesh, t_meas, y, u_nodes, p0 = vdp_setup
    x_cap = 0.95 * float(np.max(np.abs(y)))
    model = VdPWithEnvelope(x_cap)
    prob, data, z0 = _build(mesh, t_meas, y, u_nodes, p0, model=model)
    # Strictly feasible start: shrink the interpolated guess inside the cap.
    V0 = np.array(z0.V)
    V0[:, 0] = np.clip(V0[:, 0], -0.98 * x_cap, 0.98 * x_cap)
    z0 = z0._replace(V=jnp.asarray(V0, prob.dtype))
    z, stats = constrained_gauss_newton(
        prob, z0, data, ConstrainedOptions(n_outer=8, inner_maxiter=30)
    )
    x1 = np.asarray(z.V)[:, 0]
    assert np.all(np.abs(x1) < x_cap)                # feasible everywhere
    assert np.max(np.abs(x1)) > 0.99 * x_cap         # envelope active
    assert np.isfinite(float(stats.cost))
    assert float(stats.gviol) < 0.0


def test_no_constraints_raises(vdp_setup):
    mesh, t_meas, y, u_nodes, p0 = vdp_setup
    prob, data, z0 = _build(mesh, t_meas, y, u_nodes, p0)
    from collocfem_tpu.solve import make_constrained_solver

    with pytest.raises(ValueError):
        make_constrained_solver(prob)
