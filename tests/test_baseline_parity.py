"""Float64 parity between the device package and the scipy CPU reference
pipeline (SURVEY.md §6: residual parity <= 1e-9 is the acceptance bar;
§4: solver vs scipy reference solves and parity harness)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import solve_ivp

from baseline_cpu.pipeline import (
    BaselineProblem,
    gauss_newton_baseline,
)
from collocfem_tpu.models import VanDerPol
from collocfem_tpu.ops.mesh import uniform_mesh
from collocfem_tpu.problem import Decision, EstimationProblem
from collocfem_tpu.solve import SolverOptions, make_gn_solver

MU_TRUE, B_TRUE = 1.2, 0.7
TF = 6.0


@pytest.fixture(scope="module")
def setup():
    mesh = uniform_mesh(0.0, TF, num_elements=12, degree=4)
    t_meas = np.linspace(0.05, TF - 0.05, 40)
    sol = solve_ivp(
        lambda t, x: [
            x[1],
            MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0] + B_TRUE * np.sin(t),
        ],
        (0, TF), [1.0, 0.0], rtol=1e-10, atol=1e-11, dense_output=True,
    )
    y = sol.sol(t_meas)[0][:, None]
    u_nodes = np.sin(mesh.elem_times)[..., None]

    prob = EstimationProblem.build(
        VanDerPol(), mesh, t_meas, defect_weight=100.0
    )
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    base = BaselineProblem.build(mesh, t_meas, y, u_nodes, defect_weight=100.0)
    return mesh, prob, data, base, y, t_meas


def test_residual_parity(setup):
    mesh, prob, data, base, y, t_meas = setup
    rng = np.random.default_rng(3)
    V = rng.standard_normal((mesh.num_nodes, 2))
    p = np.array([0.8, 0.4])
    r_base = base.residuals(V, p)
    z = Decision(V=jnp.asarray(V), p=jnp.asarray(p))
    r_pkg = np.asarray(prob.residual_vector(z, data))
    # Package appends (zero-weight) prior residuals; element part must match.
    assert r_pkg.shape[0] == r_base.shape[0] + 4
    np.testing.assert_allclose(r_pkg[: r_base.shape[0]], r_base, atol=1e-9)
    assert np.max(np.abs(r_pkg[r_base.shape[0]:])) == 0.0


def test_jacobian_parity(setup):
    mesh, prob, data, base, y, t_meas = setup
    rng = np.random.default_rng(4)
    V = rng.standard_normal((mesh.num_nodes, 2))
    p = np.array([0.8, 0.4])
    J = base.jacobian(V, p).toarray()

    def res(Vf, pf):
        z = Decision(V=Vf.reshape(V.shape), p=pf)
        return prob.residual_vector(z, data)[: J.shape[0]]

    Jx = np.asarray(jax.jacfwd(res, argnums=0)(jnp.asarray(V.ravel()),
                                               jnp.asarray(p)))
    Jp = np.asarray(jax.jacfwd(res, argnums=1)(jnp.asarray(V.ravel()),
                                               jnp.asarray(p)))
    np.testing.assert_allclose(J[:, : V.size], Jx, atol=1e-9)
    np.testing.assert_allclose(J[:, V.size:], Jp, atol=1e-9)


def test_end_to_end_parity(setup):
    mesh, prob, data, base, y, t_meas = setup
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.3])
    V0 = np.asarray(z0.V)

    V_b, p_b, info = gauss_newton_baseline(base, V0, [0.5, 0.3])
    assert info["converged"] or info["cost"] < 1e-8

    solve = make_gn_solver(
        prob, SolverOptions(maxiter=50, gtol=1e-9, xtol=1e-12)
    )
    z, stats = solve(z0, data)
    np.testing.assert_allclose(np.asarray(z.p), p_b, atol=1e-7)
    np.testing.assert_allclose(p_b, [MU_TRUE, B_TRUE], atol=5e-4)


def test_stacked_multi_experiment_parity():
    """The block-diagonal-stacked CPU counterpart of config 5
    (baseline_cpu.configs_baseline) matches the package's batch cost exactly and
    its Jacobian (incl. the shared-p arrowhead and prior rows) passes FD."""
    from baseline_cpu.configs_baseline import (
        build_stacked_multi_experiment,
        make_config5_data,
    )
    from collocfem_tpu.parallel.batch import BatchDecision, batch_cost

    n_exp, elements = 4, 8
    mesh, t_meas, y_all, u_all = make_config5_data(n_exp, elements)
    base = build_stacked_multi_experiment(mesh, t_meas, y_all, u_all)
    prob = EstimationProblem.build(
        VanDerPol(), mesh, t_meas, defect_weight=300.0
    )
    datas = [
        prob.pack_data(y_all[e], t_meas, u_nodes=u_all[e], meas_weight=100.0)
        for e in range(n_exp)
    ]
    data_batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)
    rng = np.random.default_rng(3)
    V = rng.standard_normal((n_exp, mesh.num_nodes, 2))
    p = np.array([1.1, 0.4])
    z = BatchDecision(V=jnp.asarray(V), p=jnp.asarray(p))
    c_pkg = float(
        batch_cost(prob, z, data_batch, jnp.zeros(2), jnp.full(2, 1e-3))
    )
    r = base.residuals(V.reshape(-1, 2), p)
    c_cpu = 0.5 * r @ r
    assert abs(c_cpu - c_pkg) <= 1e-12 * abs(c_pkg)

    J = base.jacobian(V.reshape(-1, 2), p)
    m_dof = n_exp * mesh.num_nodes * 2
    zvec = np.concatenate([V.ravel(), p])
    eps = 1e-6
    for i in [0, 5, m_dof - 1, m_dof, m_dof + 1]:
        dz = np.zeros_like(zvec)
        dz[i] = eps
        rp = base.residuals(
            (zvec + dz)[:m_dof].reshape(-1, 2), (zvec + dz)[m_dof:]
        )
        rm = base.residuals(
            (zvec - dz)[:m_dof].reshape(-1, 2), (zvec - dz)[m_dof:]
        )
        fd = (rp - rm) / (2 * eps)
        col = np.asarray(J[:, i].todense()).ravel()
        err = np.max(np.abs(fd - col)) / max(1.0, np.max(np.abs(col)))
        assert err < 1e-6, (i, err)
