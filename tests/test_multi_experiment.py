"""Shared-parameter multi-experiment estimation (BASELINE.json config 5):
batched VdP experiments with one shared parameter vector, solved by the
parameter-Schur DP algorithm — single shard (vmap) and sharded over the
"dp" axis of the virtual 8-device mesh.

Fast tier runs at degree 2 with ONE shared reference solve (an XLA:CPU
solver-loop compile costs ~3x more at degree 4 — measured 34 s vs 11 s —
and the checks here are batch/shard/layout AGREEMENT, not discretization
fidelity, which tests/test_gauss_newton.py anchors at degree 4)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from scipy.integrate import solve_ivp

from collocfem_tpu.models import VanDerPol
from collocfem_tpu.ops.mesh import uniform_mesh
from collocfem_tpu.parallel.batch import (
    BatchDecision,
    make_multi_experiment_solver,
)
from collocfem_tpu.parallel.meshes import make_device_mesh
from collocfem_tpu.problem import EstimationProblem
from collocfem_tpu.solve import SolverOptions

MU_TRUE, B_TRUE = 1.3, 0.5
N_EXP = 8
OPTS = SolverOptions(maxiter=40, gtol=1e-9, xtol=1e-10)


def _simulate(x0, freq, tf):
    def u_fn(t):
        return np.sin(freq * t)

    def rhs(t, x):
        return [x[1], MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0] + B_TRUE * u_fn(t)]

    sol = solve_ivp(rhs, (0.0, tf), x0, rtol=1e-10, atol=1e-11,
                    dense_output=True)
    return sol.sol, u_fn


@pytest.fixture(scope="module")
def batch_setup():
    tf = 8.0
    mesh = uniform_mesh(0.0, tf, num_elements=48, degree=2)
    t_meas = np.linspace(0.05, tf - 0.05, 80)
    model = VanDerPol()
    prob = EstimationProblem.build(model, mesh, t_meas, defect_weight=300.0)

    rng = np.random.default_rng(42)
    datas, v0s = [], []
    for i in range(N_EXP):
        x0 = rng.uniform(-2, 2, size=2)
        freq = 0.7 + 0.15 * i
        traj, u_fn = _simulate(x0, freq, tf)
        y = traj(t_meas)[0][:, None]
        u_nodes = u_fn(mesh.elem_times)[..., None]
        d = prob.pack_data(y, t_meas, u_nodes=u_nodes, p_weight=0.0)
        datas.append(d)
        v0s.append(prob.initial_guess_from_data(t_meas, y, p0=[0.0, 0.0]).V)
    data_batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)
    z0 = BatchDecision(
        V=jnp.stack(v0s), p=jnp.asarray([2.0, 0.2], prob.dtype)
    )
    p_prior = jnp.asarray([1.0, 1.0], prob.dtype)
    p_w = jnp.asarray([1e-3, 1e-3], prob.dtype)
    return prob, z0, data_batch, p_prior, p_w


@pytest.fixture(scope="module")
def soa_solution(batch_setup):
    """ONE reference solve (the default concatenated-chain SoA pipeline),
    shared by the convergence, sharded-parity, and layout-parity tests —
    every extra solver build is a separate solver-loop compile."""
    prob, z0, data_batch, p_prior, p_w = batch_setup
    solve = make_multi_experiment_solver(prob, OPTS)
    return solve(z0, data_batch, p_prior, p_w)


def test_multi_experiment_vmap(batch_setup, soa_solution):
    z, stats = soa_solution
    p = np.asarray(z.p)
    assert bool(stats.converged), np.asarray(stats.history)[:, :2]
    # Degree-2 discretization bias dominates (see module docstring): the
    # batch estimate must still land on the truth to truncation level.
    assert abs(p[0] - MU_TRUE) < 2e-2, p
    assert abs(p[1] - B_TRUE) < 2e-2, p


def test_multi_experiment_sharded_matches_vmap(batch_setup, soa_solution,
                                               eight_devices):
    from collocfem_tpu.solve.newton import SolveStats

    prob, z0, data_batch, p_prior, p_w = batch_setup
    z_ref, _ = soa_solution

    mesh = make_device_mesh(dp=8, sp=1, devices=eight_devices)
    solve = make_multi_experiment_solver(prob, OPTS, dp_axis="dp")

    sharded = jax.jit(
        jax.shard_map(
            solve,
            mesh=mesh,
            in_specs=(
                BatchDecision(V=P("dp"), p=P()),
                jax.tree_util.tree_map(lambda _: P("dp"), data_batch),
                P(), P(),
            ),
            out_specs=(
                BatchDecision(V=P("dp"), p=P()),
                SolveStats(*([P()] * 6)),
            ),
        )
    )
    z_sh, stats_sh = sharded(z0, data_batch, p_prior, p_w)
    np.testing.assert_allclose(
        np.asarray(z_sh.p), np.asarray(z_ref.p), rtol=1e-8, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(z_sh.V), np.asarray(z_ref.V), rtol=1e-6, atol=1e-8
    )


def test_assemble_soa_batched_matches_per_experiment(batch_setup):
    """The concatenated-chain system == per-experiment SoA systems laid side
    by side (exact block-diagonal structure, zero boundary couplings)."""
    from collocfem_tpu.ops import doubleword as dw
    from collocfem_tpu.ops.assemble import (
        assemble_gn_soa,
        assemble_gn_soa_batched,
    )
    from collocfem_tpu.parallel.batch import _finish_cost_dw, batch_cost
    from collocfem_tpu.problem import Decision

    prob, z0, data_batch, p_prior, p_w = batch_setup
    k = prob.mesh.num_elements + 1
    sys, ct = assemble_gn_soa_batched(
        prob, z0.V, z0.p, data_batch, with_cost=True
    )
    assert sys.D.shape[-1] == N_EXP * k
    c_sum, gp_sum = 0.0, 0.0
    for e in range(N_EXP):
        data_e = jax.tree_util.tree_map(lambda l: l[e], data_batch)
        se = assemble_gn_soa(prob, Decision(V=z0.V[e], p=z0.p), data_e)
        sl = slice(e * k, (e + 1) * k)
        np.testing.assert_allclose(sys.D[:, :, sl], se.D, rtol=1e-13, atol=0)
        np.testing.assert_allclose(sys.E[:, :, sl], se.E, rtol=1e-13, atol=0)
        np.testing.assert_allclose(sys.B[:, :, sl], se.B, rtol=1e-13, atol=0)
        np.testing.assert_allclose(sys.gx[:, sl], se.gx, rtol=1e-13, atol=0)
        # boundary coupling between experiments is exactly zero
        assert np.all(np.asarray(sys.E[:, :, e * k + k - 1]) == 0.0)
        c_sum = c_sum + se.C
        gp_sum = gp_sum + se.gp
    np.testing.assert_allclose(sys.C, c_sum, rtol=1e-13)
    np.testing.assert_allclose(sys.gp, gp_sum, rtol=1e-12, atol=1e-14)
    # DW cost (+ shared prior) == the standalone batch cost
    ct_full = _finish_cost_dw(ct, z0.p, p_prior, p_w, None)
    c_ref = float(batch_cost(prob, z0, data_batch, p_prior, p_w))
    assert abs(float(dw.to_single(ct_full)) - c_ref) <= 1e-12 * abs(c_ref)


def test_step_layouts_agree(batch_setup):
    """The concatenated-chain SoA step == the vmapped block-major step
    (same per-experiment damping semantics, same Schur reduction)."""
    from collocfem_tpu.ops.assemble import assemble_gn_soa_batched
    from collocfem_tpu.parallel.batch import (
        concat_chain_solve,
        shared_gn_step,
        shared_gn_step_soa,
    )

    prob, z0, data_batch, p_prior, p_w = batch_setup
    lam = jnp.asarray(1e-3, prob.dtype)
    dV_b, dp_b, gnorm_b, aux_b = shared_gn_step(
        prob, z0, data_batch, lam, p_prior, p_w
    )
    sys = assemble_gn_soa_batched(prob, z0.V, z0.p, data_batch)
    dV_s, dp_s, aux_s = shared_gn_step_soa(
        prob, sys, lam, z0.p, p_prior, p_w,
        n_exp=N_EXP, chain_solve=concat_chain_solve,
    )
    np.testing.assert_allclose(np.asarray(dp_s), np.asarray(dp_b),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dV_s), np.asarray(dV_b),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(float(aux_s.gdot), float(aux_b.gdot),
                               rtol=1e-9)
    np.testing.assert_allclose(float(aux_s.sds), float(aux_b.sds), rtol=1e-9)
    np.testing.assert_allclose(float(aux_s.step_norm),
                               float(aux_b.step_norm), rtol=1e-9)


def test_solver_layouts_agree(batch_setup, soa_solution):
    """End-to-end: layout='blocks' recovers the same p as the SoA solve."""
    prob, z0, data_batch, p_prior, p_w = batch_setup
    z_s, _ = soa_solution
    z_b, st_b = make_multi_experiment_solver(prob, OPTS, layout="blocks")(
        z0, data_batch, p_prior, p_w
    )
    np.testing.assert_allclose(
        np.asarray(z_s.p), np.asarray(z_b.p), rtol=1e-7, atol=1e-9
    )


def test_layouts_agree_on_config5_shaped_data():
    """Config 5's shape (10-element degree-4 experiments, the shared
    generator of baseline_cpu) through both layouts with the default chain
    solver: the concatenated SoA chain and the vmapped block-major CR give
    the same fixed-work iterates."""
    from baseline_cpu.configs_baseline import make_config5_data

    n_exp = 16
    mesh, t_meas, y_all, u_all = make_config5_data(n_exp, 10)
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=300.0)
    datas = [prob.pack_data(y_all[e], t_meas, u_nodes=u_all[e],
                            meas_weight=100.0) for e in range(n_exp)]
    data_batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)
    z0 = BatchDecision(
        V=jnp.stack([prob.initial_guess_from_data(t_meas, y_all[e],
                                                  p0=[0, 0]).V
                     for e in range(n_exp)]),
        p=jnp.asarray([2.0, 0.2], prob.dtype))
    pp = jnp.zeros(2, prob.dtype)
    pw = jnp.full((2,), 1e-3, prob.dtype)
    opts = SolverOptions(maxiter=15, gtol=0.0, lam0=1e-6, lam_max=1e30)
    z_s, st_s = make_multi_experiment_solver(prob, opts, layout="soa")(
        z0, data_batch, pp, pw)
    z_b, st_b = make_multi_experiment_solver(prob, opts, layout="blocks")(
        z0, data_batch, pp, pw)
    assert int(st_s.iterations) == int(st_b.iterations) == 15
    np.testing.assert_allclose(np.asarray(z_s.p), np.asarray(z_b.p),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(z_s.V), np.asarray(z_b.V),
                               rtol=1e-7, atol=1e-9)
