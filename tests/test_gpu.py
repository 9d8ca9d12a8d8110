"""Card-only tests: float32 numerics on a real GPU.

Marked ``gpu``; the ``gpu_device`` fixture skips them where the run has no
GPU.  On a GPU machine: ``COLLOCFEM_TEST_PLATFORM=gpu pytest -m gpu``
(chip_smoke.py runs them as its last phase).  Each test runs with x64 off,
so the arrays are float32 as in production."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from collocfem_tpu.ops.einsum_hp import einsum_hp
from collocfem_tpu.solve.blocktri import blocktri_cr_factor_soa

pytestmark = pytest.mark.gpu


@pytest.fixture
def f32_on_gpu(gpu_device):
    with jax.enable_x64(False), jax.default_device(gpu_device):
        yield gpu_device


def test_einsum_hp_is_full_float32(f32_on_gpu):
    # A TF32 product keeps ~3 decimal digits (u = 4.9e-4); HIGHEST keeps f32.
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    got = np.asarray(jax.jit(lambda x, y: einsum_hp("ij,jk->ik", x, y))(a, b))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert np.max(np.abs(got - ref) / scale) < 1e-5


def test_cr_chain_solve_float32_backward_error(f32_on_gpu):
    # Unit-diagonal SPD chain (as after equilibration), K not a power of 2.
    rng = np.random.default_rng(1)
    k, b, r = 3000, 8, 3
    E = 0.1 * rng.standard_normal((b, b, k))
    E[:, :, -1] = 0.0
    D = np.repeat(np.eye(b)[:, :, None], k, axis=2)
    D += 0.05 * np.einsum("ijk,ljk->ilk", E, E)
    G = rng.standard_normal((b, r, k))
    X = np.asarray(jax.jit(lambda D, E, G: blocktri_cr_factor_soa(D, E)(G))(
        D.astype(np.float32), E.astype(np.float32), G.astype(np.float32)),
        dtype=np.float64)
    D, E = D.astype(np.float32).astype(np.float64), E.astype(
        np.float32).astype(np.float64)
    G = G.astype(np.float32).astype(np.float64)
    ax = np.einsum("ijk,jrk->irk", D, X)
    ax[:, :, :-1] += np.einsum("ijk,jrk->irk", E[:, :, :-1], X[:, :, 1:])
    ax[:, :, 1:] += np.einsum("jik,jrk->irk", E[:, :, :-1], X[:, :, :-1])
    eta = np.linalg.norm(ax - G) / (3.0 * np.linalg.norm(X) + np.linalg.norm(G))
    assert X.dtype == np.float64 and np.all(np.isfinite(X))
    assert eta < 1e-6


def test_gn_solve_float32_recovers_vdp(f32_on_gpu):
    from scipy.integrate import solve_ivp

    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions, make_gn_solver

    tf = 10.0
    sol = solve_ivp(
        lambda t, x: [x[1], (1 - x[0] ** 2) * x[1] - x[0]
                      + 0.7 * 0.5 * np.sin(1.1 * t)],
        (0.0, tf), (2.0, 0.0), rtol=1e-11, atol=1e-12, dense_output=True)
    mesh = uniform_mesh(0.0, tf, 40, 4)
    t_meas = np.linspace(0.025, tf - 0.025, 200)
    y = sol.sol(t_meas)[0][:, None]
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=30.0, dtype=jnp.float32)
    data = prob.pack_data(y, t_meas,
                          u_nodes=0.5 * np.sin(1.1 * mesh.elem_times)[..., None])
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
    z, stats = make_gn_solver(prob, SolverOptions(maxiter=60, gtol=0.0))(
        z0, data)
    assert z.V.dtype == jnp.float32
    assert list(z.p.devices())[0].platform == "gpu"
    np.testing.assert_allclose(np.asarray(z.p), [1.0, 0.7], atol=1e-3)
