"""DW cyclic reduction vs f64 reference on ill-conditioned chains.

The decisive case: 1-D-Poisson-like chains with cond ~ K^2, where plain
f32 CR loses all accuracy past K ~ 1e4 but DW must stay at ~cond * 2^-49.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from collocfem_tpu.solve.blocktri import (
    blocktri_solve_cr,
    blocktri_solve_scan,
)
from collocfem_tpu.solve.blocktri_dw import (
    blocktri_cr_factor_soa_dw,
    blocktri_solve_cr_dw,
)

RNG = np.random.default_rng(7)


def _poisson_chain(k, b, dtype=np.float32):
    """SPD block chain with cond ~ k^2 (discrete 1-D Laplacian blocks).

    Strictly SPD: the block Laplacian (D=2I, E=-I) is PD with
    eigmin ~ (pi/k)^2, and the added per-block PSD jitter only raises
    eigenvalues.
    """
    J = 0.15 * RNG.standard_normal((k, b, b))
    D = 2.0 * np.eye(b) + np.einsum("kij,klj->kil", J, J)
    E = np.broadcast_to(-np.eye(b), (k, b, b)).copy()
    E[-1] = 0.0
    return (jnp.asarray(D.astype(dtype)), jnp.asarray(E.astype(dtype)))


def _f64_reference(D, E, G):
    """Thomas scan in f64 (tests run on CPU with x64 on)."""
    to64 = lambda a: jnp.asarray(np.asarray(a, dtype=np.float64))
    return np.asarray(blocktri_solve_scan(to64(D), to64(E), to64(G)))


@pytest.mark.parametrize("k,b,r", [
    (64, 4, 1),
    # distinct (b, r) shapes compile their own ~20 s unrolled DW CR each;
    # one fast anchor suffices, the rest are slow-tier twins
    pytest.param(192, 3, 2, marks=pytest.mark.slow),
    pytest.param(1024, 2, 1, marks=pytest.mark.slow),
])
def test_dw_cr_matches_f64(k, b, r):
    D, E = _poisson_chain(k, b)
    G = jnp.asarray(RNG.standard_normal((k, b, r)).astype(np.float32))
    X_ref = _f64_reference(D, E, G)
    X_dw = np.asarray(blocktri_solve_cr_dw(D, E, G), dtype=np.float64)
    scale = np.abs(X_ref).max()
    err = np.abs(X_dw - X_ref).max() / scale
    # cond ~ k^2 <= 1e6 here; DW keeps ~cond * 2^-49 + f32 output rounding.
    assert err < 2e-6, err


def test_dw_beats_f32_on_long_ill_conditioned_chain():
    """K=4096: cond ~ 1.7e7 — f32 CR noticeably degrades, DW must not."""
    k, b = 4096, 2
    D, E = _poisson_chain(k, b)
    G = jnp.asarray(RNG.standard_normal((k, b, 1)).astype(np.float32))
    X_ref = _f64_reference(D, E, G)
    scale = np.abs(X_ref).max()

    X_f32 = np.asarray(
        blocktri_solve_cr(D, E, G), dtype=np.float64)
    X_dw = np.asarray(blocktri_solve_cr_dw(D, E, G), dtype=np.float64)

    err_f32 = np.abs(X_f32 - X_ref).max() / scale
    err_dw = np.abs(X_dw - X_ref).max() / scale
    # DW lands at f32-rounding-of-the-true-solution level.
    assert err_dw < 1e-5, err_dw
    assert err_dw < err_f32 / 30, (err_dw, err_f32)


def test_factor_apply_reuse():
    """One DW factorization applied to two different RHS batches."""
    k, b, r = 128, 3, 2
    D, E = _poisson_chain(k, b)
    to_soa = lambda A: jnp.moveaxis(A, 0, -1)
    apply = blocktri_cr_factor_soa_dw(to_soa(D), to_soa(E))
    for seed in (0, 1):
        G = jnp.asarray(
            np.random.default_rng(seed).standard_normal(
                (k, b, r)).astype(np.float32))
        X_ref = _f64_reference(D, E, G)
        X = np.asarray(jnp.moveaxis(apply(to_soa(G)), -1, 0),
                       dtype=np.float64)
        err = np.abs(X - X_ref).max() / np.abs(X_ref).max()
        assert err < 2e-6, (seed, err)


def test_non_pow2_and_tiny_chains():
    for k in (1, 2, 3, 7, 33):
        D, E = _poisson_chain(k, 2)
        G = jnp.asarray(RNG.standard_normal((k, 2, 1)).astype(np.float32))
        X_ref = _f64_reference(D, E, G)
        X = np.asarray(blocktri_solve_cr_dw(D, E, G), dtype=np.float64)
        err = np.abs(X - X_ref).max() / max(np.abs(X_ref).max(), 1e-30)
        assert err < 1e-5, (k, err)


@pytest.mark.slow  # 85 s: a full second GN solver-loop compile; DW unit
# coverage above is the fast anchor
def test_gn_end_to_end_with_cr_dw():
    """Full Gauss-Newton estimation with the DW KKT factorization."""
    import jax.numpy as jnp
    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import make_gn_solver
    from collocfem_tpu.utils.simulate import rk4_trajectory

    tf = 6.0
    mesh = uniform_mesh(0.0, tf, 24, 4)
    t_meas = np.linspace(0.1, tf - 0.1, 80)
    u_fn = lambda s: jnp.sin(0.9 * s)[None]
    t_fine = np.linspace(0.0, tf, 2001)
    xs = rk4_trajectory(VanDerPol().f, jnp.array([1.0, 0.0]), t_fine,
                        u_fn=u_fn, p=jnp.array([1.0, 1.0]))
    y = np.interp(t_meas, t_fine, np.asarray(xs[:, 0]))[:, None]
    y = y + 0.01 * np.random.default_rng(1).standard_normal(y.shape)

    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=100.0,
                                   dtype=jnp.float32)
    u_nodes = np.sin(0.9 * np.asarray(mesh.elem_times))[..., None]
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])

    z, stats = make_gn_solver(
        prob, SolverOptions(maxiter=25, gtol=1e-8, method="cr_dw")
    )(z0, data)
    p = np.asarray(z.p)
    assert np.all(np.isfinite(p))
    np.testing.assert_allclose(p, [1.0, 1.0], atol=0.08)
