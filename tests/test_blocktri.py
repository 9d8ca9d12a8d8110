"""Block-tridiagonal solver tests: scan (Thomas), cyclic reduction, dense
— all must agree with a dense numpy solve on random SPD systems
(SURVEY.md §4: solver vs jnp.linalg/scipy reference solves)."""

import jax.numpy as jnp
import numpy as np
import pytest

from collocfem_tpu.solve.blocktri import (
    blocktri_solve_cr,
    blocktri_solve_dense,
    blocktri_solve_scan,
)


def random_spd_blocktri(k, b, r, seed=0):
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((k, b, b))
    E[-1] = 0.0
    D = np.zeros((k, b, b))
    for i in range(k):
        m = rng.standard_normal((b, b))
        dom = np.linalg.norm(E[i - 1]) if i > 0 else 0.0
        dom += np.linalg.norm(E[i]) if i < k - 1 else 0.0
        D[i] = m @ m.T + (dom + 1.0) * np.eye(b)
    G = rng.standard_normal((k, b, r))
    return D, E, G


def dense_reference(D, E, G):
    k, b, _ = D.shape
    A = np.zeros((k * b, k * b))
    for i in range(k):
        A[i * b : (i + 1) * b, i * b : (i + 1) * b] = D[i]
        if i + 1 < k:
            A[i * b : (i + 1) * b, (i + 1) * b : (i + 2) * b] = E[i]
            A[(i + 1) * b : (i + 2) * b, i * b : (i + 1) * b] = E[i].T
    return np.linalg.solve(A, G.reshape(k * b, -1)).reshape(G.shape)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 13, 32])
@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize(
    "solver", [blocktri_solve_scan, blocktri_solve_cr, blocktri_solve_dense]
)
def test_solvers_match_dense(k, b, solver):
    D, E, G = random_spd_blocktri(k, b, r=3, seed=k * 10 + b)
    want = dense_reference(D, E, G)
    got = np.asarray(solver(jnp.asarray(D), jnp.asarray(E), jnp.asarray(G)))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_cr_single_rhs_squeeze():
    D, E, G = random_spd_blocktri(6, 4, r=1, seed=7)
    want = dense_reference(D, E, G)[..., 0]
    got = np.asarray(
        blocktri_solve_cr(jnp.asarray(D), jnp.asarray(E), jnp.asarray(G[..., 0]))
    )
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_large_chain_wellposed():
    # 10k-element-scale chain (north-star size) stays accurate.
    D, E, G = random_spd_blocktri(1024, 4, r=2, seed=3)
    x = np.asarray(blocktri_solve_cr(jnp.asarray(D), jnp.asarray(E), jnp.asarray(G)))
    # Verify by residual: A x == G.
    r = np.einsum("kij,kjr->kir", D, x)
    r[:-1] += np.einsum("kij,kjr->kir", E[:-1], x[1:])
    r[1:] += np.einsum("kji,kjr->kir", E[:-1], x[:-1])
    np.testing.assert_allclose(r, G, rtol=1e-8, atol=1e-8)


def _to_soa(a):
    return jnp.asarray(np.moveaxis(a, 0, -1))


@pytest.mark.parametrize(
    "k,b,r", [(37, 4, 1), (37, 8, 3), (100, 4, 3), (130, 8, 1)]
)
def test_cr_factor_soa_matches_f64_dense(k, b, r):
    """The SoA factor/apply CR (the hot-path chain solve) against a float64
    dense solve: non-power-of-two K (padding), both block sizes."""
    from collocfem_tpu.solve.blocktri import blocktri_cr_factor_soa

    D, E, G = random_spd_blocktri(k, b, r, seed=k + b + r)
    want = dense_reference(D, E, G)
    apply = blocktri_cr_factor_soa(_to_soa(D), _to_soa(E))
    got = np.moveaxis(np.asarray(apply(_to_soa(G))), -1, 0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_factor_apply_matches_one_shot():
    """Factor once, apply to two right-hand sides: both match the one-shot
    cyclic reduction."""
    from collocfem_tpu.solve.blocktri import blocktri_cr_factor

    D, E, G = (jnp.asarray(a) for a in random_spd_blocktri(300, 6, 2, seed=3))
    apply = blocktri_cr_factor(D, E)
    np.testing.assert_allclose(np.asarray(apply(G)),
                               np.asarray(blocktri_solve_cr(D, E, G)),
                               rtol=1e-9, atol=1e-10)
    G2 = jnp.asarray(np.random.default_rng(4).standard_normal(G.shape))
    np.testing.assert_allclose(np.asarray(apply(G2)),
                               np.asarray(blocktri_solve_cr(D, E, G2)),
                               rtol=1e-9, atol=1e-10)
