"""Unrolled tiny-block linear algebra vs jnp.linalg (SURVEY.md §4:
hot-path solves vs jnp.linalg reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from collocfem_tpu.ops import smallblocks


def _spd(rng, batch, b):
    A = rng.standard_normal((batch, b, b))
    return jnp.asarray(A @ np.swapaxes(A, -1, -2) + b * np.eye(b))


@pytest.mark.parametrize("b", [1, 2, 5, 8, 16])
def test_chol_matches_linalg(b):
    rng = np.random.default_rng(0)
    A = _spd(rng, 7, b)
    np.testing.assert_allclose(
        np.asarray(smallblocks.chol(A)),
        np.asarray(jnp.linalg.cholesky(A)),
        rtol=1e-12, atol=1e-12,
    )


@pytest.mark.parametrize("b", [1, 3, 8])
def test_spd_solve(b):
    rng = np.random.default_rng(1)
    A = _spd(rng, 5, b)
    B = jnp.asarray(rng.standard_normal((5, b, 4)))
    X = smallblocks.spd_solve(A, B)
    np.testing.assert_allclose(
        np.asarray(jnp.einsum("kij,kjr->kir", A, X)), np.asarray(B),
        rtol=1e-10, atol=1e-10,
    )


def test_triangular_solves():
    rng = np.random.default_rng(2)
    A = _spd(rng, 4, 6)
    L = smallblocks.chol(A)
    B = jnp.asarray(rng.standard_normal((4, 6, 2)))
    X = smallblocks.solve_lower(L, B)
    np.testing.assert_allclose(
        np.asarray(jnp.einsum("kij,kjr->kir", L, X)), np.asarray(B),
        atol=1e-11,
    )
    Y = smallblocks.solve_lower_t(L, B)
    np.testing.assert_allclose(
        np.asarray(jnp.einsum("kji,kjr->kir", L, Y)), np.asarray(B),
        atol=1e-11,
    )


def test_unbatched():
    rng = np.random.default_rng(3)
    A = _spd(rng, 1, 5)[0]
    L = smallblocks.chol(A)
    np.testing.assert_allclose(
        np.asarray(L), np.asarray(jnp.linalg.cholesky(A)), atol=1e-12
    )


def test_grad_flows():
    # The unrolled factorization must be differentiable (jacfwd through the
    # whole Newton step relies on it).
    rng = np.random.default_rng(4)
    A = _spd(rng, 3, 4)
    B = jnp.asarray(rng.standard_normal((3, 4, 1)))

    def loss(A):
        return jnp.sum(smallblocks.spd_solve(A, B) ** 2)

    g = jax.grad(loss)(A)
    assert np.all(np.isfinite(np.asarray(g)))
