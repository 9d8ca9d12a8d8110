"""Batched tiny-block linear algebra, unrolled into elementwise ops.

The block-tridiagonal KKT factorization works on huge *batches* of tiny SPD
blocks (bd = d*nv, typically 8-16).  ``jnp.linalg.cholesky`` /
``solve_triangular`` lower to blocked LAPACK-style loops that neither fuse
nor vectorize well at these sizes; here the small dimension is **unrolled in
Python at trace time**, so every arithmetic op is an elementwise op over the
batch axis, and XLA fuses whole factorizations into a handful of
kernels.  This is the
"pack multiple elements per tile" resolution of SURVEY.md §7 hard part 1.

All functions take (..., b, b) / (..., b, r) arrays with static small ``b``
and are exact (same flop sequence as the textbook algorithms — no
approximation), so they also serve the float64 CPU parity path.
"""

from __future__ import annotations

import jax.numpy as jnp

# Above this block size the unrolled trace gets large with no payoff;
# fall back to lax.linalg primitives.
MAX_UNROLL = 16


def _unstack(A):
    """(..., b, b) -> list-of-lists of (...,) entries."""
    b = A.shape[-1]
    return [[A[..., i, j] for j in range(b)] for i in range(b)]


def chol(A):
    """Lower Cholesky factor of SPD blocks (..., b, b), unrolled over b."""
    b = A.shape[-1]
    if b > MAX_UNROLL:
        return jnp.linalg.cholesky(A)
    a = _unstack(A)
    L = [[None] * b for _ in range(b)]
    inv = [None] * b
    for j in range(b):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        # Clamp: in f32, near-singular damped systems can round the pivot
        # negative; a junk-but-finite factor lets the LM reject the step
        # gracefully instead of poisoning the solve with NaNs.
        d = jnp.sqrt(jnp.maximum(s, jnp.finfo(s.dtype).tiny))
        L[j][j] = d
        inv[j] = 1.0 / d
        for i in range(j + 1, b):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv[j]
    zero = jnp.zeros_like(a[0][0])
    rows = [
        jnp.stack([L[i][j] if j <= i else zero for j in range(b)], axis=-1)
        for i in range(b)
    ]
    return jnp.stack(rows, axis=-2)


def solve_lower(L, B):
    """X with L X = B;  L (..., b, b) lower-triangular, B (..., b, r)."""
    b = L.shape[-1]
    if b > MAX_UNROLL:
        import jax.scipy.linalg as jsl

        return jsl.solve_triangular(L, B, lower=True)
    X = [None] * b
    for i in range(b):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * X[k]
        X[i] = s / L[..., i, i, None]
    return jnp.stack(X, axis=-2)


def solve_lower_t(L, B):
    """X with L^T X = B (back substitution on the transposed factor)."""
    b = L.shape[-1]
    if b > MAX_UNROLL:
        import jax.scipy.linalg as jsl

        return jsl.solve_triangular(
            jnp.swapaxes(L, -1, -2), B, lower=False
        )
    X = [None] * b
    for i in range(b - 1, -1, -1):
        s = B[..., i, :]
        for k in range(i + 1, b):
            s = s - L[..., k, i, None] * X[k]
        X[i] = s / L[..., i, i, None]
    return jnp.stack(X, axis=-2)


def chol_solve(L, B):
    """SPD solve from a precomputed lower Cholesky factor."""
    return solve_lower_t(L, solve_lower(L, B))


def spd_solve(A, B):
    """One-shot SPD solve of tiny blocks: chol + two triangular sweeps."""
    return chol_solve(chol(A), B)
