"""Symmetric positive-definite block-tridiagonal solvers.

On-device replacement for the reference's UMFPACK/SuperLU sparse LU
(SURVEY.md §2b row 1).  All algorithms are pivot-free (the Gauss-Newton
normal equations + Levenberg damping make every Schur complement SPD —
SURVEY.md §7 hard part 1) and plain jnp/lax, left to XLA to fuse:

  * ``blocktri_solve_scan``  — block-Cholesky Thomas recursion via
    ``lax.scan`` (O(K) sequential depth; reference implementation, and the
    in-shard local solver for the distributed SPIKE path).
  * ``blocktri_solve_cr``    — cyclic reduction: log2(K) levels, each level a
    *batched* Cholesky/triangular-solve over half the blocks (parallel depth
    O(log K)).
  * ``blocktri_cr_factor[_soa]`` — factor once / apply many (the SoA
    wrapper serves ``solve.kkt.solve_kkt_soa``).
  * ``blocktri_solve_dense`` — materialized dense solve (tests, tiny K).

Convention: A[k,k] = D[k] (SPD, (K,b,b)); A[k,k+1] = E[k]; A[k+1,k] = E[k]^T,
with E[K-1] ignored/zero.  Solves A X = G for G (K, b, r).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# Batched tiny-block primitives as library calls (LAPACK on CPU,
# cuSOLVER/cuBLAS on the GPU): a handful of HLO ops per call, so the
# compiled program stays small whatever the block size.
def _cholesky(A):
    """Lower Cholesky factor of a batch of SPD blocks (..., b, b)."""
    return jnp.linalg.cholesky(A)


def _chol_solve(L, B):
    """Solve (L L^T) X = B for a batch: L (..., b, b), B (..., b, r)."""
    tri = jax.lax.linalg.triangular_solve
    y = tri(L, B, left_side=True, lower=True)
    return tri(L, y, left_side=True, lower=True, transpose_a=True)


def _bmm(a, b):
    """a @ b over a batch of tiny blocks, as an exact f32 multiply-reduce
    (no matrix unit, so no reduced-precision TF32 path)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _btm(a, b):
    """a^T @ b over a batch of tiny blocks (multiply-reduce)."""
    return jnp.sum(a[..., :, :, None] * b[..., :, None, :], axis=-3)


# ---------------------------------------------------------------------------
# Dense reference
# ---------------------------------------------------------------------------
def blocktri_solve_dense(D, E, G):
    """Materialize the block-tridiagonal matrix and solve densely (tests)."""
    k, b, _ = D.shape
    A = jnp.zeros((k * b, k * b), D.dtype)
    for i in range(k):
        sl = slice(i * b, (i + 1) * b)
        A = A.at[sl, sl].set(D[i])
        if i + 1 < k:
            s2 = slice((i + 1) * b, (i + 2) * b)
            A = A.at[sl, s2].set(E[i])
            A = A.at[s2, sl].set(E[i].T)
    x = jnp.linalg.solve(A, G.reshape(k * b, -1))
    return x.reshape(G.shape)


# ---------------------------------------------------------------------------
# Sequential block-Cholesky (Thomas) via lax.scan
# ---------------------------------------------------------------------------
def blocktri_solve_scan(D, E, G):
    """O(K)-depth block LDL^T forward/backward recursion with lax.scan."""
    k = D.shape[0]
    if k == 1:
        return _chol_solve(_cholesky(D[0]), G[0])[None]

    l0 = _cholesky(D[0])

    def fwd(carry, inp):
        l_prev, y_prev = carry
        d_i, e_prev, g_i = inp
        w = _chol_solve(l_prev, e_prev)          # U_{i-1}^{-1} E_{i-1}
        u_i = d_i - _btm(e_prev, w)              # D_i - E^T U^{-1} E
        y_i = g_i - _btm(w, y_prev)              # g_i - (U^{-1}E)^T y_{i-1}
        l_i = _cholesky(u_i)
        return (l_i, y_i), (l_i, y_i)

    (_, _), (ls, ys) = jax.lax.scan(fwd, (l0, G[0]), (D[1:], E[:-1], G[1:]))
    ls = jnp.concatenate([l0[None], ls])
    ys = jnp.concatenate([G[0][None], ys])

    x_last = _chol_solve(ls[-1], ys[-1])

    def bwd(x_next, inp):
        l_i, y_i, e_i = inp
        x_i = _chol_solve(l_i, y_i - _bmm(e_i, x_next))
        return x_i, x_i

    _, xs = jax.lax.scan(
        bwd, x_last, (ls[:-1], ys[:-1], E[:-1]), reverse=True
    )
    return jnp.concatenate([xs, x_last[None]])


def blocktri_inverse_blocks(D, E):
    """Selected inverse of the SPD block-tridiagonal A (Takahashi recursion).

    The reference lineage reports estimate uncertainty from the inverse of
    the information matrix (SURVEY.md §3.4); for the state path that inverse
    is dense, but only its block-(tri)diagonal part is needed for per-node
    covariances and per-element confidence bands.  The Takahashi/RTS
    recursion produces exactly those blocks from the block-Cholesky (Thomas)
    factorization without ever forming the dense inverse:

      forward:   S_0 = D_0;   W_k = S_k^{-1} E_k;  S_{k+1} = D_{k+1} - E_k^T W_k
      backward:  Sigma_{K-1} = S_{K-1}^{-1}
                 Sigma_{k,k+1} = -W_k Sigma_{k+1}
                 Sigma_k = S_k^{-1} + W_k Sigma_{k+1} W_k^T

    O(K) sequential depth — this is a reporting path, not the Newton hot
    loop.  Run in float64 on CPU for ill-conditioned (lightly regularized)
    systems.

    Returns:
      diag: (K, b, b) diagonal blocks ``inv(A)[k, k]``.
      off:  (K-1, b, b) super-diagonal blocks ``inv(A)[k, k+1]``.
    """
    k = D.shape[0]
    if k == 1:
        b = D.shape[1]
        sinv = _chol_solve(_cholesky(D[0]), jnp.eye(b, dtype=D.dtype))
        return sinv[None], jnp.zeros((0, b, b), D.dtype)

    eye = jnp.eye(D.shape[1], dtype=D.dtype)

    def fwd(s_carry, inp):
        d_next, e_k = inp
        l_k = _cholesky(s_carry)
        w_k = _chol_solve(l_k, e_k)
        sinv_k = _chol_solve(l_k, eye)
        s_next = d_next - _btm(e_k, w_k)
        return s_next, (sinv_k, w_k)

    s_last, (sinvs, ws) = jax.lax.scan(fwd, D[0], (D[1:], E[:-1]))
    sigma_last = _chol_solve(_cholesky(s_last), eye)

    def bwd(sigma_next, inp):
        sinv_k, w_k = inp
        off_k = -_bmm(w_k, sigma_next)
        sigma_k = sinv_k - _bmm(w_k, off_k.swapaxes(-1, -2))
        return sigma_k, (sigma_k, off_k)

    _, (sigmas, offs) = jax.lax.scan(
        bwd, sigma_last, (sinvs, ws), reverse=True
    )
    diag = jnp.concatenate([sigmas, sigma_last[None]])
    return diag, offs


# ---------------------------------------------------------------------------
# Cyclic reduction: O(log K) parallel depth
# ---------------------------------------------------------------------------
def _pad_pow2(D, E):
    """Pad the chain to a power of two with identity/zero-coupled blocks."""
    k, b, _ = D.shape
    kp = 1 << max(0, (k - 1).bit_length())
    if kp == k:
        return D, E
    eye = jnp.broadcast_to(jnp.eye(b, dtype=D.dtype), (kp - k, b, b))
    D = jnp.concatenate([D, eye])
    # E[k-1] is ignored by convention but becomes an INTERIOR coupling
    # after padding — zero it so the pad blocks stay decoupled.
    E = E.at[k - 1].set(0.0)
    E = jnp.concatenate([E, jnp.zeros((kp - k, b, b), D.dtype)])
    return D, E


def blocktri_cr_factor(D, E):
    """Pivot-free SPD block cyclic reduction: factor once, apply many.

    Returns ``apply(G) -> X`` solving A X = G on (K, b, r) (or (K, b))
    arrays.  Each level eliminates the odd-indexed blocks with one batched
    Cholesky + triangular solves, halving the active chain (log2(K)
    levels after padding K to a power of two with identity blocks — an
    exact fixed point of the update).  The even-odd permutation of an SPD
    block-tridiagonal matrix stays SPD at every level, so no pivoting is
    needed (SURVEY.md §7 hard part 1).  Back-substitution uses the stored
    Schur factors, x_odd = s_g - s_up x_even - s_lo x_right (no re-solve).

    Levels are Python-unrolled at their true (halving) shapes: O(K) work
    in total, and every level is a few batched library calls and fused
    multiply-reduces, so the traced program stays small.
    """
    k0 = D.shape[0]
    D, E = _pad_pow2(D, E)
    kp = D.shape[0]
    levels = []
    while D.shape[0] > 1:
        d_even, d_odd = D[0::2], D[1::2]
        e_up, e_lo = E[0::2], E[1::2]           # even->odd, odd->next even
        l_odd = _cholesky(d_odd)
        s_up = _chol_solve(l_odd, jnp.swapaxes(e_up, -1, -2))  # Dodd^-1 Eup^T
        s_lo = _chol_solve(l_odd, e_lo)                         # Dodd^-1 Elo
        D = d_even - _bmm(e_up, s_up)
        D = D.at[1:].add(-_btm(e_lo, s_lo)[:-1])
        E = -_bmm(e_up, s_lo)                                   # even i -> i+1
        levels.append((l_odd, e_up, e_lo, s_up, s_lo))
    l_root = _cholesky(D[0])

    def apply(G):
        squeeze = G.ndim == 2
        if squeeze:
            G = G[..., None]
        G = jnp.concatenate(
            [G, jnp.zeros((kp - k0,) + G.shape[1:], G.dtype)])
        s_gs = []
        for l_odd, e_up, e_lo, _, _ in levels:
            g_even, g_odd = G[0::2], G[1::2]
            s_g = _chol_solve(l_odd, g_odd)
            G = g_even - _bmm(e_up, s_g)
            G = G.at[1:].add(-_btm(e_lo, s_g)[:-1])
            s_gs.append(s_g)
        X = _chol_solve(l_root, G[0])[None]
        for (_, _, _, s_up, s_lo), s_g in zip(reversed(levels),
                                              reversed(s_gs)):
            x_right = jnp.concatenate([X[1:], jnp.zeros_like(X[:1])])
            x_odd = s_g - _bmm(s_up, X) - _bmm(s_lo, x_right)
            X = jnp.stack([X, x_odd], axis=1).reshape(
                (2 * X.shape[0],) + X.shape[1:])
        X = X[:k0]
        return X[..., 0] if squeeze else X

    return apply


def blocktri_solve_cr(D, E, G):
    """One-shot cyclic reduction: :func:`blocktri_cr_factor` applied once."""
    return blocktri_cr_factor(D, E)(G)


def blocktri_cr_factor_soa(Ds, Es):
    """Structure-of-arrays wrapper around :func:`blocktri_cr_factor`: takes
    (b, b, K) inputs and returns ``apply(Gs (b, r, K)) -> X (b, r, K)``,
    the layout the SoA assembly and ``solve.kkt.solve_kkt_soa`` use."""
    apply = blocktri_cr_factor(jnp.moveaxis(Ds, -1, 0),
                               jnp.moveaxis(Es, -1, 0))
    return lambda Gs: jnp.moveaxis(apply(jnp.moveaxis(Gs, -1, 0)), 0, -1)


from collocfem_tpu.solve.blocktri_dw import blocktri_solve_cr_dw  # noqa: E402


SOLVERS = {
    "cr": blocktri_solve_cr,
    "cr_dw": blocktri_solve_cr_dw,
    "scan": blocktri_solve_scan,
    "dense": blocktri_solve_dense,
}
