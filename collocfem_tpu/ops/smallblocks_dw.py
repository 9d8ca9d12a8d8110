"""Double-word tiny-block algebra in SoA layout (chain on the minor axis).

Block Cholesky, triangular solves and products with every scalar op in
double-word f32 (``ops.doubleword``).  This is the
factorization precision that carries cyclic reduction past the f32
conditioning cliff (the equilibrated collocation chain has cond ~ K^2,
crossing f32's workable range at K ~ 1e4 elements) on plain f32
elementwise arithmetic.

Trace-size design: a DW scalar op costs ~10-20 XLA primitives, so the
fully scalar-unrolled structure of ``ops.smallblocks`` (fine for plain
f32) would trace ~10^5 equations per b=8 cyclic-reduction level (measured:
139k eqns, 100 s trace).  Here every inner loop is VECTORIZED over block
indices: contractions are one broadcasted ``dw.mul`` over a (b, m, c, K)
temporary plus a log2(m)-step pairwise DW reduction, and the Cholesky is
right-looking with whole-trailing-submatrix rank-1 updates — O(b) DW calls
per factorization instead of O(b^3).  The pairwise reduction is also more
accurate than sequential summation.

Matrices are ``DW`` pairs of (b, b|r, K) arrays; all DW ops broadcast, so
the K chain axis stays the minor axis untouched.
"""

from __future__ import annotations

import jax.numpy as jnp

from collocfem_tpu.ops import doubleword as dw
from collocfem_tpu.ops.doubleword import DW


def from_single(A) -> DW:
    return dw.from_single(A)


def to_single(A: DW):
    return dw.to_single(A)


def _sum(X: DW, axis: int) -> DW:
    """Pairwise DW reduction along ``axis`` (log2(n) dw.add calls)."""
    return dw.pairwise_sum(X, axis)


def _row(A: DW, i) -> DW:
    return DW(A.hi[i], A.lo[i])


def chol(A: DW) -> DW:
    """Lower Cholesky of SPD blocks, right-looking: A (b, b, K) DW -> L.

    O(b) DW calls: per pivot, one column scale and one rank-1 update of
    the whole trailing submatrix.  Pivots are floored at tiny (see
    smallblocks.chol: finite junk over NaN poisoning under damping).
    """
    b = A.hi.shape[0]
    M = A  # trailing (b-j, b-j, K) submatrix
    cols = []  # (d_j, below_j DW (b-j-1, K))
    # Pivot floor: eps^2 (~1.4e-14 for f32 base) keeps 1/pivot bounded so
    # clamped junk on an (effectively) indefinite system stays FINITE and
    # the LM reject/inflate loop can recover — flooring at dtype-tiny like
    # the f32 path would overflow the DW Schur updates to inf/NaN.
    # Legitimate pivots of an equilibrated chain are >= ~1/cond >> eps^2.
    floor = jnp.finfo(A.hi.dtype).eps ** 2
    for j in range(b):
        piv = DW(M.hi[0, 0], M.lo[0, 0])
        piv = DW(jnp.maximum(piv.hi, floor),
                 jnp.where(piv.hi > floor, piv.lo, 0.0))
        d = dw.sqrt(piv)
        below = DW(M.hi[1:, 0], M.lo[1:, 0])
        below = dw.mul(below, dw.recip(d))
        cols.append((d, below))
        if j + 1 < b:
            outer = dw.mul(DW(below.hi[:, None], below.lo[:, None]),
                           DW(below.hi[None, :], below.lo[None, :]))
            M = dw.sub(DW(M.hi[1:, 1:], M.lo[1:, 1:]), outer)
    # Pack columns into dense lower-triangular (b, b, *trailing); all ops
    # above broadcast over arbitrary trailing dims (SoA (K,) or none).
    z = jnp.zeros(A.hi.shape[2:], A.hi.dtype)
    hi_rows, lo_rows = [], []
    for i in range(b):
        hr, lr = [], []
        for j in range(b):
            if j > i:
                hr.append(z)
                lr.append(z)
            elif j == i:
                hr.append(cols[j][0].hi)
                lr.append(cols[j][0].lo)
            else:
                hr.append(cols[j][1].hi[i - j - 1])
                lr.append(cols[j][1].lo[i - j - 1])
        hi_rows.append(jnp.stack(hr))
        lo_rows.append(jnp.stack(lr))
    return DW(jnp.stack(hi_rows), jnp.stack(lo_rows))


def solve_lower(L: DW, B: DW) -> DW:
    """X with L X = B; L (b, b, K) DW lower, B (b, r, K) DW.

    Row-sequential, vectorized over (previous rows x RHS columns).
    """
    b = B.hi.shape[0]
    xs = []  # DW (r, K) rows
    for i in range(b):
        s = _row(B, i)
        if i:
            Xp = DW(jnp.stack([x.hi for x in xs]),
                    jnp.stack([x.lo for x in xs]))          # (i, r, K)
            Li = DW(L.hi[i, :i, None], L.lo[i, :i, None])    # (i, 1, K)
            s = dw.sub(s, _sum(dw.mul(Li, Xp), 0))
        xs.append(dw.mul(s, dw.recip(DW(L.hi[i, i], L.lo[i, i]))))
    return DW(jnp.stack([x.hi for x in xs]), jnp.stack([x.lo for x in xs]))


def solve_lower_t(L: DW, B: DW) -> DW:
    """X with L^T X = B (backward sweep, vectorized like solve_lower)."""
    b = B.hi.shape[0]
    xs = [None] * b
    for i in range(b - 1, -1, -1):
        s = _row(B, i)
        if i + 1 < b:
            Xn = DW(jnp.stack([x.hi for x in xs[i + 1:]]),
                    jnp.stack([x.lo for x in xs[i + 1:]]))   # (b-i-1, r, K)
            Li = DW(L.hi[i + 1:, i, None], L.lo[i + 1:, i, None])
            s = dw.sub(s, _sum(dw.mul(Li, Xn), 0))
        xs[i] = dw.mul(s, dw.recip(DW(L.hi[i, i], L.lo[i, i])))
    return DW(jnp.stack([x.hi for x in xs]), jnp.stack([x.lo for x in xs]))


def chol_solve(L: DW, B: DW) -> DW:
    return solve_lower_t(L, solve_lower(L, B))


def mm(A: DW, B: DW) -> DW:
    """(b, m, K) @ (m, c, K) -> (b, c, K): one dw.mul + pairwise reduce."""
    P = dw.mul(DW(A.hi[:, :, None], A.lo[:, :, None]),
               DW(B.hi[None], B.lo[None]))
    return _sum(P, 1)


def mtm(A: DW, B: DW) -> DW:
    """A^T @ B: (m, b, K)^T @ (m, c, K) -> (b, c, K)."""
    return mm(transpose(A), B)


def sub(A: DW, B: DW) -> DW:
    return dw.sub(A, B)


def transpose(A: DW) -> DW:
    return DW(jnp.swapaxes(A.hi, 0, 1), jnp.swapaxes(A.lo, 0, 1))
