"""Damped KKT solve: block-tridiagonal core + arrowhead Schur complement.

SURVEY.md §7 hard part 2: parameters touch every element (arrowhead
columns); they are eliminated by a Schur complement — solve the
block-tridiagonal part against [g_x | B] in one multi-RHS pass, then a tiny
dense (nq, nq) solve, then back-substitution.  Replaces the reference's
global sparse factorization of the bordered system (SURVEY.md §2b).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from collocfem_tpu.ops.einsum_hp import einsum_hp

from collocfem_tpu.ops.assemble import BlockTriSystem, materialize_dense
from collocfem_tpu.ops.smallblocks import spd_solve
from collocfem_tpu.solve.blocktri import SOLVERS


# Chain-solver names every driver accepts: the SOLVERS registry plus
# 'dense_full' (solve_kkt's materialized bordered system).
METHODS = frozenset(SOLVERS) | {"dense_full"}


def resolve_method(method: str) -> str:
    """Resolve ``SolverOptions.method`` at solver-build time.

    'auto' is the cyclic reduction ('cr'); any other name must be a known
    chain solver.  An unknown name raises here, before tracing, instead of
    selecting some other solver.
    """
    if method == "auto":
        return "cr"
    if method not in METHODS:
        raise ValueError(
            f"unknown KKT method {method!r}; expected 'auto' or one of "
            f"{sorted(METHODS)}"
        )
    return method


def _schur_solve(schur, r):
    """Tiny dense SPD solve of the (nq, nq) parameter Schur system.

    Unrolled Cholesky (ops.smallblocks) instead of jnp.linalg.solve: at
    nq <= 16 the unrolled arithmetic fuses into the surrounding elementwise
    code instead of a library call.  The Schur complement of the
    equilibrated damped GN system is SPD by construction.
    """
    return spd_solve(schur, r[:, None])[:, 0]


def _equilibrate(sys: BlockTriSystem, lam, damp_scale=None):
    """Symmetric Jacobi scaling of the damped KKT system.

    The collocation Hessian mixes O((2/h D)^2) defect curvature with O(1)
    measurement rows — condition numbers of 1e7+ that swamp float32 (the
    default working precision; SURVEY.md §7 hard part 4).  Scaling by
    S = diag(damped H)^(-1/2) brings the diagonal to exactly 1; the scaled
    Schur complements stay SPD and the float32 factorization error drops by
    orders of magnitude.  Cost: O(K b^2) elementwise — negligible next to
    the factorization.
    """
    bd = sys.block_size
    nq = sys.C.shape[0]
    eye_b = jnp.eye(bd, dtype=sys.D.dtype)
    # Dimensionless isotropic (Levenberg) damping: lam multiplies the
    # GLOBAL max diagonal, i.e. A + lam*max(diag(A))*I in the original
    # coordinates.  An absolute lam*I is meaningless once the diagonal
    # spans 1..1e8 (relative 1e-11 at lam=1e-3): the f32 assembly noise
    # (~u * diag) then dominates and the "damped" system can be
    # INDEFINITE, which f64/double-word factorizations faithfully turn
    # into overflow junk while f32's clamped pivots hide it.  A single
    # global scale keeps the damping geometry isotropic (per-row Marquardt
    # scaling distorted LM trajectories into slow valley-crawls on the MAP
    # state-path problems) while making lam scale-free and guaranteeing a
    # PD damped system for lam >> sqrt(n_terms)*u ~ 1e-6.
    diag = einsum_hp("kii->ki", sys.D)                      # (K, bd)
    if damp_scale is None:
        dmax = jnp.max(diag)
        if nq:
            dmax = jnp.maximum(dmax, jnp.max(jnp.diag(sys.C)))
    else:
        # Caller-chosen damping scale.  The barrier interior-point solvers
        # pass the PRE-barrier (estimation) max diagonal: the barrier's
        # 1/g^2 curvature blows the system diagonal up by ~1/mu near an
        # active constraint, and lam * that wall crushes the tangential
        # directions the iterate must slide along (measured: the
        # constrained VdP estimate jammed at a non-stationary boundary
        # point).  Equilibration below still uses the FULL damped diagonal.
        dmax = damp_scale
    lam_abs = lam * jnp.maximum(dmax, jnp.finfo(sys.D.dtype).tiny)
    d_damped = sys.D + lam_abs * eye_b
    sx = jnp.sqrt(einsum_hp("kii->ki", d_damped))
    inv_sx = 1.0 / sx
    D = d_damped * inv_sx[:, :, None] * inv_sx[:, None, :]  # unit diagonal
    E = sys.E[:-1] * inv_sx[:-1, :, None] * inv_sx[1:, None, :]
    E = jnp.concatenate([E, sys.E[-1:]], axis=0)            # E[K-1] unused/0
    gx = sys.gx * inv_sx
    if nq:
        c_damped = sys.C + lam_abs * jnp.eye(nq, dtype=sys.C.dtype)
        inv_sp = 1.0 / jnp.sqrt(jnp.diag(c_damped))
        B = sys.B * inv_sx[:, :, None] * inv_sp[None, None, :]
        C = c_damped * inv_sp[:, None] * inv_sp[None, :]
        gp = sys.gp * inv_sp
    else:
        inv_sp = jnp.zeros((0,), sys.D.dtype)
        B, C, gp = sys.B, sys.C, sys.gp
    scaled = BlockTriSystem(D=D, E=E, B=B, C=C, gx=gx, gp=gp)
    return scaled, inv_sx, inv_sp, dmax


def blocktri_matvec(D, E, X):
    """y = A X for the symmetric block-tridiagonal A (E[K-1] ignored)."""
    y = einsum_hp("kij,kj->ki", D, X)
    y = y.at[:-1].add(einsum_hp("kij,kj->ki", E[:-1], X[1:]))
    y = y.at[1:].add(einsum_hp("kji,kj->ki", E[:-1], X[:-1]))
    return y


def _equilibrate_soa(sys, lam, damp_scale=None):
    """Jacobi scaling of the damped SoA system (no layout shuffles).

    Dimensionless isotropic damping: lam multiplies the global max
    diagonal — see :func:`_equilibrate` for why an absolute lam*I fails
    at this problem's diagonal dynamic range, and for ``damp_scale``'s
    role in the barrier interior-point solvers.
    """
    bd = sys.block_size
    nq = sys.C.shape[0]
    dtype = sys.D.dtype
    eye = jnp.eye(bd, dtype=dtype)[:, :, None]
    diag = jnp.stack([sys.D[i, i] for i in range(bd)])      # (bd, K)
    if damp_scale is None:
        dmax = jnp.max(diag)
        if nq:
            dmax = jnp.maximum(dmax, jnp.max(jnp.diag(sys.C)))
    else:
        dmax = damp_scale
    lam_abs = lam * jnp.maximum(dmax, jnp.finfo(dtype).tiny)
    Dd = sys.D + lam_abs * eye
    diag_d = diag + lam_abs
    inv = 1.0 / jnp.sqrt(diag_d)
    D = Dd * inv[:, None, :] * inv[None, :, :]
    inv_next = jnp.concatenate(
        [inv[:, 1:], jnp.ones_like(inv[:, :1])], axis=-1
    )
    E = sys.E * inv[:, None, :] * inv_next[None, :, :]
    gx = sys.gx * inv
    if nq:
        c_damped = sys.C + lam_abs * jnp.eye(nq, dtype=dtype)
        inv_sp = 1.0 / jnp.sqrt(jnp.diag(c_damped))
        B = sys.B * inv[:, None, :] * inv_sp[None, :, None]
        C = c_damped * inv_sp[:, None] * inv_sp[None, :]
        gp = sys.gp * inv_sp
    else:
        inv_sp = jnp.zeros((0,), dtype)
        B, C, gp = sys.B, sys.C, sys.gp
    return type(sys)(D=D, E=E, B=B, C=C, gx=gx, gp=gp), inv, inv_sp, dmax


def _matvec_soa(D, E, X):
    """y = A X in SoA: D/E (bd, bd, K), X (bd, K) — unrolled block rows."""
    bd = D.shape[0]
    rows = []
    for i in range(bd):
        s = sum(D[i, j] * X[j] for j in range(bd))
        up = sum(E[i, j, :-1] * X[j, 1:] for j in range(bd))
        lo = sum(E[j, i, :-1] * X[j, :-1] for j in range(bd))
        s = s.at[:-1].add(up)
        s = s.at[1:].add(lo)
        rows.append(s)
    return jnp.stack(rows)


def solve_kkt_soa(sys, lam, refine: int = 0, dw: bool = False,
                  damp_scale=None, with_dmax: bool = False):
    """SoA twin of :func:`solve_kkt` (sys: assemble.BlockTriSystemSoA).

    The entire pipeline — equilibration, factorization, multi-RHS apply,
    arrowhead Schur, iterative refinement — runs in the chain-on-lanes
    layout with zero transposes; the block-major layout's (K, b, b)
    tile-padding made each layout shuffle cost more than the factorization
    itself at K ~ 10^4.  Returns (dx (bd, K), dp (nq,)).

    ``dw=True`` factorizes the chain in double-word f32 (~48-bit,
    solve.blocktri_dw): the single-shot path past the f32 conditioning
    cliff at K ~ 1e4 (cond ~ K^2), at ~an order of magnitude more
    elementwise work than the plain-f32 factorization.
    """
    from collocfem_tpu.solve.blocktri import blocktri_cr_factor_soa
    from collocfem_tpu.solve.blocktri_dw import blocktri_cr_factor_soa_dw

    nq = sys.C.shape[0]
    with jax.named_scope("equilibrate"):
        s, inv, inv_sp, dmax = _equilibrate_soa(sys, lam, damp_scale)
    ret = (lambda dx, dp: (dx, dp, dmax)) if with_dmax else \
        (lambda dx, dp: (dx, dp))
    factor = blocktri_cr_factor_soa_dw if dw else blocktri_cr_factor_soa
    with jax.named_scope("chain_factor"):
        apply_fn = factor(s.D, s.E)

    if nq == 0:
        dx = -apply_fn(s.gx[:, None, :])[:, 0, :]
        for _ in range(refine):
            res = s.gx + _matvec_soa(s.D, s.E, dx)
            dx = dx - apply_fn(res[:, None, :])[:, 0, :]
        return ret(dx * inv, jnp.zeros((0,), sys.D.dtype))

    rhs = jnp.concatenate([s.gx[:, None, :], s.B], axis=1)  # (bd, 1+nq, K)
    with jax.named_scope("chain_apply"):
        x = apply_fn(rhs)
    a_g, a_b = x[:, 0, :], x[:, 1:, :]
    if dw:
        # The Schur complement C - B^T A^{-1} B cancels almost exactly on
        # long chains (its value can be ~1e-4 of either operand); float32
        # reduction noise over ~b*K terms then dominates the parameter
        # block and parameter steps become noise.  The double-word tier
        # accumulates these contractions in DW so the cancellation
        # survives (assemble_gn_soa's DW nq-reductions are the matching
        # assembly-side fix).
        from collocfem_tpu.ops import doubleword as dwm

        schur = s.C - jnp.stack([
            jnp.stack([
                dwm.to_single(dwm.dot(s.B[:, q, :].ravel(),
                                      a_b[:, q2, :].ravel()))
                for q2 in range(nq)
            ]) for q in range(nq)
        ])
        rp = s.gp - jnp.stack([
            dwm.to_single(dwm.dot(s.B[:, q, :].ravel(), a_g.ravel()))
            for q in range(nq)
        ])
    else:
        schur = s.C - einsum_hp("bqk,brk->qr", s.B, a_b)
        rp = s.gp - einsum_hp("bqk,bk->q", s.B, a_g)
    dp = -_schur_solve(schur, rp)
    dx = -(a_g + einsum_hp("bqk,q->bk", a_b, dp))
    for _ in range(refine):
        res_x = (
            s.gx + _matvec_soa(s.D, s.E, dx)
            + einsum_hp("bqk,q->bk", s.B, dp)
        )
        res_p = (
            s.gp + einsum_hp("bqk,bk->q", s.B, dx)
            + einsum_hp("qr,r->q", s.C, dp)
        )
        ax = apply_fn(res_x[:, None, :])[:, 0, :]
        cp = _schur_solve(
            schur, res_p - einsum_hp("bqk,bk->q", s.B, ax)
        )
        cx = ax - einsum_hp("bqk,q->bk", a_b, cp)
        dx = dx - cx
        dp = dp - cp
    return ret(dx * inv, dp * inv_sp)


def solve_kkt(sys: BlockTriSystem, lam, method: str = "cr",
              refine: int = 0, damp_scale=None, with_dmax: bool = False):
    """Solve the damped KKT system [[A, B], [B^T, C]] [dx, dp] = -[gx, gp].

    Damping is isotropic Levenberg at a dimensionless scale: the system is
    symmetrically Jacobi-equilibrated and ``lam * dmax * I`` is added,
    where ``dmax = max(diag(A) ∪ diag(C))`` — i.e. A + lam*dmax*I in the
    original coordinates, NOT per-row Marquardt ``A + lam diag(A)``
    (see _equilibrate; newton.py's gain-ratio predicted-decrease
    ``0.5*(lam*dmax*||s||² − g·s)`` relies on these isotropic
    semantics).  With
    ``refine > 0``, performs that many iterative-refinement passes —
    residual of the (scaled) KKT system, correction re-solve — pushing the
    float32 step error from O(eps * cond) toward O(eps) (SURVEY.md §7 hard
    part 4) for one extra factorization-free solve each.  Returns
    (dx (K, bd), dp (nq,)).
    """
    k, bd = sys.num_blocks, sys.block_size
    nq = sys.C.shape[0]

    if method == "dense_full":
        h, g = materialize_dense(sys)
        n = h.shape[0]
        scale = jnp.max(jnp.diag(h)) if damp_scale is None else damp_scale
        lam_abs = lam * jnp.maximum(scale, jnp.finfo(h.dtype).tiny)
        d = -jnp.linalg.solve(h + lam_abs * jnp.eye(n, dtype=h.dtype), g)
        dx = d[: k * bd].reshape(k, bd)
        if with_dmax:
            return dx, d[k * bd :], scale
        return dx, d[k * bd :]

    s, inv_sx, inv_sp, dmax = _equilibrate(sys, lam, damp_scale)
    ret = (lambda dx, dp: (dx, dp, dmax)) if with_dmax else \
        (lambda dx, dp: (dx, dp))
    if method == "cr":
        # Factorize once; every solve (multi-RHS and each refinement pass)
        # reuses the factors (blocktri_cr_factor).
        from collocfem_tpu.solve.blocktri import blocktri_cr_factor

        solve_once = blocktri_cr_factor(s.D, s.E)
    else:
        solver = SOLVERS[method]
        solve_once = lambda G: solver(s.D, s.E, G)

    if nq == 0:
        dx = -solve_once(s.gx[..., None])[..., 0]
        for _ in range(refine):
            res = s.gx + blocktri_matvec(s.D, s.E, dx)
            dx = dx - solve_once(res[..., None])[..., 0]
        return ret(dx * inv_sx, jnp.zeros((0,), sys.D.dtype))

    rhs = jnp.concatenate([s.gx[..., None], s.B], axis=-1)  # (K, bd, 1+nq)
    x = solve_once(rhs)
    a_g, a_b = x[..., 0], x[..., 1:]                # A^{-1}gx, A^{-1}B
    schur = s.C - einsum_hp("kbq,kbr->qr", s.B, a_b)
    rp = s.gp - einsum_hp("kbq,kb->q", s.B, a_g)
    dp = -_schur_solve(schur, rp)
    dx = -(a_g + einsum_hp("kbq,q->kb", a_b, dp))
    for _ in range(refine):
        res_x = (
            s.gx + blocktri_matvec(s.D, s.E, dx)
            + einsum_hp("kbq,q->kb", s.B, dp)
        )
        res_p = (
            s.gp + einsum_hp("kbq,kb->q", s.B, dx)
            + einsum_hp("qr,r->q", s.C, dp)
        )
        ax = solve_once(res_x[..., None])[..., 0]
        cp = _schur_solve(
            schur, res_p - einsum_hp("kbq,kb->q", s.B, ax)
        )
        cx = ax - einsum_hp("kbq,q->kb", a_b, cp)
        dx = dx - cx
        dp = dp - cp
    return ret(dx * inv_sx, dp * inv_sp)
