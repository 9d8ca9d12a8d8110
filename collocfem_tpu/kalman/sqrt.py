"""Square-root Kalman filtering/smoothing (QR array algorithms).

The float32-native path: covariances are carried as lower-triangular
square roots and every propagation/update is one QR triangularization of a
stacked pre-array (Kailath array algorithm), so covariances stay PSD by
construction at roughly half the working precision's condition-number
sensitivity — the same trick that makes the f32 collocation stack viable
(SURVEY.md §7 hard part 4).

Smoother uses the all-PSD Joseph form

    P_s = G P_s' G^T + (I - G A) P_f (I - G A)^T + G Q G^T

so the smoothed square root is again a single stacked QR — no differencing
of covariances anywhere.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


class SqrtFilterResult(NamedTuple):
    """Means (T, nx); S_* are lower-triangular with P = S S^T."""

    mean_f: jnp.ndarray
    S_f: jnp.ndarray
    mean_p: jnp.ndarray
    S_p: jnp.ndarray
    loglik: jnp.ndarray


def psd_sqrt(M):
    """Symmetric PSD square root via eigh, eigenvalues clamped at 0.

    Used for process-noise inputs that may be exactly singular (e.g.
    Qd[0] = 0, Van Loan Qd of rank-deficient Qc) where Cholesky would NaN.
    """
    w, V = jnp.linalg.eigh(0.5 * (M + jnp.swapaxes(M, -1, -2)))
    return (V * jnp.sqrt(jnp.maximum(w, 0.0))[..., None, :]) @ jnp.swapaxes(
        V, -1, -2)


def _tri_pos(Rm):
    """Flip row signs so the triangular factor has nonnegative diagonal."""
    d = jnp.sign(jnp.diagonal(Rm))
    d = jnp.where(d == 0, 1.0, d)
    return d[:, None] * Rm


def _qr_r(pre):
    """Upper factor of a tall pre-array, diagonal made nonnegative."""
    return _tri_pos(jnp.linalg.qr(pre, mode="r"))


def sqrt_kalman_filter(Ad, Qd, H, R, y, m0, P0, mask=None) -> SqrtFilterResult:
    """Linear square-root KF. Same conventions as ``kalman_filter``.

    Qd may be singular (a PSD sqrt is taken via eigh); R must be PD.
    """
    from collocfem_tpu.kalman.filtering import _bcast_time

    y = jnp.asarray(y)
    T, ny = y.shape
    Hb = _bcast_time(H, T)
    Rb = _bcast_time(R, T)
    mask = jnp.ones(T, y.dtype) if mask is None else jnp.asarray(mask, y.dtype)
    Q_sq = psd_sqrt(jnp.asarray(Qd))
    R_sq = jnp.linalg.cholesky(Rb)
    m0 = jnp.asarray(m0)
    S0 = jnp.linalg.cholesky(jnp.asarray(P0))
    nx = m0.shape[0]

    def step(carry, inp):
        m, S = carry
        A_k, Qs_k, H_k, Rs_k, y_k, mk = inp
        # Predict: S_p from QR of [[(A S)^T], [Qs^T]].
        S_p = _qr_r(jnp.concatenate([(A_k @ S).T, Qs_k.T], axis=0)).T
        m_p = A_k @ m
        # Update: one triangularization of the (ny+nx) pre-array.
        pre = jnp.zeros((ny + nx, ny + nx), y.dtype)
        pre = pre.at[:ny, :ny].set(Rs_k.T)
        pre = pre.at[ny:, :ny].set(S_p.T @ H_k.T)
        pre = pre.at[ny:, ny:].set(S_p.T)
        post = _qr_r(pre)
        S_y = post[:ny, :ny].T              # innovation sqrt (lower)
        Kbar = post[:ny, ny:].T             # K @ S_y
        S_f = post[ny:, ny:].T
        e = y_k - H_k @ m_p
        ew = solve_triangular(S_y, e, lower=True)
        m_f = m_p + mk * (Kbar @ ew)
        S_f = mk * S_f + (1.0 - mk) * S_p
        ll = mk * (-0.5) * (
            ew @ ew + 2.0 * jnp.sum(jnp.log(jnp.diagonal(S_y)))
            + ny * jnp.log(2.0 * jnp.pi))
        return (m_f, S_f), (m_f, S_f, m_p, S_p, ll)

    _, (m_f, S_f, m_p, S_p, ll) = jax.lax.scan(
        step, (m0, S0), (jnp.asarray(Ad), Q_sq, Hb, R_sq, y, mask))
    return SqrtFilterResult(m_f, S_f, m_p, S_p, jnp.sum(ll))


def sqrt_rts_smoother(res: SqrtFilterResult, Ad, Qd):
    """Square-root RTS pass. Returns smoothed (means (T,nx), S (T,nx,nx)).

    Needs the same per-step (Ad, Qd) passed to the forward filter; the
    smoother gain is built from triangular solves against S_p (no inverse,
    no covariance differencing).
    """
    Q_sq = psd_sqrt(jnp.asarray(Qd))
    nx = res.mean_f.shape[1]
    eye = jnp.eye(nx, dtype=res.mean_f.dtype)

    def step(carry, inp):
        ms_next, Ss_next = carry
        m_f, S_f, A1, Qs1, m_p1, S_p1 = inp
        P_f = S_f @ S_f.T
        # G^T = P_p^{-1} A P_f via two triangular solves on S_p.
        t1 = solve_triangular(S_p1, A1 @ P_f, lower=True)
        G = solve_triangular(S_p1.T, t1, lower=False).T
        ms = m_f + G @ (ms_next - m_p1)
        pre = jnp.concatenate(
            [(G @ Ss_next).T, ((eye - G @ A1) @ S_f).T, (G @ Qs1).T], axis=0)
        Ss = _qr_r(pre).T
        return (ms, Ss), (ms, Ss)

    inps = (res.mean_f[:-1], res.S_f[:-1], jnp.asarray(Ad)[1:], Q_sq[1:],
            res.mean_p[1:], res.S_p[1:])
    init = (res.mean_f[-1], res.S_f[-1])
    _, (ms, Ss) = jax.lax.scan(step, init, inps, reverse=True)
    ms = jnp.concatenate([ms, res.mean_f[-1:]], axis=0)
    Ss = jnp.concatenate([Ss, res.S_f[-1:]], axis=0)
    return ms, Ss
