"""Numpy + scipy.sparse Gauss-Newton collocation pipeline (CPU reference).

Mirrors the device package's residual definition exactly (same LGL tables, same
scaling, same ordering) so float64 parity to 1e-9 is checkable, but follows
the *reference's* architecture (SURVEY.md §1/§3.1): per-element dense
derivative blocks scattered into a global scipy.sparse matrix, SuperLU
factorization of the damped normal equations each iteration, Levenberg
damping loop in Python.  Derivatives are hand-coded per model (the
reference lineage generates them symbolically; SURVEY.md §2a "Model
codegen") — no JAX anywhere in this package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from collocfem_tpu.ops.basis import make_basis
from collocfem_tpu.ops.mesh import Mesh
from collocfem_tpu.problem import group_measurements


class VdPModelNP:
    """Van der Pol with hand-coded numpy derivatives (matches models.vdp)."""

    nx, nu, nq, ny = 2, 1, 2, 1

    def f(self, X, U, p, t):
        """X (..., 2), U (..., 1) -> (..., 2)."""
        x1, x2 = X[..., 0], X[..., 1]
        mu, b = p
        return np.stack([x2, mu * (1 - x1**2) * x2 - x1 + b * U[..., 0]], -1)

    def dfdx(self, X, U, p, t):
        """(..., 2, 2) Jacobian of f wrt x."""
        x1, x2 = X[..., 0], X[..., 1]
        mu, _ = p
        z = np.zeros_like(x1)
        row0 = np.stack([z, np.ones_like(x1)], -1)
        row1 = np.stack([-2 * mu * x1 * x2 - 1, mu * (1 - x1**2)], -1)
        return np.stack([row0, row1], -2)

    def dfdp(self, X, U, p, t):
        """(..., 2, 2) Jacobian of f wrt p = [mu, b]."""
        x1, x2 = X[..., 0], X[..., 1]
        z = np.zeros_like(x1)
        row0 = np.stack([z, z], -1)
        row1 = np.stack([(1 - x1**2) * x2, U[..., 0]], -1)
        return np.stack([row0, row1], -2)

    def h(self, X, U, p, t):
        return X[..., :1]

    def dhdx(self, X, U=None, p=None):
        out = np.zeros(X.shape[:-1] + (1, 2))
        out[..., 0, 0] = 1.0
        return out


@dataclasses.dataclass
class BaselineProblem:
    """Static tables + data for the scipy pipeline (VdP estimation)."""

    model: VdPModelNP
    mesh: Mesh
    y: np.ndarray        # (N, S, ny) grouped measurements
    mrows: np.ndarray    # (N, S, d+1)
    mmask: np.ndarray    # (N, S)
    mtimes: np.ndarray   # (N, S)
    u: np.ndarray        # (N, d+1, nu)
    dscale: np.ndarray   # (N, d, nx)
    meas_w: np.ndarray   # (ny,)
    p_prior: np.ndarray = None   # (nq,) or None: optional prior mean on p
    p_w: np.ndarray = None       # (nq,) sqrt prior weights (None = no prior)

    @staticmethod
    def build(mesh, meas_times, y_values, u_nodes, defect_weight=100.0,
              meas_weight=1.0, model=None, p_prior=None, p_weight=None):
        model = VdPModelNP() if model is None else model
        yg, rg, mg, tg = group_measurements(mesh, meas_times, y_values)
        w = mesh.basis.weights[1:]
        h = mesh.widths
        scale = np.sqrt(w[None, :, None] * h[:, None, None] * 0.5) * float(
            defect_weight
        )
        scale = np.broadcast_to(scale, (mesh.num_elements, mesh.degree, model.nx))
        pw = None
        if p_weight is not None:
            pw = np.broadcast_to(
                np.asarray(p_weight, dtype=np.float64), (model.nq,)
            )
            p_prior = np.zeros(model.nq) if p_prior is None else np.asarray(
                p_prior, dtype=np.float64
            )
        return BaselineProblem(
            model=model, mesh=mesh, y=yg, mrows=rg, mmask=mg, mtimes=tg,
            u=u_nodes, dscale=scale,
            meas_w=np.broadcast_to(
                np.asarray(meas_weight, dtype=np.float64), (model.ny,)
            ).copy(),
            p_prior=p_prior, p_w=pw,
        )

    # -- residuals (ordering identical to collocfem_tpu.problem) -------------
    def _element_states(self, V):
        return V[self.mesh.elem_node_idx]  # (N, d+1, nx)

    def residuals(self, V, p):
        """Stacked residual vector: per-element (defects, measurements)."""
        mesh, m = self.mesh, self.model
        D = mesh.basis.diff
        Xe = self._element_states(V)                       # (N, d+1, nx)
        te = mesh.elem_times
        xdot = (2.0 / mesh.widths[:, None, None]) * np.einsum(
            "kj,ejn->ekn", D, Xe
        )
        fv = m.f(Xe, self.u, p, te)
        defect = (xdot - fv)[:, 1:, :] * self.dscale        # (N, d, nx)
        xs = np.einsum("esj,ejn->esn", self.mrows, Xe)      # (N, S, nx)
        us = np.einsum("esj,ejq->esq", self.mrows, self.u)  # (N, S, nu)
        hs = m.h(xs, us, p, self.mtimes)
        meas = (hs - self.y) * self.meas_w * self.mmask[..., None]
        n = mesh.num_elements
        out = np.concatenate(
            [defect.reshape(n, -1), meas.reshape(n, -1)], axis=1
        ).ravel()
        if self.p_w is not None:
            out = np.concatenate([out, self.p_w * (p - self.p_prior)])
        return out

    def jacobian(self, V, p):
        """Global sparse Jacobian (COO -> CSR) wrt (V.ravel(), p)."""
        mesh, m = self.mesh, self.model
        n, d, nx, nq = mesh.num_elements, mesh.degree, m.nx, m.nq
        D = mesh.basis.diff
        Xe = self._element_states(V)
        te = mesh.elem_times
        s = (d + 1) * nx

        # d defect / d x:  (2/h) D[k,j] I - delta_kj df/dx(x_k)
        A = m.dfdx(Xe, self.u, p, te)                      # (N, d+1, nx, nx)
        eye = np.eye(nx)
        jd = (2.0 / mesh.widths[:, None, None, None, None]) * (
            D[None, :, None, :, None] * eye[None, None, :, None, :]
        ) * np.ones((n, 1, 1, 1, 1))                       # (N, d+1, nx, d+1, nx)
        kk = np.arange(d + 1)
        jd[:, kk, :, kk, :] -= np.swapaxes(A, 0, 1)        # delta_kj term
        jd = jd[:, 1:] * self.dscale[..., None, None]      # scale rows
        jd_x = jd.reshape(n, d * nx, s)
        jd_p = (
            -m.dfdp(Xe, self.u, p, te)[:, 1:] * self.dscale[..., None]
        ).reshape(n, d * nx, nq)

        # d meas / d x: rows . dh/dx  (+ dh/dp for p-dependent outputs,
        # e.g. the aircraft az channel reconstructs alpha' from the model)
        xs = np.einsum("esj,ejn->esn", self.mrows, Xe)
        us = np.einsum("esj,ejq->esq", self.mrows, self.u)
        Hx = m.dhdx(xs, us, p)                             # (N, S, ny, nx)
        jm = (
            Hx[:, :, :, None, :] * self.mrows[:, :, None, :, None]
        )                                                  # (N, S, ny, d+1, nx)
        jm = jm * (self.meas_w[None, None, :, None, None])
        jm = jm * self.mmask[:, :, None, None, None]
        sy = self.y.shape[1] * m.ny
        jm_x = jm.reshape(n, sy, s)
        if hasattr(m, "dhdp"):
            Hp = m.dhdp(xs, us, p)                         # (N, S, ny, nq)
            jm_p = (
                Hp * self.meas_w[None, None, :, None]
                * self.mmask[:, :, None, None]
            ).reshape(n, sy, nq)
        else:
            jm_p = np.zeros((n, sy, nq))

        jx = np.concatenate([jd_x, jm_x], axis=1)          # (N, rows_e, s)
        jp = np.concatenate([jd_p, jm_p], axis=1)
        rows_e = jx.shape[1]

        # COO scatter: element e rows -> global rows, cols -> node dofs + p.
        row0 = np.arange(n)[:, None, None] * rows_e
        rows = row0 + np.arange(rows_e)[None, :, None]
        cols_x = (self.mesh.elem_node_idx[:, None, :, None] * nx
                  + np.arange(nx)[None, None, None, :]).reshape(n, 1, s)
        rows_x = np.broadcast_to(rows, (n, rows_e, s))
        cols_xb = np.broadcast_to(cols_x, (n, rows_e, s))
        m_dof = self.mesh.num_nodes * nx
        cols_p = np.broadcast_to(
            m_dof + np.arange(nq)[None, None, :], (n, rows_e, nq)
        )
        rows_p = np.broadcast_to(rows, (n, rows_e, nq))
        data = np.concatenate([jx.ravel(), jp.ravel()])
        r_all = np.concatenate([rows_x.ravel(), rows_p.ravel()])
        c_all = np.concatenate([cols_xb.ravel(), cols_p.ravel()])
        nrows = n * rows_e
        if self.p_w is not None:
            data = np.concatenate([data, self.p_w])
            r_all = np.concatenate([r_all, nrows + np.arange(nq)])
            c_all = np.concatenate([c_all, m_dof + np.arange(nq)])
            nrows += nq
        return sp.coo_matrix(
            (data, (r_all, c_all)), shape=(nrows, m_dof + nq)
        ).tocsr()


def gauss_newton_baseline(
    prob: BaselineProblem, V0, p0, maxiter=50, gtol=1e-9, xtol=1e-12,
    lam0=1e-3,
):
    """Reference-style LM loop: sparse normal equations + SuperLU splu."""
    V = np.array(V0, dtype=np.float64)
    p = np.array(p0, dtype=np.float64)
    m_dof = prob.mesh.num_nodes * prob.model.nx
    lam = lam0
    r = prob.residuals(V, p)
    cost = 0.5 * r @ r
    it = 0
    converged = False
    for it in range(maxiter):
        J = prob.jacobian(V, p)
        g = J.T @ r
        gnorm = np.max(np.abs(g))
        if gnorm < gtol:
            converged = True
            break
        H = (J.T @ J).tocsc()
        accepted = False
        for _ in range(25):
            Hd = H + lam * sp.identity(H.shape[0], format="csc")
            try:
                dz = -spla.splu(Hd).solve(g)
            except RuntimeError:
                lam *= 5.0
                continue
            V_try = V + dz[:m_dof].reshape(V.shape)
            p_try = p + dz[m_dof:]
            r_try = prob.residuals(V_try, p_try)
            c_try = 0.5 * r_try @ r_try
            if np.isfinite(c_try) and c_try < cost:
                step = np.linalg.norm(dz)
                V, p, r, cost = V_try, p_try, r_try, c_try
                lam = max(lam * 0.2, 1e-14)
                accepted = True
                if step < xtol:
                    converged = True
                break
            lam = min(lam * 5.0, 1e12)
        if not accepted or converged:
            if not accepted:
                break
            if converged:
                break
    return V, p, {"iterations": it + 1, "cost": cost, "converged": converged,
                  "lam": lam}
