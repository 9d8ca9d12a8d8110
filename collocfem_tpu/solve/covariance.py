"""Parameter covariance / standard errors from the Gauss-Newton Fisher matrix.

The output-error lineage reports parameter standard errors alongside the
estimates (Cramer-Rao bounds from the GN approximation of the information
matrix — SURVEY.md §3.4).  With the residual convention used here (each
residual pre-multiplied by its sqrt information 1/sigma), the GN normal
matrix IS the Fisher information of (V, p); the parameter covariance is the
inverse of its p-Schur complement:

    Cov(p) = ( C - B^T A^{-1} B )^{-1}

computed with the same block-tridiagonal machinery as the Newton step — one
multi-RHS chain solve, no global matrix.
"""

from __future__ import annotations

import jax.numpy as jnp

from collocfem_tpu.ops.assemble import assemble_gn
from collocfem_tpu.ops.einsum_hp import einsum_hp
from collocfem_tpu.ops.smallblocks import spd_solve
from collocfem_tpu.solve.blocktri import SOLVERS, blocktri_inverse_blocks


def parameter_covariance(problem, z, data, method: str = "cr"):
    """(nq, nq) covariance of the parameter estimate at solution ``z``.

    Assumes measurement weights are 1/sigma (so residuals are standardized)
    and the solution is a (local) optimum.  For joint MAP estimation the
    defect weights contribute as the process-noise prior, giving the
    posterior covariance of p.
    """
    sys = assemble_gn(problem, z, data)
    nq = sys.C.shape[0]
    if nq == 0:
        return jnp.zeros((0, 0), sys.D.dtype)
    solver = SOLVERS[method]
    a_b = solver(sys.D, sys.E, sys.B)               # A^{-1} B
    schur = sys.C - einsum_hp("kbq,kbr->qr", sys.B, a_b)
    # SPD inverse via the unrolled Cholesky (ops.smallblocks).
    eye = jnp.eye(schur.shape[0], dtype=schur.dtype)
    return spd_solve(schur, eye)


def parameter_std(problem, z, data, method: str = "cr"):
    """(nq,) standard errors: sqrt(diag(Cov(p)))."""
    cov = parameter_covariance(problem, z, data, method)
    return jnp.sqrt(jnp.diag(cov))


def state_covariance_blocks(problem, z, data, method: str = "cr"):
    """Block-tridiagonal part of the state-path covariance at solution ``z``.

    The xx-block of the KKT inverse, marginalized over the parameters:

        Cov(x) = A^{-1} + (A^{-1} B) Cov(p) (A^{-1} B)^T

    with the block-(tri)diagonal part of ``A^{-1}`` from the Takahashi
    selected inverse (:func:`blocktri_inverse_blocks`) and the parameter
    correction a rank-nq update from quantities the parameter-covariance
    path already computes.  Per-node covariances and per-element confidence
    bands never need more of the dense inverse than these blocks.

    Returns ``(diag (K, bd, bd), off (K-1, bd, bd), cov_p (nq, nq))`` where
    ``off[k] = Cov(block k, block k+1)``.
    """
    sys = assemble_gn(problem, z, data)
    diag, off = blocktri_inverse_blocks(sys.D, sys.E)
    nq = sys.C.shape[0]
    if nq == 0:
        return diag, off, jnp.zeros((0, 0), sys.D.dtype)
    a_b = SOLVERS[method](sys.D, sys.E, sys.B)      # W = A^{-1} B  (K, bd, nq)
    schur = sys.C - einsum_hp("kbq,kbr->qr", sys.B, a_b)
    cov_p = spd_solve(schur, jnp.eye(nq, dtype=schur.dtype))
    wc = einsum_hp("kbq,qr->kbr", a_b, cov_p)       # W Cov(p)
    diag = diag + einsum_hp("kbq,kcq->kbc", wc, a_b)
    off = off + einsum_hp("kbq,kcq->kbc", wc[:-1], a_b[1:])
    return diag, off, cov_p


def state_covariance_nodes(problem, z, data, method: str = "cr"):
    """(num_nodes, nv, nv) marginal covariance of each node's variables."""
    diag, _, _ = state_covariance_blocks(problem, z, data, method)
    k, bd, _ = diag.shape
    nv = problem.nv
    d = bd // nv
    per_node = diag.reshape(k, d, nv, d, nv)
    per_node = per_node[:, jnp.arange(d), :, jnp.arange(d), :]  # (d, k, nv, nv)
    per_node = per_node.swapaxes(0, 1).reshape(k * d, nv, nv)
    return per_node[: problem.num_nodes]


def state_std(problem, z, data, method: str = "cr"):
    """(num_nodes, nv) standard deviation of every node variable.

    The pointwise confidence band of the estimated trajectory (and of the
    control trajectory for OCP problems, which share the node layout).
    """
    cov = state_covariance_nodes(problem, z, data, method)
    var = jnp.diagonal(cov, axis1=-2, axis2=-1)
    return jnp.sqrt(jnp.maximum(var, 0.0))


def element_covariance(problem, z, data, method: str = "cr"):
    """(N, s, s) joint covariance of each element's stacked variables.

    Element ``e`` owns block ``e`` plus the leading ``nv`` variables of
    block ``e+1`` (the shared boundary node) — ``s = (d+1)*nv`` locals, in
    the same layout as ``problem.gather_elements``.  This is the covariance
    needed to propagate uncertainty through the element's interpolating
    polynomial (confidence bands at arbitrary ``t``, not just at nodes).
    """
    diag, off, _ = state_covariance_blocks(problem, z, data, method)
    nv = problem.nv
    n = problem.mesh.num_elements
    bd = diag.shape[1]
    s = bd + nv
    top_left = diag[:n]                              # (N, bd, bd)
    top_right = off[:n, :, :nv]                      # (N, bd, nv)
    bot_right = diag[1 : n + 1, :nv, :nv]            # (N, nv, nv)
    cov = jnp.zeros((n, s, s), diag.dtype)
    cov = cov.at[:, :bd, :bd].set(top_left)
    cov = cov.at[:, :bd, bd:].set(top_right)
    cov = cov.at[:, bd:, :bd].set(top_right.swapaxes(-1, -2))
    cov = cov.at[:, bd:, bd:].set(bot_right)
    return cov


def trajectory_std(problem, z, data, times, method: str = "cr"):
    """(T, nv) standard deviation of the interpolated trajectory at ``times``.

    Propagates the per-element joint node covariance through the Lagrange
    interpolation row: Var[x(t)] = r(t)^T Cov_elem r(t) per variable, so the
    band is consistent between nodes (unlike interpolating node stds, which
    ignores the strong within-element correlation).
    """
    import numpy as np

    mesh = problem.mesh
    nv = problem.nv
    d = mesh.degree
    ecov = element_covariance(problem, z, data, method)   # (N, s, s)
    e, rows = mesh.interp_rows(np.asarray(times))
    rows = jnp.asarray(rows, ecov.dtype)                  # (T, d+1)
    C = ecov[e].reshape(rows.shape[0], d + 1, nv, d + 1, nv)
    var = einsum_hp("tj,tl,tjala->ta", rows, rows, C)
    return jnp.sqrt(jnp.maximum(var, 0.0))
