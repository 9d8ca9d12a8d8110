"""Multi-experiment estimation: data parallelism with shared parameters.

BASELINE.json config 5 ("Batched multi-experiment estimation: 1024 vmapped
trajectories, ~10k total elements").  The reference loops over experiments in
one Python process (SURVEY.md §3.5); here the per-experiment Gauss-Newton
systems are assembled and solved *batched* (vmap in-shard) and, when a device
mesh is given, sharded over the "dp" axis.  The experiments share the
parameter vector p, which couples them only through the tiny (nq, nq)
parameter Schur complement — the single cross-device reduction per iteration
is a ``psum`` of that Schur block and its gradient (SURVEY.md §2c DP row).

The accept/damping logic is the SHARED gain-ratio + Nielsen + double-word
loop (solve.lm_core), the same body as the single-device headline solver —
a plain f32 `c_try < cost` test freezes below ~cost·6e-8 resolution exactly
on the large total-element-count batches this path exists for.

Structure per iteration (all on device):
  per experiment e:  A_e dx_e + B_e dp = -gx_e   (block-tridiagonal A_e)
  shared:            sum_e B_e^T dx_e + (C_e) dp = -sum_e gp_e
  =>  S = sum_e (C_e - B_e^T A_e^{-1} B_e) + prior,
      r = sum_e (gp_e - B_e^T A_e^{-1} gx_e) + prior,
      dp = -S^{-1} r;   dx_e = -A_e^{-1}(gx_e + B_e dp).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from collocfem_tpu.ops import doubleword as dw
from collocfem_tpu.ops.einsum_hp import einsum_hp
from collocfem_tpu.ops.smallblocks import spd_solve

from collocfem_tpu.ops.assemble import (
    assemble_gn,
    assemble_gn_soa_batched,
    blocks_to_nodes,
)
from collocfem_tpu.problem import Decision
from collocfem_tpu.solve.blocktri import SOLVERS, blocktri_cr_factor_soa
from collocfem_tpu.solve.lm_core import LMAux, lm_loop, psum_dw
from collocfem_tpu.solve.newton import (
    HISTORY_COLS,
    SolveStats,
    SolverOptions,
    stats_from_lm,
)


class BatchDecision(NamedTuple):
    """V: (n_exp, M, nv) per-experiment state paths; p: (nq,) shared."""

    V: jnp.ndarray
    p: jnp.ndarray


def _psum_maybe(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def _local_cost(problem, z: BatchDecision, data_batch):
    """Sum of per-experiment costs over the local batch (no shared prior)."""
    per_exp = jax.vmap(
        lambda V, d: problem.cost(Decision(V=V, p=z.p), d), in_axes=(0, 0)
    )(z.V, data_batch)
    return jnp.sum(per_exp)


def batch_cost(problem, z: BatchDecision, data_batch, p_prior, p_w):
    """Total cost over the experiment batch + global parameter prior.

    Per-experiment ``data_batch.p_w`` must be zero — the shared prior enters
    exactly once, here.
    """
    rp = p_w * (z.p - p_prior)
    return _local_cost(problem, z, data_batch) + 0.5 * jnp.sum(rp * rp)


def _batch_cost_dw(problem, z: BatchDecision, data_batch, p_prior, p_w,
                   dp_axis):
    """Double-word total cost: per-experiment residual vectors accumulated
    in DW locally, summed exactly across "dp" shards (lm_core.psum_dw), the
    shared prior added once (identically on every shard)."""
    r = jax.vmap(
        lambda V, d: problem.residual_vector(Decision(V=V, p=z.p), d),
        in_axes=(0, 0),
    )(z.V, data_batch).ravel()
    s = dw.pairwise_sum(dw.DW(*dw.two_prod(r, r)))
    if dp_axis is not None:
        s = psum_dw(s, dp_axis)
    rp = p_w * (z.p - p_prior)
    s = dw.add(s, dw.pairwise_sum(dw.DW(*dw.two_prod(rp, rp))))
    return dw.mul_single(s, 0.5)


def concat_chain_solve(D, E, G):
    """Chain solve for the concatenated batch chain: SoA cyclic reduction
    in the (b, b, K) / (b, r, K) convention (zero coupling at experiment
    boundaries keeps the experiments independent)."""
    return blocktri_cr_factor_soa(D, E)(G)


def shared_gn_step_soa(
    problem,
    sys,
    lam,
    p,
    p_prior,
    p_w,
    *,
    n_exp: int,
    chain_solve,
    dp_axis: str | None = None,
):
    """One damped shared-parameter GN step from the CONCATENATED-chain SoA
    system (ops.assemble.assemble_gn_soa_batched) — config 5's hot path.

    The whole local batch is one (bd, bd, n_exp*K) chain with zero coupling
    at experiment boundaries, so a single chain solve
    factors every experiment at once and the arrowhead Schur complement IS
    the shared-parameter reduction.  Damping is dimensionless per
    EXPERIMENT (lam * max diagonal of experiment e's blocks — identical to
    the block-major path, and therefore invariant to the dp shard count);
    ``aux.sds`` accounts for the block-diagonal damping matrix exactly, so
    the gain-ratio model stays consistent under dp sharding.

    Returns (dV (n_exp, M, nv), dp (nq,), aux: LMAux) with globally-reduced
    aux scalars.
    """
    nq = problem.model.nq
    bd, _, kt = sys.D.shape
    k = kt // n_exp
    nv = problem.nv
    dtype = sys.D.dtype
    tiny = jnp.finfo(dtype).tiny

    diag = jnp.stack([sys.D[i, i] for i in range(bd)])       # (bd, Kt)
    dmax_e = jnp.maximum(
        jnp.max(diag.reshape(bd, n_exp, k), axis=(0, 2)), tiny
    )                                                        # (n_exp,)
    lam_lane = jnp.broadcast_to(
        (lam * dmax_e)[:, None], (n_exp, k)
    ).reshape(kt)                                            # (Kt,)
    eye = jnp.eye(bd, dtype=dtype)[:, :, None]
    inv = 1.0 / jnp.sqrt(diag + lam_lane)
    Dsc = (sys.D + lam_lane * eye) * inv[:, None, :] * inv[None, :, :]
    inv_next = jnp.concatenate([inv[:, 1:], jnp.ones_like(inv[:, :1])], -1)
    Esc = sys.E * inv[:, None, :] * inv_next[None, :, :]
    rhs = jnp.concatenate(
        [(sys.gx * inv)[:, None, :], sys.B * inv[:, None, :]], axis=1
    )
    x = chain_solve(Dsc, Esc, rhs)                           # (bd, 1+nq, Kt)
    # Unscale back to original coordinates: A_d^{-1} = S X~ S for the
    # state-side-only Jacobi scaling S = diag(inv).
    a_g = x[:, 0, :] * inv
    a_b = x[:, 1:, :] * inv[:, None, :]

    s_loc = sys.C - einsum_hp("bqk,brk->qr", sys.B, a_b)
    r_loc = sys.gp - einsum_hp("bqk,bk->q", sys.B, a_g)
    gx_max = jnp.max(jnp.abs(sys.gx))
    s_tot = _psum_maybe(s_loc, dp_axis)
    r_tot = _psum_maybe(r_loc, dp_axis)
    gp_sum = _psum_maybe(sys.gp, dp_axis)
    if dp_axis is not None:
        gx_max = jax.lax.pmax(gx_max, dp_axis)

    pw2 = p_w**2
    prior_g = pw2 * (p - p_prior)
    s_tot = s_tot + jnp.diag(pw2)
    smax = jnp.maximum(jnp.max(jnp.diag(s_tot)), tiny)
    s_tot = s_tot + (lam * smax) * jnp.eye(nq, dtype=dtype)
    gp_tot = gp_sum + prior_g
    dp = -spd_solve(s_tot, (r_tot + prior_g)[:, None])[:, 0]
    dx = -(a_g + einsum_hp("bqk,q->bk", a_b, dp))            # (bd, Kt)
    dV = (
        dx.reshape(bd, n_exp, k)
        .transpose(1, 2, 0)
        .reshape(n_exp, k * (bd // nv), nv)[:, : problem.num_nodes]
    )

    gdot_dw = dw.dot(sys.gx.ravel(), dx.ravel())
    dx2_e = jnp.sum(dx.reshape(bd, n_exp, k) ** 2, axis=(0, 2))  # (n_exp,)
    sn2_loc = jnp.sum(dx2_e)
    sds_loc = jnp.vdot(dmax_e, dx2_e)
    if dp_axis is not None:
        gdot_dw = psum_dw(gdot_dw, dp_axis)
        sds_loc = jax.lax.psum(sds_loc, dp_axis)
        sn2_loc = jax.lax.psum(sn2_loc, dp_axis)
    gdot = dw.to_single(gdot_dw) + jnp.vdot(gp_tot, dp)
    gnorm = jnp.maximum(gx_max, jnp.max(jnp.abs(gp_tot), initial=0.0))
    aux = LMAux(
        gnorm=gnorm,
        gdot=gdot,
        sds=sds_loc + smax * jnp.vdot(dp, dp),
        step_norm=jnp.sqrt(sn2_loc + jnp.vdot(dp, dp)),
        alpha=jnp.asarray(1.0, dtype),
    )
    return dV, dp, aux


def _finish_cost_dw(ct_local, p, p_prior, p_w, dp_axis):
    """Local assembly DW cost -> global batch cost (+ shared prior once)."""
    if dp_axis is not None:
        ct_local = psum_dw(ct_local, dp_axis)
    rp = p_w * (p - p_prior)
    prior = dw.mul_single(
        dw.pairwise_sum(dw.DW(*dw.two_prod(rp, rp))), 0.5
    )
    return dw.add(ct_local, prior)


def shared_gn_step(
    problem,
    z: BatchDecision,
    data_batch,
    lam,
    p_prior,
    p_w,
    *,
    chain_solver=None,
    dp_axis: str | None = None,
):
    """One damped shared-parameter GN step over the local experiment batch.

    Args:
      chain_solver: ``solve(D, E, G) -> X`` for one block-tridiagonal system
        (default: cyclic reduction), vmapped over the experiments.  Pass a
        vmap-compatible SPIKE closure to additionally shard each chain over
        "sp".
      dp_axis: mesh axis name for the parameter psum (None = single shard).
    Returns:
      (dV (n_exp, M, nv), dp (nq,), gnorm, aux) where aux carries the
      globally-reduced accept quantities (lm_core.LMAux sans step data).
    """
    chain_solver = chain_solver or SOLVERS["cr"]
    nq = problem.model.nq

    sys_b = jax.vmap(
        lambda V, d: assemble_gn(problem, Decision(V=V, p=z.p), d),
        in_axes=(0, 0),
    )(z.V, data_batch)

    # Dimensionless isotropic damping — lam scales the per-experiment max
    # diagonal, matching solve.kkt._equilibrate's scale-free convention.
    bd = sys_b.D.shape[-1]
    eye_b = jnp.eye(bd, dtype=sys_b.D.dtype)
    dg = einsum_hp("ekii->eki", sys_b.D)
    dmax = jnp.maximum(jnp.max(dg, axis=(1, 2)),
                       jnp.finfo(sys_b.D.dtype).tiny)      # (n_exp,)
    d_damped = sys_b.D + (lam * dmax)[:, None, None, None] * eye_b

    rhs = jnp.concatenate([sys_b.gx[..., None], sys_b.B], axis=-1)
    x = jax.vmap(chain_solver)(d_damped, sys_b.E, rhs)
    # x: (n_exp, K, bd, 1+nq)
    a_g, a_b = x[..., 0], x[..., 1:]

    s_loc = jnp.sum(sys_b.C, 0) - einsum_hp("ekbq,ekbr->qr", sys_b.B, a_b)
    r_loc = jnp.sum(sys_b.gp, 0) - einsum_hp("ekbq,ekb->q", sys_b.B, a_g)
    gnorm_loc = jnp.maximum(
        jnp.max(jnp.abs(sys_b.gx)), jnp.max(jnp.abs(sys_b.gp), initial=0.0)
    )

    s_tot = _psum_maybe(s_loc, dp_axis)
    r_tot = _psum_maybe(r_loc, dp_axis)
    gnorm = (
        jax.lax.pmax(gnorm_loc, dp_axis) if dp_axis is not None else gnorm_loc
    )

    pw2 = p_w**2
    s_tot = s_tot + jnp.diag(pw2)
    smax = jnp.maximum(jnp.max(jnp.diag(s_tot)),
                       jnp.finfo(s_tot.dtype).tiny)
    s_tot = s_tot + (lam * smax) * jnp.eye(nq, dtype=s_tot.dtype)
    r_tot = r_tot + pw2 * (z.p - p_prior)
    # Unrolled SPD solve (ops.smallblocks): tiny nq, fuses with its inputs.
    dp = -spd_solve(s_tot, r_tot[:, None])[:, 0]
    dx = -(a_g + einsum_hp("ekbq,q->ekb", a_b, dp))
    dV = jax.vmap(lambda d: blocks_to_nodes(d, problem.num_nodes, problem.nv))(dx)

    # Globally-reduced accept quantities for the shared LM loop.  The
    # damping matrix is block-diagonal (lam*dmax_e on experiment e's state
    # blocks, lam*smax on p), so the damping quadratic form is
    #   sᵀΛ̂s = Σ_e dmax_e‖dx_e‖² + smax‖dp‖².
    gdot_dw = dw.dot(sys_b.gx.ravel(), dx.ravel())
    sds_loc = jnp.sum(dmax * jnp.sum(dx * dx, axis=(1, 2)))
    sn2_loc = jnp.sum(dx * dx)
    if dp_axis is not None:
        gdot_dw = psum_dw(gdot_dw, dp_axis)
        sds_loc = jax.lax.psum(sds_loc, dp_axis)
        sn2_loc = jax.lax.psum(sn2_loc, dp_axis)
    gp_tot = _psum_maybe(jnp.sum(sys_b.gp, 0), dp_axis) + pw2 * (z.p - p_prior)
    gdot = dw.to_single(gdot_dw) + jnp.vdot(gp_tot, dp)
    sds = sds_loc + smax * jnp.vdot(dp, dp)
    snorm2 = sn2_loc + jnp.vdot(dp, dp)
    aux = LMAux(
        gnorm=gnorm, gdot=gdot, sds=sds,
        step_norm=jnp.sqrt(snorm2),
        alpha=jnp.asarray(1.0, dV.dtype),
    )
    return dV, dp, gnorm, aux


def make_multi_experiment_solver(
    problem, options: SolverOptions = SolverOptions(), *, dp_axis=None,
    chain_solver=None, layout: str = "auto",
):
    """Jitted shared-parameter LM solver over a batch of experiments.

    Returns ``solve(z0: BatchDecision, data_batch, p_prior, p_w) ->
    (BatchDecision, SolveStats)``.  ``data_batch`` is a ProblemData pytree
    with a leading experiment axis on every leaf and ``p_w == 0`` (the shared
    prior is passed explicitly).  With ``dp_axis`` set, call inside
    shard_map with experiments sharded over that axis.

    ``layout`` selects the assembly/solve pipeline:
      * ``"soa"`` — the CONCATENATED-chain SoA hot path: one batched SoA
        assembly (assemble_gn_soa_batched, experiments side by side along
        the chain axis) feeding one cyclic-reduction chain solve, with the
        trial cost read off the assembly's own residuals (the speculative
        with_cost structure of solve.newton).  No block-major (E, K, b, b)
        arrays exist anywhere.
      * ``"blocks"`` — the vmapped block-major path (per-experiment
        assemble_gn + per-chain CR), kept for custom ``chain_solver``
        closures (e.g. the dp x sp sharded SPIKE).
      * ``"auto"`` — "blocks" when a ``chain_solver`` is supplied,
        "soa" otherwise.

    ``chain_solver`` (blocks layout only) defaults to per-chain cyclic
    reduction.
    """
    opt = options
    if layout == "auto":
        layout = "blocks" if chain_solver is not None else "soa"
    if layout not in ("soa", "blocks"):
        raise ValueError(f"unknown layout {layout!r}")

    if layout == "soa":
        k = problem.mesh.num_elements + 1

        def solve(z0: BatchDecision, data_batch, p_prior, p_w):
            n_exp = z0.V.shape[0]

            def trial_fn(z, sys, lam):
                dV, dp, aux = shared_gn_step_soa(
                    problem, sys, lam, z.p, p_prior, p_w,
                    n_exp=n_exp, chain_solve=concat_chain_solve,
                    dp_axis=dp_axis,
                )
                z_try = BatchDecision(V=z.V + dV, p=z.p + dp)
                sys_try, ct_loc = assemble_gn_soa_batched(
                    problem, z_try.V, z_try.p, data_batch, with_cost=True
                )
                ct = _finish_cost_dw(ct_loc, z_try.p, p_prior, p_w, dp_axis)
                return z_try, sys_try, ct, aux

            carry0, c0_loc = assemble_gn_soa_batched(
                problem, z0.V, z0.p, data_batch, with_cost=True
            )
            c0 = _finish_cost_dw(c0_loc, z0.p, p_prior, p_w, dp_axis)
            st = lm_loop(
                z0, carry0, c0, trial_fn,
                maxiter=opt.maxiter, lam0=opt.lam0,
                gtol=opt.gtol, ftol=opt.ftol, xtol=opt.xtol,
                lam_min=opt.lam_min, lam_max=opt.lam_max,
                dtype=z0.V.dtype, verbose=opt.verbose,
            )
            return st.z, stats_from_lm(st)

        if dp_axis is None:
            return jax.jit(solve)
        return solve

    def solve(z0: BatchDecision, data_batch, p_prior, p_w):
        def trial_fn(z, carry, lam):
            dV, dp, gnorm, aux = shared_gn_step(
                problem, z, data_batch, lam, p_prior, p_w,
                chain_solver=chain_solver, dp_axis=dp_axis,
            )
            z_try = BatchDecision(V=z.V + dV, p=z.p + dp)
            ct = _batch_cost_dw(
                problem, z_try, data_batch, p_prior, p_w, dp_axis
            )
            return z_try, carry, ct, aux

        c0 = _batch_cost_dw(problem, z0, data_batch, p_prior, p_w, dp_axis)
        st = lm_loop(
            z0, (), c0, trial_fn,
            maxiter=opt.maxiter, lam0=opt.lam0,
            gtol=opt.gtol, ftol=opt.ftol, xtol=opt.xtol,
            lam_min=opt.lam_min, lam_max=opt.lam_max,
            dtype=z0.V.dtype, verbose=opt.verbose,
        )
        return st.z, stats_from_lm(st)

    if dp_axis is None:
        return jax.jit(solve)
    return solve
