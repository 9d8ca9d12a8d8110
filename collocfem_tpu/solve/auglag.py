"""On-device augmented-Lagrangian + log-barrier solver for constrained OCPs.

On-device replacement for the reference's IPOPT path (SURVEY.md §2b row 3,
§3.3: interior-point NLP with Python callbacks every iteration).  Here the
entire constrained solve is ONE jitted program: equality constraints
(collocation defects, boundary conditions, per-node equality path
constraints g_eq(x,u,p,t)=0) via augmented Lagrangian in
least-squares form, inequality path constraints via a log barrier whose
Gauss-Newton Hessian is per-node PSD — so every inner iteration is the same
damped block-tridiagonal(+arrowhead) solve as estimation
(SURVEY.md §7 hard part 3: fixed iteration bounds, masked convergence, no
data-dependent Python control flow).

Structure:
  outer k = 1..n_outer (lax.fori_loop):
      inner: damped Gauss-Newton on
          Phi(z) = 0.5||sqrt(rho) c(z) + lam/sqrt(rho)||^2   (AL, equalities)
                 + 0.5||cost residuals(z)||^2                 (objective)
                 - mu sum log(-g(z))                          (barrier)
        with fraction-to-boundary + feasibility backtracking line search
        (lax.while_loop, on device);
      lam <- lam + rho c(z);  mu <- max(mu * mu_factor, mu_min);
      rho <- rho * rho_up if ||c|| stalled.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from collocfem_tpu.ops.einsum_hp import einsum_hp

from collocfem_tpu.ops import doubleword as dw
from collocfem_tpu.ops.assemble import (
    BlockTriSystem,
    blocks_to_nodes,
    blocks_to_nodes_soa,
    node_block_scatter_soa,
    scatter_gn_blocks,
    scatter_gn_blocks_soa,
)
from collocfem_tpu.problem import Decision
from collocfem_tpu.solve.kkt import (resolve_method,
                                     solve_kkt, solve_kkt_soa)
from collocfem_tpu.solve.lm_core import LMAux, fused_quadforms, lm_loop

OUTER_HISTORY_COLS = (
    "objective", "cviol", "mu", "rho", "inner_iters", "grad_norm"
)


@dataclasses.dataclass(frozen=True)
class ALBarrierOptions:
    """Static configuration for the AL + barrier OCP solver."""

    n_outer: int = 14
    inner_maxiter: int = 40
    gtol: float = 1e-8        # inner gradient tolerance (scaled by sqrt(mu))
    ctol: float = 1e-9        # equality violation target (reporting)
    # rho0/mu0 shape the FIRST subproblem's landscape, which decides the
    # basin on nonconvex problems: rho0=10/mu0=1 let the swing-up fall
    # into an infeasible local minimizer of ||c||^2 (cviol 0.70) in f32 —
    # and only escaped it in f64 by luck of the inner iteration cap.
    # Measured on the pendulum (f32 AND cpu f64): rho0=100 + mu0=0.1
    # reaches the global basin in both precisions (obj 2.5875,
    # cviol 3e-5 / 7e-11); rho0=1000 over-pulls feasibility and jams again.
    rho0: float = 100.0
    rho_up: float = 10.0
    rho_max: float = 1e8
    cviol_ratio: float = 0.25  # required violation decrease before rho_up
    mu0: float = 0.1
    mu_factor: float = 0.2
    mu_min: float = 1e-9
    lam0: float = 1e-3
    lam_up: float = 5.0
    lam_down: float = 0.2
    lam_min: float = 1e-14
    lam_max: float = 1e12
    ftb: float = 0.995        # fraction-to-boundary factor
    max_backtrack: int = 30
    # 'auto' resolves at build time like solve.newton, to 'cr' (here the
    # block-major pipeline); only 'cr_dw' routes through the SoA pipeline.
    method: str = "auto"      # 'auto'|'cr'|'cr_dw'|'scan'|...


class OCPStats(NamedTuple):
    objective: jnp.ndarray   # () final objective (no constraint terms)
    cviol: jnp.ndarray       # () final max |c|
    gviol: jnp.ndarray       # () final max g (<= 0 means feasible)
    grad_norm: jnp.ndarray   # () final inner gradient inf-norm
    history: jnp.ndarray     # (n_outer, 6) per-outer-iteration table
    multipliers: object      # final equality multipliers (Multipliers pytree)
    mu: jnp.ndarray          # () final barrier parameter (nu_i = mu / -g_i)


def _barrier_value(g, mu):
    """-mu sum log(-g); +inf when any g >= 0 so infeasible trials reject."""
    safe = jnp.where(g < 0, -g, 1.0)
    val = -mu * jnp.sum(jnp.log(safe))
    return jnp.where(jnp.any(g >= 0), jnp.inf, val)


def _node_block_scatter(sys: BlockTriSystem, Hn, Bn, gn, degree):
    """Add per-node (nv, nv)/(nv, nq)/(nv,) terms into the block structure.

    Node n lives in block n // d at node-offset n % d — every global node
    belongs to exactly one block, so per-node Hessians are block-diagonal.
    """
    k, bd, _ = sys.D.shape
    nq = sys.C.shape[0]
    m = Hn.shape[0]
    nv = Hn.shape[1]
    d = degree
    blk = jnp.arange(m) // d
    off = jnp.arange(m) % d
    D = sys.D.reshape(k, d, nv, d, nv).at[blk, off, :, off, :].add(Hn)
    B = sys.B.reshape(k, d, nv, nq).at[blk, off, :, :].add(Bn)
    gx = sys.gx.reshape(k, d, nv).at[blk, off, :].add(gn)
    return sys._replace(
        D=D.reshape(k, bd, bd), B=B.reshape(k, bd, nq), gx=gx.reshape(k, bd)
    )


def make_ocp_solver(problem, options: ALBarrierOptions = ALBarrierOptions()):
    """Build a jitted ``solve(z0) -> (z, OCPStats)`` for ``problem``.

    ``z0`` must be strictly feasible w.r.t. the path constraints
    (g(z0) < 0 at every node); use ``problem.initial_guess()``.
    """
    opt = options
    opt = dataclasses.replace(opt, method=resolve_method(opt.method))
    soa = opt.method == "cr_dw"
    model, mesh = problem.model, problem.mesh
    n, d = mesh.num_elements, mesh.degree
    nv, nx, nq = problem.nv, model.nx, model.nq
    k = n + 1
    num_nodes = problem.num_nodes
    sqm = lambda v: jnp.asarray(v, problem.dtype)

    # -- element residual in AL least-squares form ---------------------------
    def elem_res(ve_flat, p, lam_e, sqrt_rho, width, times, cscale, qscale):
        c = problem.elem_constraints(ve_flat, p, width, times, cscale)
        r_al = sqrt_rho * c + lam_e / sqrt_rho
        lr = problem.elem_cost_residual(ve_flat, p, times, qscale)
        return jnp.concatenate([r_al.ravel(), lr.ravel()])

    def terminal_res(x_last, p):
        return problem.model.terminal_cost_residual(x_last, p)

    def boundary_terms(z, mult, rho):
        """AL residuals for the two boundary-condition groups."""
        x, _ = problem.split(z.V)
        sr = jnp.sqrt(rho)
        r0 = sr * problem.x0_mask * (x[0] - problem.x0_val) + mult.b0 / sr
        rf = sr * problem.xf_mask * (x[-1] - problem.xf_val) + mult.bf / sr
        return r0 * problem.x0_mask, rf * problem.xf_mask

    # -- equality path constraints (per node, AL least-squares form) ----------
    ne = getattr(model, "ne", 0)

    def node_eq_res(v_n, p, lam_n, sr, t_n):
        x_n, u_n = v_n[:nx], v_n[nx:]
        return sr * model.g_eq(x_n, u_n, p, t_n) + lam_n / sr

    def eq_path_merit(z, mult, rho):
        if not ne:
            return jnp.zeros((), problem.dtype)
        sr = jnp.sqrt(rho)
        r = jax.vmap(node_eq_res, in_axes=(0, None, 0, None, 0))(
            z.V, z.p, mult.path_eq, sr, problem.node_times
        )
        return 0.5 * jnp.sum(r * r)

    # -- merit (must stay gradient-consistent with the assembly below) -------
    def merit(z, mult, rho, mu):
        ve = problem.gather_elements(z.V)
        sr = jnp.sqrt(rho)
        r_el = jax.vmap(elem_res, in_axes=(0, None, 0, None, 0, 0, 0, 0))(
            ve, z.p, mult.defect, sr, problem.widths, problem.elem_times,
            problem.cscale, problem.qscale,
        )
        r0, rf = boundary_terms(z, mult, rho)
        x, _ = problem.split(z.V)
        tr = terminal_res(x[-1], z.p)
        g = problem.path_constraints(z)
        lsq = (
            jnp.sum(r_el * r_el) + jnp.sum(r0 * r0) + jnp.sum(rf * rf)
            + jnp.sum(tr * tr)
        )
        return 0.5 * lsq + _barrier_value(g, mu) + eq_path_merit(z, mult, rho)

    def merit_dw(z, mult, rho, mu):
        """Double-word merit: the least-squares terms must resolve
        improvements below f32's ~merit·6e-8 resolution or the inner LM
        freezes on fine meshes (same failure solve.newton's DW cost
        fixes); the barrier term is added at base precision."""
        ve = problem.gather_elements(z.V)
        sr = jnp.sqrt(rho)
        r_el = jax.vmap(elem_res, in_axes=(0, None, 0, None, 0, 0, 0, 0))(
            ve, z.p, mult.defect, sr, problem.widths, problem.elem_times,
            problem.cscale, problem.qscale,
        )
        r0, rf = boundary_terms(z, mult, rho)
        x, _ = problem.split(z.V)
        parts = [r_el.ravel(), r0, rf, terminal_res(x[-1], z.p)]
        if ne:
            parts.append(
                jax.vmap(node_eq_res, in_axes=(0, None, 0, None, 0))(
                    z.V, z.p, mult.path_eq, sr, problem.node_times
                ).ravel()
            )
        r = jnp.concatenate(parts)
        s = dw.mul_single(dw.pairwise_sum(dw.DW(*dw.two_prod(r, r))), 0.5)
        return dw.add_single(
            s, _barrier_value(problem.path_constraints(z), mu)
        )

    # -- assembly ------------------------------------------------------------
    def assemble(z, mult, rho, mu):
        ve = problem.gather_elements(z.V)
        sr = jnp.sqrt(rho)

        def per_elem(ve_flat, lam_e, width, times, cscale, qscale):
            args = (ve_flat, z.p, lam_e, sr, width, times, cscale, qscale)
            r = elem_res(*args)
            jx, jp = jax.jacfwd(elem_res, argnums=(0, 1))(*args)
            return r, jx, jp

        r, jx, jp = jax.vmap(per_elem)(
            ve, mult.defect, problem.widths, problem.elem_times,
            problem.cscale, problem.qscale,
        )
        # Layout-native normal equations: the SoA branch orders every
        # einsum output element/node-LAST and scatters with static lane
        # slices, so NO block-major intermediate (and no per-iteration
        # soa_from_blocks conversion, round-3/4 weak item) exists in the
        # hot loop.
        hpp = einsum_hp("emq,emr->qr", jp, jp)
        gpe = einsum_hp("emq,em->q", jp, r)
        if soa:
            sys = scatter_gn_blocks_soa(
                einsum_hp("emi,emj->ije", jx, jx),
                einsum_hp("emi,emq->iqe", jx, jp),
                hpp, einsum_hp("emi,em->ie", jx, r), gpe,
                num_blocks=k, nv=nv, overlap=nv, dtype=problem.dtype,
            )
        else:
            sys = scatter_gn_blocks(
                einsum_hp("emi,emj->eij", jx, jx),
                einsum_hp("emi,emq->eiq", jx, jp),
                hpp, einsum_hp("emi,em->ei", jx, r), gpe,
                num_blocks=k, nv=nv, overlap=nv, dtype=problem.dtype,
            )

        # Boundary conditions: analytic diagonal terms.  Node 0 -> block 0;
        # node M-1 = N*d -> block K-1 offset 0.
        r0, rf = boundary_terms(z, mult, rho)
        ix = jnp.arange(nx)
        x, _ = problem.split(z.V)
        tr = terminal_res(x[-1], z.p)
        jt_x, jt_p = jax.jacfwd(terminal_res, argnums=(0, 1))(x[-1], z.p)
        t_xx = einsum_hp("mi,mj->ij", jt_x, jt_x)
        t_xp = einsum_hp("mi,mq->iq", jt_x, jt_p)
        t_gx = einsum_hp("mi,m->i", jt_x, tr)
        C = sys.C + einsum_hp("mq,mr->qr", jt_p, jt_p)
        gp = sys.gp + einsum_hp("mq,m->q", jt_p, tr)
        if soa:
            D = sys.D.at[ix, ix, 0].add(rho * problem.x0_mask)
            D = D.at[ix, ix, k - 1].add(rho * problem.xf_mask)
            D = D.at[:nx, :nx, k - 1].add(t_xx)
            B = sys.B.at[:nx, :, k - 1].add(t_xp)
            gx = sys.gx.at[:nx, 0].add(jnp.sqrt(rho) * r0)
            gx = gx.at[:nx, k - 1].add(jnp.sqrt(rho) * rf + t_gx)
        else:
            D = sys.D.at[0, ix, ix].add(rho * problem.x0_mask)
            D = D.at[k - 1, ix, ix].add(rho * problem.xf_mask)
            D = D.at[k - 1, :nx, :nx].add(t_xx)
            B = sys.B.at[k - 1, :nx, :].add(t_xp)
            gx = sys.gx.at[0, :nx].add(jnp.sqrt(rho) * r0)
            gx = gx.at[k - 1, :nx].add(jnp.sqrt(rho) * rf + t_gx)
        sys = sys._replace(D=D, B=B, C=C, gx=gx, gp=gp)

        # Log-barrier: per-node gradient + PSD Gauss-Newton Hessian.
        def node_g(v_n, p, t_n):
            x_n, u_n = v_n[:nx], v_n[nx:]
            return model.g(x_n, u_n, p, t_n)

        gvals = jax.vmap(node_g, in_axes=(0, None, 0))(
            z.V, z.p, problem.node_times
        )                                                   # (M, ng)
        jgv, jgp = jax.vmap(
            jax.jacfwd(node_g, argnums=(0, 1)), in_axes=(0, None, 0)
        )(z.V, z.p, problem.node_times)                     # (M, ng, nv/nq)
        w1 = mu / (-gvals)                                  # (M, ng) > 0
        w2 = w1 / (-gvals)                                  # mu / g^2
        gp_bar = einsum_hp("mgq,mg->q", jgp, w1)
        Hpp_bar = einsum_hp("mgq,mg,mgr->qr", jgp, w2, jgp)
        if soa:
            sys = node_block_scatter_soa(
                sys,
                einsum_hp("mgi,mg,mgj->ijm", jgv, w2, jgv),
                einsum_hp("mgi,mg,mgq->iqm", jgv, w2, jgp),
                einsum_hp("mgi,mg->im", jgv, w1), d,
            )
        else:
            sys = _node_block_scatter(
                sys,
                einsum_hp("mgi,mg,mgj->mij", jgv, w2, jgv),
                einsum_hp("mgi,mg,mgq->miq", jgv, w2, jgp),
                einsum_hp("mgi,mg->mi", jgv, w1), d,
            )
        sys = sys._replace(C=sys.C + Hpp_bar, gp=sys.gp + gp_bar)

        # Equality path constraints: per-node AL residuals, exact Gauss-Newton
        # contributions (same block-diagonal landing zone as the barrier).
        if ne:
            def per_node(v_n, lam_n, t_n):
                args = (v_n, z.p, lam_n, sr, t_n)
                r_n = node_eq_res(*args)
                jv_n, jp_n = jax.jacfwd(node_eq_res, argnums=(0, 1))(*args)
                return r_n, jv_n, jp_n

            r_eq, jev, jep = jax.vmap(per_node)(
                z.V, mult.path_eq, problem.node_times
            )
            Hpp_eq = einsum_hp("meq,mer->qr", jep, jep)
            gp_eq = einsum_hp("meq,me->q", jep, r_eq)
            if soa:
                sys = node_block_scatter_soa(
                    sys,
                    einsum_hp("mei,mej->ijm", jev, jev),
                    einsum_hp("mei,meq->iqm", jev, jep),
                    einsum_hp("mei,me->im", jev, r_eq), d,
                )
            else:
                sys = _node_block_scatter(
                    sys,
                    einsum_hp("mei,mej->mij", jev, jev),
                    einsum_hp("mei,meq->miq", jev, jep),
                    einsum_hp("mei,me->mi", jev, r_eq), d,
                )
            sys = sys._replace(C=sys.C + Hpp_eq, gp=sys.gp + gp_eq)
        return sys, gvals, jgv, jgp

    # -- fraction-to-boundary + feasibility backtracking ---------------------
    def line_search_alpha(z, dV, dp, gvals, jgv, jgp):
        dgdir = (
            einsum_hp("mgi,mi->mg", jgv, dV)
            + (einsum_hp("mgq,q->mg", jgp, dp) if nq else jnp.zeros_like(gvals))
        )
        ratio = jnp.where(
            dgdir > 0, opt.ftb * (-gvals) / jnp.maximum(dgdir, 1e-300), jnp.inf
        )
        alpha0 = jnp.minimum(1.0, jnp.min(ratio, initial=jnp.inf))

        def cond(carry):
            alpha, it = carry
            g_try = problem.path_constraints(
                Decision(V=z.V + alpha * dV, p=z.p + alpha * dp)
            )
            return (jnp.any(g_try >= 0)) & (it < opt.max_backtrack)

        def body(carry):
            alpha, it = carry
            return alpha * 0.5, it + 1

        alpha, _ = jax.lax.while_loop(
            cond, body, (alpha0, jnp.asarray(0, jnp.int32))
        )
        return alpha

    # -- inner damped GN loop -------------------------------------------------
    def inner_solve(z, mult, rho, mu, lam_lm):
        """One AL/barrier subproblem via the SHARED LM loop (solve.lm_core):
        gain-ratio acceptance on the double-word merit, Nielsen damping,
        λ-railed early exit; the step is fraction-to-boundary + feasibility
        clipped and α enters the predicted decrease exactly."""

        def trial_fn(z, carry, lam):
            sys, gvals, jgv, jgp = assemble(z, mult, rho, mu)
            gnorm = jnp.maximum(
                jnp.max(jnp.abs(sys.gx)), jnp.max(jnp.abs(sys.gp), initial=0.0)
            )
            if soa:
                dx, dp, dmax = solve_kkt_soa(
                    sys, lam,
                    dw=opt.method == "cr_dw",
                    with_dmax=True,
                )
                dV = blocks_to_nodes_soa(dx, num_nodes, nv)
            else:
                dx, dp, dmax = solve_kkt(
                    sys, lam, opt.method, with_dmax=True
                )
                dV = blocks_to_nodes(dx, num_nodes, nv)
            alpha = line_search_alpha(z, dV, dp, gvals, jgv, jgp)
            z_try = Decision(V=z.V + alpha * dV, p=z.p + alpha * dp)
            ct = merit_dw(z_try, mult, rho, mu)
            gdot, snorm2 = fused_quadforms(
                sys.gx.ravel(), sys.gp, dx.ravel(), dp
            )
            aux = LMAux(
                gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                step_norm=alpha * jnp.sqrt(snorm2), alpha=alpha,
            )
            return z_try, carry, ct, aux

        # Inner tolerance loosens with mu (classic interior-point
        # schedule): no point polishing a barrier subproblem to below
        # its own bias.
        gtol_eff = jnp.maximum(jnp.asarray(opt.gtol, problem.dtype), 0.1 * mu)
        st = lm_loop(
            z, (), merit_dw(z, mult, rho, mu), trial_fn,
            maxiter=opt.inner_maxiter, lam0=lam_lm,
            gtol=gtol_eff, xtol=1e-15,
            lam_min=opt.lam_min, lam_max=opt.lam_max,
            dtype=problem.dtype,
            # Nonconvex AL merit: gain-ratio rejection converges to the
            # nearest stationary point, which early in the homotopy is an
            # INFEASIBLE local minimizer of ||c||^2 (measured: swing-up
            # jammed at cviol 0.70); plain-decrease acceptance explores.
            accept_mode="decrease",
        )
        return st.z, jnp.minimum(st.lam, 1e3), st.it, st.gnorm

    # -- outer AL loop ---------------------------------------------------------
    @jax.jit
    def solve(z0: Decision):
        mult0 = problem.zero_multipliers()

        def outer(o, carry):
            z, mult, rho, mu, lam_lm, cviol_prev, hist = carry
            z, lam_lm, inner_it, gnorm = inner_solve(z, mult, rho, mu, lam_lm)
            c = problem.constraints(z)
            cviol = jnp.maximum(
                jnp.max(jnp.abs(c.defect)),
                jnp.maximum(
                    jnp.max(jnp.abs(c.b0), initial=0.0),
                    jnp.max(jnp.abs(c.bf), initial=0.0),
                ),
            )
            cviol = jnp.maximum(
                cviol, jnp.max(jnp.abs(c.path_eq), initial=0.0)
            )
            mult = jax.tree_util.tree_map(
                lambda l, ci: l + rho * ci, mult, c
            )
            rho_new = jnp.where(
                cviol > opt.cviol_ratio * cviol_prev,
                jnp.minimum(rho * opt.rho_up, opt.rho_max),
                rho,
            )
            mu_new = jnp.maximum(mu * opt.mu_factor, opt.mu_min)
            hist = hist.at[o].set(
                jnp.stack([
                    problem.objective(z), cviol, mu, rho,
                    inner_it.astype(problem.dtype), gnorm,
                ])
            )
            return (z, mult, rho_new, mu_new, lam_lm, cviol, hist)

        carry0 = (
            z0, mult0, sqm(opt.rho0), sqm(opt.mu0), sqm(opt.lam0),
            sqm(jnp.inf),
            jnp.zeros((opt.n_outer, len(OUTER_HISTORY_COLS)), problem.dtype),
        )
        z, mult, rho, mu, lam_lm, cviol, hist = jax.lax.fori_loop(
            0, opt.n_outer, outer, carry0
        )
        g = problem.path_constraints(z)
        stats = OCPStats(
            objective=problem.objective(z),
            cviol=cviol,
            gviol=jnp.max(g, initial=-jnp.inf),
            grad_norm=hist[-1, 5],
            history=hist,
            multipliers=mult,
            mu=mu,
        )
        return z, stats

    return solve


def solve_ocp(problem, z0=None, options: ALBarrierOptions = ALBarrierOptions()):
    """One-shot convenience wrapper around :func:`make_ocp_solver`."""
    if z0 is None:
        z0 = problem.initial_guess()
    return make_ocp_solver(problem, options)(z0)
