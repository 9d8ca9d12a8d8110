"""Bound-constrained estimation: log-barrier interior point around GN/LM.

Capability parity target: the reference lineage hands estimation problems
with simple variable bounds (lb <= z <= ub — e.g. positivity of physical
parameters, state envelopes) to IPOPT, which enforces them with a primal
log-barrier interior point (SURVEY.md §2b row 3, §2a "Inequality
handling").  The on-device equivalent here keeps the entire bounded solve
as ONE jitted program, mirroring solve/auglag.py's OCP structure:

  outer o = 1..n_outer (lax.fori_loop):
      inner: damped Gauss-Newton on
          Phi(z) = 0.5 ||r(z)||^2                       (estimation cost)
                 - mu sum log(p - p_lo) + log(p_hi - p)  (parameter bounds)
                 - mu sum log(x - x_lo) + log(x_hi - x)  (per-node states)
        with exact fraction-to-boundary step clipping (box bounds make the
        max feasible step elementwise-analytic — no backtracking loop);
      mu <- max(mu * mu_factor, mu_min).

The barrier Hessian of box bounds is DIAGONAL, so its KKT contribution is
a diagonal add to the D blocks (states, one slot per collocation node) and
to the arrowhead corner C (parameters) — the step solve stays the same
block-tridiagonal + Schur pipeline as unconstrained estimation
(solve.kkt.solve_kkt), no new factorization structure.

Infinite bounds are masked out at trace time (the Bounds arrays are closed
over as constants), so `bounds(problem, p_lo=[0, None])` costs nothing for
the unbounded components.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from collocfem_tpu.ops import doubleword as dw
from collocfem_tpu.ops.assemble import (
    assemble_gn,
    assemble_gn_soa,
    blocks_to_nodes,
    blocks_to_nodes_soa,
)
from collocfem_tpu.problem import Decision
from collocfem_tpu.solve.auglag import _node_block_scatter
from collocfem_tpu.solve.kkt import (resolve_method,
                                     solve_kkt, solve_kkt_soa)
from collocfem_tpu.solve.lm_core import LMAux, fused_quadforms, lm_loop

BOUNDS_HISTORY_COLS = ("cost", "grad_norm", "mu", "inner_iters")


class Bounds(NamedTuple):
    """Box bounds; entries are +-inf where unconstrained.

    p_lo/p_hi: (nq,) parameter bounds.
    x_lo/x_hi: (nx,) state bounds, enforced at every collocation node.
    """

    p_lo: np.ndarray
    p_hi: np.ndarray
    x_lo: np.ndarray
    x_hi: np.ndarray


def make_bounds(problem, p_lo=None, p_hi=None, x_lo=None, x_hi=None) -> Bounds:
    """Build a :class:`Bounds` for ``problem``; ``None`` entries (whole
    argument or per-component) mean unbounded."""
    nq, nx = problem.model.nq, problem.model.nx

    def fill(spec, n, sign, name):
        out = np.full((n,), sign * np.inf)
        if spec is not None:
            flat = np.ravel(spec)
            if np.ndim(spec) == 0:
                # A bare scalar bounds EVERY component, explicitly.
                flat = np.broadcast_to(flat, (n,))
            elif flat.size != n:
                raise ValueError(
                    f"{name} has {flat.size} entries but needs {n} "
                    "(one per component; use None for unbounded entries)"
                )
            out[:] = [sign * np.inf if s is None else s for s in flat]
        return out

    b = Bounds(
        p_lo=fill(p_lo, nq, -1.0, "p_lo"), p_hi=fill(p_hi, nq, +1.0, "p_hi"),
        x_lo=fill(x_lo, nx, -1.0, "x_lo"), x_hi=fill(x_hi, nx, +1.0, "x_hi"),
    )
    if np.any(b.p_lo >= b.p_hi) or np.any(b.x_lo >= b.x_hi):
        raise ValueError("lower bounds must be strictly below upper bounds")
    return b


def project_interior(z0: Decision, b: Bounds, margin: float = 1e-2) -> Decision:
    """Clip ``z0`` into the strict interior of ``b``.

    The barrier needs a strictly feasible start; components outside (or on)
    a bound are pulled in by ``margin`` (absolute for one-sided bounds,
    relative to the box width for two-sided)."""

    def pull(v, lo, hi):
        width = np.where(
            np.isfinite(lo) & np.isfinite(hi), hi - lo, 1.0
        )
        eps = margin * width
        lo_in = np.where(np.isfinite(lo), lo + eps, -np.inf)
        hi_in = np.where(np.isfinite(hi), hi - eps, np.inf)
        return jnp.clip(v, lo_in, hi_in)

    return Decision(V=pull(z0.V, b.x_lo, b.x_hi), p=pull(z0.p, b.p_lo, b.p_hi))


@dataclasses.dataclass(frozen=True)
class BoundedOptions:
    """Static configuration for the bounded estimation solver."""

    n_outer: int = 10
    inner_maxiter: int = 30
    gtol: float = 1e-8        # inner gradient tolerance (floored at 0.1*mu)
    mu0: float = 1e-2
    mu_factor: float = 0.2
    mu_min: float = 1e-10
    lam0: float = 1e-6
    lam_up: float = 5.0
    lam_down: float = 0.2
    lam_min: float = 1e-14
    lam_max: float = 1e12
    ftb: float = 0.995        # fraction-to-boundary factor
    # 'auto' resolves at build time like solve.newton, to 'cr' (here the
    # block-major pipeline); only 'cr_dw' routes through the SoA pipeline.
    method: str = "auto"      # 'auto'|'cr'|'cr_dw'|'scan'|...


class BoundedStats(NamedTuple):
    cost: jnp.ndarray       # () final estimation cost (no barrier terms)
    grad_norm: jnp.ndarray  # () final barrier-augmented gradient inf-norm
    mu: jnp.ndarray         # () final barrier parameter
    history: jnp.ndarray    # (n_outer, 4) per-outer table


def make_bounded_solver(
    problem, b: Bounds, options: BoundedOptions = BoundedOptions()
):
    """Build a jitted ``solve(z0, data) -> (z, BoundedStats)``.

    ``z0`` must be strictly inside the bounds (use :func:`project_interior`).
    The solution approaches active bounds to within O(mu_min / multiplier);
    inactive-bound problems reproduce the unconstrained GN solution.
    """
    opt = options
    opt = dataclasses.replace(opt, method=resolve_method(opt.method))
    soa = opt.method == "cr_dw"
    dtype = problem.dtype
    nx = problem.model.nx
    nq = problem.model.nq
    d = problem.mesh.degree
    num_nodes = problem.num_nodes
    nv = problem.nv

    # Static masks + safe bound values (inf -> 0 so masked lanes stay finite).
    mp_lo = np.isfinite(b.p_lo)
    mp_hi = np.isfinite(b.p_hi)
    mx_lo = np.isfinite(b.x_lo)
    mx_hi = np.isfinite(b.x_hi)
    p_lo = jnp.asarray(np.where(mp_lo, b.p_lo, 0.0), dtype)
    p_hi = jnp.asarray(np.where(mp_hi, b.p_hi, 0.0), dtype)
    x_lo = jnp.asarray(np.where(mx_lo, b.x_lo, 0.0), dtype)
    x_hi = jnp.asarray(np.where(mx_hi, b.x_hi, 0.0), dtype)
    has_x = bool(mx_lo.any() or mx_hi.any())
    has_p = bool(nq and (mp_lo.any() or mp_hi.any()))

    def slacks(z):
        """Masked slack arrays; masked-out components read as 1."""
        x = z.V[:, :nx]
        return (
            jnp.where(mp_lo, z.p - p_lo, 1.0),
            jnp.where(mp_hi, p_hi - z.p, 1.0),
            jnp.where(mx_lo, x - x_lo, 1.0),
            jnp.where(mx_hi, x_hi - x, 1.0),
        )

    def barrier_value(z, mu):
        sl = slacks(z)
        total = sum(jnp.sum(jnp.log(jnp.where(s > 0, s, 1.0))) for s in sl)
        feasible = jnp.all(
            jnp.stack([jnp.all(s > 0) for s in sl])
        )
        return jnp.where(feasible, -mu * total, jnp.inf)

    def merit(z, data, mu):
        return problem.cost(z, data) + barrier_value(z, mu)

    def merit_dw(z, data, mu):
        """Double-word merit: the estimation term must resolve improvements
        below f32's ~cost·6e-8 resolution or the inner LM freezes before
        converging at headline mesh sizes (same failure solve.newton's DW
        cost fixes); the barrier term is added at base precision."""
        return dw.add_single(problem.cost_dw(z, data), barrier_value(z, mu))

    def add_barrier_terms(sys, z, mu):
        """Diagonal barrier adds, layout-aware (SoA: static lane slices —
        no block-major intermediates or soa_from_blocks conversions in the
        hot loop, round-3 verdict weak 4)."""
        sp_lo, sp_hi, sx_lo, sx_hi = slacks(z)
        if has_p:
            gp_b = jnp.where(mp_lo, -mu / sp_lo, 0.0) + jnp.where(
                mp_hi, mu / sp_hi, 0.0
            )
            hp_b = jnp.where(mp_lo, mu / sp_lo**2, 0.0) + jnp.where(
                mp_hi, mu / sp_hi**2, 0.0
            )
            sys = sys._replace(
                C=sys.C + jnp.diag(hp_b), gp=sys.gp + gp_b
            )
        if has_x:
            gn_x = jnp.where(mx_lo, -mu / sx_lo, 0.0) + jnp.where(
                mx_hi, mu / sx_hi, 0.0
            )                                               # (M, nx)
            hn_x = jnp.where(mx_lo, mu / sx_lo**2, 0.0) + jnp.where(
                mx_hi, mu / sx_hi**2, 0.0
            )
            ix = jnp.arange(nx)
            if soa:
                # Node m = k*d + off -> static lane-slice [off::d].
                bd, _, kk = sys.D.shape
                D = sys.D.reshape(d, nv, d, nv, kk)
                gx = sys.gx.reshape(d, nv, kk)
                for off in range(d):
                    h_sl = hn_x[off::d].T               # (nx, <=K)
                    w = h_sl.shape[-1]
                    D = D.at[off, ix, off, ix, :w].add(h_sl)
                    gx = gx.at[off, :nx, :w].add(gn_x[off::d].T)
                sys = sys._replace(
                    D=D.reshape(bd, bd, kk), gx=gx.reshape(bd, kk)
                )
            else:
                Hn = jnp.zeros((num_nodes, nv, nv), dtype).at[:, ix, ix].set(
                    hn_x
                )
                gn = jnp.zeros((num_nodes, nv), dtype).at[:, :nx].set(gn_x)
                Bn = jnp.zeros((num_nodes, nv, nq), dtype)
                sys = _node_block_scatter(sys, Hn, Bn, gn, d)
        return sys

    def ftb_alpha(z, dV, dp):
        """Exact max feasible step fraction for box bounds (elementwise)."""
        sp_lo, sp_hi, sx_lo, sx_hi = slacks(z)
        dx = dV[:, :nx]
        big = jnp.asarray(jnp.inf, dtype)

        def limit(slack, step, mask):
            # step moving toward the bound shrinks the slack.
            r = jnp.where(
                mask & (step > 0),
                opt.ftb * slack / jnp.maximum(step, 1e-300),
                big,
            )
            return jnp.min(r, initial=jnp.inf)

        a = jnp.minimum(limit(sp_lo, -dp, mp_lo), limit(sp_hi, dp, mp_hi))
        a = jnp.minimum(a, limit(sx_lo, -dx, mx_lo))
        a = jnp.minimum(a, limit(sx_hi, dx, mx_hi))
        return jnp.minimum(jnp.asarray(1.0, dtype), a)

    def inner_solve(z, data, mu, lam_lm):
        """One barrier subproblem via the SHARED LM loop (solve.lm_core):
        gain-ratio acceptance on the double-word merit, Nielsen damping,
        λ-railed early exit — the same body as the headline solver, with
        the step fraction-to-boundary-clipped (α enters the predicted
        decrease exactly; see lm_core's α-aware quadratic model)."""

        def trial_fn(z, carry, lam):
            sys_est = (assemble_gn_soa if soa else assemble_gn)(
                problem, z, data
            )
            # Damping scale from the PRE-barrier (estimation) diagonal: the
            # barrier's 1/slack^2 wall inflates the diagonal by ~1/mu at
            # active bounds, and lam * that wall would crush progress along
            # the free coordinates (see solve.kkt._equilibrate).
            if soa:
                diag = jnp.stack(
                    [sys_est.D[i, i] for i in range(sys_est.D.shape[0])]
                ).ravel()
            else:
                diag = jnp.einsum("kii->ki", sys_est.D).ravel()
            if sys_est.C.shape[0]:
                diag = jnp.concatenate([diag, jnp.diag(sys_est.C)])
            dmax = jnp.max(diag)
            sys = add_barrier_terms(sys_est, z, mu)
            gnorm = jnp.maximum(
                jnp.max(jnp.abs(sys.gx)),
                jnp.max(jnp.abs(sys.gp), initial=0.0),
            )
            if soa:
                dx, dp = solve_kkt_soa(
                    sys, lam,
                    dw=opt.method == "cr_dw",
                    damp_scale=dmax,
                )
                dV = blocks_to_nodes_soa(dx, num_nodes, nv)
            else:
                dx, dp = solve_kkt(sys, lam, opt.method, damp_scale=dmax)
                dV = blocks_to_nodes(dx, num_nodes, nv)
            alpha = ftb_alpha(z, dV, dp)
            z_try = Decision(V=z.V + alpha * dV, p=z.p + alpha * dp)
            ct = merit_dw(z_try, data, mu)
            gdot, snorm2 = fused_quadforms(
                sys.gx.ravel(), sys.gp, dx.ravel(), dp
            )
            aux = LMAux(
                gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                step_norm=alpha * jnp.sqrt(snorm2), alpha=alpha,
            )
            return z_try, carry, ct, aux

        gtol_eff = jnp.maximum(jnp.asarray(opt.gtol, dtype), 0.1 * mu)
        st = lm_loop(
            z, (), merit_dw(z, data, mu), trial_fn,
            maxiter=opt.inner_maxiter, lam0=lam_lm,
            gtol=gtol_eff, xtol=1e-15,
            lam_min=opt.lam_min, lam_max=opt.lam_max,
            dtype=dtype,
        )
        return st.z, st.lam, st.it, st.gnorm

    @jax.jit
    def solve(z0: Decision, data):
        def outer(o, carry):
            z, mu, lam_lm, hist = carry
            z, lam_lm, inner_it, gnorm = inner_solve(z, data, mu, lam_lm)
            # A λ-railed inner exit leaves lam at lam_max; the next barrier
            # subproblem (smaller μ) is a NEW landscape — clamp the warm
            # start so it isn't frozen behind 25 Nielsen down-steps.
            lam_lm = jnp.minimum(lam_lm, 1e3)
            hist = hist.at[o].set(
                jnp.stack([
                    problem.cost(z, data), gnorm, mu,
                    inner_it.astype(dtype),
                ])
            )
            mu_new = jnp.maximum(mu * opt.mu_factor, opt.mu_min)
            return (z, mu_new, lam_lm, hist)

        carry0 = (
            z0, jnp.asarray(opt.mu0, dtype), jnp.asarray(opt.lam0, dtype),
            jnp.zeros((opt.n_outer, len(BOUNDS_HISTORY_COLS)), dtype),
        )
        z, mu, lam_lm, hist = jax.lax.fori_loop(
            0, opt.n_outer, outer, carry0
        )
        stats = BoundedStats(
            cost=problem.cost(z, data),
            grad_norm=hist[-1, 1],
            mu=mu,
            history=hist,
        )
        return z, stats

    return solve


def bounded_gauss_newton(
    problem, z0, data, b: Bounds,
    options: BoundedOptions = BoundedOptions(),
):
    """One-shot convenience wrapper: projects ``z0`` inside and solves."""
    z0 = project_interior(z0, b)
    return make_bounded_solver(problem, b, options)(z0, data)
