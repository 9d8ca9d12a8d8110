"""Fully on-device Gauss-Newton / Levenberg-Marquardt driver.

Capability parity target: the reference's Newton/GN/IRLS outer loop with
line search / damping (SURVEY.md §2a "Newton/GN/IRLS driver", §3.1;
BASELINE.json north_star: "line-search/damping logic runs jit-compiled with
lax.while_loop so the full estimation loop stays on-device").

The whole solve — assemble, factorize, step, accept/reject, convergence —
is a single ``lax.while_loop`` under jit: zero host round-trips per
iteration.  The loop body (gain-ratio acceptance, Nielsen damping,
double-word cost comparison) is the shared implementation in
:mod:`collocfem_tpu.solve.lm_core`; per-iteration diagnostics land in a
fixed-size history table (SURVEY.md §5 "Metrics / logging").

Cost reuse (speculative assembly): the Gauss-Newton path assembles at the
TRIAL iterate each iteration and reads the trial cost off the assembly's
own residuals (``assemble_gn*(with_cost=True)``), threading the assembled
system through the accept decision via the lm_core carry.  Accepted steps
then start the next iteration with their system already built — the
standalone full-residual cost pass (~30% of the N=10k iteration wall) is
gone entirely, and rejected steps pay one assembly instead of one assembly
plus one residual pass.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from collocfem_tpu.ops.assemble import (
    assemble_gn,
    assemble_gn_soa,
    assemble_newton,
    blocks_to_nodes,
    blocks_to_nodes_soa,
    soa_from_blocks,
)
from collocfem_tpu.problem import Decision
from collocfem_tpu.solve.kkt import (resolve_method,
                                     solve_kkt, solve_kkt_soa)
from collocfem_tpu.solve.lm_core import (
    HISTORY_COLS,
    LMAux,
    fused_quadforms,
    lm_loop,
)

__all__ = [
    "HISTORY_COLS", "SolverOptions", "SolveStats", "make_gn_solver",
    "gauss_newton", "make_irls_solver",
]


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration (plain dataclass per SURVEY.md §5
    "Config / flag system": no gin/hydra)."""

    maxiter: int = 50
    gtol: float = 1e-10
    ftol: float = 0.0
    xtol: float = 0.0
    # lam is DIMENSIONLESS: the damping added is lam * max(diag(H)) * I
    # (solve.kkt._equilibrate).  1e-9 starts effectively undamped — the
    # right regime for well-initialized collocation problems — and the LM
    # loop inflates it on rejections.
    lam0: float = 1e-9
    lam_up: float = 5.0
    lam_down: float = 0.2
    lam_min: float = 1e-14
    lam_max: float = 1e12
    # Chain solver (solve.kkt.METHODS); 'auto' resolves at solver-build
    # time to the SoA cyclic reduction 'cr'.
    method: str = "auto"     # 'auto'|'cr'|'cr_dw'|'scan'|'dense'|...
    kkt_refine: int = 0      # iterative-refinement passes per KKT solve
    verbose: bool = False
    irls_delta: float = 0.0  # >0 enables Huber IRLS reweighting
    # 'gn' drops the curvature term sum_i r_i * hess(r_i) (Gauss-Newton);
    # 'newton' assembles the exact per-element Hessian (ops.assemble.
    # assemble_newton) for quadratic local convergence on large-residual
    # fits.  The LM damping/rejection logic absorbs indefiniteness.
    hessian: str = "gn"      # 'gn' | 'newton'
    # Carry a LOW-ORDER state word and evaluate residuals at the
    # double-word state (the 2/h-amplified difference operator otherwise
    # floors the achievable cost at the f32 state-STORAGE roundoff on very
    # fine meshes — measured p-err floor 4.9e-4 at N=100k that neither
    # factorization tier touches).  Pair with method='cr_dw' past the f32
    # conditioning cliff.  GN/SoA path only.
    state_dw: bool = False


class SolveStats(NamedTuple):
    iterations: jnp.ndarray  # () int
    converged: jnp.ndarray   # () bool
    cost: jnp.ndarray        # () final cost
    grad_norm: jnp.ndarray   # () final gradient inf-norm
    lam: jnp.ndarray         # () final damping
    history: jnp.ndarray     # (maxiter, 5) per-iteration table


def stats_from_lm(st) -> SolveStats:
    """Build a :class:`SolveStats` from a finished lm_core.LMState."""
    return SolveStats(
        iterations=st.it,
        converged=st.done,
        cost=st.cost,
        grad_norm=st.gnorm,
        lam=st.lam,
        history=st.history,
    )


def make_gn_solver(problem, options: SolverOptions = SolverOptions()):
    """Build a jitted ``solve(z0, data) -> (z, SolveStats)`` for ``problem``.

    The returned function is traced once per (shapes, options) and can be
    vmapped over a batch axis of (z0, data) for multi-experiment estimation
    (BASELINE.json config 5).
    """
    opt = options
    opt = dataclasses.replace(opt, method=resolve_method(opt.method))
    nv = problem.nv
    num_nodes = problem.num_nodes
    soa = opt.method in ("cr", "cr_dw")

    def solve_step(sys, lam):
        """KKT solve of an assembled system: (dx, dp, dV, gnorm, dmax).

        ``dmax`` (the dimensionless-damping scale max diag(H)) is read
        back from the solve's own equilibration pass instead of being
        re-derived here — the diag extraction + concat + max it replaced
        were ~4 extra kernels per LM iteration at the headline shape.
        """
        gnorm = jnp.maximum(
            jnp.max(jnp.abs(sys.gx)), jnp.max(jnp.abs(sys.gp), initial=0.0)
        )
        if soa:
            dx, dp, dmax = solve_kkt_soa(
                sys, lam, opt.kkt_refine,
                dw=opt.method == "cr_dw",
                with_dmax=True,
            )
            dV = blocks_to_nodes_soa(dx, num_nodes, nv)
            dx_flat = dx.ravel()
        else:
            dx, dp, dmax = solve_kkt(
                sys, lam, opt.method, opt.kkt_refine, with_dmax=True
            )
            dV = blocks_to_nodes(dx, num_nodes, nv)
            dx_flat = dx.ravel()
        return dx_flat, dp, dV, gnorm, dmax

    def gx_flat(sys):
        # g·s and s·s only need ELEMENTWISE pairing, which plain ravel
        # preserves in both layouts — no transposes in the hot path.
        return sys.gx.ravel()

    @jax.jit
    def solve(z0: Decision, data):
        if opt.hessian == "newton":
            # Exact-Newton assembly exposes no residual vector (it works in
            # gradient/Hessian space), so the trial cost is a standalone
            # double-word residual pass — the non-speculative structure.
            def trial_fn(z, carry, lam):
                sys = assemble_newton(problem, z, data)
                if soa:
                    sys = soa_from_blocks(sys)
                dx_flat, dp, dV, gnorm, dmax = solve_step(sys, lam)
                z_try = Decision(V=z.V + dV, p=z.p + dp)
                ct = problem.cost_dw(z_try, data)
                gdot, snorm2 = fused_quadforms(
                    gx_flat(sys), sys.gp, dx_flat, dp
                )
                aux = LMAux(
                    gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                    step_norm=jnp.sqrt(snorm2),
                    alpha=jnp.asarray(1.0, dV.dtype),
                )
                return z_try, carry, ct, aux

            carry0 = ()
            c0 = problem.cost_dw(z0, data)
        elif opt.state_dw:
            if not soa:
                raise ValueError("state_dw requires an SoA method "
                                 "(cr/cr_dw)")
            from collocfem_tpu.ops import doubleword as dw

            def trial_fn(z, carry, lam):
                sys, v_lo = carry
                dx_flat, dp, dV, gnorm, dmax = solve_step(sys, lam)
                # Double-word state update: the step lands in (hi, lo)
                # exactly, so sub-eps corrections accumulate instead of
                # rounding away against |V|.
                v_dw = dw.add(dw.DW(z.V, v_lo), dw.from_single(dV))
                z_try = Decision(V=v_dw.hi, p=z.p + dp)
                sys_try, ct = assemble_gn_soa(
                    problem, z_try, data, with_cost=True, v_lo=v_dw.lo
                )
                gdot, snorm2 = fused_quadforms(
                    gx_flat(sys), sys.gp, dx_flat, dp
                )
                aux = LMAux(
                    gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                    step_norm=jnp.sqrt(snorm2),
                    alpha=jnp.asarray(1.0, dV.dtype),
                )
                return z_try, (sys_try, v_dw.lo), ct, aux

            v_lo0 = jnp.zeros_like(z0.V)
            sys0, c0 = assemble_gn_soa(
                problem, z0, data, with_cost=True, v_lo=v_lo0
            )
            carry0 = (sys0, v_lo0)
        else:
            assemble_c = assemble_gn_soa if soa else assemble_gn

            def trial_fn(z, sys, lam):
                # ``sys`` was assembled at z by the PREVIOUS iteration (or
                # carry0); assemble at the trial point, reusing its
                # residuals for the double-word trial cost.  The named
                # scopes label the device kernels of each phase in
                # profiler traces (benchmarks/trace_iteration.py).
                with jax.named_scope("kkt_solve"):
                    dx_flat, dp, dV, gnorm, dmax = solve_step(sys, lam)
                z_try = Decision(V=z.V + dV, p=z.p + dp)
                with jax.named_scope("assemble"):
                    sys_try, ct = assemble_c(problem, z_try, data,
                                             with_cost=True)
                gdot, snorm2 = fused_quadforms(
                    gx_flat(sys), sys.gp, dx_flat, dp
                )
                aux = LMAux(
                    gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                    step_norm=jnp.sqrt(snorm2),
                    alpha=jnp.asarray(1.0, dV.dtype),
                )
                return z_try, sys_try, ct, aux

            carry0, c0 = assemble_c(problem, z0, data, with_cost=True)

        st = lm_loop(
            z0, carry0, c0, trial_fn,
            maxiter=opt.maxiter, lam0=opt.lam0,
            gtol=opt.gtol, ftol=opt.ftol, xtol=opt.xtol,
            lam_min=opt.lam_min, lam_max=opt.lam_max,
            dtype=z0.V.dtype, verbose=opt.verbose,
        )
        return st.z, stats_from_lm(st)

    return solve


def gauss_newton(problem, z0, data, options: SolverOptions = SolverOptions()):
    """One-shot convenience wrapper around :func:`make_gn_solver`."""
    return make_gn_solver(problem, options)(z0, data)


def make_irls_solver(
    problem, options: SolverOptions = SolverOptions(), n_rounds: int = 4,
    inner_solver=None,
):
    """Huber-robust estimation: iteratively reweighted Gauss-Newton.

    The reference's IRLS capability (SURVEY.md §2a "Newton/GN/IRLS driver",
    §3.4 "possibly IRLS reweighting").  Each round solves the weighted
    least-squares problem with :func:`make_gn_solver`, then recomputes
    per-sample Huber weights w = min(1, delta/|r|) from the *base-weighted*
    measurement residuals, damping outliers.  ``options.irls_delta`` is the
    Huber threshold in units of weighted residual (i.e. sigmas when
    ``meas_weight`` is 1/sigma).

    Returns ``solve(z0, data) -> (z, stats, data_weighted)``; the returned
    ``data_weighted`` carries the final per-sample weights.

    ``inner_solver`` swaps the per-round solver: pass e.g.
    ``parallel.sharded.make_sp_gn_solver(problem, dev_mesh, options)`` for
    element-chain-sharded robust estimation (the reweighting operates on
    global arrays either way).
    """
    if options.irls_delta <= 0:
        raise ValueError("set options.irls_delta > 0 for IRLS")
    delta = options.irls_delta
    inner = inner_solver or make_gn_solver(problem, options)

    @jax.jit
    def reweight(z, data, base_w):
        data_base = data._replace(meas_w=base_w)
        r = problem.measurement_residuals(z, data_base)  # (N, S, ny)
        w = jnp.minimum(1.0, delta / jnp.maximum(jnp.abs(r), 1e-30))
        return data._replace(meas_w=base_w * jnp.sqrt(w))

    def solve(z0, data):
        base_w = jnp.broadcast_to(
            data.meas_w, problem.mmask.shape + (problem.model.ny,)
        )
        z, stats = inner(z0, data)
        for _ in range(n_rounds):
            data = reweight(z, data, base_w)
            z, stats = inner(z, data)
        return z, stats, data

    return solve
