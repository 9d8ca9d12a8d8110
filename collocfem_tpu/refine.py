"""Adaptive mesh refinement for collocation estimation.

The reference lineage refines the time mesh between solves and warm-starts
from the previous solution (SURVEY.md §5 "Checkpoint / resume": "warm starts
between mesh refinements").  Rebuild: a defect-based error indicator drives
:func:`collocfem_tpu.ops.mesh.refined_mesh`, and the previous collocation
polynomial is interpolated onto the new node set.  Each round has new static
shapes and therefore recompiles — refinement is an outer (host) loop by
nature; the inner solves stay fully on device.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from collocfem_tpu.ops.mesh import Mesh, interpolate_trajectory, refined_mesh
from collocfem_tpu.problem import Decision, EstimationProblem
from collocfem_tpu.solve.newton import SolverOptions, make_gn_solver


def defect_error_indicator(problem: EstimationProblem, z: Decision,
                           n_samples: int = 4) -> np.ndarray:
    """Per-element ODE-residual indicator, sampled OFF the collocation nodes.

    At the collocation points the defect is (near) zero by construction; the
    discretization error lives between them.  Samples the collocation
    polynomial's ODE residual ||x'(t) - f(x(t), u(t), p, t)|| at ``n_samples``
    interior non-collocation points per element and returns the per-element
    max — the standard indicator for h-refinement of collocation methods.
    """
    mesh, model = problem.mesh, problem.model
    n, d = mesh.num_elements, mesh.degree
    # Midpoints between adjacent LGL nodes (never collocation points).
    tau = mesh.basis.nodes
    mids = 0.5 * (tau[:-1] + tau[1:])
    sel = np.linspace(0, mids.size - 1, n_samples).round().astype(int)
    taus = mids[sel]                                    # (S,)
    left = mesh.breakpoints[:-1][:, None]
    h = mesh.widths[:, None]
    times = (left + 0.5 * h * (taus[None, :] + 1.0)).ravel()

    V = np.asarray(z.V)
    vals, derivs = interpolate_trajectory(mesh, V, times, derivative=True)
    x = jnp.asarray(vals)[:, : model.nx]
    dx = jnp.asarray(derivs)[:, : model.nx]
    # Input at sample times: interpolate the node inputs the same way.
    # (problem stores u per element-node in ProblemData; use zeros when the
    # caller doesn't provide u_of_t — indicator only needs relative sizes.)
    u = jnp.zeros((times.size, model.nu), problem.dtype)
    f = jax.vmap(model.f, in_axes=(0, 0, None, 0))(
        x, u, z.p, jnp.asarray(times, problem.dtype)
    )
    err = jnp.linalg.norm(dx - f, axis=1).reshape(n, n_samples)
    # h-weighted integrated residual: the element's contribution to the
    # global error scales with its width, so the indicator decreases under
    # refinement even where the pointwise residual stays sharp.
    return np.asarray(jnp.mean(err, axis=1)) * mesh.widths


def estimate_multilevel(
    model,
    meas_times,
    y_values,
    p0,
    *,
    t0,
    tf,
    num_elements,
    degree: int = 4,
    coarsen: int = 4,
    levels: int = 3,
    defect_weight=100.0,
    pack_kwargs: dict | None = None,
    options: SolverOptions = SolverOptions(),
    u_nodes_fn=None,
):
    """Nested-iteration estimation: solve coarse, prolong, re-solve.

    The float32 path is conditioning-limited for single-shot solves on
    very fine meshes: the Jacobi-equilibrated collocation chain behaves
    like a 1-D Poisson operator with cond ~ K^2, which crosses the float32
    Cholesky cliff (~1/eps) around K ~ 10^4.  Classic nested iteration
    sidesteps it: converge on a coarse mesh (cond down by coarsen^2 per
    level), interpolate the solution up, and let the fine level start in
    the quadratic-convergence basin where large-lambda damped steps
    suffice.  Returns (problem, z, stats, history) like estimate_adaptive.
    """
    pack_kwargs = dict(pack_kwargs or {})
    ns = [max(2, int(np.ceil(num_elements / coarsen ** (levels - 1 - i))))
          for i in range(levels)]
    ns[-1] = num_elements
    opts_per_level = level_schedule(options, ns)
    z = None
    history = []
    prev_mesh = None
    for n, opts in zip(ns, opts_per_level):
        from collocfem_tpu.ops.mesh import uniform_mesh

        mesh = uniform_mesh(t0, tf, n, degree)
        prob = EstimationProblem.build(
            model, mesh, meas_times, defect_weight=defect_weight
        )
        u_nodes = u_nodes_fn(mesh) if u_nodes_fn is not None else None
        data = prob.pack_data(
            y_values, meas_times, u_nodes=u_nodes, **pack_kwargs
        )
        if z is None:
            z0 = prob.initial_guess_from_data(meas_times, y_values, p0=p0)
        else:
            V0 = interpolate_trajectory(prev_mesh, z.V, mesh.node_times)
            z0 = Decision(V=jnp.asarray(V0, prob.dtype), p=z.p)
        solve = make_gn_solver(prob, opts)
        z, stats = solve(z0, data)
        history.append((mesh, np.asarray(z.p), float(stats.cost)))
        prev_mesh = mesh
    return prob, z, stats, history


# Chain length past which the plain-f32 factorization accuracy floors out:
# the equilibrated collocation chain has cond ~ K^2 (1-D-Poisson-like), and
# at K ~ 4e4 the K^2 * eps_f32 step error reaches ~1e-4 relative — measured
# at N=100k round 4 as a converged p-err of 4.9e-4 that no amount of
# iteration repairs.  Levels beyond this run the double-word (~48-bit)
# cyclic reduction instead.
CR_DW_CHAIN = 40_000


def level_schedule(options: SolverOptions, ns) -> list[SolverOptions]:
    """Per-level (method, tier) schedule for nested iteration.

    ``options`` may be a sequence (one per level, used verbatim) or a
    single :class:`SolverOptions` — then levels whose chain length K = n+1
    exceeds :data:`CR_DW_CHAIN` get ``method='cr_dw'`` (the double-word
    factorization tier that restores quadratic-ladder accuracy past the
    f32 conditioning cliff) and the rest keep the given method.
    """
    import dataclasses

    if isinstance(options, (list, tuple)):
        if len(options) != len(ns):
            raise ValueError(
                f"options sequence has {len(options)} entries for "
                f"{len(ns)} levels"
            )
        return list(options)
    return [
        dataclasses.replace(options, method="cr_dw", state_dw=True)
        if n + 1 > CR_DW_CHAIN else options
        for n in ns
    ]


def estimate_adaptive(
    model,
    mesh0: Mesh,
    meas_times,
    y_values,
    p0,
    *,
    rounds: int = 3,
    growth: float = 1.5,
    floor_frac: float = 0.1,
    defect_weight=100.0,
    pack_kwargs: dict | None = None,
    options: SolverOptions = SolverOptions(),
    u_nodes_fn=None,
):
    """Estimate with ``rounds`` of defect-driven h-refinement + warm starts.

    Args:
      u_nodes_fn: optional ``f(mesh) -> (N, d+1, nu)`` input table builder
        (inputs must be re-evaluated on each refined mesh).
    Returns:
      (problem, z, stats, history) — history is a list of
      (mesh, p_estimate, max_indicator) per round.
    """
    pack_kwargs = dict(pack_kwargs or {})
    mesh = mesh0
    z = None
    history = []
    for rnd in range(rounds):
        prob = EstimationProblem.build(
            model, mesh, meas_times, defect_weight=defect_weight
        )
        u_nodes = u_nodes_fn(mesh) if u_nodes_fn is not None else None
        data = prob.pack_data(
            y_values, meas_times, u_nodes=u_nodes, **pack_kwargs
        )
        if z is None:
            z0 = prob.initial_guess_from_data(meas_times, y_values, p0=p0)
        else:
            V0 = interpolate_trajectory(history[-1][0], z.V, mesh.node_times)
            z0 = Decision(V=jnp.asarray(V0, prob.dtype), p=z.p)
        solve = make_gn_solver(prob, options)
        z, stats = solve(z0, data)
        ind = defect_error_indicator(prob, z)
        history.append((mesh, np.asarray(z.p), float(ind.max())))
        if rnd < rounds - 1:
            n_new = int(np.ceil(mesh.num_elements * growth))
            # Floor the density at a fraction of its max: without it the
            # equidistribution dumps nearly all elements on the sharpest
            # feature and lets background elements balloon, *increasing*
            # global error.
            density = np.maximum(ind, floor_frac * ind.max() + 1e-300)
            mesh = refined_mesh(
                mesh.t0, mesh.tf, n_new, mesh.degree, density
            )
    return prob, z, stats, history
