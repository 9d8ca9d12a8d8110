"""Per-element collocation residual primitives (L4, SURVEY.md §2a
"Collocation defect residual" / "Measurement & cost terms").

All functions here are pure jnp and operate on a **single element**; the
problem layer vmaps them over all elements (BASELINE.json north_star:
"per-element residual and defect evaluation ... becomes a vmapped kernel
over all elements").  Derivatives come from jacfwd at the assembly layer —
nothing here hand-codes a Jacobian.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from collocfem_tpu.ops.einsum_hp import einsum_hp


def element_derivative(diff: jnp.ndarray, width, Xe: jnp.ndarray) -> jnp.ndarray:
    """Collocation-polynomial time derivative at all element nodes.

    Args:
      diff:  (d+1, d+1) reference-element differentiation matrix.
      width: scalar element width h_e.
      Xe:    (d+1, n) node values.
    Returns:
      (d+1, n) dX/dt at the nodes (chain rule: dtau/dt = 2/h).

    Numerics: D annihilates constants (its rows sum to zero), so the
    element-left value is subtracted first — mathematically identical, but
    it removes the O(|X|) cancellation in D @ X that left the derivative
    with only ~3 significant digits in float32 on fine meshes (h ~ 1e-3),
    which stalled float32 convergence at N ~ 10^4 elements.
    """
    return (2.0 / width) * einsum_hp(
        "kj,jn->kn", diff, Xe - Xe[:1], preferred_element_type=Xe.dtype
    )


def defect_residual(model, diff, width, times, Xe, Ue, p, scale):
    """Weighted collocation defects at local nodes 1..d of one element.

    The defect at node k is  dx/dt(t_k) - f(x_k, u_k, p, t_k); it is skipped
    at local node 0 (enforced as node d of the previous element; node 0 of
    the first element carries the initial condition / prior instead).

    Args:
      model: Model instance.
      diff:  (d+1, d+1) differentiation matrix.
      width: scalar h_e.
      times: (d+1,) node times.
      Xe:    (d+1, nx) node states.
      Ue:    (d+1, nu) node inputs.
      p:     (nq,) parameters.
      scale: (d, nx) multiplicative sqrt-weights (quadrature x process noise).
    Returns:
      (d, nx) scaled defect residuals.
    """
    xdot = element_derivative(diff, width, Xe)
    fvals = jax.vmap(model.f, in_axes=(0, 0, None, 0))(Xe, Ue, p, times)
    return (xdot - fvals)[1:, :] * scale


def defect_residual_all(model, diff, width, times, Xe, Ue, p, scale):
    """Weighted defects at ALL d+1 nodes of one element.

    Used by the trajectory-optimization layer: enforcing the defect at every
    LGL node (standard pseudospectral practice) pins the degree-d defect
    polynomial at d+1 points, so it vanishes identically — collocating only
    at d nodes leaves one dynamics-violating control mode per element that an
    optimizer will exploit.  The resulting constraint set is mildly
    over-determined across shared nodes, which the augmented-Lagrangian
    least-squares treatment absorbs.

    Returns (d+1, nx) scaled defect residuals (``scale`` is (d+1, nx)).
    """
    xdot = element_derivative(diff, width, Xe)
    fvals = jax.vmap(model.f, in_axes=(0, 0, None, 0))(Xe, Ue, p, times)
    return (xdot - fvals) * scale


def element_derivative_dw(diff, width, Xe_hi, Xe_lo):
    """Double-word collocation derivative: (2/h) D (Xe_hi + Xe_lo).

    At fine widths the derivative operator amplifies STATE-STORAGE
    roundoff by 2/h: a float32 node value carries ~eps·|x| absolute error,
    so dx/dt inherits (2/h)·eps·|x| noise that no factorization precision
    can remove — measured at N=100k (h=1e-4) as a converged-cost floor of
    ~0.28 and a parameter-error floor of 4.9e-4 that plain-f32 AND
    double-word-factorization ladders both hit identically.  Carrying a
    low-order word for the state and contracting D against the pair in
    error-free double-word arithmetic (Dekker two_prod + two_sum
    accumulation) restores derivative accuracy to ~(2/h)·eps² and moves
    the floor out of reach.  Returns a doubleword.DW of shape (d+1, n).
    """
    from collocfem_tpu.ops import doubleword as dw

    # Exact left-value subtraction in DW (kills the O(|X|) constant mode
    # BEFORE the contraction, same trick as element_derivative).
    xd = dw.add(dw.DW(*dw.two_sum(Xe_hi, -Xe_hi[:1])),
                dw.DW(*dw.two_sum(Xe_lo, -Xe_lo[:1])))
    dcount = diff.shape[0]
    acc = None
    for j in range(dcount):
        term = dw.add(
            dw.DW(*dw.two_prod(diff[:, j:j + 1], xd.hi[j][None, :])),
            dw.from_single(diff[:, j:j + 1] * xd.lo[j][None, :]),
        )
        acc = term if acc is None else dw.add(acc, term)
    return dw.mul_single(acc, 2.0 / width)


def defect_residual_dw(model, diff, width, times, Xe_hi, Xe_lo, Ue, p,
                       scale):
    """Double-word-state twin of :func:`defect_residual`.

    The derivative term is evaluated over the (hi, lo) state pair; the
    dynamics f are evaluated at the hi word (f has O(1) state sensitivity,
    so sub-eps state corrections move f below float32 resolution — only
    the 2/h-amplified difference operator needs the low word).
    """
    from collocfem_tpu.ops import doubleword as dw

    xdot = element_derivative_dw(diff, width, Xe_hi, Xe_lo)
    fvals = jax.vmap(model.f, in_axes=(0, 0, None, 0))(Xe_hi, Ue, p, times)
    r = dw.to_single(dw.add_single(xdot, -fvals))
    return r[1:, :] * scale


def measurement_residual(model, rows, Xe, Ue_meas, p, times, y, w, mask):
    """Weighted output residuals for the measurements landing in one element.

    Args:
      model:   Model instance.
      rows:    (S, d+1) Lagrange interpolation rows at the sample times.
      Xe:      (d+1, nx) node states.
      Ue_meas: (S, nu) input at the sample times.
      p:       (nq,) parameters.
      times:   (S,) sample times.
      y:       (S, ny) measured values (padded entries arbitrary).
      w:       (ny,) or (S, ny) sqrt measurement weights.
      mask:    (S,) 1.0 for real samples, 0.0 for padding.
    Returns:
      (S, ny) scaled residuals (zero on padding).
    """
    x_s = einsum_hp("sj,jn->sn", rows, Xe, preferred_element_type=Xe.dtype)
    h_s = jax.vmap(model.h, in_axes=(0, 0, None, 0))(x_s, Ue_meas, p, times)
    return (h_s - y) * w * mask[:, None]


def interpolate_states(rows, Xe):
    """(S, d+1) rows x (d+1, n) node values -> (S, n) interpolated values."""
    return einsum_hp("sj,jn->sn", rows, Xe, preferred_element_type=Xe.dtype)
