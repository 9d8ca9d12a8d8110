"""Free-final-time trajectory optimization (minimum-time problems).

Capability parity target: the reference lineage's optimal-control problems
include free-final-time formulations (time enters the NLP as a decision
variable handed to IPOPT).  No file:line citations possible — the reference
mount was empty (SURVEY.md §0).

Design
------
A data-dependent horizon would make every mesh table dynamic — hostile to
XLA's static-shape compilation model.  Instead the problem is transcribed in
**normalized time** s ∈ [0, 1] on a *static* mesh, and the horizon enters as
one extra entry in the existing parameter "arrowhead" column of the KKT
system (no new structure anywhere in the solver):

  * dynamics are time-dilated:  dx/ds = tf · f(x, u, p, s·tf);
  * the horizon is parameterized  tf = tf_ref · exp(θ)  with θ the appended
    parameter — positive by construction, and the exp keeps the Gauss-Newton
    model of d(tf)/dθ well-scaled across decades of tf;
  * a bracket tf ∈ [tf_min, tf_max] is enforced through the existing
    log-barrier path-constraint machinery (two extra rows of ``g``).  The
    floor matters: with a pure time cost the transcription has a degenerate
    basin at tf → 0 (every defect vanishes as the dilation collapses), and
    the barrier keeps the iterates out of it;
  * the running cost picks up the dilation Jacobian:  ∫₀^T l dt =
    ∫₀¹ l·tf ds, i.e. the least-squares residuals are scaled by √tf, and a
    time cost  time_weight·T  is the constant residual √(2·time_weight·tf)
    under the same quadrature.

Everything downstream (AL/log-barrier solve, block-tridiagonal KKT with
arrowhead Schur complement, SPIKE/CR factorization) is unchanged.
"""

from __future__ import annotations

import jax.numpy as jnp

from collocfem_tpu.model import Model
from collocfem_tpu.ocp import OptimalControlProblem
from collocfem_tpu.ops.mesh import uniform_mesh


class FreeTimeModel(Model):
    """Time-dilated wrapper: normalized time s ∈ [0,1], horizon in p[-1].

    The wrapped model's parameters stay at p[:-1]; the appended θ = p[-1]
    encodes the horizon as tf = tf_ref·exp(θ).  Instances are meant to be
    built through :func:`free_time_ocp`.
    """

    def __init__(self, base: Model, tf_ref: float, time_weight: float,
                 tf_min: float, tf_max: float):
        if tf_ref <= 0 or tf_min <= 0 or tf_max <= tf_min:
            raise ValueError("need 0 < tf_min < tf_max and tf_ref > 0")
        if not (tf_min < tf_ref < tf_max):
            raise ValueError(
                f"tf_ref={tf_ref} must lie strictly inside the bracket "
                f"({tf_min}, {tf_max}) so the initial guess is barrier-feasible"
            )
        self.base = base
        self.tf_ref = float(tf_ref)
        self.time_weight = float(time_weight)
        self.tf_min = float(tf_min)
        self.tf_max = float(tf_max)
        self.nx = base.nx
        self.nu = base.nu
        self.nq = base.nq + 1
        self.ng = base.ng + 2
        self.ne = base.ne

    # -- horizon ---------------------------------------------------------------
    def final_time(self, p):
        """Optimized horizon tf = tf_ref · exp(θ) from a parameter vector."""
        return self.tf_ref * jnp.exp(p[-1])

    def _split(self, p):
        return p[:-1], self.final_time(p)

    # -- Model protocol (normalized time s) -------------------------------------
    def f(self, x, u, p, s):
        pb, tf = self._split(p)
        return tf * self.base.f(x, u, pb, s * tf)

    def h(self, x, u, p, s):
        pb, tf = self._split(p)
        return self.base.h(x, u, pb, s * tf)

    def g(self, x, u, p, s):
        pb, tf = self._split(p)
        gb = self.base.g(x, u, pb, s * tf)
        bracket = jnp.stack([self.tf_min - tf, tf - self.tf_max])
        return jnp.concatenate([gb, bracket])

    def g_eq(self, x, u, p, s):
        pb, tf = self._split(p)
        return self.base.g_eq(x, u, pb, s * tf)

    def running_cost_residual(self, x, u, p, s):
        pb, tf = self._split(p)
        rb = jnp.sqrt(tf) * self.base.running_cost_residual(x, u, pb, s * tf)
        if self.time_weight == 0.0:
            return rb
        # 0.5 · Σ w_k (h/2) · (√(2·w_t·tf))² = w_t·tf · ∫₀¹ ds = w_t·T.
        rt = jnp.sqrt(2.0 * self.time_weight * tf)
        return jnp.concatenate([rb, rt[None]])

    def terminal_cost_residual(self, x, p):
        return self.base.terminal_cost_residual(x, p[:-1])


def free_time_ocp(
    model: Model,
    num_elements: int = 16,
    degree: int = 4,
    x0=None,
    xf=None,
    tf_ref: float = 1.0,
    time_weight: float = 1.0,
    tf_min: float | None = None,
    tf_max: float | None = None,
    dtype=None,
):
    """Build a free-final-time OCP on a static normalized-time mesh.

    Returns ``(prob, ftmodel)``: an :class:`OptimalControlProblem` over
    s ∈ [0, 1] whose decision parameters end with the horizon coordinate θ,
    and the :class:`FreeTimeModel` wrapper (use ``ftmodel.final_time(z.p)``
    to read the optimized horizon).  Solve with the standard AL/barrier
    solver::

        prob, ftm = free_time_ocp(model, 16, 4, x0=[0,0], xf=[1,0],
                                  tf_ref=3.0, time_weight=1.0)
        z, stats = solve_ocp(prob, options=ALBarrierOptions(n_outer=14))
        tf = ftm.final_time(z.p)

    ``prob.initial_guess()`` starts at θ = 0, i.e. tf = tf_ref — strictly
    inside the barrier bracket.  Defaults: ``tf_min = tf_ref/10``,
    ``tf_max = 10·tf_ref``.
    """
    tf_min = tf_ref / 10.0 if tf_min is None else float(tf_min)
    tf_max = tf_ref * 10.0 if tf_max is None else float(tf_max)
    ftmodel = FreeTimeModel(model, tf_ref, time_weight, tf_min, tf_max)
    mesh = uniform_mesh(0.0, 1.0, num_elements, degree)
    prob = OptimalControlProblem.build(ftmodel, mesh, x0=x0, xf=xf, dtype=dtype)
    return prob, ftmodel
