"""Problem assembly layer (L4): estimation problems on a collocation mesh.

Capability parity target: the reference's core "FEM" layer (SURVEY.md §1 L4,
§3.1-§3.2 call stacks): global residual vector = collocation defects +
measurement residuals (+ parameter/initial-state priors for joint MAP
estimation), with the block-banded + arrowhead second-order structure.  No
file:line citations possible — reference mount empty (SURVEY.md §0).

Design
------
The reference assembles a global ``scipy.sparse`` matrix; here **no global
sparse matrix ever exists**.  A problem is split into

  * a static :class:`EstimationProblem` — model + precomputed host-side
    tables (differentiation matrix, widths, interpolation rows, masks), baked
    into the jitted computation as constants (XLA moves them to the device
    once at execution), and
  * a :class:`ProblemData` pytree — measurement values, inputs, priors and
    weights — passed as a traced argument so the *same compiled program*
    serves every experiment (and vmaps over batches of experiments,
    BASELINE.json config 5).

Residuals/Jacobians are evaluated per element (vmap) and scattered into the
block-tridiagonal + arrowhead Gauss-Newton system by
:mod:`collocfem_tpu.ops.assemble`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from collocfem_tpu.model import Model
from collocfem_tpu.ops import residual as res_ops
from collocfem_tpu.ops.mesh import Mesh


class Decision(NamedTuple):
    """Decision variables: node values V (M, nv) and parameters p (nq,)."""

    V: jnp.ndarray
    p: jnp.ndarray


class ProblemData(NamedTuple):
    """Per-experiment data pytree (traced; vmap over a leading batch axis).

    Attributes:
      y:        (N, S, ny) measurement values grouped by element (padded).
      u:        (N, d+1, nu) exogenous input at the collocation nodes.
      meas_w:   (ny,) sqrt measurement weights (1/sigma).
      p_prior:  (nq,) parameter prior mean.
      p_w:      (nq,) sqrt prior weights (0 = no prior on that parameter).
      x0_prior: (nx,) initial-state prior mean.
      x0_w:     (nx,) sqrt prior weights (0 = free initial state), or a
                full (nx, nx) sqrt-information matrix L (residual
                L @ (x(t0) − x0_prior); cost term uses Λ = LᵀL).  The
                matrix form carries a correlated arrival-cost prior —
                the moving-horizon estimator (collocfem_tpu.mhe) feeds
                the EKF-propagated window prior through it.
    """

    y: jnp.ndarray
    u: jnp.ndarray
    meas_w: jnp.ndarray
    p_prior: jnp.ndarray
    p_w: jnp.ndarray
    x0_prior: jnp.ndarray
    x0_w: jnp.ndarray


class ElemData(NamedTuple):
    """Per-element slice of problem tables + data (internal, vmapped)."""

    width: jnp.ndarray   # ()
    times: jnp.ndarray   # (d+1,)
    u: jnp.ndarray       # (d+1, nu)
    dscale: jnp.ndarray  # (d, nx)
    rows: jnp.ndarray    # (S, d+1)
    mask: jnp.ndarray    # (S,)
    mtimes: jnp.ndarray  # (S,)
    y: jnp.ndarray       # (S, ny)
    meas_w: jnp.ndarray  # (S, ny) per-sample sqrt weights


def group_measurements(
    mesh: Mesh, times: np.ndarray, values: np.ndarray, pad_to: int | None = None
):
    """Group samples by containing element with static-shape padding.

    Returns host arrays (y (N,S,ny), rows (N,S,d+1), mask (N,S),
    mtimes (N,S)) — SURVEY.md §7 hard part 5: measurement times become
    precomputed (element, interpolation-row) tables so shapes stay static.
    """
    times = np.asarray(times, dtype=np.float64)
    values = np.atleast_2d(np.asarray(values, dtype=np.float64))
    if values.shape[0] != times.shape[0]:
        raise ValueError("values must have one row per sample time")
    n, d = mesh.num_elements, mesh.degree
    e, rows = mesh.interp_rows(times)
    counts = np.bincount(e, minlength=n)
    s = int(counts.max()) if pad_to is None else int(pad_to)
    if s < counts.max():
        raise ValueError(f"pad_to={s} < max samples per element {counts.max()}")
    s = max(s, 1)
    ny = values.shape[1]
    yg = np.zeros((n, s, ny))
    rg = np.zeros((n, s, d + 1))
    mg = np.zeros((n, s))
    tg = np.zeros((n, s))
    # Vectorized slotting: stable-sort samples by element, then the slot of
    # sample i is its rank within its element (cumcount).
    order = np.argsort(e, kind="stable")
    es = e[order]
    starts = np.searchsorted(es, np.arange(n), side="left")
    slot = np.arange(es.size) - starts[es]
    yg[es, slot] = values[order]
    rg[es, slot] = rows[order]
    mg[es, slot] = 1.0
    tg[es, slot] = times[order]
    return yg, rg, mg, tg


@dataclasses.dataclass(frozen=True, eq=False)
class EstimationProblem:
    """Weighted nonlinear least-squares collocation problem.

    Residual groups (SURVEY.md §3.1-§3.2):
      * defects at local nodes 1..d of every element, scaled by
        sqrt(quadrature weight * h/2) * defect_weight (the process-noise
        sqrt information for joint MAP state-path estimation);
      * measurement residuals y - h(x(t_i)) scaled by meas_w;
      * optional Gaussian priors on p and on x(t0).

    The instance holds only static tables; experiment data arrives via
    :class:`ProblemData` at call time.
    """

    model: Model
    mesh: Mesh
    # Host-side constant tables (numpy; see build() for why not device):
    diff: jnp.ndarray        # (d+1, d+1)
    widths: jnp.ndarray      # (N,)
    elem_times: jnp.ndarray  # (N, d+1)
    dscale: jnp.ndarray      # (N, d, nx) — or (N, d+1, nx) for 'full' rule
    mrows: jnp.ndarray       # (N, S, d+1)
    mmask: jnp.ndarray       # (N, S)
    mtimes: jnp.ndarray      # (N, S)
    node_idx: np.ndarray     # (N, d+1) static host ints
    dtype: jnp.dtype
    defect_rule: str = "interior"

    # -- construction ---------------------------------------------------------
    @staticmethod
    def build(
        model: Model,
        mesh: Mesh,
        meas_times: np.ndarray,
        defect_weight=1.0,
        pad_to: int | None = None,
        dtype=None,
        defect_rule: str = "interior",
    ) -> "EstimationProblem":
        """Precompute all static tables (host numpy -> device arrays).

        ``defect_rule`` selects the process-noise quadrature:
          * ``"interior"`` (default): defects at local nodes 1..d — the
            classical square collocation system (d defect rows pin the d
            free coefficients per element given the shared left node).
          * ``"full"``: defects at ALL d+1 LGL nodes, each carrying its own
            quadrature weight.  The least-squares (MAP) objective then
            integrates the process-noise density with the COMPLETE LGL rule
            — the interior rule drops the w₀·h/2 left-endpoint term, a
            relative O(1/(d(d+1))) quadrature bias that dominates the gap
            to the exact Kalman/RTS smoother on linear-Gaussian problems
            (tests/test_mhe.py, tests/test_kalman_parity.py).  Use for
            filtering-grade MAP estimation; costs one extra residual row
            per state per element.
        """
        dtype = dtype or (
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        )
        n, d, nx = mesh.num_elements, mesh.degree, model.nx
        dummy_vals = np.zeros((np.asarray(meas_times).size, model.ny))
        _, rg, mg, tg = group_measurements(mesh, meas_times, dummy_vals, pad_to)
        # Defect scale: sqrt(w_k * h_e / 2) * defect_weight at the
        # collocated nodes (1..d, or 0..d for the 'full' rule).
        if defect_rule not in ("interior", "full"):
            raise ValueError(f"unknown defect_rule {defect_rule!r}")
        w = mesh.basis.weights if defect_rule == "full" else mesh.basis.weights[1:]
        h = mesh.widths  # (N,)
        dw = np.broadcast_to(np.asarray(defect_weight, dtype=np.float64), (nx,))
        scale = np.sqrt(w[None, :, None] * h[:, None, None] * 0.5) * dw
        # Tables stay HOST-side (numpy): jit captures them as closure
        # constants, and lowering a device-resident constant costs a
        # device->host fetch per array.  numpy constants embed straight
        # from host memory and move to the device once, at execution.
        return EstimationProblem(
            model=model,
            mesh=mesh,
            diff=np.asarray(mesh.basis.diff, dtype),
            widths=np.asarray(h, dtype),
            elem_times=np.asarray(mesh.elem_times, dtype),
            dscale=np.asarray(scale, dtype),
            mrows=np.asarray(rg, dtype),
            mmask=np.asarray(mg, dtype),
            mtimes=np.asarray(tg, dtype),
            node_idx=mesh.elem_node_idx,
            dtype=dtype,
            defect_rule=defect_rule,
        )

    def pack_data(
        self,
        y_values: np.ndarray,
        meas_times: np.ndarray,
        u_nodes=None,
        meas_weight=1.0,
        p_prior=None,
        p_weight=0.0,
        x0_prior=None,
        x0_weight=0.0,
    ) -> ProblemData:
        """Build the ProblemData pytree from raw sample arrays."""
        m = self.model
        y_arr = np.atleast_2d(np.asarray(y_values, dtype=np.float64))
        if y_arr.shape[-1] != m.ny:
            raise ValueError(
                f"y_values has {y_arr.shape[-1]} channel(s) but the model's "
                f"output map h produces ny={m.ny} — a mismatch would "
                "silently broadcast in the residual"
            )
        yg, _, _, _ = group_measurements(
            self.mesh, meas_times, y_values, pad_to=self.mrows.shape[1]
        )
        n, d = self.mesh.num_elements, self.mesh.degree
        if u_nodes is None:
            u_nodes = np.zeros((n, d + 1, m.nu))
        bc = lambda v, k: np.broadcast_to(np.asarray(v, dtype=np.float64), (k,))
        x0w = np.asarray(x0_weight, dtype=np.float64)
        x0w = x0w if x0w.ndim == 2 else bc(x0_weight, m.nx)
        return ProblemData(
            y=jnp.asarray(yg, self.dtype),
            u=jnp.asarray(u_nodes, self.dtype),
            meas_w=jnp.asarray(bc(meas_weight, m.ny), self.dtype),
            p_prior=jnp.asarray(
                np.zeros(m.nq) if p_prior is None else p_prior, self.dtype
            ),
            p_w=jnp.asarray(bc(p_weight, m.nq), self.dtype),
            x0_prior=jnp.asarray(
                np.zeros(m.nx) if x0_prior is None else x0_prior, self.dtype
            ),
            x0_w=jnp.asarray(x0w, self.dtype),
        )

    # -- sizes ----------------------------------------------------------------
    @property
    def nv(self) -> int:
        """Decision variables per node (estimation: just the state)."""
        return self.model.nx

    @property
    def num_nodes(self) -> int:
        return self.mesh.num_nodes

    # -- residuals --------------------------------------------------------------
    def _elem_data(self, data: ProblemData) -> ElemData:
        # meas_w may be (ny,) shared or (N, S, ny) per-sample (IRLS).
        n, s = self.mmask.shape
        return ElemData(
            width=self.widths,
            times=self.elem_times,
            u=data.u,
            dscale=self.dscale,
            rows=self.mrows,
            mask=self.mmask,
            mtimes=self.mtimes,
            y=data.y,
            meas_w=jnp.broadcast_to(data.meas_w, (n, s, self.model.ny)),
        )

    def elem_residual(self, xe_flat: jnp.ndarray, p: jnp.ndarray, ed: ElemData):
        """Residual vector of ONE element: (d*nx + S*ny,). jacfwd target."""
        d, nx = self.mesh.degree, self.model.nx
        xe = xe_flat.reshape(d + 1, self.nv)
        x_nodes, u_nodes = xe[:, :nx], ed.u
        defect_fn = (
            res_ops.defect_residual_all
            if self.defect_rule == "full"
            else res_ops.defect_residual
        )
        defect = defect_fn(
            self.model, self.diff, ed.width, ed.times, x_nodes, u_nodes, p,
            ed.dscale,
        )
        u_meas = res_ops.interpolate_states(ed.rows, u_nodes)
        meas = res_ops.measurement_residual(
            self.model, ed.rows, x_nodes, u_meas, p, ed.mtimes, ed.y,
            ed.meas_w, ed.mask,
        )
        return jnp.concatenate([defect.ravel(), meas.ravel()])

    def elem_residual_dw(self, xe_flat, p, ed: ElemData, xe_lo_flat):
        """Double-word-state twin of :meth:`elem_residual`.

        The defect's 2/h-amplified difference operator runs over the
        (hi, lo) state pair (ops.residual.defect_residual_dw); dynamics,
        measurements, and weights see the hi word only.  Argument order
        keeps (xe_flat, p) first so the assembly's jacfwd(argnums=(0, 1))
        applies unchanged — the Jacobian is taken at the hi word, which is
        all Gauss-Newton needs (the LOW word only restores residual-value
        accuracy).
        """
        if self.defect_rule == "full":
            raise NotImplementedError(
                "state_dw supports the interior defect rule only"
            )
        d, nx = self.mesh.degree, self.model.nx
        xe = xe_flat.reshape(d + 1, self.nv)
        xe_lo = xe_lo_flat.reshape(d + 1, self.nv)
        x_nodes, u_nodes = xe[:, :nx], ed.u
        defect = res_ops.defect_residual_dw(
            self.model, self.diff, ed.width, ed.times, x_nodes,
            xe_lo[:, :nx], u_nodes, p, ed.dscale,
        )
        u_meas = res_ops.interpolate_states(ed.rows, u_nodes)
        meas = res_ops.measurement_residual(
            self.model, ed.rows, x_nodes, u_meas, p, ed.mtimes, ed.y,
            ed.meas_w, ed.mask,
        )
        return jnp.concatenate([defect.ravel(), meas.ravel()])

    def gather_elements(self, V: jnp.ndarray) -> jnp.ndarray:
        """(M, nv) node values -> (N, (d+1)*nv) per-element flats.

        Element e spans global nodes e*d + j (j = 0..d, endpoints shared),
        so the overlapping windows are d+1 STATIC strided slices, which XLA
        lowers cheaper than the equivalent dynamic row gather V[node_idx].
        """
        n, d = self.mesh.num_elements, self.mesh.degree
        cols = [V[j:j + (n - 1) * d + 1:d] for j in range(d + 1)]
        return jnp.stack(cols, axis=1).reshape(n, -1)

    def residual_vector(self, z: Decision, data: ProblemData) -> jnp.ndarray:
        """Full stacked residual vector (defects, measurements, priors)."""
        xe = self.gather_elements(z.V)
        ed = self._elem_data(data)
        r_elems = jax.vmap(self.elem_residual, in_axes=(0, None, 0))(xe, z.p, ed)
        r_p = data.p_w * (z.p - data.p_prior)
        dx0 = z.V[0, : self.model.nx] - data.x0_prior
        r_x0 = data.x0_w @ dx0 if data.x0_w.ndim == 2 else data.x0_w * dx0
        return jnp.concatenate([r_elems.ravel(), r_p, r_x0])

    def cost(self, z: Decision, data: ProblemData) -> jnp.ndarray:
        r = self.residual_vector(z, data)
        return 0.5 * jnp.sum(r * r)

    def cost_dw(self, z: Decision, data: ProblemData):
        """0.5 * sum(r^2) accumulated in double-word precision.

        Residuals are evaluated in the working dtype; only the squared-sum
        ACCUMULATION runs in ~48-bit double-word f32 (ops.doubleword: one
        two_prod + log2(n) DW adds — a few extra elementwise passes).  The
        LM accept/reject test compares costs at ~cost * 6e-8 resolution in
        plain f32, which freezes convergence once true per-step
        improvements drop below that; the DW pair resolves improvements
        down to ~cost * 4e-15.  Returns a doubleword.DW scalar.
        """
        from collocfem_tpu.ops import doubleword as dw

        r = self.residual_vector(z, data).ravel()
        s = dw.pairwise_sum(dw.DW(*dw.two_prod(r, r)))
        return dw.mul_single(s, 0.5)

    def measurement_residuals(self, z: Decision, data: ProblemData):
        """Weighted per-sample measurement residuals (N, S, ny) (masked).

        Used by the IRLS driver to compute robust reweighting factors.
        """
        ed = self._elem_data(data)
        xe = self.gather_elements(z.V)
        d, nx = self.mesh.degree, self.model.nx

        def per_elem(xe_flat, e):
            x_nodes = xe_flat.reshape(d + 1, self.nv)[:, :nx]
            u_meas = res_ops.interpolate_states(e.rows, e.u)
            return res_ops.measurement_residual(
                self.model, e.rows, x_nodes, u_meas, z.p, e.mtimes, e.y,
                e.meas_w, e.mask,
            )

        return jax.vmap(per_elem)(xe, ed)

    # -- initialization helpers -------------------------------------------------
    def initial_guess_from_data(
        self, meas_times, y_values, p0, state_guess=None
    ) -> Decision:
        """Crude V0: interpolate measured channels over time, zeros elsewhere
        (the reference lineage warm-starts from data the same way [R])."""
        m = self.mesh
        tt = m.node_times
        nx = self.model.nx
        V0 = np.zeros((m.num_nodes, self.nv))
        y = np.atleast_2d(np.asarray(y_values, dtype=np.float64))
        k = min(nx, y.shape[1])
        for j in range(k):
            V0[:, j] = np.interp(tt, np.asarray(meas_times), y[:, j])
        if state_guess is not None:
            V0[:] = state_guess
        return Decision(
            V=jnp.asarray(V0, self.dtype), p=jnp.asarray(p0, self.dtype)
        )
