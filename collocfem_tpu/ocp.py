"""Trajectory-optimization problem assembly (BASELINE.json config 3).

Capability parity target: the reference's inequality-constrained optimal
control path (SURVEY.md §3.3 "Trajectory optimization with path constraints";
§2a "Inequality handling").  The reference lineage hands these problems to
IPOPT via Python callbacks — a C++→Python boundary every iteration (SURVEY.md
§3.3 marks it as the perf bottleneck).  No file:line citations possible —
reference mount empty (SURVEY.md §0).

Design
------
Controls become node decision variables alongside the states: each global
node carries ``v = [x (nx); u (nu)]``, so the Gauss-Newton KKT matrix keeps
the *same* uniform block-tridiagonal structure as estimation (blocks of
``d`` nodes, ``bd = d*(nx+nu)``), and the whole solve — augmented-Lagrangian
defect/boundary constraints, log-barrier path constraints, cyclic-reduction
factorization — runs as one jitted on-device loop
(:mod:`collocfem_tpu.solve.auglag`).  No callback boundary exists at all.

Residual/constraint groups:
  * collocation defects (equality, handled by augmented Lagrangian),
    scaled by sqrt(w_k h_e / 2) for mesh-independent conditioning;
  * boundary conditions x(t0) / x(tf) (equality, masked per component);
  * running + terminal cost in least-squares form (Model.running_cost_residual);
  * path constraints g(x, u, p, t) <= 0 at every global node (log barrier,
    whose Gauss-Newton Hessian is per-node PSD and lands in the block
    diagonal);
  * equality path constraints g_eq(x, u, p, t) = 0 at every global node
    (augmented Lagrangian, same per-node block-diagonal structure).
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
from collocfem_tpu.problem import Decision


class Multipliers(NamedTuple):
    """Augmented-Lagrangian multipliers for the equality constraint groups."""

    defect: jnp.ndarray   # (N, d+1, nx) — defects at ALL nodes (see
                          # ops.residual.defect_residual_all)
    b0: jnp.ndarray       # (nx,)
    bf: jnp.ndarray       # (nx,)
    path_eq: jnp.ndarray  # (M, ne) — equality path constraints per node


def _mask_from_value(val, nx):
    """np.nan entries mean 'free'; finite entries are fixed boundary values."""
    if val is None:
        return np.zeros(nx), np.zeros(nx)
    v = np.broadcast_to(np.asarray(val, dtype=np.float64), (nx,))
    mask = np.isfinite(v).astype(np.float64)
    return np.where(np.isfinite(v), v, 0.0), mask


@dataclasses.dataclass(frozen=True, eq=False)
class OptimalControlProblem:
    """Direct LGL collocation OCP with node variables v = [x; u].

    Static tables only; build once per (model, mesh, boundary conditions).
    """

    model: Model
    mesh: Mesh
    diff: jnp.ndarray        # (d+1, d+1)
    widths: jnp.ndarray      # (N,)
    elem_times: jnp.ndarray  # (N, d+1)
    cscale: jnp.ndarray      # (N, d+1, nx) sqrt(w_k h/2) defect-constraint scale
    qscale: jnp.ndarray      # (N, d+1) sqrt(w_k h/2) cost-quadrature scale
    node_times: jnp.ndarray  # (M,)
    node_idx: np.ndarray     # (N, d+1) static host ints
    x0_val: jnp.ndarray      # (nx,)
    x0_mask: jnp.ndarray     # (nx,) 1 = fixed component
    xf_val: jnp.ndarray      # (nx,)
    xf_mask: jnp.ndarray     # (nx,)
    dtype: jnp.dtype

    @staticmethod
    def build(
        model: Model, mesh: Mesh, x0=None, xf=None, dtype=None
    ) -> "OptimalControlProblem":
        """Precompute static tables.  ``x0``/``xf`` entries of np.nan are free."""
        dtype = dtype or (
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        )
        nx = model.nx
        w = mesh.basis.weights            # (d+1,)
        h = mesh.widths                   # (N,)
        cscale = np.sqrt(w[None, :, None] * h[:, None, None] * 0.5)
        cscale = np.broadcast_to(
            cscale, (mesh.num_elements, mesh.degree + 1, nx)
        )
        qscale = np.sqrt(w[None, :] * h[:, None] * 0.5)
        x0v, x0m = _mask_from_value(x0, nx)
        xfv, xfm = _mask_from_value(xf, nx)
        # Host-side (numpy) tables: see EstimationProblem.build — device-
        # resident closure constants cost a d2h fetch per array at lowering.
        return OptimalControlProblem(
            model=model,
            mesh=mesh,
            diff=np.asarray(mesh.basis.diff, dtype),
            widths=np.asarray(h, dtype),
            elem_times=np.asarray(mesh.elem_times, dtype),
            cscale=np.asarray(cscale, dtype),
            qscale=np.asarray(qscale, dtype),
            node_times=np.asarray(mesh.node_times, dtype),
            node_idx=mesh.elem_node_idx,
            x0_val=np.asarray(x0v, dtype),
            x0_mask=np.asarray(x0m, dtype),
            xf_val=np.asarray(xfv, dtype),
            xf_mask=np.asarray(xfm, dtype),
            dtype=dtype,
        )

    # -- sizes ----------------------------------------------------------------
    @property
    def nv(self) -> int:
        return self.model.nx + self.model.nu

    @property
    def num_nodes(self) -> int:
        return self.mesh.num_nodes

    def split(self, V: jnp.ndarray):
        """(…, nv) node variables -> states (…, nx), controls (…, nu)."""
        nx = self.model.nx
        return V[..., :nx], V[..., nx:]

    # -- per-element pieces (vmapped by the solver) ---------------------------
    def gather_elements(self, V: jnp.ndarray) -> jnp.ndarray:
        return V[self.node_idx].reshape(self.mesh.num_elements, -1)

    def elem_constraints(self, ve_flat, p, width, times, cscale):
        """Scaled defect constraints of one element: (d+1, nx)."""
        d = self.mesh.degree
        ve = ve_flat.reshape(d + 1, self.nv)
        x_nodes, u_nodes = self.split(ve)
        return res_ops.defect_residual_all(
            self.model, self.diff, width, times, x_nodes, u_nodes, p, cscale
        )

    def elem_cost_residual(self, ve_flat, p, times, qscale):
        """Scaled running-cost residuals of one element: (d+1, nl)."""
        d = self.mesh.degree
        ve = ve_flat.reshape(d + 1, self.nv)
        x_nodes, u_nodes = self.split(ve)
        lr = jax.vmap(self.model.running_cost_residual, in_axes=(0, 0, None, 0))(
            x_nodes, u_nodes, p, times
        )
        return lr * qscale[:, None]

    # -- whole-trajectory quantities ------------------------------------------
    def constraints(self, z: Decision) -> Multipliers:
        """All equality constraint values (same pytree shape as multipliers)."""
        ve = self.gather_elements(z.V)
        c_def = jax.vmap(self.elem_constraints, in_axes=(0, None, 0, 0, 0))(
            ve, z.p, self.widths, self.elem_times, self.cscale
        )
        x, _ = self.split(z.V)
        c0 = self.x0_mask * (x[0] - self.x0_val)
        cf = self.xf_mask * (x[-1] - self.xf_val)
        return Multipliers(
            defect=c_def, b0=c0, bf=cf, path_eq=self.eq_path_constraints(z)
        )

    def path_constraints(self, z: Decision) -> jnp.ndarray:
        """g(x, u, p, t) at every global node: (M, ng)."""
        x, u = self.split(z.V)
        return jax.vmap(self.model.g, in_axes=(0, 0, None, 0))(
            x, u, z.p, self.node_times
        )

    def eq_path_constraints(self, z: Decision) -> jnp.ndarray:
        """g_eq(x, u, p, t) at every global node: (M, ne)."""
        x, u = self.split(z.V)
        return jax.vmap(self.model.g_eq, in_axes=(0, 0, None, 0))(
            x, u, z.p, self.node_times
        )

    def objective(self, z: Decision) -> jnp.ndarray:
        """Quadrature running cost + terminal cost (no constraint terms)."""
        ve = self.gather_elements(z.V)
        lr = jax.vmap(self.elem_cost_residual, in_axes=(0, None, 0, 0))(
            ve, z.p, self.elem_times, self.qscale
        )
        x, _ = self.split(z.V)
        tr = self.model.terminal_cost_residual(x[-1], z.p)
        return 0.5 * (jnp.sum(lr * lr) + jnp.sum(tr * tr))

    def zero_multipliers(self) -> Multipliers:
        n, d, nx = self.mesh.num_elements, self.mesh.degree, self.model.nx
        return Multipliers(
            defect=jnp.zeros((n, d + 1, nx), self.dtype),
            b0=jnp.zeros((nx,), self.dtype),
            bf=jnp.zeros((nx,), self.dtype),
            path_eq=jnp.zeros((self.num_nodes, self.model.ne), self.dtype),
        )

    def initial_guess(self, u0=0.0, p0=None) -> Decision:
        """Linear state interpolation between (masked) boundary values."""
        m = self.mesh
        nx, nu = self.model.nx, self.model.nu
        tt = np.asarray(m.node_times)
        s = (tt - m.t0) / (m.tf - m.t0)
        xa = np.asarray(self.x0_val) * np.asarray(self.x0_mask)
        xb = np.asarray(self.xf_val) * np.asarray(self.xf_mask)
        X = xa[None, :] + s[:, None] * (xb - xa)[None, :]
        U = np.broadcast_to(
            np.asarray(u0, dtype=np.float64), (m.num_nodes, nu)
        ).copy() if nu else np.zeros((m.num_nodes, 0))
        V = np.concatenate([X, U], axis=1)
        p = np.zeros(self.model.nq) if p0 is None else np.asarray(p0)
        return Decision(V=jnp.asarray(V, self.dtype), p=jnp.asarray(p, self.dtype))
