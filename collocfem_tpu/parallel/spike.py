"""Element-chain (time-mesh) sharded block-tridiagonal solve: SPIKE /
substructuring over the "sp" mesh axis.

The CP/ring-attention analogue for this workload (SURVEY.md §2c, §5): the
collocation element chain is partitioned into contiguous shards; each device
eliminates its interior blocks with a local pivot-free block-Cholesky solve,
the shards' boundary blocks form a small SPD block-tridiagonal *interface
system* (2 blocks per shard) that is all-gathered across devices and solved
redundantly on every device, and the interiors are recovered by local
back-substitution.  Communication per solve: one all-gather of
(2, b, b)-sized interface blocks — O(P b^2), independent of mesh size K.

All Schur complements of an SPD matrix are SPD, so no pivoting is needed
anywhere (same argument as SURVEY.md §7 hard part 1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from collocfem_tpu.ops.einsum_hp import einsum_hp
from jax.sharding import PartitionSpec as P

from collocfem_tpu.parallel.meshes import SP_AXIS
from collocfem_tpu.solve.blocktri import blocktri_solve_scan


def _bmm(a, b):
    return einsum_hp("...ij,...jk->...ik", a, b, preferred_element_type=a.dtype)


def _bmtm(a, b):
    return einsum_hp("...ji,...jk->...ik", a, b, preferred_element_type=a.dtype)


def blocktri_solve_spike(
    D, E, G, *, axis_name: str = SP_AXIS, local_solver=blocktri_solve_scan
):
    """Distributed SPD block-tridiagonal solve; call INSIDE shard_map.

    Args:
      D: (m, b, b) local diagonal blocks (this shard's contiguous slice of
         the global K-block chain; m = K / P, m >= 2).
      E: (m, b, b) local superdiagonal; E[j] couples local block j to j+1,
         and E[m-1] couples this shard's last block to the NEXT shard's
         first block (zero on the last shard).
      G: (m, b, r) local right-hand sides.
      axis_name: mesh axis the chain is sharded over.
    Returns:
      (m, b, r) local slice of the global solution.
    """
    m, b, _ = D.shape
    r = G.shape[-1]
    if m < 2:
        raise ValueError("SPIKE needs >= 2 blocks per shard")

    if m == 2:
        s_ll, s_rr, s_lr = D[0], D[1], E[0]
        gh_l, gh_r = G[0], G[1]
        w_g = w_u = w_v = None
    else:
        # Interior system: local blocks 1..m-2.
        d_int, e_int = D[1:-1], E[1:-1]
        # RHS columns: interior part of g, plus the two boundary couplings.
        u_cols = jnp.zeros((m - 2, b, b), D.dtype).at[0].set(
            jnp.swapaxes(E[0], -1, -2)
        )
        v_cols = jnp.zeros((m - 2, b, b), D.dtype).at[-1].set(E[m - 2])
        rhs = jnp.concatenate([G[1:-1], u_cols, v_cols], axis=-1)
        w = local_solver(d_int, e_int, rhs)
        w_g, w_u, w_v = w[..., :r], w[..., r : r + b], w[..., r + b :]
        # Boundary Schur blocks: S = A_bb - A_bI A_II^{-1} A_Ib.
        s_ll = D[0] - _bmm(E[0], w_u[0])
        s_lr = -_bmm(E[0], w_v[0])
        s_rr = D[m - 1] - _bmtm(E[m - 2], w_v[-1])
        gh_l = G[0] - _bmm(E[0], w_g[0])
        gh_r = G[m - 1] - _bmtm(E[m - 2], w_g[-1])

    # Interface system: 2 blocks per shard, chained by E[m-1] across shards.
    d_red = jnp.stack([s_ll, s_rr])                      # (2, b, b)
    e_red = jnp.stack([s_lr, E[m - 1]])                  # (2, b, b)
    g_red = jnp.stack([gh_l, gh_r])                      # (2, b, r)

    # One all-gather; every shard solves the small system redundantly
    # (2P blocks) — cheaper than a distributed solve at these sizes.
    d_all = jax.lax.all_gather(d_red, axis_name).reshape(-1, b, b)
    e_all = jax.lax.all_gather(e_red, axis_name).reshape(-1, b, b)
    g_all = jax.lax.all_gather(g_red, axis_name).reshape(-1, b, r)
    x_all = blocktri_solve_scan(d_all, e_all, g_all)

    s = jax.lax.axis_index(axis_name)
    x_l = jax.lax.dynamic_slice_in_dim(x_all, 2 * s, 1, axis=0)[0]
    x_r = jax.lax.dynamic_slice_in_dim(x_all, 2 * s + 1, 1, axis=0)[0]

    if m == 2:
        return jnp.stack([x_l, x_r])

    # Local back-substitution: x_I = W_g - W_U x_l - W_V x_r.
    x_int = w_g - _bmm(w_u, x_l) - _bmm(w_v, x_r)
    return jnp.concatenate([x_l[None], x_int, x_r[None]])


def spike_chain_solver(num_blocks: int, sp_size: int, *, axis_name: str = SP_AXIS):
    """Per-chain solver for use INSIDE a shard_map that carries ``axis_name``.

    Takes *global* (K, b, b)/(K, b, r) arrays replicated over the "sp" axis
    (e.g. assembled redundantly per shard), has each sp-rank eliminate its
    contiguous chunk via SPIKE, and all-gathers the solution so every rank
    returns the full (K, b, r) result.  Composes with the "dp" experiment
    axis: pass as ``chain_solver`` to the multi-experiment solver
    (collocfem_tpu.parallel.batch), which vmaps it over experiments.

    ``num_blocks`` must be divisible by ``sp_size`` with >= 2 blocks/shard.
    """
    if num_blocks % sp_size:
        raise ValueError(f"K={num_blocks} not divisible by sp={sp_size}")
    m = num_blocks // sp_size
    if m < 2:
        raise ValueError("need >= 2 blocks per sp shard")

    def solve(D, E, G):
        j = jax.lax.axis_index(axis_name)
        Dl = jax.lax.dynamic_slice_in_dim(D, j * m, m, axis=0)
        El = jax.lax.dynamic_slice_in_dim(E, j * m, m, axis=0)
        Gl = jax.lax.dynamic_slice_in_dim(G, j * m, m, axis=0)
        Xl = blocktri_solve_spike(Dl, El, Gl, axis_name=axis_name)
        # Disjoint-scatter + psum instead of all_gather: identical bits and
        # communication volume, but the result is typed INVARIANT over the
        # sp axis (all_gather outputs are vma-varying and would poison the
        # LM while_loop carries under check_vma=True — see lm_core.replicate).
        full = jax.lax.dynamic_update_slice_in_dim(
            jnp.zeros(G.shape, G.dtype), Xl, j * m, axis=0
        )
        return jax.lax.psum(full, axis_name)

    return solve


def spike_sharded_solver(mesh, *, axis_name: str = SP_AXIS, in_blocks_axis=0):
    """Build a global-array solver sharding the chain over ``axis_name``.

    Returns ``solve(D, E, G) -> X`` operating on *global* (K, b, b)/(K, b, r)
    arrays; K must be divisible by the axis size (pad with identity blocks
    upstream if needed — see ``collocfem_tpu.ops.assemble``'s padded layout).
    """
    spec = P(axis_name)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
    )
    def solve(D, E, G):
        return blocktri_solve_spike(D, E, G, axis_name=axis_name)

    return solve
