"""Gauss-Newton assembly: per-element jacfwd -> block-tridiagonal + arrowhead.

Capability parity target: the reference's Jacobian/Hessian assembly into a
global sparse matrix (SURVEY.md §2a "Jacobian/Hessian assembly"; BASELINE.json
north_star: "jacfwd with exploited block-banded sparsity, materialized
directly into a block-tridiagonal/arrowhead KKT structure").

Block layout (see collocfem_tpu.ops.mesh): nodes are padded to K*d (K=N+1
blocks of d nodes); element e touches block e plus the first node of block
e+1, so the state Hessian is block tridiagonal with uniform (d*nv, d*nv)
blocks — static shapes, no COO/CSC triplets, no host round-trips.  The
parameter "arrowhead" is kept as a separate (K, bd, nq) strip + (nq, nq)
corner and eliminated by a Schur complement in the solver.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from collocfem_tpu.ops.einsum_hp import einsum_hp


class BlockTriSystem(NamedTuple):
    """Damped GN normal equations  [[A, B], [B^T, C]] [dx, dp] = -[gx, gp].

    A is block tridiagonal: diagonal blocks ``D`` (K, bd, bd) and
    super-diagonal coupling ``E`` (K, bd, bd) with A[k, k+1] = E[k]
    (E[K-1] = 0).  ``B`` (K, bd, nq) is the parameter strip, ``C`` (nq, nq)
    the parameter corner; ``gx`` (K, bd), ``gp`` (nq,) the gradient.
    """

    D: jnp.ndarray
    E: jnp.ndarray
    B: jnp.ndarray
    C: jnp.ndarray
    gx: jnp.ndarray
    gp: jnp.ndarray

    @property
    def num_blocks(self) -> int:
        return self.D.shape[0]

    @property
    def block_size(self) -> int:
        return self.D.shape[1]


def scatter_gn_blocks(hxx, hxp, hpp, gxe, gpe, *, num_blocks, nv, overlap, dtype):
    """Scatter per-element dense GN blocks into the block-tri + arrowhead form.

    Element ``e`` owns block ``e`` (its first ``bd = s - overlap`` local
    variables) and the leading ``overlap`` variables of block ``e+1`` (the
    shared boundary node).  Shared machinery for estimation *and* optimal
    control assembly.

    Args:
      hxx: (N, s, s) per-element J^T J with s = bd + overlap.
      hxp: (N, s, nq) element-parameter coupling.
      hpp: (nq, nq) parameter block (already summed).
      gxe: (N, s) per-element gradient.
      gpe: (nq,) parameter gradient (already summed).
      num_blocks: K = N + 1.
      nv: variables per node.
      overlap: number of trailing element variables shared with block e+1
        (= nv for C^0 node sharing).
    Returns:
      BlockTriSystem with zero C-corner priors (caller adds priors/damping).
    """
    n, s, _ = hxx.shape
    k = num_blocks
    bd = s - overlap
    nq = hxp.shape[-1]
    idx = jnp.arange(n)

    D = jnp.zeros((k, bd, bd), dtype)
    D = D.at[idx].add(hxx[:, :bd, :bd])
    D = D.at[idx + 1, :overlap, :overlap].add(hxx[:, bd:, bd:])
    E = jnp.zeros((k, bd, bd), dtype)
    E = E.at[idx, :, :overlap].add(hxx[:, :bd, bd:])
    B = jnp.zeros((k, bd, nq), dtype)
    B = B.at[idx].add(hxp[:, :bd, :])
    B = B.at[idx + 1, :overlap, :].add(hxp[:, bd:, :])
    gx = jnp.zeros((k, bd), dtype)
    gx = gx.at[idx].add(gxe[:, :bd])
    gx = gx.at[idx + 1, :overlap].add(gxe[:, bd:])

    # Identity on the trailing pad entries of the last block so the padded
    # system stays SPD; their solution/gradient is exactly 0.
    pad = jnp.arange(overlap, bd)
    D = D.at[k - 1, pad, pad].add(1.0)
    return BlockTriSystem(D=D, E=E, B=B, C=hpp, gx=gx, gp=gpe)


def _cost_dw_from_residuals(r, z, data, nx):
    """Double-word 0.5*||r_full||^2 from the element residuals ``r`` already
    evaluated by the assembly, plus the prior residual terms.

    Matches ``EstimationProblem.cost_dw`` exactly (same residual vector,
    same DW accumulation); evaluating it here lets the LM loop skip the
    separate full residual pass per iteration (~30% of the N=10k iteration
    wall was the standalone cost evaluation).
    """
    from collocfem_tpu.ops import doubleword as dw

    rf = r.ravel()
    s = dw.pairwise_sum(dw.DW(*dw.two_prod(rf, rf)))
    dx0 = z.V[0, :nx] - data.x0_prior
    r_x0 = data.x0_w @ dx0 if data.x0_w.ndim == 2 else data.x0_w * dx0
    extra = jnp.concatenate([data.p_w * (z.p - data.p_prior), r_x0])
    s = dw.add(s, dw.pairwise_sum(dw.DW(*dw.two_prod(extra, extra))))
    return dw.mul_single(s, 0.5)


def assemble_gn(problem, z, data, with_cost: bool = False):
    """Assemble the Gauss-Newton system at iterate ``z``.

    Per element: residual r_e and Jacobians (J_x (m, (d+1)nv), J_p (m, nq))
    via vmapped jacfwd; dense normal-equation blocks J^T J / J^T r are formed
    as batched contractions and scattered with static index maps.  With
    ``with_cost``, also returns the double-word cost at ``z`` (reusing the
    residuals).
    """
    mesh, model = problem.mesh, problem.model
    n, d, nv, nq = mesh.num_elements, mesh.degree, problem.nv, model.nq
    k, bd, s = n + 1, d * nv, (d + 1) * nv
    nx = model.nx

    xe = problem.gather_elements(z.V)  # (N, s)
    ed = problem._elem_data(data)

    def per_elem(xe_flat, edata):
        r = problem.elem_residual(xe_flat, z.p, edata)
        jx, jp = jax.jacfwd(problem.elem_residual, argnums=(0, 1))(
            xe_flat, z.p, edata
        )
        return r, jx, jp

    r, jx, jp = jax.vmap(per_elem, in_axes=(0, 0))(xe, ed)
    # Dense per-element normal-equation blocks.
    hxx = einsum_hp("emi,emj->eij", jx, jx)          # (N, s, s)
    hxp = einsum_hp("emi,emq->eiq", jx, jp)          # (N, s, nq)
    hpp = einsum_hp("emq,emr->qr", jp, jp)           # (nq, nq)
    gxe = einsum_hp("emi,em->ei", jx, r)             # (N, s)
    gpe = einsum_hp("emq,em->q", jp, r)              # (nq,)

    dtype = z.V.dtype
    sys = scatter_gn_blocks(
        hxx, hxp, hpp, gxe, gpe, num_blocks=k, nv=nv, overlap=nv, dtype=dtype
    )
    out = _add_priors_block(sys, z, data, nx)
    if with_cost:
        return out, _cost_dw_from_residuals(r, z, data, nx)
    return out


def _add_priors_block(sys: BlockTriSystem, z, data, nx) -> BlockTriSystem:
    """Parameter prior -> corner; x0 prior -> first nx of block 0.

    Priors are exactly quadratic, so their Gauss-Newton and exact-Newton
    contributions coincide (shared by assemble_gn / assemble_newton).
    """
    pw2 = data.p_w**2
    C = sys.C + jnp.diag(pw2)
    gp = sys.gp + pw2 * (z.p - data.p_prior)
    dx0 = z.V[0, :nx] - data.x0_prior
    if data.x0_w.ndim == 2:  # full sqrt-information prior: Λ = LᵀL
        lam_x0 = data.x0_w.T @ data.x0_w
        D = sys.D.at[0, :nx, :nx].add(lam_x0)
        gx = sys.gx.at[0, :nx].add(lam_x0 @ dx0)
    else:
        x0w2 = data.x0_w**2
        D = sys.D.at[0, jnp.arange(nx), jnp.arange(nx)].add(x0w2)
        gx = sys.gx.at[0, :nx].add(x0w2 * dx0)
    return BlockTriSystem(D=D, E=sys.E, B=sys.B, C=C, gx=gx, gp=gp)


def assemble_newton(problem, z, data):
    """Assemble the EXACT Newton system at iterate ``z``.

    The reference's solver family is "Newton / Gauss-Newton / IRLS"
    (SURVEY.md §2a; BASELINE.json north_star: "hand/AD Jacobian and
    **Hessian** assembly ... full Newton estimation").  The Gauss-Newton
    system drops the curvature term Σᵢ rᵢ ∇²rᵢ; this assembly keeps it:
    per element, the full Hessian of 0.5‖r_e‖² over (local nodes, params)
    is taken with forward-over-reverse AD and scattered into the SAME
    block-tridiagonal + arrowhead structure — element residuals only touch
    element-local variables, so second derivatives add no new sparsity.

    The exact Hessian can be indefinite far from a minimum; the LM loop's
    damping/rejection logic (solve.newton) handles that — a failed
    (non-SPD) factorization yields a non-finite trial cost, the step is
    rejected and λ inflates until H + λ·dmax·I is SPD.
    """
    mesh = problem.mesh
    n, d, nv = mesh.num_elements, mesh.degree, problem.nv
    k = n + 1
    nx = problem.model.nx

    xe = problem.gather_elements(z.V)
    ed = problem._elem_data(data)

    def cost_e(xe_flat, p, edata):
        r = problem.elem_residual(xe_flat, p, edata)
        return 0.5 * jnp.sum(r * r)

    grad_e = jax.grad(cost_e, argnums=(0, 1))

    def per_elem(xe_flat, edata):
        gx_e, gp_e = grad_e(xe_flat, z.p, edata)
        (hxx, hxp), (_, hpp) = jax.jacfwd(grad_e, argnums=(0, 1))(
            xe_flat, z.p, edata
        )
        return gx_e, gp_e, hxx, hxp, hpp

    gxe, gpe, hxx, hxp, hpp = jax.vmap(per_elem, in_axes=(0, 0))(xe, ed)
    sys = scatter_gn_blocks(
        hxx, hxp, jnp.sum(hpp, axis=0), gxe, jnp.sum(gpe, axis=0),
        num_blocks=k, nv=nv, overlap=nv, dtype=z.V.dtype,
    )
    return _add_priors_block(sys, z, data, nx)


def soa_from_blocks(sys: BlockTriSystem) -> BlockTriSystemSoA:
    """Block-major -> SoA layout (chain index to the minor axis)."""
    return BlockTriSystemSoA(
        D=jnp.moveaxis(sys.D, 0, -1),
        E=jnp.moveaxis(sys.E, 0, -1),
        B=jnp.moveaxis(sys.B, 0, -1),
        C=sys.C,
        gx=jnp.moveaxis(sys.gx, 0, -1),
        gp=sys.gp,
    )


def scatter_gn_blocks_soa(hxx, hxp, hpp, gxe, gpe, *, num_blocks, nv,
                          overlap, dtype):
    """SoA twin of :func:`scatter_gn_blocks` — element-LAST inputs.

    Args: hxx (s, s, N), hxp (s, nq, N), gxe (s, N) with the element axis
    minor; hpp/gpe as in the block-major version.  Built in
    2D (rows, K) form (chain minor) and bitcast to 3D — the same
    layout discipline as assemble_gn_soa, so no block-major intermediates
    exist anywhere (OCP hot loops previously paid a soa_from_blocks
    conversion per inner LM iteration).
    """
    s, _, n = hxx.shape
    k = num_blocks
    bd = s - overlap
    nq = hxp.shape[1]
    pad_cols = [(0, 0), (0, bd - overlap), (0, 0)]

    D2 = jnp.zeros((bd * bd, k), dtype)
    D2 = D2.at[:, :n].add(hxx[:bd, :bd].reshape(bd * bd, n))
    D2 = D2.at[:overlap * bd, 1:n + 1].add(
        jnp.pad(hxx[bd:, bd:], pad_cols).reshape(overlap * bd, n)
    )
    E2 = jnp.zeros((bd * bd, k), dtype)
    E2 = E2.at[:, :n].set(
        jnp.pad(hxx[:bd, bd:], pad_cols).reshape(bd * bd, n)
    )
    B2 = jnp.zeros((bd * nq, k), dtype)
    B2 = B2.at[:, :n].add(hxp[:bd].reshape(bd * nq, n))
    B2 = B2.at[:overlap * nq, 1:n + 1].add(
        hxp[bd:].reshape(overlap * nq, n)
    )
    gx = jnp.zeros((bd, k), dtype)
    gx = gx.at[:, :n].add(gxe[:bd])
    gx = gx.at[:overlap, 1:n + 1].add(gxe[bd:])
    # SPD identity on the trailing pad entries of the last block.
    import numpy as _np

    pad_rows = _np.arange(overlap, bd) * (bd + 1)
    D2 = D2.at[pad_rows, k - 1].add(1.0)
    return BlockTriSystemSoA(
        D=D2.reshape(bd, bd, k), E=E2.reshape(bd, bd, k),
        B=B2.reshape(bd, nq, k), C=hpp, gx=gx, gp=gpe,
    )


def node_block_scatter_soa(sys, Hn, Bn, gn, degree):
    """Add per-node terms into the SoA block structure, node-LAST inputs.

    Hn (nv, nv, M), Bn (nv, nq, M), gn (nv, M); node m lives in block
    m // d at node-offset m % d, so nodes of a fixed offset land on
    CONSECUTIVE chain slots — d static strided slices, no dynamic scatter
    (the same discipline as solve.bounds' barrier adds).
    """
    bd, _, k = sys.D.shape
    nq = sys.C.shape[0]
    nv = gn.shape[0]
    d = degree
    m = gn.shape[-1]
    D = sys.D.reshape(d, nv, d, nv, k)
    B = sys.B.reshape(d, nv, nq, k)
    gx = sys.gx.reshape(d, nv, k)
    for off in range(d):
        w = len(range(off, m, d))
        D = D.at[off, :, off, :, :w].add(Hn[:, :, off::d])
        if nq:
            B = B.at[off, :, :, :w].add(Bn[:, :, off::d])
        gx = gx.at[off, :, :w].add(gn[:, off::d])
    return sys._replace(
        D=D.reshape(bd, bd, k), B=B.reshape(bd, nq, k),
        gx=gx.reshape(bd, k),
    )


def assemble_newton_soa(problem, z, data) -> "BlockTriSystemSoA":
    """SoA twin of :func:`assemble_newton`.

    Unlike assemble_gn_soa (which orders its einsum outputs to avoid any
    layout shuffle), the Hessian blocks come out of forward-over-reverse AD
    element-major, so this pays one transpose per field — acceptable for
    the exact-Newton mode, which trades per-iteration cost for quadratic
    local convergence.
    """
    return soa_from_blocks(assemble_newton(problem, z, data))


class BlockTriSystemSoA(NamedTuple):
    """The same damped-GN system in structure-of-arrays layout.

    The chain index K is the LAST (minor) axis of every field, so the
    assembly scatters become static slices and no transposes exist
    anywhere in the hot path.

      D (bd, bd, K), E (bd, bd, K), B (bd, nq, K), gx (bd, K),
      C (nq, nq), gp (nq,).
    """

    D: jnp.ndarray
    E: jnp.ndarray
    B: jnp.ndarray
    C: jnp.ndarray
    gx: jnp.ndarray
    gp: jnp.ndarray

    @property
    def num_blocks(self) -> int:
        return self.D.shape[-1]

    @property
    def block_size(self) -> int:
        return self.D.shape[0]


def assemble_gn_soa(problem, z, data, with_cost: bool = False, v_lo=None):
    """SoA twin of :func:`assemble_gn` — the hot-path assembly.

    Per-element jacfwd as in assemble_gn, but the normal-equation einsums
    emit the element axis LAST and the block-chain scatter is two static
    lane-slices (elements e -> chain slots e and e+1).  With ``with_cost``,
    also returns the double-word cost at ``z`` (reusing the residuals).
    """
    mesh, model = problem.mesh, problem.model
    n, d, nv, nq = mesh.num_elements, mesh.degree, problem.nv, model.nq
    k, bd = n + 1, d * nv
    nx = model.nx

    xe = problem.gather_elements(z.V)
    ed = problem._elem_data(data)

    if v_lo is None:
        def per_elem(xe_flat, edata):
            r = problem.elem_residual(xe_flat, z.p, edata)
            jx, jp = jax.jacfwd(problem.elem_residual, argnums=(0, 1))(
                xe_flat, z.p, edata
            )
            return r, jx, jp

        r, jx, jp = jax.vmap(per_elem, in_axes=(0, 0))(xe, ed)
    else:
        # Double-word state tier: residuals at the (hi, lo) state pair
        # (problem.elem_residual_dw) — breaks the (2/h)-amplified f32
        # state-storage floor on very fine meshes; the Jacobian stays at
        # the hi word (all Gauss-Newton needs).
        xe_lo = problem.gather_elements(v_lo)

        def per_elem_dw(xe_flat, edata, xe_lo_flat):
            r = problem.elem_residual_dw(xe_flat, z.p, edata, xe_lo_flat)
            jx, jp = jax.jacfwd(
                problem.elem_residual_dw, argnums=(0, 1)
            )(xe_flat, z.p, edata, xe_lo_flat)
            return r, jx, jp

        r, jx, jp = jax.vmap(per_elem_dw, in_axes=(0, 0, 0))(xe, ed, xe_lo)

    # 2D-first construction: every chain array is built as (rows, K) —
    # whose default layout keeps the chain minor — and bitcast-reshaped to
    # the 3D SoA shape at the end.  Building in 3D (bd, bd, K) lets XLA
    # propagate the contraction emitters' block-major {0,1,2} layout into
    # the whole scatter chain.  The per-piece contractions below also skip
    # the never-used hxx[bd:, :bd] cross block.
    jx1, jx2 = jx[:, :, :bd], jx[:, :, bd:]
    h11 = einsum_hp("emi,emj->ije", jx1, jx1).reshape(bd * bd, n)
    h22 = einsum_hp("emi,emj->ije", jx2, jx2)        # (nv, nv, N)
    h12 = einsum_hp("emi,emj->ije", jx1, jx2)        # (bd, nv, N)
    b1 = einsum_hp("emi,emq->iqe", jx1, jp).reshape(bd * nq, n)
    b2 = einsum_hp("emi,emq->iqe", jx2, jp).reshape(nv * nq, n)
    g1 = einsum_hp("emi,em->ie", jx1, r)             # (bd, N)
    g2 = einsum_hp("emi,em->ie", jx2, r)             # (nv, N)
    if v_lo is not None and nq:
        # The nq-sized global reductions (parameter Hessian corner and
        # gradient) sum ~N*m float32 terms; their sqrt(n)*eps summation
        # noise (~5e-5 relative at N=1e5) is the SAME size as the
        # arrowhead Schur complement they later cancel against, turning
        # parameter steps into noise — measured as the p-err ~4.9e-4
        # plateau the DW state tier alone could not break at N=100k.
        # Double-word accumulation brings them to ~eps relative (matching
        # DW Schur contractions live in solve.kkt's dw tier).
        from collocfem_tpu.ops import doubleword as dwm

        jpf = jp.reshape(-1, nq)
        rf = r.ravel()
        hpp = jnp.stack([
            jnp.stack([
                dwm.to_single(dwm.dot(jpf[:, q], jpf[:, q2]))
                for q2 in range(nq)
            ]) for q in range(nq)
        ])
        gpe = jnp.stack([
            dwm.to_single(dwm.dot(jpf[:, q], rf)) for q in range(nq)
        ])
    else:
        hpp = einsum_hp("emq,emr->qr", jp, jp)       # (nq, nq)
        gpe = einsum_hp("emq,em->q", jp, r)          # (nq,)

    dtype = z.V.dtype
    pad_cols = [(0, 0), (0, bd - nv), (0, 0)]
    D2 = jnp.zeros((bd * bd, k), dtype)
    D2 = D2.at[:, :n].add(h11)
    # Block e+1 top-left (nv, nv) overlap: rows i*bd+j for i, j < nv are
    # the leading nv*bd rows once the column space is padded nv -> bd.
    D2 = D2.at[:nv * bd, 1:n + 1].add(
        jnp.pad(h22, pad_cols).reshape(nv * bd, n)
    )
    E2 = jnp.zeros((bd * bd, k), dtype)
    E2 = E2.at[:, :n].set(
        jnp.pad(h12, pad_cols).reshape(bd * bd, n)
    )
    B2 = jnp.zeros((bd * nq, k), dtype)
    B2 = B2.at[:, :n].add(b1)
    B2 = B2.at[:nv * nq, 1:n + 1].add(b2)
    gx = jnp.zeros((bd, k), dtype)
    gx = gx.at[:, :n].add(g1)
    gx = gx.at[:nv, 1:n + 1].add(g2)

    pw2 = data.p_w**2
    C = hpp + jnp.diag(pw2)
    gp = gpe + pw2 * (z.p - data.p_prior)
    dx0 = z.V[0, :nx] - data.x0_prior
    # Diagonal additions (SPD identity on the trailing pad entries of the
    # last block + x0-prior weights on block 0) as ONE static-index row
    # scatter on the 2D layout.
    diag_add = jnp.zeros((bd, k), dtype)
    diag_add = diag_add.at[nv:, k - 1].set(1.0)
    if data.x0_w.ndim == 2:  # full sqrt-information prior: Λ = LᵀL
        lam_x0 = data.x0_w.T @ data.x0_w
        for i in range(nx):
            D2 = D2.at[i * bd:i * bd + nx, 0:1].add(lam_x0[i][:, None])
        gx = gx.at[:nx, 0].add(lam_x0 @ dx0)
    else:
        diag_add = diag_add.at[:nx, 0].add(data.x0_w**2)
        gx = gx.at[:nx, 0].add(data.x0_w**2 * dx0)
    diag_rows = jnp.arange(bd) * (bd + 1)
    D2 = D2.at[diag_rows, :].add(diag_add)

    out = BlockTriSystemSoA(
        D=D2.reshape(bd, bd, k), E=E2.reshape(bd, bd, k),
        B=B2.reshape(bd, nq, k), C=C, gx=gx, gp=gp,
    )
    if with_cost:
        return out, _cost_dw_from_residuals(r, z, data, nx)
    return out


def blocks_to_nodes_soa(dx: jnp.ndarray, num_nodes: int, nv: int) -> jnp.ndarray:
    """(bd, K) SoA solution -> (M, nv) node values."""
    bd, k = dx.shape
    return dx.T.reshape(k * (bd // nv), nv)[:num_nodes]


def assemble_gn_soa_batched(problem, Vb, p, data_batch, with_cost: bool = False):
    """Batched-experiment SoA assembly: ONE concatenated chain for the whole
    batch (BASELINE.json config 5's hot path).

    The per-experiment block-tridiagonal systems are laid side by side on
    the lane axis, experiment-major: chain slot ``x*K + k`` holds experiment
    x's block k, and the coupling block at each experiment's last slot is
    left ZERO, so the concatenated matrix is exactly block-diagonal over
    experiments — a valid block-tridiagonal chain the SoA cyclic reduction
    (solve.blocktri.blocktri_cr_factor_soa) factors as-is.  The parameter strip
    B and corner C accumulate over ALL experiments, so the arrowhead Schur
    complement of the concatenated system IS the shared-parameter Schur sum
    of parallel.batch (SURVEY.md §3.5).

    Versus ``vmap(assemble_gn)`` (block-major (E, K, b, b) and a per-field
    layout shuffle before any SoA solver), every scatter
    here is a static slice on the minor axes of (bd, bd, E, K) intermediates
    and the final reshape to (bd, bd, E*K) is layout-free.

    Args:
      Vb: (E, M, nv) per-experiment node values.
      p: (nq,) SHARED parameters.
      data_batch: ProblemData pytree with a leading experiment axis on every
        leaf.  Per-experiment p priors (data.p_w) are honored (summed into
        C/gp) but the batch solvers pass them as zero and add the shared
        prior once at the Schur level.
      with_cost: also return the double-word LOCAL cost (defects +
        measurements + per-experiment priors; the caller adds the shared
        parameter prior once and psums across "dp" shards).
    Returns:
      BlockTriSystemSoA with chain length E*K (and optionally the DW cost).
    """
    from collocfem_tpu.ops import doubleword as dw

    mesh, model = problem.mesh, problem.model
    n, d, nv, nq = mesh.num_elements, mesh.degree, problem.nv, model.nq
    k, bd, s = n + 1, d * nv, (d + 1) * nv
    nx = model.nx
    n_exp = Vb.shape[0]

    def per_exp(V, data):
        xe = problem.gather_elements(V)
        ed = problem._elem_data(data)

        def per_elem(xe_flat, edata):
            r = problem.elem_residual(xe_flat, p, edata)
            jx, jp = jax.jacfwd(problem.elem_residual, argnums=(0, 1))(
                xe_flat, p, edata
            )
            return r, jx, jp

        return jax.vmap(per_elem, in_axes=(0, 0))(xe, ed)

    r, jx, jp = jax.vmap(per_exp, in_axes=(0, 0))(Vb, data_batch)
    # jx (E, N, m, s), jp (E, N, m, nq), r (E, N, m).  Normal-equation
    # einsums emit (…, E, N) so the chain scatter below is static slices.
    hxx = einsum_hp("xemi,xemj->ijxe", jx, jx)       # (s, s, E, N)
    hxp = einsum_hp("xemi,xemq->iqxe", jx, jp)       # (s, nq, E, N)
    hpp = einsum_hp("xemq,xemr->qr", jp, jp)         # (nq, nq)
    gxe = einsum_hp("xemi,xem->ixe", jx, r)          # (s, E, N)
    gpe = einsum_hp("xemq,xem->q", jp, r)            # (nq,)

    dtype = Vb.dtype
    D = jnp.zeros((bd, bd, n_exp, k), dtype)
    D = D.at[:, :, :, :n].add(hxx[:bd, :bd])
    D = D.at[:nv, :nv, :, 1:].add(hxx[bd:, bd:])
    E = jnp.zeros((bd, bd, n_exp, k), dtype)
    E = E.at[:, :nv, :, :n].add(hxx[:bd, bd:])       # slot k-1 stays 0:
    #                                 experiments decouple at the boundary
    B = jnp.zeros((bd, nq, n_exp, k), dtype)
    B = B.at[:, :, :, :n].add(hxp[:bd])
    B = B.at[:nv, :, :, 1:].add(hxp[bd:])
    gx = jnp.zeros((bd, n_exp, k), dtype)
    gx = gx.at[:, :, :n].add(gxe[:bd])
    gx = gx.at[:nv, :, 1:].add(gxe[bd:])

    # Per-experiment priors + SPD pad rows in one fused diagonal scatter.
    pw2 = data_batch.p_w**2                          # (E, nq)
    C = hpp + jnp.diag(jnp.sum(pw2, axis=0))
    gp = gpe + jnp.sum(pw2 * (p[None, :] - data_batch.p_prior), axis=0)
    dx0 = Vb[:, 0, :nx] - data_batch.x0_prior        # (E, nx)
    diag_add = jnp.zeros((bd, n_exp, k), dtype)
    diag_add = diag_add.at[nv:, :, k - 1].set(1.0)
    if data_batch.x0_w.ndim == 3:                    # full sqrt-info priors
        lam_x0 = einsum_hp("xij,xik->jkx", data_batch.x0_w, data_batch.x0_w)
        D = D.at[:nx, :nx, :, 0].add(lam_x0)
        gx = gx.at[:nx, :, 0].add(
            einsum_hp("ijx,xj->ix", lam_x0, dx0)
        )
        r_x0 = einsum_hp("xij,xj->xi", data_batch.x0_w, dx0)
    else:
        x0w2 = data_batch.x0_w**2                    # (E, nx)
        diag_add = diag_add.at[:nx, :, 0].add(x0w2.T)
        gx = gx.at[:nx, :, 0].add((x0w2 * dx0).T)
        r_x0 = data_batch.x0_w * dx0
    rows = jnp.arange(bd)
    D = D.at[rows, rows, :, :].add(diag_add)

    out = BlockTriSystemSoA(
        D=D.reshape(bd, bd, n_exp * k),
        E=E.reshape(bd, bd, n_exp * k),
        B=B.reshape(bd, nq, n_exp * k),
        C=C,
        gx=gx.reshape(bd, n_exp * k),
        gp=gp,
    )
    if with_cost:
        rf = r.ravel()
        sdw = dw.pairwise_sum(dw.DW(*dw.two_prod(rf, rf)))
        extra = jnp.concatenate(
            [
                (data_batch.p_w * (p[None, :] - data_batch.p_prior)).ravel(),
                r_x0.ravel(),
            ]
        )
        sdw = dw.add(sdw, dw.pairwise_sum(dw.DW(*dw.two_prod(extra, extra))))
        return out, dw.mul_single(sdw, 0.5)
    return out


def materialize_dense(sys: BlockTriSystem) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Expand to a dense (K*bd+nq)^2 matrix + gradient (tests / tiny meshes)."""
    k, bd = sys.num_blocks, sys.block_size
    nq = sys.C.shape[0]
    n = k * bd + nq
    H = jnp.zeros((n, n), sys.D.dtype)
    for i in range(k):
        sl = slice(i * bd, (i + 1) * bd)
        H = H.at[sl, sl].set(sys.D[i])
        if i + 1 < k:
            s2 = slice((i + 1) * bd, (i + 2) * bd)
            H = H.at[sl, s2].set(sys.E[i])
            H = H.at[s2, sl].set(sys.E[i].T)
        H = H.at[sl, k * bd :].set(sys.B[i])
        H = H.at[k * bd :, sl].set(sys.B[i].T)
    H = H.at[k * bd :, k * bd :].set(sys.C)
    g = jnp.concatenate([sys.gx.ravel(), sys.gp])
    return H, g


def blocks_to_nodes(dx_blocks: jnp.ndarray, num_nodes: int, nv: int) -> jnp.ndarray:
    """(K, bd) block-stacked solution -> (M, nv) real node values."""
    k, bd = dx_blocks.shape
    return dx_blocks.reshape(k * (bd // nv), nv)[:num_nodes]
