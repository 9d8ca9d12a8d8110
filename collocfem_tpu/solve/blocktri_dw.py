"""Double-word cyclic reduction: the f64-grade block-tridiagonal solver.

Same fixed-shape / SoA / hybrid-schedule structure as
``solve.blocktri.blocktri_solve_cr`` (python-unrolled top levels -> fixed
shape ``fori_loop`` middle -> sequential Thomas tail), with every scalar
operation in ~48-bit double-word f32 arithmetic (ops.doubleword /
ops.smallblocks_dw).  Purpose (SURVEY.md §7 hard part 4): the equilibrated
collocation chain has cond ~ K^2, which crosses f32's workable range at
K ~ 1e4 elements — single-shot fine-mesh f32 factorizations stall there.
DW cyclic reduction runs entirely on f32 elementwise ops, keeps the chain
on the minor axis, and extends the workable conditioning to
cond * 2^-49 < 1, i.e. K ~ 1e7.

Cost: a DW op is ~10-20 f32 elementwise ops, so expect roughly an order
of magnitude over the plain-f32 sweep; it is only needed when single-shot
fine-mesh accuracy is required in f32 (the f32 + multilevel-warm-start
ladder remains the fast path).  Native float64 is the alternative where
the device runs it at speed.

In/out is plain f32; widening/rounding happens at the boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from collocfem_tpu.ops import doubleword as dw
from collocfem_tpu.ops import smallblocks_dw as sbdw
from collocfem_tpu.ops.doubleword import DW


def _split(A: DW):
    """Even/odd lane split of DW (b, c, K) -> two DW (b, c, K/2)."""
    def s(a):
        half = a.shape[-1] // 2
        a4 = a.reshape(a.shape[0], a.shape[1], half, 2)
        return a4[..., 0], a4[..., 1]
    eh, oh = s(A.hi)
    el, ol = s(A.lo)
    return DW(eh, el), DW(oh, ol)


def _interleave(E: DW, O: DW) -> DW:
    """Inverse of _split: DW (b, c, K/2) x2 -> DW (b, c, K)."""
    def iv(e, o):
        b, c, half = e.shape
        return jnp.stack([e, o], axis=-1).reshape(b, c, 2 * half)
    return DW(iv(E.hi, O.hi), iv(E.lo, O.lo))


def _tail_sub_shift(A: DW, X: DW) -> DW:
    """A with A[..., 1:] -= X[..., :-1] (DW)."""
    head = DW(A.hi[..., :1], A.lo[..., :1])
    r = dw.sub(DW(A.hi[..., 1:], A.lo[..., 1:]),
               DW(X.hi[..., :-1], X.lo[..., :-1]))
    return DW(jnp.concatenate([head.hi, r.hi], axis=-1),
              jnp.concatenate([head.lo, r.lo], axis=-1))


def _slice(A: DW, sl) -> DW:
    return DW(A.hi[..., sl], A.lo[..., sl])


def _concat(As, axis=-1) -> DW:
    return DW(jnp.concatenate([a.hi for a in As], axis=axis),
              jnp.concatenate([a.lo for a in As], axis=axis))


def _zeros_like(A: DW, shape=None) -> DW:
    if shape is None:
        return DW(jnp.zeros_like(A.hi), jnp.zeros_like(A.lo))
    return DW(jnp.zeros(shape, A.hi.dtype), jnp.zeros(shape, A.hi.dtype))


def _cr_level_factor_dw(Ds: DW, Es: DW):
    """G-independent half of one DW CR level (mirrors _cr_level_factor_soa)."""
    d_even, d_odd = _split(Ds)
    e_up, e_lo = _split(Es)
    l_odd = sbdw.chol(d_odd)
    s_up = sbdw.chol_solve(l_odd, sbdw.transpose(e_up))
    s_lo = sbdw.chol_solve(l_odd, e_lo)
    d_new = dw.sub(d_even, sbdw.mm(e_up, s_up))
    d_new = _tail_sub_shift(d_new, sbdw.mtm(e_lo, s_lo))
    e_new = dw.neg(sbdw.mm(e_up, s_lo))
    return (d_new, e_new), (l_odd, e_up, e_lo, s_up, s_lo)


def _cr_level_apply_dw(fac, Gs: DW):
    """RHS half of one DW CR level."""
    l_odd, e_up, e_lo, _, _ = fac
    g_even, g_odd = _split(Gs)
    s_g = sbdw.chol_solve(l_odd, g_odd)
    g_new = dw.sub(g_even, sbdw.mm(e_up, s_g))
    g_new = _tail_sub_shift(g_new, sbdw.mtm(e_lo, s_g))
    return g_new, s_g


def _cr_backsub_dw(x_even: DW, s_up: DW, s_lo: DW, s_g: DW) -> DW:
    """x_odd = s_g - s_up x_even - s_lo x_right; interleave (DW)."""
    zero_col = _zeros_like(_slice(x_even, slice(0, 1)))
    x_right = _concat([_slice(x_even, slice(1, None)), zero_col])
    x_odd = dw.sub(dw.sub(s_g, sbdw.mm(s_up, x_even)),
                   sbdw.mm(s_lo, x_right))
    return _interleave(x_even, x_odd)


def _thomas_dw(D: DW, E: DW, G: DW) -> DW:
    """Sequential DW block-Thomas on a short SoA chain (the CR tail).

    Runs as ``lax.scan``s with DW-pair carries so the traced body is ONE
    block step regardless of tail length — a python-unrolled version of
    even a 16-block tail at b=8 traced ~10^5 primitives and blew up
    compile time.
    """
    k = D.hi.shape[-1]
    at = lambda A, i: DW(A.hi[..., i], A.lo[..., i])
    if k == 1:
        x = sbdw.chol_solve(sbdw.chol(at(D, 0)), at(G, 0))
        return DW(x.hi[..., None], x.lo[..., None])

    # SoA (b, c, K) -> AoS (K, b, c) for the scan's leading axis.
    aos = lambda A: DW(jnp.moveaxis(A.hi, -1, 0), jnp.moveaxis(A.lo, -1, 0))
    dsl = lambda A, sl: DW(A.hi[sl], A.lo[sl])
    Da, Ea, Ga = aos(D), aos(E), aos(G)

    l0 = sbdw.chol(at(D, 0))
    y0 = at(G, 0)

    def fwd(carry, inp):
        l_prev, y_prev = carry
        d_i, e_prev, g_i = inp
        w = sbdw.chol_solve(l_prev, e_prev)          # U_{i-1}^{-1} E_{i-1}
        u_i = dw.sub(d_i, sbdw.mtm(e_prev, w))
        y_i = dw.sub(g_i, sbdw.mtm(w, y_prev))
        l_i = sbdw.chol(u_i)
        return (l_i, y_i), (l_i, y_i)

    (_, _), (ls, ys) = jax.lax.scan(
        fwd, (l0, y0),
        (dsl(Da, slice(1, None)), dsl(Ea, slice(0, k - 1)),
         dsl(Ga, slice(1, None))))
    cat = lambda h, t: DW(jnp.concatenate([h.hi[None], t.hi]),
                          jnp.concatenate([h.lo[None], t.lo]))
    ls = cat(l0, ls)
    ys = cat(y0, ys)

    x_last = sbdw.chol_solve(dsl(ls, k - 1), dsl(ys, k - 1))

    def bwd(x_next, inp):
        l_i, y_i, e_i = inp
        x_i = sbdw.chol_solve(l_i, dw.sub(y_i, sbdw.mm(e_i, x_next)))
        return x_i, x_i

    _, xs = jax.lax.scan(
        bwd, x_last,
        (dsl(ls, slice(0, k - 1)), dsl(ys, slice(0, k - 1)),
         dsl(Ea, slice(0, k - 1))),
        reverse=True)
    X = DW(jnp.concatenate([xs.hi, x_last.hi[None]]),
           jnp.concatenate([xs.lo, x_last.lo[None]]))
    return DW(jnp.moveaxis(X.hi, 0, -1), jnp.moveaxis(X.lo, 0, -1))


def _pad_pow2_f32(Ds, Es, k0):
    """f32 SoA pre-pad (identity/zero) to a power-of-two chain length."""
    b = Ds.shape[0]
    kp = 1 << max(0, (k0 - 1).bit_length())
    if kp == k0:
        return Ds, Es, k0
    dtype = Ds.dtype
    eye = jnp.broadcast_to(jnp.eye(b, dtype=dtype)[:, :, None],
                           (b, b, kp - k0))
    Ds = jnp.concatenate([Ds, eye], axis=-1)
    Es = Es.at[:, :, k0 - 1].set(0.0)
    Es = jnp.concatenate([Es, jnp.zeros((b, b, kp - k0), dtype)], axis=-1)
    return Ds, Es, kp


def blocktri_cr_factor_soa_dw(Ds, Es, *, unroll: int = 4, tail: int = 16):
    """DW factorization of an SPD block-tridiagonal chain, SoA f32 in.

    Returns ``apply(Gs) -> X`` (both f32 SoA (b, r, K)); X is the DW-grade
    solution rounded once at the end.  Level schedule: the top ``unroll``
    levels are python-unrolled at halving shapes; the rest run in a
    fixed-shape ``fori_loop`` (compile time O(1) in K); chains of
    <= ``tail`` blocks finish with the unrolled DW Thomas recursion.
    """
    b = Ds.shape[0]
    k0 = Ds.shape[-1]
    Ds, Es, k = _pad_pow2_f32(Ds, Es, k0)
    D = dw.from_single(Ds)
    E = dw.from_single(Es)
    dtype = Ds.dtype

    # Stage 1: python-unrolled top levels (shapes truly halve).
    static_facs = []
    while D.hi.shape[-1] > tail and len(static_facs) < unroll:
        (D, E), fac = _cr_level_factor_dw(D, E)
        static_facs.append(fac)
    k2 = D.hi.shape[-1]

    # Stage 2: fixed-shape fori levels at size k2 (factors stacked).
    levels = 0
    fori_state = None
    if k2 > tail:
        levels = (k2 // tail).bit_length() - 1
        half = k2 // 2
        eye = jnp.broadcast_to(jnp.eye(b, dtype=dtype)[:, :, None],
                               (b, b, half))

        def zstack(shape):
            return DW(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))

        def fwd(l, carry):
            D, E, st_l, st_eu, st_el = carry
            (d_new, e_new), (l_odd, e_up, e_lo, _, _) = \
                _cr_level_factor_dw(D, E)
            upd = lambda st, v: DW(
                jax.lax.dynamic_update_index_in_dim(st.hi, v.hi, l, 0),
                jax.lax.dynamic_update_index_in_dim(st.lo, v.lo, l, 0))
            st_l = upd(st_l, l_odd)
            st_eu = upd(st_eu, e_up)
            st_el = upd(st_el, e_lo)
            # Re-pad to k2: identity/zero pad is an exact CR fixed point.
            D = _concat([d_new, DW(eye, jnp.zeros_like(eye))])
            E = _concat([e_new, zstack((b, b, half))])
            return D, E, st_l, st_eu, st_el

        st0 = (zstack((levels, b, b, half)),) * 3
        D, E, st_l, st_eu, st_el = jax.lax.fori_loop(
            0, levels, fwd, (D, E) + st0)
        fori_state = (st_l, st_eu, st_el, half)

    D_tail = _slice(D, slice(0, tail if k2 > tail else k2))
    E_tail = _slice(E, slice(0, tail if k2 > tail else k2))

    def apply(Gs):
        """Gs f32 (b, r, K) -> X f32 (b, r, K) at DW accuracy."""
        r = Gs.shape[1]
        if k != k0:
            Gs = jnp.concatenate(
                [Gs, jnp.zeros((b, r, k - k0), dtype)], axis=-1)
        G = dw.from_single(Gs)

        # Stage 1 forward.
        sgs_static = []
        for fac in static_facs:
            G, s_g = _cr_level_apply_dw(fac, G)
            sgs_static.append((fac[3], fac[4], s_g))  # (s_up, s_lo, s_g)

        if fori_state is not None:
            st_l, st_eu, st_el, half = fori_state

            def zst(shape):
                return DW(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))

            def ffwd(l, carry):
                G, st_sg = carry
                idx = lambda st: DW(
                    jax.lax.dynamic_index_in_dim(st.hi, l, 0, keepdims=False),
                    jax.lax.dynamic_index_in_dim(st.lo, l, 0, keepdims=False))
                fac = (idx(st_l), idx(st_eu), idx(st_el), None, None)
                g_new, s_g = _cr_level_apply_dw(fac, G)
                st_sg = DW(
                    jax.lax.dynamic_update_index_in_dim(
                        st_sg.hi, s_g.hi, l, 0),
                    jax.lax.dynamic_update_index_in_dim(
                        st_sg.lo, s_g.lo, l, 0))
                G = _concat([g_new, zst((b, r, half))])
                return G, st_sg

            G, st_sg = jax.lax.fori_loop(
                0, levels, ffwd, (G, zst((levels, b, r, half))))

            # Tail solve on the active prefix.
            X = _thomas_dw(D_tail, E_tail,
                           _slice(G, slice(0, tail)))
            X = _concat([X, zst((b, r, k2 - tail))])

            def fbwd(i, X):
                l = levels - 1 - i
                idx = lambda st: DW(
                    jax.lax.dynamic_index_in_dim(st.hi, l, 0, keepdims=False),
                    jax.lax.dynamic_index_in_dim(st.lo, l, 0, keepdims=False))
                l_odd = idx(st_l)
                e_up = idx(st_eu)
                e_lo = idx(st_el)
                s_g = idx(st_sg)
                # Recompute s_up/s_lo from stored l_odd (cheaper than
                # stacking them: 2 triangular sweeps vs 2 more stacks).
                s_up = sbdw.chol_solve(l_odd, sbdw.transpose(e_up))
                s_lo = sbdw.chol_solve(l_odd, e_lo)
                return _cr_backsub_dw(
                    _slice(X, slice(0, half)), s_up, s_lo, s_g)

            X = jax.lax.fori_loop(0, levels, fbwd, X)
        else:
            X = _thomas_dw(D_tail, E_tail, G)

        # Stage 1 backward.
        for s_up, s_lo, s_g in reversed(sgs_static):
            X = _cr_backsub_dw(X, s_up, s_lo, s_g)

        return dw.to_single(_slice(X, slice(0, k0)))

    return apply


def blocktri_solve_cr_dw(D, E, G, **kw):
    """AoS one-shot DW CR solve: D/E (K, b, b), G (K, b[, r]) f32."""
    squeeze = G.ndim == 2
    if squeeze:
        G = G[..., None]
    to_soa = lambda A: jnp.moveaxis(A, 0, -1)
    apply = blocktri_cr_factor_soa_dw(to_soa(D), to_soa(E), **kw)
    X = jnp.moveaxis(apply(to_soa(G)), -1, 0)
    return X[..., 0] if squeeze else X
