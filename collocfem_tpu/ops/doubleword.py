"""Double-word (double-double) f32 arithmetic from error-free transforms.

Extended precision for float32 working data (SURVEY.md §7 hard part 4).
A double-word number ``x = hi + lo`` (|lo| <= ulp(hi)/2) carries ~2x24 = 48
significand bits (unit roundoff ~4e-15, between f32 and f64) using ONLY
IEEE f32 adds/muls — every operation below is a short fixed sequence of
full-width elementwise ops, so it vectorizes over the (K,) chain layout
exactly like plain f32.  Whether this tier beats native float64 in time to
accuracy on a given device is a measurement, not an assumption.

Algorithms are the classical error-free transforms (Knuth two-sum, Dekker
split/two-prod — no FMA required) and the
double-double add/mul/div/sqrt built from them; see Hida, Li & Bailey,
"Library for double-double and quad-double arithmetic" (2007).

Correctness relies on round-to-nearest IEEE arithmetic without value-
changing reassociation, which XLA keeps by default; tests validate every
op against a float64 oracle.

Works for any base dtype (tests also exercise f64-based DW on CPU), but
f32 is the intended use.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class DW(NamedTuple):
    """A double-word value/array: represented value is hi + lo."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def from_single(a) -> DW:
    """Exact widening of a native float array to DW."""
    a = jnp.asarray(a)
    return DW(a, jnp.zeros_like(a))


def to_single(x: DW):
    """Round a DW back to its base dtype."""
    return x.hi + x.lo


def two_sum(a, b):
    """s, err with s = fl(a+b) and a+b = s+err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """two_sum under the precondition |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    """Dekker split: a = hi + lo with hi, lo having ~half-width mantissas.

    The split constant is 2^ceil(p/2)+1 for a p-bit significand: 4097 for
    f32 (p=24), 2^27+1 for f64 (p=53).
    """
    c = 4097.0 if a.dtype == jnp.float32 else 134217729.0
    t = c * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p, err with p = fl(a*b) and a*b = p+err exactly (Dekker, no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add(x: DW, y: DW) -> DW:
    """DW + DW (accurate variant: ~2 ulp)."""
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return DW(*quick_two_sum(s, e))


def sub(x: DW, y: DW) -> DW:
    return add(x, neg(y))


def neg(x: DW) -> DW:
    return DW(-x.hi, -x.lo)


def add_single(x: DW, a) -> DW:
    """DW + native float."""
    a = jnp.asarray(a, x.hi.dtype)
    s, e = two_sum(x.hi, a)
    e = e + x.lo
    return DW(*quick_two_sum(s, e))


def mul(x: DW, y: DW) -> DW:
    """DW * DW."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DW(*quick_two_sum(p, e))


def mul_single(x: DW, a) -> DW:
    """DW * native float."""
    a = jnp.asarray(a, x.hi.dtype)
    p, e = two_prod(x.hi, a)
    e = e + x.lo * a
    return DW(*quick_two_sum(p, e))


def div(x: DW, y: DW) -> DW:
    """DW / DW via two corrected quotient terms."""
    q1 = x.hi / y.hi
    r = sub(x, mul_single(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_single(y, q2))
    q3 = r.hi / y.hi
    s, e = quick_two_sum(q1, q2)
    return add_single(DW(s, e), q3)


def recip(y: DW) -> DW:
    one = DW(jnp.ones_like(y.hi), jnp.zeros_like(y.hi))
    return div(one, y)


def sqrt(x: DW) -> DW:
    """DW sqrt via one refined Heron correction on the f32 estimate.

    For x <= 0 the clamp semantics of the callers (smallblocks.chol) are
    preserved by flooring hi at the dtype's tiny.
    """
    xh = jnp.maximum(x.hi, jnp.finfo(x.hi.dtype).tiny)
    s = jnp.sqrt(xh)
    # err = x - s*s computed exactly, then one Newton step: s + err/(2 s).
    p, e = two_prod(s, s)
    err = add(sub(x, DW(p, jnp.zeros_like(p))), DW(-e, jnp.zeros_like(e)))
    corr = err.hi / (2.0 * s)
    return DW(*quick_two_sum(s, corr))


def pairwise_sum(x: DW, axis: int = 0) -> DW:
    """DW reduction along ``axis`` via pairwise halving (log2(n) adds).

    Pairwise order is also more accurate than sequential summation; used
    for DW dot products and the solver's DW cost accumulation.
    """
    hi = jnp.moveaxis(x.hi, axis, 0)
    lo = jnp.moveaxis(x.lo, axis, 0)
    n = hi.shape[0]
    if n == 0:
        z = jnp.zeros(hi.shape[1:], hi.dtype)
        return DW(z, z)
    # Pad to a power of two with zeros (an exact additive identity for
    # two_sum), so every level is a clean halving: no odd-tail
    # concatenates — those emitted 2 extra kernels per level, and on the
    # solver's ~1e5-element reductions the kernel count dominates the
    # (bandwidth-trivial) arithmetic.
    n2 = 1 << (n - 1).bit_length()
    if n2 != n:
        pad = [(0, n2 - n)] + [(0, 0)] * (hi.ndim - 1)
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
        n = n2
    while n > 1:
        m = n // 2
        s = add(DW(hi[:m], lo[:m]), DW(hi[m:], lo[m:]))
        hi, lo = s.hi, s.lo
        n = m
    return DW(hi[0], lo[0])


def dot(a, b) -> DW:
    """DW-accumulated dot product of two native-float 1-D arrays."""
    p, e = two_prod(a, b)
    return pairwise_sum(DW(p, e))


def less(x: DW, y: DW):
    """Elementwise x < y on normalized DW values."""
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo < y.lo))


def to_float64(x: DW):
    """Exact f64 view of a DW value — FOR TESTS on CPU only."""
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)
