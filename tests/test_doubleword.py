"""Double-word f32 arithmetic vs a float64 oracle.

Validates the error-free-transform layer (ops.doubleword) and the DW
tiny-block algebra (ops.smallblocks_dw): every op must deliver ~48-bit
relative accuracy on f32 inputs — far beyond plain f32's 24 bits and
sufficient for the cond ~ K^2 collocation chains at K ~ 1e4-1e5
(SURVEY.md §7 hard part 4).
"""

import jax
import jax.numpy as jnp
import numpy as np

from collocfem_tpu.ops import doubleword as dw
from collocfem_tpu.ops import smallblocks_dw as sbdw

RNG = np.random.default_rng(42)
# ~48-bit arithmetic: unit roundoff 2^-49 ~ 1.8e-15; allow a few ulps.
TOL = 5e-14


def _rand32(*shape, scale=1.0):
    return jnp.asarray(
        (scale * RNG.standard_normal(shape)).astype(np.float32))


def _ref64(a32):
    return np.asarray(a32, dtype=np.float64)


def test_two_sum_two_prod_exact():
    a, b = _rand32(1000), _rand32(1000, scale=1e-4)
    s, e = dw.two_sum(a, b)
    np.testing.assert_array_equal(
        _ref64(s) + _ref64(e), _ref64(a) + _ref64(b))
    p, e = dw.two_prod(a, b)
    np.testing.assert_array_equal(
        _ref64(p) + _ref64(e), _ref64(a) * _ref64(b))


def test_dw_add_mul_div_sqrt_accuracy():
    xh, xl = _rand32(1000), _rand32(1000, scale=1e-8)
    yh, yl = _rand32(1000), _rand32(1000, scale=1e-8)
    x, y = dw.DW(*dw.quick_two_sum(xh, xl)), dw.DW(*dw.quick_two_sum(yh, yl))
    x64 = _ref64(x.hi) + _ref64(x.lo)
    y64 = _ref64(y.hi) + _ref64(y.lo)

    for op, ref in [
        (dw.add, x64 + y64),
        (dw.sub, x64 - y64),
        (dw.mul, x64 * y64),
        (dw.div, x64 / y64),
    ]:
        got = np.asarray(dw.to_float64(op(x, y)))
        err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
        assert err.max() < TOL, (op.__name__, err.max())

    xp = dw.DW(jnp.abs(x.hi) + 1.0, x.lo)
    ref = np.sqrt(_ref64(xp.hi) + _ref64(xp.lo))
    got = np.asarray(dw.to_float64(dw.sqrt(xp)))
    assert (np.abs(got - ref) / ref).max() < TOL


def test_dw_accumulation_beats_f32():
    """Summing many cancelling products: DW keeps ~1e-14, f32 loses to ~1e-4."""
    n = 4096
    a, b = _rand32(n), _rand32(n)
    ref = float(np.sum(_ref64(a) * _ref64(b)))
    s = dw.from_single(jnp.zeros(()))
    av, bv = a, b
    acc = dw.from_single(jnp.zeros_like(a))
    acc = dw.mul(dw.from_single(av), dw.from_single(bv))
    # tree-free sequential fold in DW via scan for trace efficiency
    def body(c, i):
        return dw.add(c, dw.DW(acc.hi[i], acc.lo[i])), None
    tot, _ = jax.lax.scan(body, s, jnp.arange(n))
    got = float(dw.to_float64(tot))
    f32 = float(jnp.sum(a * b))
    assert abs(got - ref) / max(abs(ref), 1e-30) < 1e-12
    # sanity: f32 error is orders of magnitude larger on this data
    assert abs(f32 - ref) > abs(got - ref)


def _rand_spd_chain(b, k, cond):
    """SPD blocks (b, b, K) f32 with eigenvalues exactly logspace(1..1/cond)."""
    w = np.logspace(0, -np.log10(cond), b)
    blocks = []
    for _ in range(k):
        q, _ = np.linalg.qr(RNG.standard_normal((b, b)))
        blocks.append((q * w) @ q.T)
    A = np.stack(blocks)
    return jnp.asarray(np.moveaxis(A, 0, -1).astype(np.float32))


def test_dw_cholesky_solve_vs_f64():
    """Forward error tracks cond * u_dw (~1e6 * 2e-15), not cond * u_f32."""
    b, k = 4, 64
    A32 = _rand_spd_chain(b, k, cond=1e6)
    B32 = _rand32(b, 2, k)
    A64 = _ref64(A32)
    B64 = _ref64(B32)
    # f64 reference solve per chain slice
    Xref = np.stack([
        np.linalg.solve(A64[:, :, i], B64[:, :, i]) for i in range(k)
    ], axis=-1)

    X_dw = np.asarray(sbdw.to_single(
        sbdw.chol_solve(sbdw.chol(sbdw.from_single(A32)),
                        sbdw.from_single(B32))), dtype=np.float64)
    # Plain float32 solve (LAPACK in f32; numpy would solve in f64).
    X_f32 = np.moveaxis(np.asarray(jnp.linalg.solve(
        jnp.moveaxis(A32, -1, 0), jnp.moveaxis(B32, -1, 0)),
        dtype=np.float64), 0, -1)

    scale = np.abs(Xref).max(axis=(0, 1))        # per chain slice
    rel_dw = (np.abs(X_dw - Xref).max(axis=(0, 1)) / scale)
    rel_f32 = (np.abs(X_f32 - Xref).max(axis=(0, 1)) / scale)
    # DW: cond * u_dw ~ 2e-9 (allow 2 orders of headroom).
    assert np.median(rel_dw) < 1e-7, np.median(rel_dw)
    # f32: cond * u_f32 ~ 6e-2 — DW must beat it by >= 1e4 in the median.
    assert np.median(rel_dw) * 1e4 < np.median(rel_f32), (
        np.median(rel_dw), np.median(rel_f32))


def test_dw_mm_mtm_vs_f64():
    b, m, c, k = 3, 4, 2, 32
    A = _rand32(b, m, k)
    B = _rand32(m, c, k)
    ref = np.einsum("imk,mck->ick", _ref64(A), _ref64(B))
    got = np.asarray(sbdw.to_single(
        sbdw.mm(sbdw.from_single(A), sbdw.from_single(B))),
        dtype=np.float64)
    assert np.abs(got - ref).max() < 1e-6 * np.abs(ref).max()

    At = jnp.swapaxes(A, 0, 1)
    got_t = np.asarray(sbdw.to_single(
        sbdw.mtm(sbdw.from_single(At), sbdw.from_single(B))),
        dtype=np.float64)
    assert np.abs(got_t - ref).max() < 1e-6 * np.abs(ref).max()


def test_dw_ops_jit_and_stay_f32():
    """DW ops must trace under jit and never promote to f64 internally."""
    x = dw.from_single(_rand32(64))
    y = dw.from_single(_rand32(64))

    @jax.jit
    def f(x, y):
        return dw.mul(dw.add(x, y), dw.sqrt(dw.DW(jnp.abs(y.hi) + 1.0, y.lo)))

    out = f(x, y)
    assert out.hi.dtype == jnp.float32 and out.lo.dtype == jnp.float32
