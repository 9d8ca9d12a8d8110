"""Microbenchmark: block-tridiagonal solver variants on the GPU.

Times one solve of an SPD block-tridiagonal system at the headline shape
(K=16384 blocks of bd=8, nrhs=3 — the VdP 10k-element KKT) for each solver
variant.  Each timed unit is a jitted ``fori_loop`` chaining ``inner``
data-dependent solves, bounded by ``block_until_ready``; the per-call
dispatch overhead amortizes over ``inner`` solves.

Usage: python benchmarks/blocktri_bench.py [--k 16384] [--b 8] [--r 3]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np


def timeit_chained(solve, D, E, G, inner=400, reps=3):
    """Median over reps of (wall of `inner` chained solves) / inner."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(D, E, G):
        def body(i, g):
            x = solve(D, E, g)
            # Data dependence so XLA cannot elide or overlap iterations;
            # the perturbation is far below f32 resolution of G.
            return g + 1e-30 * x

        return jax.lax.fori_loop(0, inner, body, G)

    jax.block_until_ready(loop(D, E, G))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(D, E, G))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / inner


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=16384)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--r", type=int, default=3)
    ap.add_argument("--inner", type=int, default=400)
    ap.add_argument("--with-scan", action="store_true",
                    help="include the O(K)-depth Thomas scan (slow at big K)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from collocfem_tpu.ops.einsum_hp import einsum_hp
    from collocfem_tpu.solve.blocktri import SOLVERS
    from collocfem_tpu.utils.device import card_line, require_gpu

    devs = require_gpu()
    print(f"[{card_line()}] device_kind={devs[0].device_kind}  K={args.k} "
          f"b={args.b} r={args.r}")
    rng = np.random.default_rng(0)
    k, b, r = args.k, args.b, args.r
    A = rng.standard_normal((k, b, b)).astype(np.float32)
    D = jnp.asarray(A @ A.transpose(0, 2, 1) + 4 * b * np.eye(b, dtype=np.float32))
    E = jnp.asarray(0.3 * rng.standard_normal((k, b, b)).astype(np.float32))
    G = jnp.asarray(rng.standard_normal((k, b, r)).astype(np.float32))

    names = ["cr", "cr_dw"] + (["scan"] if args.with_scan else [])
    for name in names:
        fn = SOLVERS[name]
        inner = args.inner if name != "scan" else 2
        t = timeit_chained(fn, D, E, G, inner=inner)
        # residual check (single un-timed solve)
        X = jax.jit(fn)(D, E, G)
        rres = einsum_hp("kij,kjr->kir", D, X)
        rres = rres.at[:-1].add(einsum_hp("kij,kjr->kir", E[:-1], X[1:]))
        rres = rres.at[1:].add(einsum_hp("kji,kjr->kir", E[:-1], X[:-1]))
        err = float(jnp.max(jnp.abs(rres - G)))
        print(f"{name:>6}: {t*1e3:9.3f} ms   max|Ax-g|={err:.2e}")


if __name__ == "__main__":
    main()
