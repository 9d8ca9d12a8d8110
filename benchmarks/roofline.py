"""HBM-traffic (roofline) accounting for the headline N=10k LM iteration.

States an analytic minimum-traffic model and measures against it:

  * per phase, every array the phase must READ once plus every array it
    must WRITE once (compulsory traffic; fusion can't do better,
    re-materialization does worse);
  * measured per-phase walls: a jitted fori_loop of ``--inner``
    data-dependent repetitions (a real 1e-30 data dependence, so XLA
    cannot hoist the body), median over ``--reps``; the full-iteration row
    is differential ((wall60 - wall15)/45 of the actual solver), which
    cancels the per-call overhead exactly;
  * achieved GB/s = model bytes / measured wall, as a fraction of the
    device's HBM peak from :data:`PEAKS` (keyed by ``device_kind``; an
    unknown device is an error).

A phase far below peak at these sizes is bound by kernel launch/latency
(many small ops over a K~10^4 chain), not bandwidth.

Usage: python benchmarks/roofline.py [--elements 10000] [--inner 400]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np

# Published peaks per device_kind (NVIDIA H100 SXM data sheet, dense rates,
# at the full 700 W power limit): HBM3 bandwidth and float32 rates.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbs": 3350.0, "f32_tflops": 67.0, "tf32_tflops": 495.0,
        "source": "NVIDIA H100 SXM data sheet",
    },
}


def peaks_for(device_kind):
    """The peak table entry of ``device_kind``; unknown kinds raise."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak table entry for device_kind "
                       f"{device_kind!r}; add it with its source") from None


def nbytes(*arrs):
    return sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in arrs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=10000)
    ap.add_argument("--inner", type=int, default=400)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from collocfem_tpu.utils.cache import enable_persistent_cache
    from collocfem_tpu.utils.device import card_line, require_gpu

    devs = require_gpu()
    peak = peaks_for(devs[0].device_kind)["hbm_gbs"]
    card = card_line()
    enable_persistent_cache()

    from baseline_cpu.run_baseline import build_headline_problem
    from bench import wall_stats
    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.ops.assemble import assemble_gn_soa
    from collocfem_tpu.problem import Decision, EstimationProblem
    from collocfem_tpu.solve.kkt import solve_kkt_soa

    mesh, t_meas, y, u_nodes = build_headline_problem(args.elements)
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=100.0)
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
    z0 = Decision(V=jnp.asarray(z0.V), p=jnp.asarray(z0.p))
    lam = jnp.asarray(3e-6, z0.V.dtype)

    sys0, _ = assemble_gn_soa(prob, z0, data, with_cost=True)
    ed = prob._elem_data(data)

    # ---- analytic compulsory-traffic model (bytes per execution) --------
    sys_bytes = nbytes(sys0.D, sys0.E, sys0.B, sys0.gx)  # C/gp are tiny
    # Assembly: reads the iterate + per-element data tables, writes the
    # system.  The per-element Jacobian intermediates are fusion-resident
    # (never round-trip HBM in the measured XLA schedule at this size) —
    # if XLA did materialize them the model would UNDERcount, which only
    # strengthens a below-roofline conclusion.
    asm_bytes = (
        nbytes(z0.V)
        + sum(nbytes(np.asarray(leaf)) for leaf in ed)
        + nbytes(data.y, data.u)
        + sys_bytes
    )
    # KKT solve: read the system once, write the step once.  The cyclic
    # reduction's level passes re-read and re-write O(K) arrays per level,
    # so this compulsory bound UNDERcounts the traffic it does.
    kkt_bytes = sys_bytes + nbytes(sys0.gx)
    # Iterate update + accept bookkeeping: read step + V, write V.
    upd_bytes = 3 * nbytes(z0.V)

    # ---- measured phase walls -------------------------------------------
    inner = args.inner

    def timed(name, fn, *xs):
        f = jax.jit(fn)
        out = f(*xs)
        jax.block_until_ready(out)
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = f(*xs)
            jax.block_until_ready(out)
            float(np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[0])
            walls.append((time.perf_counter() - t0) / inner)
        return float(np.median(walls))

    def assemble_loop(V, p):
        def body(i, acc):
            s, ct = assemble_gn_soa(
                prob, Decision(V=V * (1.0 + 1e-30 * acc), p=p), data,
                with_cost=True
            )
            return acc + s.gx[0, 0] + ct.hi * 1e-30

        return jax.lax.fori_loop(0, inner, body, jnp.zeros((), V.dtype))

    def kkt_loop(_):
        def body(i, acc):
            s = sys0._replace(D=sys0.D * (1.0 + 1e-30 * acc))
            dx, dp = solve_kkt_soa(s, lam, 0)
            return acc + dx[0, 0] + dp[0] * 1e-30

        return jax.lax.fori_loop(0, inner, body, jnp.zeros((), sys0.D.dtype))

    t_asm = timed("assembly", assemble_loop, z0.V, z0.p)
    t_kkt = timed("kkt", kkt_loop, jnp.zeros(()))

    # Differential full-iteration wall from the ACTUAL solver: cancels the
    # per-call dispatch overhead that polluted per-call timings.
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import make_gn_solver

    def lm_wall(iters):
        solve_fn = make_gn_solver(prob, SolverOptions(
            maxiter=iters, gtol=0.0, ftol=0.0, xtol=0.0, kkt_refine=0,
            lam0=3e-6, lam_max=1e30))
        jax.block_until_ready(solve_fn(z0, data))
        return wall_stats(lambda: solve_fn(z0, data), args.reps)["median_s"]

    t_iter = (lm_wall(60) - lm_wall(15)) / 45.0

    print(f"[{card}] N={args.elements} headline iteration, "
          f"device_kind={devs[0].device_kind}, dtype={sys0.D.dtype}")
    print(f"{'phase':>10} {'model MB':>10} {'wall ms':>9} "
          f"{'GB/s':>8} {'% peak':>7}")
    total_b = asm_bytes + kkt_bytes + upd_bytes
    for name, b, t in [("assembly", asm_bytes, t_asm),
                       ("kkt solve", kkt_bytes, t_kkt),
                       ("iteration", total_b, t_iter)]:
        gbs = b / t / 1e9
        print(f"{name:>10} {b / 1e6:>10.2f} {1e3 * t:>9.3f} "
              f"{gbs:>8.1f} {100 * gbs / peak:>6.1f}%")
    print(f"\nHBM peak: {peak:.0f} GB/s "
          f"({peaks_for(devs[0].device_kind)['source']}). Phases far below "
          "peak are bound by kernel launch/latency, not bandwidth.")


if __name__ == "__main__":
    main()
