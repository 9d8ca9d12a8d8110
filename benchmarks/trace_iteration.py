"""Per-iteration split of the headline LM solve from one profiler trace.

Builds the N=10k VdP headline (bench.py's fixed-work solver), measures the
per-LM-iteration wall differentially ((wall of 60 iterations - wall of 15)
/ 45, median of reps, each bounded by ``block_until_ready``), then traces
one 15-iteration solve with ``jax.profiler`` and reduces the device events:

  * window — first device kernel start to last kernel end;
  * busy   — union of kernel intervals over all device streams; idle share
             = 1 - busy / window;
  * kernels per iteration — device kernel events / iterations;
  * split  — device time per phase, from each kernel's HLO instruction
             (the ``hlo_op`` stat) mapped to its ``op_name`` metadata in the
             compiled HLO, whose name stack carries the solver's named
             scopes: ``assemble``, ``kkt_solve`` (``equilibrate``,
             ``chain_factor``, ``chain_apply``, the rest is the arrowhead
             Schur and glue), everything else is LM control.

Needs a GPU.  Writes ``chiprun_out/trace_iteration.json`` (and the raw
trace under ``chiprun_out/trace/``) and prints a summary.

Usage: python benchmarks/trace_iteration.py [--elements 10000] [--reps 5]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import glob
import json
import re
import time

import numpy as np

PHASES = ("assemble", "equilibrate", "chain_factor", "chain_apply",
          "kkt_solve", "lm_control")


def op_names(hlo_text):
    """{HLO instruction name: op_name metadata} from compiled HLO text."""
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?"
                     r"metadata=\{[^}]*op_name=\"([^\"]*)\"", re.M)
    return dict(pat.findall(hlo_text))


def phase_of(op_name):
    """Innermost solver phase named in an op_name name stack."""
    for tag in ("equilibrate", "chain_factor", "chain_apply"):
        if f"/{tag}/" in op_name or op_name.endswith(f"/{tag}"):
            return tag
    for tag in ("assemble", "kkt_solve"):
        if f"/{tag}/" in op_name or op_name.endswith(f"/{tag}"):
            return tag
    return "lm_control"


def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(xplane_path, names, iterations):
    """Device busy/idle, kernel count and per-phase device time."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" not in stats:
                    continue              # memcpy / launch markers
                events.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                               ev.duration_ns, stats["hlo_op"], ev.name))
    if not events:
        raise RuntimeError("no device kernel events in the trace")
    start = min(e[0] for e in events)
    end = max(e[1] for e in events)
    window = end - start
    busy = union_ns([(e[0], e[1]) for e in events])
    split = {p: 0.0 for p in PHASES}
    by_kernel = {}
    for _, _, dur, hlo_op, name in events:
        split[phase_of(names.get(hlo_op, ""))] += dur
        by_kernel[name] = by_kernel.get(name, 0.0) + dur
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window,
        "kernels": len(events),
        "kernels_per_iteration": len(events) / iterations,
        "device_ms_by_phase": {p: v / 1e6 for p, v in split.items()},
        "device_ms_per_iteration_by_phase": {
            p: v / 1e6 / iterations for p, v in split.items()},
        "top_kernels_ms": [(n, v / 1e6) for n, v in top],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()

    import jax

    import bench
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import make_gn_solver
    from collocfem_tpu.utils.cache import enable_persistent_cache
    from collocfem_tpu.utils.device import card_line, require_gpu

    devs = require_gpu()
    card = card_line()
    enable_persistent_cache()
    prob, z0, data, _ = bench._setup(args.elements)

    def compiled_solver(iters):
        opts = SolverOptions(maxiter=iters, gtol=0.0, ftol=0.0, xtol=0.0,
                             kkt_refine=0, lam0=3e-6, lam_max=1e30)
        c = make_gn_solver(prob, opts).lower(z0, data).compile()
        jax.block_until_ready(c(z0, data))
        return c

    s15, s60 = compiled_solver(15), compiled_solver(60)
    w15 = bench.wall_stats(lambda: s15(z0, data), args.reps)
    w60 = bench.wall_stats(lambda: s60(z0, data), args.reps)
    per_iter = (w60["median_s"] - w15["median_s"]) / 45.0

    trace_dir = os.path.join(args.out, "trace")
    jax.profiler.start_trace(trace_dir)
    t0 = time.perf_counter()
    jax.block_until_ready(s15(z0, data))
    host_wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    red = reduce_trace(path, op_names(s15.as_text()), 15)

    out = {
        "card": card, "device_kind": devs[0].device_kind,
        "elements": args.elements,
        "wall_15_iters": w15, "wall_60_iters": w60,
        "per_iteration_s": per_iter,
        "traced_host_wall_s": host_wall,
        "trace": red,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trace_iteration.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"[{card}] N={args.elements}: 15-iteration wall median "
          f"{w15['median_s']:.6f} s, 60-iteration {w60['median_s']:.6f} s, "
          f"per iteration {1e3 * per_iter:.4f} ms (differential)")
    print(f"[{card}] traced 15-iteration solve: device window "
          f"{red['window_ms']:.3f} ms, busy {red['busy_ms']:.3f} ms, idle "
          f"share {red['idle_share']:.3f}, {red['kernels_per_iteration']:.1f}"
          f" kernels/iteration")
    for p, v in red["device_ms_per_iteration_by_phase"].items():
        print(f"[{card}]   {p:>12}: {v:.4f} ms/iteration device time")
    for n, v in red["top_kernels_ms"]:
        print(f"[{card}]   kernel {n}: {v:.3f} ms total")


if __name__ == "__main__":
    main()
