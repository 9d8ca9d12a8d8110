"""Smoke test of the library's main paths on one GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # only the dp x sp mesh paths, 4 cards

One card, in order (any failure exits non-zero, and no result is printed):

  1. device — JAX's default backend must be a GPU; prints the device kind
     and count and the cards' name and power limit (nvidia-smi);
  2. headline — Van der Pol, N = 10,000 elements, degree 4, float32,
     through ``make_gn_solver``: the 15-iteration fixed-work run (cost down
     by more than 10x) and the converged multilevel ladder
     (‖p − p_true‖∞ < 1e-4), with compile time, median wall and
     ``memory_analysis``;
  3. parity — the chain solve (``blocktri_cr_factor_soa``, float32, on the
     GPU) at the headline KKT shape against the float64 block-Thomas
     reference on the host, at the default matmul precision and at
     "highest"; the VdP residual and cost on the GPU against
     ``baseline_cpu/pipeline.py`` (float64);
  4. configs — config 3 (pendulum swing-up, ``make_ocp_solver``) and
     config 5 (1024 x 10-element experiments,
     ``make_multi_experiment_solver``) at their BASELINE sizes;
  5. card-only tests — ``pytest -m gpu`` in a process of its own, started
     after the process that ran phases 1-4 has exited (one JAX process per
     card at a time).

Phases 1-4 run in a child process (``--phases``); this parent never
imports JAX.  Every number is printed beside the card's name and power
limit.  The last line is the JSON result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE_TAG = "chip_smoke-device: "

# Chain-solve tolerances for the float32 solve of the unit-diagonal
# equilibrated system A X = G.  The normwise backward error
# η = ‖AX − G‖ / (‖A‖∞‖X‖ + ‖G‖) of a pivot-free block CR whose Schur
# complements stay SPD is a small multiple of the float32 unit roundoff
# (u = 6e-8), so η < 1e-6; a contraction that ran in TF32 (u = 4.9e-4)
# could not meet it.  The relative residual ‖AX − G‖/‖G‖ is larger by
# ‖A‖‖X‖/‖G‖ (the chain's conditioning, ~K² before equilibration); 1e-4
# holds it to f32 level with margin.  The forward error against the
# float64 solve is reported: it is bounded only by cond(A)·η.
CHAIN_ETA_TOL = 1e-6
CHAIN_RESIDUAL_TOL = 1e-4
# Residual parity: float32 evaluation of the same residual at the same
# (float32-representable) point as the float64 CPU pipeline.  The defect
# rows apply the (2/h)·D difference operator (h = 1e-3 at N = 10^4), which
# amplifies the float32 rounding of the tables and of the state
# differences; 1e-5 of ‖r‖∞ bounds that amplification with margin.
RESIDUAL_TOL = 1e-5
COST_TOL = 1e-5
# Config 3: the swing-up optimum of the CPU float64 solve (objective
# 2.58757, BASELINE.md) — float32 reaches it to ~1e-5 relative, so 1e-3
# relative is a loose basin check; cviol is the max equality violation.
C3_OBJECTIVE = 2.58757
C3_OBJECTIVE_RTOL = 1e-3
C3_CVIOL_MAX = 1e-4
# Config 5: same data, same 15 fixed-work LM iterations as the float64 CPU
# reference (baseline_cpu/configs_results.json: p_rel_err 0.0402065); the
# noise-limited estimate moves far less than 1e-3 under float32 rounding.
C5_P_REL_ERR = 0.0402065
C5_P_REL_ERR_ATOL = 1e-3


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase functions (the CPU tests call them at tiny sizes)
# ---------------------------------------------------------------------------
def phase_device():
    """Phase 1: require a GPU; returns (devices, card line)."""
    from collocfem_tpu.utils.device import card_line, require_gpu

    devs = require_gpu()
    card = card_line()
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    log(f"card (name, power.limit): {card}")
    return devs, card


def phase_headline(card, elements=10000, reps=5):
    """Phase 2: fixed-work and converged VdP estimation via bench.py."""
    import bench

    fixed = bench.run_fixed(elements, reps)
    log(f"[{card}] headline fixed-work N={elements}: compile "
        f"{fixed['compile_s']:.3f} s; steady wall median "
        f"{fixed['wall']['median_s']:.6f} s (q1 {fixed['wall']['q1_s']:.6f},"
        f" q3 {fixed['wall']['q3_s']:.6f}, {fixed['wall']['reps']} reps); "
        f"cost {fixed['cost0']:.6e} -> {fixed['cost']:.6e}; p={fixed['p']}")
    log(f"[{card}] headline fixed-work memory_analysis: {fixed['memory']}")
    assert fixed["ok"], "fixed-work run: non-finite state or cost not down >10x"

    conv = bench.run_converged(elements, reps)
    log(f"[{card}] headline converged ladder N={elements}: compile "
        f"{conv['compile_s']:.3f} s (+ first run {conv['first_run_s']:.3f} s);"
        f" steady wall median {conv['wall']['median_s']:.6f} s (q1 "
        f"{conv['wall']['q1_s']:.6f}, q3 {conv['wall']['q3_s']:.6f}); "
        f"p={conv['p']} p-err {conv['p_err']:.6e}; level split "
        f"{conv['level_split_s']}")
    log(f"[{card}] headline converged finest-level memory_analysis: "
        f"{conv['memory']}")
    assert conv["ok"], (f"converged ladder p-err {conv['p_err']:.3e} >= "
                        f"{bench.P_ERR_TARGET}")
    return fixed, conv


def _matvec_soa_np(D, E, X):
    """A X in float64 numpy for SoA D/E (b, b, K), X (b, r, K); E[..., K-1]
    is ignored (block-tridiagonal convention)."""
    y = np.einsum("ijk,jrk->irk", D, X)
    y[:, :, :-1] += np.einsum("ijk,jrk->irk", E[:, :, :-1], X[:, :, 1:])
    y[:, :, 1:] += np.einsum("jik,jrk->irk", E[:, :, :-1], X[:, :, :-1])
    return y


def chain_system(elements):
    """The equilibrated headline KKT chain: (D, E, G) in SoA layout with
    G = [gx | B] (b, 1 + nq, K), as ``solve_kkt_soa`` factors it."""
    import jax
    import jax.numpy as jnp

    import bench
    from collocfem_tpu.ops.assemble import assemble_gn_soa
    from collocfem_tpu.solve.kkt import _equilibrate_soa

    prob, z0, data, _ = bench._setup(elements)
    lam = jnp.asarray(3e-6, prob.dtype)

    @jax.jit
    def build(z):
        s = _equilibrate_soa(assemble_gn_soa(prob, z, data), lam)[0]
        return s.D, s.E, jnp.concatenate([s.gx[:, None, :], s.B], axis=1)

    return build(z0)


def phase_chain_parity(card, elements=10000):
    """Phase 3a: device CR chain solve vs the float64 host reference."""
    import jax

    from collocfem_tpu.solve.blocktri import (blocktri_cr_factor_soa,
                                              blocktri_solve_scan)

    D, E, G = chain_system(elements)
    b, r, k = G.shape
    D64, E64, G64 = (np.asarray(a, dtype=np.float64) for a in (D, E, G))
    # ‖A‖∞: the largest absolute row sum of the block-tridiagonal matrix.
    rows = np.abs(D64).sum(axis=1)
    rows[:, :-1] += np.abs(E64[:, :, :-1]).sum(axis=1)
    rows[:, 1:] += np.abs(E64[:, :, :-1]).sum(axis=0)
    a_norm = float(rows.max())
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        to_aos = lambda a: np.moveaxis(a, -1, 0)
        X_ref = np.moveaxis(np.asarray(jax.jit(blocktri_solve_scan)(
            to_aos(D64), to_aos(E64), to_aos(G64))), 0, -1)

    results = {}
    for precision in ("default", "highest"):
        def solve(D, E, G):
            return blocktri_cr_factor_soa(D, E)(G)

        if precision == "default":
            X = jax.jit(solve)(D, E, G)
        else:
            with jax.default_matmul_precision("highest"):
                X = jax.jit(solve)(D, E, G)
        X = np.asarray(X, dtype=np.float64)
        res = np.linalg.norm(_matvec_soa_np(D64, E64, X) - G64)
        g_norm = np.linalg.norm(G64)
        out = {"eta": float(res / (a_norm * np.linalg.norm(X) + g_norm)),
               "residual": float(res / g_norm),
               "forward": float(np.linalg.norm(X - X_ref)
                                / np.linalg.norm(X_ref))}
        results[precision] = out
        log(f"[{card}] chain parity K={k} b={b} r={r} precision={precision}: "
            f"backward error eta {out['eta']:.3e} (tol {CHAIN_ETA_TOL:.0e}), "
            f"|AX-G|/|G| {out['residual']:.3e} (tol "
            f"{CHAIN_RESIDUAL_TOL:.0e}), forward error {out['forward']:.3e} "
            f"vs float64 block-Thomas")
    for precision, out in results.items():
        assert out["eta"] < CHAIN_ETA_TOL, (
            f"chain backward error {out['eta']:.3e} at {precision}")
        assert out["residual"] < CHAIN_RESIDUAL_TOL, (
            f"chain relative residual {out['residual']:.3e} at {precision}")
    return results


def phase_residual_parity(card, elements=10000):
    """Phase 3b: VdP residual/cost (device, f32) vs baseline_cpu (f64)."""
    import jax

    import bench
    from baseline_cpu.pipeline import BaselineProblem
    from baseline_cpu.run_baseline import build_headline_problem

    prob, z0, data, _ = bench._setup(elements)
    mesh, t_meas, y, u_nodes = build_headline_problem(elements)
    base = BaselineProblem.build(mesh, t_meas, y, u_nodes,
                                 defect_weight=100.0)
    r_dev = np.asarray(jax.jit(prob.residual_vector)(z0, data),
                       dtype=np.float64)
    c_dev = float(jax.jit(prob.cost)(z0, data))
    # The reference evaluates at the device's own (f32-representable) point.
    r_ref = base.residuals(np.asarray(z0.V, dtype=np.float64),
                           np.asarray(z0.p, dtype=np.float64))
    n = r_ref.shape[0]
    err_r = float(np.max(np.abs(r_dev[:n] - r_ref)) / np.max(np.abs(r_ref)))
    c_ref = 0.5 * float(np.sum(r_ref * r_ref))
    err_c = abs(c_dev - c_ref) / c_ref
    log(f"[{card}] residual parity N={elements} ({n} rows): "
        f"max|dr|/max|r| {err_r:.3e} (tol {RESIDUAL_TOL:.0e}); cost "
        f"{c_dev:.9e} vs {c_ref:.9e}, rel {err_c:.3e} (tol {COST_TOL:.0e})")
    assert np.all(r_dev[n:] == 0.0), "zero-weight prior rows must vanish"
    assert err_r < RESIDUAL_TOL, f"residual parity {err_r:.3e}"
    assert err_c < COST_TOL, f"cost parity {err_c:.3e}"
    return {"residual": err_r, "cost": err_c}


def phase_configs(card, n_exp=1024, reps=5):
    """Phase 4: config 3 (OCP, AL path) and config 5 (batched path)."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from configs_bench import config3_pendulum, config5_batched

    wall, setup_s, d3 = config3_pendulum(reps)
    log(f"[{card}] config 3 swing-up (25 elements): compile+first run "
        f"{setup_s:.3f} s; wall median {wall:.6f} s; objective "
        f"{d3['objective']:.6f} (ref {C3_OBJECTIVE}), cviol {d3['cviol']:.3e}"
        f" (max {C3_CVIOL_MAX:.0e})")
    wall5, setup5, d5 = config5_batched(reps, n_exp)
    log(f"[{card}] config 5 batched ({n_exp} x 10 elements): compile+first "
        f"run {setup5:.3f} s; wall median {wall5:.6f} s; p_rel_err "
        f"{d5['p_rel_err']:.6f} (ref {C5_P_REL_ERR})")
    assert abs(d3["objective"] - C3_OBJECTIVE) <= C3_OBJECTIVE_RTOL * \
        C3_OBJECTIVE, f"config 3 objective {d3['objective']}"
    assert d3["cviol"] <= C3_CVIOL_MAX, f"config 3 cviol {d3['cviol']}"
    if n_exp == 1024:
        assert abs(d5["p_rel_err"] - C5_P_REL_ERR) <= C5_P_REL_ERR_ATOL, (
            f"config 5 p_rel_err {d5['p_rel_err']}")
    else:
        assert np.isfinite(d5["p_rel_err"]), "config 5 non-finite estimate"
    return d3, d5


def phase_four_cards(card, devices):
    """--four-cards: dp=2 x sp=2 multi-experiment and sp=4 sharded GN, each
    against the one-device solve in float64."""
    import jax

    from collocfem_tpu.parallel.parity import dp_sp_parity, sp_parity

    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    r_dp = dp_sp_parity(devices, dp=2, sp=2)
    log(f"[{card}] four-card dp=2 x sp=2 multi-experiment (f64): {r_dp} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    t0 = time.perf_counter()
    r_sp = sp_parity(devices, k=1024)
    log(f"[{card}] four-card sp=4 sharded GN (f64): {r_sp} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    return r_dp, r_sp


def run_phases(four_cards=False):
    """Phases 1-4 (or the four-card phase) in this process; prints the
    device record behind DEVICE_TAG for the parent."""
    from collocfem_tpu.utils.cache import enable_persistent_cache

    t_start = time.perf_counter()
    devs, card = phase_device()
    enable_persistent_cache()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{card}] phase {name} done in {time.perf_counter() - t0:.1f} s"
            f" ({time.perf_counter() - t_start:.1f} s since start)")
        return out

    if four_cards:
        if len(devs) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devs)}")
        timed("four-cards", phase_four_cards, card, devs[:4])
        count = 4
    else:
        timed("headline", phase_headline, card)
        timed("chain parity", phase_chain_parity, card)
        timed("residual parity", phase_residual_parity, card)
        timed("configs", phase_configs, card)
        count = 1
    log(DEVICE_TAG + json.dumps({"platform": devs[0].platform,
                                 "kind": devs[0].device_kind,
                                 "count": count}))


def _run_child(args):
    """Run phases in a child process, echo its output, return its device
    record (or exit with its code)."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phases"] + args,
        stdout=subprocess.PIPE, text=True, cwd=ROOT,
    )
    device = None
    for line in proc.stdout:
        if line.startswith(DEVICE_TAG):
            device = json.loads(line[len(DEVICE_TAG):])
        else:
            print(line, end="", flush=True)
    rc = proc.wait()
    if rc != 0 or device is None:
        raise SystemExit(f"chip_smoke phases failed (exit code {rc})"
                         if rc else "chip_smoke phases gave no device record")
    return device


def phase_gpu_tests():
    """Phase 5: the card-only tests (pytest -m gpu) in their own process."""
    env = dict(os.environ, COLLOCFEM_TEST_PLATFORM="gpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests", "-q",
         "-p", "no:cacheprovider"],
        cwd=ROOT, env=env, capture_output=True, text=True,
    )
    print(proc.stdout[-4000:], end="", flush=True)
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    if proc.returncode != 0 or "passed" not in summary or "skipped" in summary:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"card-only tests failed: {summary!r}")
    log(f"card-only tests: {summary}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four_cards = "--four-cards" in argv
    if "--phases" in argv:
        sys.path.insert(0, ROOT)
        run_phases(four_cards)
        return
    device = _run_child(["--four-cards"] if four_cards else [])
    if not four_cards:
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
