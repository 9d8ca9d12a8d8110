"""CPU-reference walls for BASELINE.json configs 2 and 5.

Counterparts of ``benchmarks/configs_bench.py`` (the device side) measured on
the reference-architecture scipy pipeline, so the per-config speedup rows
in BASELINE.md compare identical problems doing identical fixed work:

  2. Duffing joint MAP state-path + parameter estimation, N=1000 x degree
     4, 25 LM iterations — hand-coded numpy derivatives (the reference
     lineage generates these symbolically, SURVEY.md §2a "Model codegen")
     scattered into one global scipy.sparse system + SuperLU, exactly like
     the headline pipeline.
  5. Batched multi-experiment estimation (shared parameters), 15 LM
     iterations — implemented the way SURVEY.md §3.5 describes the
     reference's stronger mode: block-diagonal stacking of all experiments
     into ONE sparse system (experiment chains decoupled in V, coupled
     only through the shared-parameter arrowhead columns), NOT a slow
     Python loop per experiment.  Same data, same initial guess, and the
     same p-prior as the device run (seeded generator shared through
     ``make_config5_data``).

Writes ``baseline_cpu/configs_results.json`` and prints one JSON line per
config.  Usage: python -m baseline_cpu.configs_baseline [--configs 2,5]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import types

import numpy as np

from baseline_cpu.pipeline import (
    BaselineProblem,
    VdPModelNP,
    gauss_newton_baseline,
)
from collocfem_tpu.ops.mesh import uniform_mesh
from collocfem_tpu.problem import group_measurements


class DuffingModelNP:
    """Duffing oscillator with hand-coded numpy derivatives.

    Mirrors collocfem_tpu.models.Duffing: p = [alpha, beta, delta], known
    forcing gamma*cos(omega*t), measured output x1.
    """

    nx, nu, nq, ny = 2, 0, 3, 1

    def __init__(self, gamma=8.0, omega=0.5):
        self.gamma = float(gamma)
        self.omega = float(omega)

    def f(self, X, U, p, t):
        del U
        x1, x2 = X[..., 0], X[..., 1]
        alpha, beta, delta = p
        force = self.gamma * np.cos(self.omega * np.asarray(t))
        return np.stack(
            [x2, -delta * x2 - alpha * x1 - beta * x1**3 + force], -1
        )

    def dfdx(self, X, U, p, t):
        x1, x2 = X[..., 0], X[..., 1]
        alpha, beta, delta = p
        z, o = np.zeros_like(x1), np.ones_like(x1)
        row0 = np.stack([z, o], -1)
        row1 = np.stack([-alpha - 3.0 * beta * x1**2, -delta * o], -1)
        return np.stack([row0, row1], -2)

    def dfdp(self, X, U, p, t):
        x1, x2 = X[..., 0], X[..., 1]
        z = np.zeros_like(x1)
        row0 = np.stack([z, z, z], -1)
        row1 = np.stack([-x1, -(x1**3), -x2], -1)
        return np.stack([row0, row1], -2)

    def h(self, X, U, p, t):
        return X[..., :1]

    def dhdx(self, X, U=None, p=None):
        out = np.zeros(X.shape[:-1] + (1, 2))
        out[..., 0, 0] = 1.0
        return out


# --------------------------------------------------------------------------
# Config 5 shared data generation (imported by benchmarks/configs_bench.py
# so CPU and device measure the IDENTICAL problem).
# --------------------------------------------------------------------------

C5_MU_TRUE, C5_B_TRUE, C5_TF = 1.3, 0.5, 8.0


def make_config5_data(n_exp, elements=10, seed=1):
    """Simulated multi-experiment VdP data: (mesh, t_meas, y_all (E,S,1),
    u_nodes_all (E,N,d+1,1)).  The simulation itself is plain numpy, but
    the mesh comes from collocfem_tpu.ops.mesh (imported at module top),
    so this module — like the rest of baseline_cpu — does require a
    working jax install; sharing the mesh object is what guarantees CPU
    and device measure bit-identical problems."""
    mesh = uniform_mesh(0.0, C5_TF, elements, 4)
    t_meas = np.linspace(0.05, C5_TF - 0.05, 8 * elements)
    rng = np.random.default_rng(seed)
    x0s = rng.uniform(-2, 2, size=(n_exp, 2))
    freqs = rng.uniform(0.6, 1.4, size=n_exp)
    tt = np.linspace(0.0, C5_TF, 2001)
    dt = tt[1] - tt[0]
    x = x0s.copy()
    paths = np.empty((tt.size, n_exp, 2))
    paths[0] = x

    def f(x, t):
        u = np.sin(freqs * t)
        return np.stack(
            [x[:, 1],
             C5_MU_TRUE * (1 - x[:, 0] ** 2) * x[:, 1] - x[:, 0]
             + C5_B_TRUE * u],
            axis=1)

    for i in range(tt.size - 1):
        t = tt[i]
        k1 = f(x, t); k2 = f(x + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = f(x + 0.5 * dt * k2, t + 0.5 * dt); k4 = f(x + dt * k3, t + dt)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        paths[i + 1] = x

    y_all = np.empty((n_exp, t_meas.size, 1))
    for e in range(n_exp):
        y_all[e, :, 0] = np.interp(t_meas, tt, paths[:, e, 0])
    y_all += 0.01 * rng.standard_normal(y_all.shape)
    u_nodes_all = np.stack([
        np.sin(freqs[e] * mesh.elem_times)[..., None] for e in range(n_exp)
    ])
    return mesh, t_meas, y_all, u_nodes_all


def build_stacked_multi_experiment(mesh, t_meas, y_all, u_nodes_all,
                                   defect_weight=300.0, meas_weight=100.0,
                                   p_weight=1e-3):
    """Block-diagonal stacking: E decoupled experiment chains + shared-p
    arrowhead, as ONE BaselineProblem over a synthetic E*N-element "mesh"
    whose node indices carry a per-experiment offset.  All the existing
    vectorized residual/Jacobian/COO machinery then applies unchanged."""
    n_exp = y_all.shape[0]
    model = VdPModelNP()
    n, d = mesh.num_elements, mesh.degree
    yg_list = []
    for e in range(n_exp):
        yg, rg, mg, tg = group_measurements(mesh, t_meas, y_all[e])
        yg_list.append(yg)
    yg_all = np.concatenate(yg_list, axis=0)              # (E*N, S, ny)
    tile = lambda a: np.concatenate([a] * n_exp, axis=0)
    offsets = (np.arange(n_exp) * mesh.num_nodes)[:, None, None]
    stacked_idx = (mesh.elem_node_idx[None] + offsets).reshape(-1, d + 1)
    smesh = types.SimpleNamespace(
        basis=mesh.basis,
        widths=tile(mesh.widths),
        num_elements=n_exp * n,
        degree=d,
        elem_node_idx=stacked_idx,
        num_nodes=n_exp * mesh.num_nodes,
        elem_times=tile(mesh.elem_times),
    )
    w = mesh.basis.weights[1:]
    scale = np.sqrt(
        w[None, :, None] * tile(mesh.widths)[:, None, None] * 0.5
    ) * float(defect_weight)
    scale = np.broadcast_to(scale, (n_exp * n, d, model.nx))
    return BaselineProblem(
        model=model, mesh=smesh, y=yg_all, mrows=tile(rg), mmask=tile(mg),
        mtimes=tile(tg), u=u_nodes_all.reshape(-1, d + 1, model.nu),
        dscale=scale, meas_w=np.full(model.ny, float(meas_weight)),
        p_prior=np.zeros(model.nq),
        p_w=np.full(model.nq, float(p_weight)),
    )


class AircraftModelNP:
    """Short-period aircraft model with hand-coded numpy derivatives.

    Mirrors collocfem_tpu.models.AircraftLongitudinal: x = [alpha, q],
    u = [de], p = [Z_a, M_a, M_q, Z_d, M_d]; outputs [alpha, q, az] with
    az = V/g0 * (alpha' - q) reconstructed from the model — the az channel
    depends on p and u, which is why the pipeline carries dhdp.
    """

    nx, nu, nq, ny = 2, 1, 5, 3

    def __init__(self, V=60.0, g0=9.81):
        self.V = float(V)
        self.g0 = float(g0)

    def f(self, X, U, p, t):
        alpha, q = X[..., 0], X[..., 1]
        Za, Ma, Mq, Zd, Md = p
        de = U[..., 0]
        return np.stack(
            [Za * alpha + q + Zd * de, Ma * alpha + Mq * q + Md * de], -1
        )

    def dfdx(self, X, U, p, t):
        alpha = X[..., 0]
        Za, Ma, Mq, Zd, Md = p
        z, o = np.zeros_like(alpha), np.ones_like(alpha)
        row0 = np.stack([Za * o, o], -1)
        row1 = np.stack([Ma * o, Mq * o], -1)
        return np.stack([row0, row1], -2)

    def dfdp(self, X, U, p, t):
        alpha, q = X[..., 0], X[..., 1]
        de = U[..., 0]
        z = np.zeros_like(alpha)
        row0 = np.stack([alpha, z, z, de, z], -1)
        row1 = np.stack([z, alpha, q, z, de], -1)
        return np.stack([row0, row1], -2)

    def h(self, X, U, p, t):
        alpha, q = X[..., 0], X[..., 1]
        Za, Ma, Mq, Zd, Md = p
        de = U[..., 0]
        az = self.V / self.g0 * (Za * alpha + Zd * de)
        return np.stack([alpha, q, az], -1)

    def dhdx(self, X, U=None, p=None):
        Za = p[0]
        out = np.zeros(X.shape[:-1] + (3, 2))
        out[..., 0, 0] = 1.0
        out[..., 1, 1] = 1.0
        out[..., 2, 0] = self.V / self.g0 * Za
        return out

    def dhdp(self, X, U, p):
        alpha = X[..., 0]
        de = U[..., 0]
        out = np.zeros(X.shape[:-1] + (3, 5))
        out[..., 2, 0] = self.V / self.g0 * alpha
        out[..., 2, 3] = self.V / self.g0 * de
        return out


def run_config4(iters=40):
    """Aircraft output-error estimation, N=200 — CPU counterpart of
    benchmarks/configs_bench.config4_aircraft.  IDENTICAL data (the
    committed flight-record CSV), mesh, weights, initial guess, and fixed
    work (40 LM iterations)."""
    from collocfem_tpu.utils.io import load_measurements

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                        "aircraft_doublet.csv")
    t_meas, vals = load_measurements(path)
    y, u_rec = vals[:, :3], vals[:, 3]
    NOISE = np.array([0.002, 0.005, 0.05])
    mesh = uniform_mesh(0.0, 8.0, 200, 4)
    u_nodes = np.interp(mesh.elem_times, t_meas, u_rec)[..., None]
    base = BaselineProblem.build(
        mesh, t_meas, y, u_nodes, defect_weight=1e4,
        meas_weight=1.0 / NOISE, model=AircraftModelNP(V=60.0, g0=9.81),
    )
    V0 = np.zeros((mesh.num_nodes, 2))
    V0[:, 0] = np.interp(mesh.node_times, t_meas, y[:, 0])
    V0[:, 1] = np.interp(mesh.node_times, t_meas, y[:, 1])
    p0 = np.array([-1.0, -5.0, -1.0, -0.1, -5.0])

    t0 = time.perf_counter()
    V, p, info = gauss_newton_baseline(
        base, V0, p0, maxiter=iters, gtol=0.0, xtol=0.0
    )
    wall = time.perf_counter() - t0
    P_TRUE = np.array([-1.2, -8.0, -2.5, -0.15, -12.0])
    p_rel = float(np.max(np.abs(p / P_TRUE - 1.0)))
    return {
        "config": "aircraft_oe_n200", "backend": "scipy-SuperLU",
        "wall_s": round(wall, 4),
        "detail": {"elements": 200, "iters": info["iterations"],
                   "p_rel_err": p_rel},
    }


def run_config2(iters=25):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    from duffing_joint import (ALPHA, BETA, DELTA, GAMMA, MEAS_NOISE, OMEGA,
                               PROC_NOISE, TF, simulate_sde)

    rng = np.random.default_rng(7)
    ts, xs = simulate_sde(rng, TF)
    t_meas = np.linspace(0.05, TF - 0.05, 2000)
    y = np.interp(t_meas, ts, xs[:, 0])[:, None]
    y += MEAS_NOISE * rng.standard_normal(y.shape)
    mesh = uniform_mesh(0.0, TF, 1000, 4)
    base = BaselineProblem.build(
        mesh, t_meas, y, np.zeros((1000, 5, 0)),
        defect_weight=1.0 / PROC_NOISE, meas_weight=1.0 / MEAS_NOISE,
        model=DuffingModelNP(gamma=GAMMA, omega=OMEGA),
        p_prior=[0.0, 0.0, 0.0], p_weight=1e-3,
    )
    V0 = np.zeros((mesh.num_nodes, 2))
    V0[:, 0] = np.interp(mesh.node_times, t_meas, y[:, 0])
    p0 = np.array([0.5, 1.0, 0.5])

    t0 = time.perf_counter()
    V, p, info = gauss_newton_baseline(
        base, V0, p0, maxiter=iters, gtol=0.0, xtol=0.0
    )
    wall = time.perf_counter() - t0
    p_rel = float(np.max(np.abs(p / np.array([ALPHA, BETA, DELTA]) - 1.0)))
    return {
        "config": "duffing_joint_n1000", "backend": "scipy-SuperLU",
        "wall_s": round(wall, 4),
        "detail": {"elements": 1000, "iters": info["iterations"],
                   "p_rel_err": p_rel},
    }


def run_config5(n_exp=1024, elements=10, iters=15):
    mesh, t_meas, y_all, u_nodes_all = make_config5_data(n_exp, elements)
    base = build_stacked_multi_experiment(mesh, t_meas, y_all, u_nodes_all)
    V0 = np.zeros((n_exp * mesh.num_nodes, 2))
    for e in range(n_exp):
        sl = slice(e * mesh.num_nodes, (e + 1) * mesh.num_nodes)
        V0[sl, 0] = np.interp(mesh.node_times, t_meas, y_all[e, :, 0])
    p0 = np.array([2.0, 0.2])

    t0 = time.perf_counter()
    V, p, info = gauss_newton_baseline(
        base, V0, p0, maxiter=iters, gtol=0.0, xtol=0.0
    )
    wall = time.perf_counter() - t0
    p_rel = float(np.max(np.abs(
        p / np.array([C5_MU_TRUE, C5_B_TRUE]) - 1.0)))
    return {
        "config": f"batched_{n_exp}exp", "backend": "scipy-SuperLU",
        "wall_s": round(wall, 4),
        "detail": {"experiments": n_exp, "elements_each": elements,
                   "iters": info["iterations"],
                   "total_elements": n_exp * elements, "p_rel_err": p_rel},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="2,5")
    ap.add_argument("--experiments", type=int, default=1024)
    args = ap.parse_args()
    results = {}
    for key in args.configs.split(","):
        key = key.strip()
        if key == "2":
            res = run_config2()
        elif key == "4":
            res = run_config4()
        elif key == "5":
            res = run_config5(args.experiments)
        else:
            raise SystemExit(f"no CPU counterpart for config {key}")
        results[res["config"]] = res
        print(json.dumps(res), flush=True)
    path = os.path.join(os.path.dirname(__file__), "configs_results.json")
    existing = {}
    if os.path.exists(path):
        with open(path) as fh:
            existing = json.load(fh)
    existing.update(results)
    with open(path, "w") as fh:
        json.dump(existing, fh, indent=2)
        fh.write("\n")


if __name__ == "__main__":
    main()
