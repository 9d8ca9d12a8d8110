"""Multi-device parity checks: the dp x sp mesh paths against one device.

Two paths exist only across devices:

  * :func:`dp_sp_parity` — the multi-experiment solver with experiments
    sharded over "dp" (parameter-Schur ``psum``) and each experiment's chain
    sharded over "sp" (SPIKE interface ``all_gather``);
  * :func:`sp_parity` — the fully chain-sharded Gauss-Newton solver
    (``ppermute`` halo exchange + SPIKE) over an "sp"-only mesh.

Each runs a few LM steps on seeded Van der Pol data and compares the result
leaf for leaf with the same fixed work on one device.  Every dp shard gets
distinct experiments, so a cross-shard indexing error changes the answer.
Run them in float64 (``jax_enable_x64``): the bounds are f64 round-off
bounds, and the collectives must agree with the local solver to that level.
"""

from __future__ import annotations

import numpy as np

# Parity bounds (f64): the sharded paths reorder sums (psum, SPIKE
# interface elimination) but do the same arithmetic, so after a few LM
# steps they agree with the one-device solve to round-off amplified by the
# KKT conditioning at K ~ 10^3.
DP_P_BOUND = 1e-9
SP_P_BOUND = 1e-8


def vdp_problem(num_elements, degree=2, seed=0, n_exp=1, dtype=None):
    """VdP estimation problem on [0, 10] with ``n_exp`` seeded experiments.

    Each experiment gets its own signal frequency, phase, forcing and noise
    drawn from ``seed``.  Returns (problem, z0 list, data list).
    """
    from collocfem_tpu.models import VanDerPol
    from collocfem_tpu.ops.mesh import uniform_mesh
    from collocfem_tpu.problem import EstimationProblem

    tf = 10.0
    mesh = uniform_mesh(0.0, tf, num_elements, degree)
    t_meas = np.linspace(0.05, tf - 0.05, max(3 * num_elements, 30))
    prob = EstimationProblem.build(
        VanDerPol(), mesh, t_meas, defect_weight=100.0, dtype=dtype
    )
    rng = np.random.default_rng(seed)
    z0s, datas = [], []
    for _ in range(n_exp):
        freq = rng.uniform(0.7, 1.3)
        phase = rng.uniform(0.0, np.pi)
        y = (np.sin(freq * t_meas + phase)[:, None]
             + 0.05 * rng.standard_normal((t_meas.size, 1)))
        u_nodes = np.sin(rng.uniform(0.6, 1.2) * mesh.elem_times)[..., None]
        datas.append(prob.pack_data(y, t_meas, u_nodes=u_nodes))
        z0s.append(prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5]))
    return prob, z0s, datas


def _max_abs_diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def dp_sp_parity(devices, dp, sp, seed=0):
    """dp x sp multi-experiment solve vs the same batch on one device.

    Two distinct experiments per dp shard, K = 512 blocks per experiment,
    5 LM steps.  Returns a dict of the parity errors; raises AssertionError
    when the state is non-finite or the parameter error exceeds
    :data:`DP_P_BOUND`.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from collocfem_tpu.parallel.batch import (
        BatchDecision,
        make_multi_experiment_solver,
    )
    from collocfem_tpu.parallel.meshes import DP_AXIS, SP_AXIS, make_device_mesh
    from collocfem_tpu.parallel.spike import spike_chain_solver
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import SolveStats

    dev_mesh = make_device_mesh(dp=dp, sp=sp, devices=devices)
    n_exp = 2 * dp
    prob, z0s, datas = vdp_problem(511, seed=seed, n_exp=n_exp)
    k = prob.mesh.num_blocks
    data_batch = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *datas)
    z0 = BatchDecision(V=jnp.stack([z.V for z in z0s]), p=z0s[0].p)
    p_prior = jnp.zeros_like(z0.p)
    p_w = jnp.zeros_like(z0.p)
    opts = SolverOptions(maxiter=5, gtol=0.0)

    chain = spike_chain_solver(k, sp, axis_name=SP_AXIS) if sp > 1 else None
    solve = make_multi_experiment_solver(
        prob, opts, dp_axis=DP_AXIS, chain_solver=chain,
    )
    step = jax.jit(
        jax.shard_map(
            solve,
            mesh=dev_mesh,
            in_specs=(
                BatchDecision(V=P(DP_AXIS), p=P()),
                jax.tree_util.tree_map(lambda _: P(DP_AXIS), data_batch),
                P(),
                P(),
            ),
            out_specs=(
                BatchDecision(V=P(DP_AXIS), p=P()),
                SolveStats(*([P()] * 6)),
            ),
            check_vma=True,
        )
    )
    z, stats = step(z0, data_batch, p_prior, p_w)
    jax.block_until_ready(z)
    assert bool(jnp.all(jnp.isfinite(z.V))), "non-finite dp x sp state"
    assert bool(jnp.all(jnp.isfinite(z.p))), "non-finite dp x sp params"

    z_one, _ = make_multi_experiment_solver(prob, opts)(
        z0, data_batch, p_prior, p_w
    )
    err_p = _max_abs_diff(z.p, z_one.p)
    err_v = _max_abs_diff(z.V, z_one.V)
    assert err_p < DP_P_BOUND, f"dp x sp parameter parity {err_p:.3e}"
    return {"dp": dp, "sp": sp, "blocks": k, "experiments": n_exp,
            "steps": 5, "cost": float(stats.cost), "err_p": err_p,
            "err_V": err_v, "bound_p": DP_P_BOUND}


def sp_parity(devices, k=1024, seed=0):
    """Chain-sharded GN over all ``devices`` ("sp") vs the one-device GN.

    K blocks (K must split into >= 2 blocks per shard), 6 LM steps.
    Returns a dict of the parity errors; raises AssertionError when the
    state is non-finite or the parameter error exceeds :data:`SP_P_BOUND`.
    """
    import jax
    import jax.numpy as jnp

    from collocfem_tpu.parallel.meshes import make_device_mesh
    from collocfem_tpu.parallel.sharded import make_sp_gn_solver
    from collocfem_tpu.solve import SolverOptions
    from collocfem_tpu.solve.newton import make_gn_solver

    sp = len(devices)
    if k % sp or k // sp < 2:
        raise ValueError(f"K={k} does not split into >= 2 blocks on {sp} "
                         "devices")
    mesh = make_device_mesh(dp=1, sp=sp, devices=devices)
    prob, (z0,), (data,) = vdp_problem(k - 1, seed=seed)
    opts = SolverOptions(maxiter=6, gtol=0.0)
    z, stats = make_sp_gn_solver(prob, mesh, opts)(z0, data)
    jax.block_until_ready(z)
    assert bool(jnp.all(jnp.isfinite(z.V))), "non-finite sp-sharded state"
    z_ref, _ = make_gn_solver(prob, opts)(z0, data)
    err_p = _max_abs_diff(z.p, z_ref.p)
    err_v = _max_abs_diff(z.V, z_ref.V)
    assert err_p < SP_P_BOUND, f"sp-sharded parameter parity {err_p:.3e}"
    return {"sp": sp, "blocks": k, "steps": 6, "cost": float(stats.cost),
            "err_p": err_p, "err_V": err_v, "bound_p": SP_P_BOUND}
