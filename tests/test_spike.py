"""Element-chain sharded SPIKE solve vs single-device solvers on the
virtual 8-device CPU mesh (SURVEY.md §4 "fake backend" analogue)."""

import jax.numpy as jnp
import numpy as np
import pytest

from collocfem_tpu.parallel.meshes import make_device_mesh
from collocfem_tpu.parallel.spike import spike_sharded_solver
from test_blocktri import dense_reference, random_spd_blocktri


@pytest.mark.parametrize(
    "k,b,r",
    [
        (16, 4, 3),
        pytest.param(32, 8, 1, marks=pytest.mark.slow),
        pytest.param(64, 3, 9, marks=pytest.mark.slow),
    ],
)
def test_spike_matches_dense(eight_devices, k, b, r):
    mesh = make_device_mesh(dp=1, sp=8, devices=eight_devices)
    d_np, e_np, g_np = random_spd_blocktri(k, b, r, seed=k + b)
    want = dense_reference(d_np, e_np, g_np)
    with mesh:
        solve = spike_sharded_solver(mesh)
        got = np.asarray(solve(jnp.asarray(d_np), jnp.asarray(e_np), jnp.asarray(g_np)))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


@pytest.mark.slow  # edge-geometry twin; the fast tier keeps the
# (16,4,3) dense match and the 2-D dp x sp mesh case
def test_spike_two_blocks_per_shard(eight_devices):
    mesh = make_device_mesh(dp=1, sp=8, devices=eight_devices)
    d_np, e_np, g_np = random_spd_blocktri(16, 5, 2, seed=3)
    want = dense_reference(d_np, e_np, g_np)
    with mesh:
        got = np.asarray(
            spike_sharded_solver(mesh)(
                jnp.asarray(d_np), jnp.asarray(e_np), jnp.asarray(g_np)
            )
        )
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


@pytest.mark.slow  # 8-device shard_map compile; dp x sp interaction is
# also exercised by __graft_entry__.dryrun_multichip at K=512
def test_spike_on_2d_mesh_with_dp(eight_devices):
    """SPIKE over sp while dp batches independent systems via vmap outside."""
    mesh = make_device_mesh(dp=2, sp=4, devices=eight_devices)
    d_np, e_np, g_np = random_spd_blocktri(32, 4, 2, seed=11)
    want = dense_reference(d_np, e_np, g_np)
    with mesh:
        got = np.asarray(
            spike_sharded_solver(mesh)(
                jnp.asarray(d_np), jnp.asarray(e_np), jnp.asarray(g_np)
            )
        )
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
