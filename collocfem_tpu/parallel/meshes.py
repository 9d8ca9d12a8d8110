"""Device-mesh construction policy — the rebuild's "communication backend".

SURVEY.md §2c: the reference has no distributed backend at all (single CPU
process); here the backend *is* the sharding policy — XLA inserts the
all-reduce/ppermute/all-gather collectives from mesh + sharding
annotations.  This module is the single place where axis names and their
meaning are defined:

  axis "dp" — data parallel over independent experiments (BASELINE.json
              config 5, 1024 trajectories).  The only cross-shard traffic
              is the tiny shared-parameter Schur complement psum.
  axis "sp" — sequence/element-chain parallel over the collocation time
              mesh (the CP analogue, SURVEY.md §5).  Exchanges halo and
              interface blocks every solve.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

DP_AXIS = "dp"
SP_AXIS = "sp"


def make_device_mesh(dp: int = 1, sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) device mesh.

    Devices fill the grid in ``jax.devices()`` order with ``sp`` minor, so
    consecutive devices hold consecutive element-chain shards.  No topology
    ordering is needed on cards joined all to all (NVLink within one host):
    every pair of devices is one hop apart.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if dp * sp > devices.size:
        raise ValueError(
            f"mesh dp={dp} x sp={sp} needs {dp * sp} devices, "
            f"have {devices.size}"
        )
    grid = devices[: dp * sp].reshape(dp, sp)
    return Mesh(grid, (DP_AXIS, SP_AXIS))
