"""Parallelism layer (SURVEY.md §2c / §5): on-device analogues of the
distributed strategies the reference lacks (it is a single-process CPU code).

  * ``collocfem_tpu.parallel.meshes``  — device-mesh construction policy
    (the "comm backend" deliverable of SURVEY.md §2c: the interconnect is
    reached only through jax.sharding meshes and XLA's collectives; there
    is no hand-written NCCL/MPI tier).
  * ``collocfem_tpu.parallel.spike``   — element-chain (time-mesh) sharding
    of the block-tridiagonal KKT solve: SPIKE/substructuring with interface
    Schur complements exchanged between devices — the CP/ring analogue.
  * ``collocfem_tpu.parallel.batch``   — multi-experiment data parallelism:
    per-experiment GN systems solved in-shard, shared-parameter Schur
    complement reduced with ``psum`` — the DP analogue.
"""

from collocfem_tpu.parallel.meshes import make_device_mesh
from collocfem_tpu.parallel.sharded import make_sp_gn_solver
from collocfem_tpu.parallel.spike import (
    blocktri_solve_spike,
    spike_chain_solver,
    spike_sharded_solver,
)

__all__ = [
    "make_device_mesh",
    "blocktri_solve_spike",
    "spike_chain_solver",
    "spike_sharded_solver",
    "make_sp_gn_solver",
]
