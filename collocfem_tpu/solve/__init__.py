"""Solver layer (L5): block-structured KKT solves + on-device outer loops
(SURVEY.md §1 L5, §2b: the on-device replacement for scipy/UMFPACK sparse
factorization and for IPOPT on inequality-constrained problems)."""

from collocfem_tpu.solve.covariance import (
    element_covariance,
    parameter_covariance,
    parameter_std,
    state_covariance_nodes,
    state_std,
    trajectory_std,
)
from collocfem_tpu.solve.auglag import (
    ALBarrierOptions,
    OCPStats,
    make_ocp_solver,
    solve_ocp,
)
from collocfem_tpu.solve.bounds import (
    BoundedOptions,
    BoundedStats,
    Bounds,
    bounded_gauss_newton,
    make_bounded_solver,
    make_bounds,
    project_interior,
)
from collocfem_tpu.solve.constrained import (
    ConstrainedOptions,
    ConstrainedStats,
    constrained_gauss_newton,
    make_constrained_solver,
)
from collocfem_tpu.solve.blocktri import (
    blocktri_solve_cr,
    blocktri_solve_dense,
    blocktri_solve_scan,
)
from collocfem_tpu.solve.kkt import solve_kkt
from collocfem_tpu.solve.newton import (
    SolverOptions,
    SolveStats,
    gauss_newton,
    make_gn_solver,
)

__all__ = [
    "blocktri_solve_cr",
    "blocktri_solve_scan",
    "blocktri_solve_dense",
    "solve_kkt",
    "SolverOptions",
    "SolveStats",
    "gauss_newton",
    "make_gn_solver",
    "ALBarrierOptions",
    "OCPStats",
    "make_ocp_solver",
    "solve_ocp",
    "parameter_covariance",
    "parameter_std",
    "state_covariance_nodes",
    "state_std",
    "element_covariance",
    "trajectory_std",
    "Bounds",
    "BoundedOptions",
    "BoundedStats",
    "make_bounds",
    "project_interior",
    "make_bounded_solver",
    "bounded_gauss_newton",
    "ConstrainedOptions",
    "ConstrainedStats",
    "make_constrained_solver",
    "constrained_gauss_newton",
]
