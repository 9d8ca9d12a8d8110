"""collocfem_tpu — on-device collocation-FEM estimation & trajectory optimization.

A ground-up JAX/XLA re-design of the capabilities of the research code
``dimasad/colloc-fem-code`` (direct LGL collocation for ODE-constrained
parameter estimation, joint MAP state-path estimation, and trajectory
optimization).  Design blueprint: ``SURVEY.md`` at the repo root.  No file:line
citations into the reference are possible: the ``/root/reference`` mount was
empty when surveyed and when this package was built (SURVEY.md §0).

Layer map (SURVEY.md §1 → this package):
  L1  basis       ``collocfem_tpu.ops.basis``     LGL nodes/weights/D-matrix
  L2  mesh        ``collocfem_tpu.ops.mesh``      elements, global DOF indexing
  L3  models      ``collocfem_tpu.model`` + ``collocfem_tpu.models.*``
  L4  assembly    ``collocfem_tpu.ops.residual`` / ``collocfem_tpu.ops.assemble``
                  (vmapped per-element residuals; jacfwd → block-tridiagonal
                  + arrowhead Gauss–Newton KKT, no global sparse matrix)
  L5  solvers     ``collocfem_tpu.solve.*`` (cyclic-reduction block solve,
                  jitted Levenberg/GN/IRLS loop, augmented-Lagrangian barrier)
  §5  parallel    ``collocfem_tpu.parallel.*`` (element-chain sharding — the
                  CP analogue; experiment batching — the DP analogue)
"""

from collocfem_tpu.model import Model
from collocfem_tpu.model_sym import symbolic_model
from collocfem_tpu.ocp import OptimalControlProblem
from collocfem_tpu.ocp_time import FreeTimeModel, free_time_ocp
from collocfem_tpu.ops.basis import LGLBasis, make_basis
from collocfem_tpu.ops.mesh import (
    Mesh,
    interpolate_trajectory,
    refined_mesh,
    uniform_mesh,
)
from collocfem_tpu.problem import Decision, EstimationProblem, ProblemData

__version__ = "0.1.0"

__all__ = [
    "Model",
    "symbolic_model",
    "LGLBasis",
    "make_basis",
    "Mesh",
    "uniform_mesh",
    "refined_mesh",
    "interpolate_trajectory",
    "EstimationProblem",
    "ProblemData",
    "Decision",
    "OptimalControlProblem",
    "FreeTimeModel",
    "free_time_ocp",
    "__version__",
]
