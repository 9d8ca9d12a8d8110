"""KKT method selection: 'auto' is the cyclic reduction, and a name that is
not a known chain solver (e.g. the removed 'spike') raises at build time in
every driver instead of selecting another solver."""

import dataclasses

import jax
import numpy as np
import pytest

from collocfem_tpu.models import Pendulum, VanDerPol
from collocfem_tpu.ocp import OptimalControlProblem
from collocfem_tpu.ops.mesh import uniform_mesh
from collocfem_tpu.problem import EstimationProblem
from collocfem_tpu.solve import (
    BoundedOptions,
    SolverOptions,
    make_bounded_solver,
    make_bounds,
    make_constrained_solver,
    make_gn_solver,
)
from collocfem_tpu.solve.auglag import ALBarrierOptions, make_ocp_solver
from collocfem_tpu.solve.constrained import ConstrainedOptions
from collocfem_tpu.solve.kkt import METHODS, resolve_method


def _vdp(num_elements=6):
    mesh = uniform_mesh(0.0, 4.0, num_elements, 2)
    t_meas = np.linspace(0.05, 3.95, 24)
    return EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=30.0), t_meas


def _build_gn(method):
    make_gn_solver(_vdp()[0], SolverOptions(method=method))


def _build_ocp(method):
    model = Pendulum(m=1.0, l=0.5, grav=9.81, u_max=2.0)
    prob = OptimalControlProblem.build(
        model, uniform_mesh(0.0, 2.5, 4, 2), x0=[0.0, 0.0], xf=[np.pi, 0.0]
    )
    make_ocp_solver(prob, ALBarrierOptions(method=method))


def _build_bounded(method):
    prob = _vdp()[0]
    make_bounded_solver(prob, make_bounds(prob, p_lo=[0.0, 0.0]),
                        BoundedOptions(method=method))


def _build_constrained(method):
    make_constrained_solver(_vdp()[0], ConstrainedOptions(method=method),
                            g_param=lambda p: p[:1] - 10.0)


@pytest.mark.parametrize(
    "build", [_build_gn, _build_ocp, _build_bounded, _build_constrained],
    ids=["gn", "ocp", "bounded", "constrained"],
)
def test_method_spike_raises(build):
    with pytest.raises(ValueError, match="unknown KKT method 'spike'"):
        build("spike")


def test_auto_resolves_to_cr():
    assert resolve_method("auto") == "cr"
    for name in METHODS:
        assert resolve_method(name) == name
    with pytest.raises(ValueError):
        resolve_method("pallas")


def test_auto_matches_explicit_cr_end_to_end():
    prob, t_meas = _vdp(num_elements=8)
    y = np.sin(t_meas)[:, None]
    data = prob.pack_data(y, t_meas)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
    opts = SolverOptions(maxiter=4, gtol=0.0)
    z_auto, st_auto = make_gn_solver(prob, opts)(z0, data)
    z_cr, st_cr = make_gn_solver(
        prob, dataclasses.replace(opts, method="cr"))(z0, data)
    for a, b in zip(jax.tree_util.tree_leaves((z_auto, st_auto)),
                    jax.tree_util.tree_leaves((z_cr, st_cr))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
