"""The port's Solver refuses what it cannot do, picks its step path from the
configuration alone, and its kernel wrappers never fall back.

* ``choose_step_path``: only CUDA, float32 and a uniform mesh take the
  kernel path (several devices run it as X strips).
* ``check_supported``: every physics option the port lacks raises
  NotImplementedError naming it, before anything runs.
* The kernel wrappers run the plain version only for CPU tensors; a tensor on
  any other non-CUDA device raises instead of computing anything.
* ``Solver()`` without a device runs on the GPU, and raises without CUDA.
* ``monitor_condition``, ``max_rms``, ``node_masks`` and ``needs_y_plus``
  follow the JAX package.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from openhyperflow2d_tpu.core import flags as fl
from openhyperflow2d_tpu.core import physics as jphys
from openhyperflow2d_tpu.core import state as jstate
from openhyperflow2d_tpu.core import step as jstep
from openhyperflow2d_tpu.examples import combustor_deck
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core import physics as tphys
from openhyperflow2d_torch.core import state as tstate
from openhyperflow2d_torch.core import step as tstep
from openhyperflow2d_torch.ops.fused_step import N_SCRATCH
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import (Solver, check_supported,
                                                 choose_step_path)


@pytest.mark.parametrize("args, use", [
    (("cuda", "float32", True), True),
    (("cpu", "float32", True), False),
    (("cuda", "float64", True), False),
    (("cuda", "float32", False), False),
    (("meta", "float32", True), False),
])
def test_choose_step_path(args, use):
    got, reason = choose_step_path(*args)
    assert got is use and reason


# the combustor's specialization (what build_case reports for that deck)
SUPPORTED = tstate.SolverParams(MaxX=8, MaxY=8, dx=1e-3, dy=1e-3,
                                sm=fl.SM_NS, models=("keps",), has_d2x=False,
                                has_d2y=False, has_nrbc=False,
                                has_ext_src=False)


@pytest.mark.parametrize("change, words", [
    # Euler decks, every closure, the k-eps variants, axisymmetric flow,
    # d2*-NULL soft BCs, NRBC, external sources, non-uniform meshes and
    # moving-wall sources are ported: accepted (words None)
    ({"sm": fl.SM_EULER}, None),
    ({"models": ("keps", "sa")}, None),
    ({"tem": fl.TEM_k_eps_Chien}, None),
    ({"ft": fl.FT_AXISYMMETRIC}, None),
    ({"uniform_mesh": False}, None),
    ({"has_d2y": True}, None),
    ({"has_nrbc": True}, None),
    ({"has_ext_src": True}, None),
    ({"isSrcAdd": True}, None),
    ({"chemistry": 2}, "chemistry model 2"),
])
def test_check_supported_names_what_is_missing(change, words):
    check_supported(SUPPORTED)
    if words is None:
        check_supported(dataclasses.replace(SUPPORTED, **change))
        return
    with pytest.raises(NotImplementedError, match=words.replace(
            "[", r"\[").replace("]", r"\]")):
        check_supported(dataclasses.replace(SUPPORTED, **change))


@pytest.fixture(scope="module")
def small_case():
    return build_case(combustor_deck(16, 40))


def test_kernel_wrappers_do_not_fall_back(small_case):
    solver = Solver(small_case, device="cpu", use_kernels=True)
    step, plan = solver.fused, solver.fused.plan
    X, Y = solver.params.MaxX, solver.params.MaxY

    def on(device):
        return (torch.zeros((31, X, Y), device=device),
                torch.zeros((31, X, Y), device=device),
                torch.zeros((N_SCRATCH, X, Y), device=device),
                torch.zeros((), device=device),
                torch.zeros(3, device=device))

    cin, cout, scr, dt, aux = on("meta")
    with pytest.raises(ValueError, match="mixed devices"):
        step.gfc(cin, cout, scr, dt, aux,
                 torch.zeros((plan.n_tiles, 2), dtype=torch.int32,
                             device="meta"))
    with pytest.raises(ValueError, match="mixed devices"):
        step.heat(cout, scr, dt)
    with pytest.raises(ValueError, match="mixed devices"):
        step.pass12(cin, cout, scr, dt, aux,
                    torch.zeros((plan.n_tiles, 27), device="meta"))
    assert all(n == 0 for n in step.launches.values())


def test_solver_runs_on_the_gpu_unless_asked(small_case, monkeypatch):
    """Solver() without a device means the GPU: where CUDA is absent it
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Solver(small_case)
    # the strip path's communicator holds its strips on the GPU by default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Solver(small_case, comm=LocalComm(2))
    assert Solver(small_case, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("mi", [0, 2, 5])
def test_monitor_condition_and_max_rms_match_jax(small_case, mi):
    """The exit test and the reported RMS follow the JAX Solver's rules for
    every MonitorIndex kind (max over equations, one equation, time)."""
    solver = Solver(small_case, device="cpu")
    solver.case = dataclasses.replace(small_case, MonitorIndex=mi,
                                      ExitMonitorValue=0.05)
    rng = np.random.default_rng(7)
    for _ in range(4):
        diags = {"RMS": rng.uniform(0.0, 0.1, (3, 9))}
        solver.global_time = float(rng.uniform(0.0, 0.1))
        ref = types.SimpleNamespace(case=solver.case,
                                    global_time=solver.global_time)
        assert solver.monitor_condition(diags) == \
            JSolver.monitor_condition(ref, diags)
        assert solver.max_rms(diags) == JSolver.max_rms(ref, diags)


def test_node_masks_and_needs_y_plus_match_jax(small_case):
    g = small_case.grid
    want = jphys.node_masks(jstate.meta_from_grid(g))
    got = tphys.node_masks(tstate.meta_from_grid(g))
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    for tem in (fl.TEM_k_eps_Std, fl.TEM_k_eps_Chien, fl.TEM_vanDriest):
        for models in (("keps",), ("prandtl",)):
            p = dataclasses.replace(small_case.params, tem=tem, models=models)
            assert tstep.needs_y_plus(p) == jstep.needs_y_plus(p)
