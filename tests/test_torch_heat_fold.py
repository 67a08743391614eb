"""The heat stage folded into pass12's general body (ops/fused_step.py
``FusedStep.pass12``; csrc/fused_step.cu ``heat_source``,
``pass12_direct``).

The fold computes a node's SrcAdd[rhoE] inside pass12 instead of reading
the plane that ``heat_kernel`` wrote between gfc and pass12.  It is legal
when pass12 writes nothing the heat stage reads, and when every node the
heat stage writes runs pass12's general body.  These tests hold that on
the CPU, through the kernels' plain versions, on the two decks of
tests/test_torch_kernel_path_heat.py (``reacting_rans_deck(48, 40,
wall_bottom=True, adiabatic=False, with_step=True)`` and
``combustor_deck(64, 256, with_step=True, adiabatic=False)``) and on the
Euler cylinders with conducting walls (``cylinders_deck(64, 48)``,
isAdiabaticWall=0: every tile general, lam_t the chunk-constant plane), on
the 64x256 step deck with the RNG k-eps variant (TurbExtModel=8: gfc in
the closures' form, gfc_keps_var_kernel), on the 64x256 step deck with
FlowType=1 (gfc and pass12 in their extended forms, F in the scratch) and
on the airfoil with conducting walls (``airfoil_deck(128, 128)``,
isAdiabaticWall=0: a solid body inside the spec set),
each as a single domain and as ``LocalComm(2, "cpu")`` X strips:

* (a) gfc_plain, then heat_plain before pass12_plain and again after it,
  on the same buffers: the two SrcAdd planes are bitwise equal, and
  pass12_plain left gfc's Tg (in ``cout``) and lam_eff (scratch plane
  SCR_LAM_EFF) untouched; the folded pass12_plain gives the separate
  form's (``heat_src`` = the plane heat_plain wrote) S, beta and partials
  bit for bit.
* (b) every node with an hw_* bit (a wall gas node, where the stage
  writes) lies in a general tile, never in a spec tile, strip plans with
  their halos included.
* (c) an iteration's launches, read from the wrappers' planning
  (``FusedStep.iteration_launches``, no CUDA needed) and from the chunk's
  calls: with the fold no ``heat_kernel``, and the dual form exactly
  ``gfc_kernel<dual>`` and ``pass12_kernel<dual>``; the chunk never calls
  the heat wrapper.

The port's kernel path (the fold included) stays held against JAX's Pallas
path, interpret mode, float64, by tests/test_torch_kernel_path_heat.py at
its tolerances: fields 1e-10 of each plane's scale, beta by
torch_parity.beta_err at rtol 1e-6, atol 3e-6, RMS and dt_used rtol 1e-10,
DD_max 1e-8, on the 64x256 deck's second cycle fields 1e-7, beta rtol =
atol = 1e-3 and DD_max 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from openhyperflow2d_torch.examples import (airfoil_deck, combustor_deck,
                                            cylinders_deck,
                                            reacting_rans_deck)
from openhyperflow2d_torch.ops.fused_step import (DISPATCH_FORMS,
                                                  SCR_LAM_EFF, SCR_SRCADD_E,
                                                  TILE, carry_views,
                                                  n_scratch, scan_dt)
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

DECKS = {
    "rans_step_heat": lambda: reacting_rans_deck(
        48, 40, wall_bottom=True, adiabatic=False, with_step=True),
    "combustor_step_heat": lambda: combustor_deck(
        64, 256, with_step=True, adiabatic=False),
    "euler_cylinders_heat": lambda: _conducting(cylinders_deck(64, 48)),
    "combustor_step_heat_rng": lambda: _rng(combustor_deck(
        64, 256, with_step=True, adiabatic=False)),
    "combustor_step_heat_axisym": lambda: _axisym(combustor_deck(
        64, 256, with_step=True, adiabatic=False)),
    "airfoil_heat": lambda: _conducting(airfoil_deck(128, 128)),
}


def _conducting(deck):
    """An Euler deck with conjugate heat at its walls."""
    deck.data["isAdiabaticWall"] = "0"
    return deck


def _rng(deck):
    """The deck with the RNG k-eps variant: gfc runs gfc_keps_var_kernel's
    plain version, pass12 the folded heat stage as on the standard deck."""
    deck.data["TurbExtModel"] = "8"
    return deck


def _axisym(deck):
    """The deck with FlowType=1: gfc and pass12 run their extended forms'
    plain versions (the F planes), pass12 the folded heat stage."""
    deck.data["FlowType"] = "1"
    return deck
LAYOUTS = ("single", "strips")
TG = 21   # carry plane of Tg (CARRY_FIELDS)
WARM = 4  # iterations before the one checked, so that the walls conduct


@functools.lru_cache(maxsize=None)
def case(deck):
    return build_case(DECKS[deck]())


@functools.lru_cache(maxsize=None)
def warmed(deck, layout):
    """A kernel-path solver on the CPU after WARM iterations."""
    comm = LocalComm(2, "cpu") if layout == "strips" else None
    s = Solver(case(deck), device="cpu", use_kernels=True, comm=comm)
    s.run_iters(WARM)
    return s


def steps_and_inputs(solver):
    """[(FusedStep, carry, frozen dt, scalar rows)] of one iteration from
    the solver's state: the single domain's, or each strip's (extended
    carry, halos filled, dt frozen across the strips)."""
    chunk = solver._chunk_fn
    if solver.comm is None:
        ca, _, raw, kaux = chunk.prologue(solver.state, 2, solver.last_iter)
        dt = scan_dt(carry_views(ca, solver.state.dt), chunk.step.ctx.active,
                     solver.params, raw.cfl_scen[0])
        return [(chunk.step, ca, dt, kaux)]
    ca, _, raw, kaux = chunk.start(solver.state, 2, solver.last_iter)
    dt = chunk.frozen_dt(ca, solver.state.strips[0].dt, raw.cfl_scen[0])
    return [(st, c, dt, kaux) for st, c in zip(chunk.steps, ca)]


def buffers(ca, step):
    """NaN-filled cout and scratch (an unwritten value shows; the F planes
    of an axisymmetric deck after the 31), zeroed per-tile partials."""
    nan = float("nan")
    plan = step.plan
    return (torch.full_like(ca, nan),
            torch.full((n_scratch(step.params),) + ca.shape[1:], nan,
                       dtype=ca.dtype),
            torch.zeros((plan.n_tiles, 2), dtype=torch.int32),
            torch.zeros((plan.n_tiles, 27), dtype=ca.dtype))


def bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def same_bits(a, b) -> bool:
    return torch.equal(bits(a), bits(b))


def heat_steps(deck, layout):
    out = [x for x in steps_and_inputs(warmed(deck, layout))
           if x[0].has_heat]
    assert out, "no domain of the deck runs the heat stage"
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_fold_is_legal(deck, layout):
    """(a) pass12 writes nothing the heat stage reads, so heat computed
    before pass12 equals heat computed after it, and the folded pass12
    gives the separate form's bits."""
    for step, ca, dt, kaux in heat_steps(deck, layout):
        cout, scr, part_i, part_f = buffers(ca, step)
        step.gfc_plain(ca, cout, scr, dt, kaux[0], part_i)
        step.heat_plain(cout, scr, dt)
        before = scr[SCR_SRCADD_E].clone()
        assert bool((before != 0).any()), "the heat source is zero"
        tg, lam_eff = cout[TG].clone(), scr[SCR_LAM_EFF].clone()
        out = {}
        for fold in (False, True):
            c2, pf = cout.clone(), part_f.clone()
            step.pass12_plain(ca, c2, scr, dt, kaux[1], pf,
                              heat_src=None if fold else before)
            out[fold] = (c2[:18], pf)
            assert same_bits(c2[TG], tg)
            assert same_bits(scr[SCR_LAM_EFF], lam_eff)
            step.heat_plain(c2, scr, dt)
            assert same_bits(scr[SCR_SRCADD_E], before)
        for x, y in zip(out[True], out[False]):
            assert same_bits(x, y)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_heat_writes_only_in_general_tiles(deck, layout):
    """(b) every wall gas node (hw_*) lies in a general tile: pass12's spec
    body, which never computes heat, drops no heat source."""
    TX, TY = TILE
    for step, _, _, _ in heat_steps(deck, layout):
        c = step.ctx
        hw = (c.hw_down | c.hw_up | c.hw_left | c.hw_right).cpu().numpy()
        i, j = np.nonzero(hw)
        assert i.size
        assert not step.plan.spec[i // TX, j // TY].any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dispatch", DISPATCH_FORMS)
def test_folded_iteration_launches(dispatch, layout):
    """(c) on the 64x256 step deck an iteration plans no heat_kernel (the
    heat stage runs folded into pass12), and the dual form plans exactly
    its two kernels; the chunk never calls the heat wrapper."""
    comm = LocalComm(2, "cpu") if layout == "strips" else None
    s = Solver(case("combustor_step_heat"), device="cpu", use_kernels=True,
               dispatch=dispatch, comm=comm)
    steps = s._chunk_fn.steps if comm else [s.fused]
    calls = []
    for st in steps:
        st.heat = lambda *a, st=st: calls.append(st)
        planned = st.iteration_launches()
        assert "heat_kernel" not in planned
        if dispatch == "dual":
            assert planned == ["gfc_kernel<dual>", "pass12_kernel<dual>"]
        else:
            # the spec tiles' gfc and pass12 in one launch
            # (step_spec_kernel), each general list's two launches
            general, spec = ("general" in st._bodies(),
                             "spec" in st._bodies())
            assert planned == (["gfc_kernel<general>"] * general
                               + ["step_spec_kernel"] * spec
                               + ["pass12_kernel<general>"] * general)
    assert any(st.has_heat for st in steps)
    s.run_iters(3)
    assert calls == []
