"""Port parity: the conjugate wall-heat stage of non-adiabatic walls.

``calc_heat_on_wall_sources`` in both forms (from the StaticCtx visit masks
and with its own shifts), ``gfc`` and ``solver_step`` with the stage, and
the eager chunk over 12 iterations, on the walls+step+heat RANS deck in
float64 against the JAX package.

The stage is a fold of selects, products and one halving per solid node,
evaluated in the same order in both packages, so ``SrcAdd`` and ``Q_conv``
are held bitwise.  gfc and solver_step are held at rtol 1e-10 of each
plane's scale (test_torch_step.py's tolerance); the chunk at the kernel
path's chunk tolerances: fields 1e-10 of scale, beta by
torch_parity.beta_err.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import beta_err, np_fields, port_case, port_inputs, \
    scaled_err, to_np

from openhyperflow2d_tpu.core import physics as jphys
from openhyperflow2d_tpu.core import static_ctx as jctx
from openhyperflow2d_tpu.core import step as jstep
from openhyperflow2d_tpu.examples import reacting_rans_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core import physics as tphys
from openhyperflow2d_torch.core import static_ctx as tctx
from openhyperflow2d_torch.core import step as tstep
from openhyperflow2d_torch.solver.runner import Solver

PHYS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu", "mu_t"]


def heat_deck():
    return reacting_rans_deck(48, 40, wall_bottom=True, adiabatic=False,
                              with_step=True)


def close(got, want, what, rtol=1e-10):
    got, want = to_np(got), np.asarray(want)
    floor = rtol * max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


@pytest.fixture(scope="module")
def chunk12():
    """Both packages' eager chunk over the first 12 iterations of the deck:
    (JAX solver, its diags, port solver, its diags)."""
    jc = jinit.build_case(heat_deck())
    js = JSolver(jc)
    assert not js.params.isAdiabaticWall and js.params.has_walls
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    return js, js.run_iters(12), ts, ts.run_iters(12)


@pytest.fixture(scope="module")
def evolved(chunk12):
    """The JAX state after 12 iterations, and the port's inputs from it."""
    js = chunk12[0]
    return js, port_inputs(js)


def _aux(jsolver, it):
    p = jsolver.params
    ja = jstep.make_aux((jsolver.beta_xs, jsolver.beta_ys),
                        (jsolver.cfl_xs, jsolver.cfl_ys), p.TurbStartIter,
                        jnp.asarray(it), p.jdtype)
    tt = [torch.tensor(np.asarray(a)) for a in
          (jsolver.beta_xs, jsolver.beta_ys, jsolver.cfl_xs, jsolver.cfl_ys)]
    ta = tstep.make_aux((tt[0], tt[1]), (tt[2], tt[3]), p.TurbStartIter, it,
                        torch.float64)
    return ja, ta


@pytest.mark.parametrize("with_ctx", [True, False])
def test_calc_heat_on_wall_sources_bitwise(evolved, with_ctx):
    js, (ts, tm, tp, _) = evolved
    jc = jctx.build_static_ctx(js.meta, js.params) if with_ctx else None
    tc = tctx.build_static_ctx(tm, tp) if with_ctx else None
    want = jphys.calc_heat_on_wall_sources(js.state, js.meta, js.params,
                                           ctx=jc)
    got = tphys.calc_heat_on_wall_sources(ts, tm, tp, ctx=tc)
    np.testing.assert_array_equal(got.SrcAdd.numpy(), np.asarray(want.SrcAdd))
    np.testing.assert_array_equal(got.Q_conv.numpy(), np.asarray(want.Q_conv))
    # the stage fired: some solid node holds a flux, some gas node a source
    assert np.abs(got.Q_conv.numpy()).max() > 0
    assert np.abs(got.SrcAdd[1].numpy()).max() == 0
    assert np.abs(got.SrcAdd[3].numpy()).max() > 0


def test_gfc_with_heat(evolved):
    js, (ts, tm, tp, tc) = evolved
    ja, ta = _aux(js, 13)
    want, want_dt, want_uns = jstep.gfc(js.state, js.meta, js.params,
                                        js.chem, ja)
    got, got_dt, got_uns = tstep.gfc(ts, tm, tp, tc, ta)
    for name, a in np_fields(want).items():
        close(getattr(got, name), a, name)
    close(got_dt, np.asarray(want_dt), "dt")
    assert bool(got_uns) == bool(want_uns)
    assert np.abs(got.Q_conv.numpy()).max() > 0


def test_solver_step_with_heat(evolved):
    js, (ts, tm, tp, tc) = evolved
    ja, ta = _aux(js, 13)
    want, wd = jstep.solver_step(js.state, js.meta, js.params, js.chem, ja)
    got, gd = tstep.solver_step(ts, tm, tp, tc, ta)
    wf = np_fields(want)
    for name in PHYS + ["dt", "A", "B", "SrcAdd", "Q_conv"]:
        close(getattr(got, name), wf[name], name)
    close(got.beta, wf["beta"], "beta", rtol=1e-6)
    for key in ("RMS", "DD_max", "dt_next"):
        close(gd[key], np.asarray(wd[key]), key)


def test_fast_chunk_with_heat_12_iters_f64(chunk12):
    js, wd, ts, gd = chunk12
    want = np_fields(js.state)
    got = ts.host_state()
    errs = {f: scaled_err(want, got, f) for f in PHYS + ["dt", "Q_conv"]}
    assert max(errs.values()) < 1e-10, errs
    assert beta_err(want, got) < 1.0
    for key in ("RMS", "dt_used"):
        close(gd[key], np.asarray(wd[key]), key)
    keep = [e for e in range(9) if e != 2]    # see test_torch_step.py
    close(gd["DD_max"][:, keep], np.asarray(wd["DD_max"])[:, keep], "DD_max")
    np.testing.assert_array_equal(gd["unstable"], np.asarray(wd["unstable"]))
    assert np.abs(got["Q_conv"]).max() > 0
