"""Port parity: the solver iteration stages and the eager chunk.

pass12, gfc and solver_step on one evolved state, then the eager
``make_fast_chunk`` (through the port's Solver) over 20 iterations against
the JAX XLA path.  Tolerances: physical fields rtol 1e-10 of each plane's
scale in float64 (torch_parity.scaled_err); beta rtol 1e-6 / atol 3e-6,
because the blending-factor update applies sqrt(|residual|), whose slope is
infinite at 0, so an ulp-level residual difference on a converged node
becomes ~1e-7 of beta (__graft_entry__.py:167-173), compared where the
equation is not at float noise (torch_parity.beta_err).  The float32 run is
held to __graft_entry__.max_rel_diff's float32 gate (rtol 3e-4, atol 1e-4).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import beta_err, max_rel_diff, np_fields, port_case, \
    port_inputs, scaled_err, to_np

from openhyperflow2d_tpu.core import step as jstep
from openhyperflow2d_tpu.examples import combustor_deck, reacting_rans_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core import step as tstep
from openhyperflow2d_torch.solver.runner import Solver

DECKS = {
    "combustor": lambda: combustor_deck(48, 40),
    "rans_wall": lambda: reacting_rans_deck(48, 40, wall_bottom=True),
}
PHYS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu", "mu_t"]


def close(got, want, what, rtol=1e-10):
    got, want = to_np(got), np.asarray(want)
    floor = rtol * max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


@pytest.fixture(scope="module", params=sorted(DECKS))
def evolved(request):
    js = JSolver(jinit.build_case(DECKS[request.param]()))
    js.run_iters(4)
    return js, port_inputs(js)


def _aux(jsolver, it):
    import torch
    p = jsolver.params
    ja = jstep.make_aux((jsolver.beta_xs, jsolver.beta_ys),
                        (jsolver.cfl_xs, jsolver.cfl_ys), p.TurbStartIter,
                        jnp.asarray(it), p.jdtype)
    tt = [torch.as_tensor(np.asarray(a)) for a in
          (jsolver.beta_xs, jsolver.beta_ys, jsolver.cfl_xs, jsolver.cfl_ys)]
    ta = tstep.make_aux((tt[0], tt[1]), (tt[2], tt[3]), p.TurbStartIter, it,
                        torch.float64)
    return ja, ta


def test_pass12(evolved):
    js, (ts, tm, tp, _) = evolved
    ja, ta = _aux(js, 5)
    want = jstep.pass12(js.state, js.meta, js.params, ja)
    got = tstep.pass12(ts, tm, tp, ta)
    for k, what in enumerate(("S", "beta", "dSdx", "dSdy")):
        close(got[k], np.asarray(want[k]), what)
    for key in ("RMS", "DD_max", "dt_used"):
        close(got[4][key], np.asarray(want[4][key]), key)


def test_gfc(evolved):
    js, (ts, tm, tp, tc) = evolved
    ja, ta = _aux(js, 5)
    want, want_dt, want_uns = jstep.gfc(js.state, js.meta, js.params,
                                        js.chem, ja)
    got, got_dt, got_uns = tstep.gfc(ts, tm, tp, tc, ta)
    for name, a in np_fields(want).items():
        close(getattr(got, name), a, name)
    close(got_dt, np.asarray(want_dt), "dt")
    assert bool(got_uns) == bool(want_uns)


def test_solver_step(evolved):
    js, (ts, tm, tp, tc) = evolved
    ja, ta = _aux(js, 5)
    want, wd = jstep.solver_step(js.state, js.meta, js.params, js.chem, ja)
    got, gd = tstep.solver_step(ts, tm, tp, tc, ta)
    wf = np_fields(want)
    for name in PHYS + ["dt", "A", "B"]:
        close(getattr(got, name), wf[name], name)
    close(got.beta, wf["beta"], "beta", rtol=1e-6)
    for key in ("RMS", "DD_max", "dt_next"):
        close(gd[key], np.asarray(wd[key]), key)


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_fast_chunk_20_iters_f64(deck):
    jc = jinit.build_case(DECKS[deck]())
    js = JSolver(jc)
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    wd = js.run_iters(20)
    gd = ts.run_iters(20)
    want = np_fields(js.state)
    got = ts.host_state()
    errs = {f: scaled_err(want, got, f) for f in PHYS + ["dt"]}
    assert max(errs.values()) < 1e-10, errs
    assert beta_err(want, got) < 1.0
    for key in ("RMS", "dt_used"):
        close(gd[key], np.asarray(wd[key]), key)
    # DD_max of rhoV is the largest residual ratio over nodes where rhoV
    # is float noise (see beta_err); the other equations are compared
    keep = [e for e in range(9) if e != 2]
    close(gd["DD_max"][:, keep], np.asarray(wd["DD_max"])[:, keep], "DD_max")
    np.testing.assert_array_equal(gd["unstable"], np.asarray(wd["unstable"]))
    assert not gd["unstable"].any()


def test_fast_chunk_op_by_op_f64():
    """Against JAX run op by op (jax.disable_jit) the eager chunk agrees to
    the last bits: the port evaluates the reference's expressions in the
    same order.  (Compiled XLA contracts and fuses differently; on decks
    where a branch on an exact zero flips, that difference grows to ~1e-5
    of a field in 12 iterations, which is why the comparisons against the
    compiled path run on decks where it does not.)"""
    import jax
    jc = jinit.build_case(combustor_deck(48, 40))
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    with jax.disable_jit():
        js = JSolver(jc)
        js.run_iters(12)
    ts.run_iters(12)
    want, got = np_fields(js.state), ts.host_state()
    errs = {f: scaled_err(want, got, f) for f in PHYS + ["dt"]}
    assert max(errs.values()) < 1e-13, errs
    assert beta_err(want, got, rtol=1e-12, atol=1e-12, floor=0.0) < 1.0


def test_fast_chunk_f32_gate():
    """Float32 against float32: __graft_entry__.max_rel_diff's gate (rtol
    3e-4, atol 1e-4, < 1) over its own horizon of 5 iterations, then each
    field against its scale after 20.  Past a few iterations the gate
    measures noise, not the port: rhoV and V are float32 noise of the
    x-momentum here, and the gate's absolute 1e-4 is below it.  JAX against
    itself (jit against op by op) reads 838 on this deck after 20
    iterations."""
    jc = jinit.build_case(combustor_deck(48, 40), dtype="float32")
    js = JSolver(jc)
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    js.run_iters(5)
    ts.run_iters(5)
    got = ts.host_state()
    assert got["S"].dtype == np.float32
    worst = max_rel_diff(np_fields(js.state), got,
                         ["S", "beta", "U", "V", "p", "Tg"], rtol=3e-4,
                         atol=1e-4)
    assert worst < 1.0, worst
    js.run_iters(15)
    ts.run_iters(15)
    want, got = np_fields(js.state), ts.host_state()
    errs = {f: scaled_err(want, got, f) for f in ("S", "U", "V", "p", "Tg")}
    assert max(errs.values()) < 1e-4, errs


def test_params_converter_round_trip(evolved):
    js, (_, _, tp, _) = evolved
    assert dataclasses.asdict(tp) == dataclasses.asdict(js.params)
