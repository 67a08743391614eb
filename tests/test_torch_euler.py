"""Port parity: Euler decks (ProblemType=0, ``p.sm != SM_NS``) on the
eager path, their static ctx, and ``check_supported``.

Decks, each built by the JAX package and handed to the port as the same
host arrays (torch_parity.port_case): ``channel_deck(32, 24)``,
``freestream_deck(nx=32, ny=24)``, ``cylinders_deck(64, 48)`` (three
NT_WNS cylinders) and ``bubble_deck(48, 32)``.

* ``check_supported`` accepts the four decks, and still refuses what the
  port lacks on an Euler case.
* The static ctx of each deck equals JAX's field by field, and the packed
  ctx words bit for bit; outside SM_NS the turbulence equations are
  inactive (``turb2`` zero, static_ctx.py:240, 266) and no tile is
  specialized (``spec_supported``).
* ``gfc`` and ``solver_step`` on an evolved state against JAX's, float64,
  rtol 1e-10: outside SM_NS the gradients keep the state's values,
  FillNode2D adds no viscous terms and carries lam and mu.
* The eager chunk (``Solver(use_kernels=False)``) over 10 iterations
  against JAX's XLA path in float64: fields to 1e-10 of each plane's
  scale, beta by ``beta_err`` (rtol 1e-6, atol 3e-6 where the equation is
  not at float noise), RMS and dt_used to rtol 1e-10, the unstable rows
  exactly; lam_t, which no Euler iteration writes, equal.  The bubble deck
  is held against JAX run op by op (``jax.disable_jit``) at 1e-13: there
  compiled XLA parts from JAX's own op-by-op run by 3.5e-10 of U's scale
  after 5 iterations, while the port and op-by-op JAX agree to 3e-16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import beta_err, np_fields, port_case, port_inputs, \
    scaled_err, to_np

from openhyperflow2d_tpu import examples as jex
from openhyperflow2d_tpu.core import flags as fl
from openhyperflow2d_tpu.core import static_ctx as jctx
from openhyperflow2d_tpu.core import step as jstep
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core import static_ctx as tctx
from openhyperflow2d_torch.core import step as tstep
from openhyperflow2d_torch.solver.runner import Solver, check_supported

DECKS = {
    "channel": lambda: jex.channel_deck(32, 24),
    "freestream": lambda: jex.freestream_deck(nx=32, ny=24),
    "cylinders": lambda: jex.cylinders_deck(64, 48),
    "bubble": lambda: jex.bubble_deck(48, 32),
}
PHYS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu", "mu_t",
        "lam_t", "dt"]
ITERS = 10


def close(got, want, what, rtol=1e-10):
    got, want = to_np(got), np.asarray(want)
    floor = rtol * max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


@pytest.fixture(scope="module", params=sorted(DECKS))
def case(request):
    return request.param, jinit.build_case(DECKS[request.param]())


def test_check_supported_accepts_euler_decks(case):
    name, jc = case
    assert jc.params.sm != fl.SM_NS, name
    check_supported(port_case(jc).params)


@pytest.mark.parametrize("change, words", [
    # axisymmetric flow, NRBC, d2*-NULL soft BCs, non-uniform meshes and
    # moving-wall sources are ported on Euler decks too: accepted (words
    # None); other chemistry codes are still refused
    ({"ft": fl.FT_AXISYMMETRIC}, None),
    ({"has_nrbc": True}, None),
    ({"has_d2y": True}, None),
    ({"uniform_mesh": False}, None),
    ({"isSrcAdd": True}, None),
    ({"chemistry": 2}, "chemistry model 2"),
])
def test_check_supported_still_refuses_the_rest(change, words):
    p = port_case(jinit.build_case(DECKS["channel"]())).params
    if words is None:
        check_supported(dataclasses.replace(p, **change))
        return
    with pytest.raises(NotImplementedError, match=words) as e:
        check_supported(dataclasses.replace(p, **change))
    assert "Euler" not in str(e.value)


def test_euler_ctx_matches_jax_bitwise(case):
    name, jc = case
    js = JSolver(jc)
    _, tm, tp, _ = port_inputs(js)
    jc_ctx = jctx.build_static_ctx(js.meta, js.params)
    tc_ctx = tctx.build_static_ctx(tm, tp)
    for f in dataclasses.fields(tctx.StaticCtx):
        a, b = getattr(jc_ctx, f.name), getattr(tc_ctx, f.name)
        np.testing.assert_array_equal(to_np(b), np.asarray(a), f.name)
    jpk = np.asarray(jctx.build_packed_ctx(js.meta, js.params))
    tpk = to_np(tctx.build_packed_ctx(tm, tp))
    np.testing.assert_array_equal(tpk.view(np.uint32), jpk)
    # outside SM_NS: k and eps never evolve, and no tile is specialized
    assert not to_np(tc_ctx.evolve[7:]).any()
    assert not tctx.spec_supported(tp)
    g = jc.grid
    assert tctx.generic_interior_map(g.CT, g.TCT, g.idXl, g.idXr, g.idYu,
                                     g.idYd, tp) is None


@pytest.fixture(scope="module")
def evolved():
    js = JSolver(jinit.build_case(DECKS["cylinders"]()))
    js.run_iters(4)
    return js, port_inputs(js)


def _aux(js, it):
    p = js.params
    ja = jstep.make_aux((js.beta_xs, js.beta_ys), (js.cfl_xs, js.cfl_ys),
                        p.TurbStartIter, jnp.asarray(it), p.jdtype)
    tt = [torch.as_tensor(np.array(a)) for a in
          (js.beta_xs, js.beta_ys, js.cfl_xs, js.cfl_ys)]
    ta = tstep.make_aux((tt[0], tt[1]), (tt[2], tt[3]), p.TurbStartIter, it,
                        torch.float64)
    return ja, ta


def test_gfc_keeps_the_gradients_outside_ns(evolved):
    js, (ts, tm, tp, tc) = evolved
    # gradients the Euler gfc must pass through untouched
    rng = np.random.default_rng(8)
    grads = {f: rng.standard_normal(np.asarray(getattr(js.state, f)).shape)
             for f in ("dUdx", "dVdy", "dTdx", "droYdx", "dkdy")}
    jst = dataclasses.replace(js.state, **{k: jnp.asarray(v)
                                           for k, v in grads.items()})
    tst = ts.replace(**{k: torch.as_tensor(v) for k, v in grads.items()})
    ja, ta = _aux(js, 5)
    want, want_dt, want_uns = jstep.gfc(jst, js.meta, js.params, js.chem,
                                        ja)
    got, got_dt, got_uns = tstep.gfc(tst, tm, tp, tc, ta)
    for name, a in np_fields(want).items():
        close(getattr(got, name), a, name)
    for name, a in grads.items():
        np.testing.assert_array_equal(to_np(getattr(got, name)), a, name)
    close(got_dt, np.asarray(want_dt), "dt")
    assert bool(got_uns) == bool(want_uns)


def test_solver_step(evolved):
    js, (ts, tm, tp, tc) = evolved
    ja, ta = _aux(js, 5)
    want, wd = jstep.solver_step(js.state, js.meta, js.params, js.chem, ja)
    got, gd = tstep.solver_step(ts, tm, tp, tc, ta)
    wf = np_fields(want)
    for name in PHYS + ["A", "B"]:
        close(getattr(got, name), wf[name], name)
    close(got.beta, wf["beta"], "beta", rtol=1e-6)
    for key in ("RMS", "DD_max", "dt_next"):
        close(gd[key], np.asarray(wd[key]), key)


def test_eager_chunk_matches_jax_f64(case):
    name, jc = case
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    lam_t0 = to_np(ts.state.lam_t).copy()
    gd = ts.run_iters(ITERS)
    if name == "bubble":
        with jax.disable_jit():
            js = JSolver(jc)
            wd = js.run_iters(ITERS)
        tol, beta_tol = 1e-13, dict(rtol=1e-12, atol=1e-12, floor=0.0)
    else:
        js = JSolver(jc)
        wd = js.run_iters(ITERS)
        tol, beta_tol = 1e-10, {}
    want, got = np_fields(js.state), ts.host_state()
    errs = {f: scaled_err(want, got, f) for f in PHYS}
    assert max(errs.values()) < tol, errs
    assert beta_err(want, got, **beta_tol) < 1.0
    for key in ("RMS", "dt_used"):
        close(gd[key], np.asarray(wd[key]), key)
    np.testing.assert_array_equal(gd["unstable"], np.asarray(wd["unstable"]))
    assert not gd["unstable"].any()
    # no Euler iteration writes lam_t: the chunk carries it as a constant
    np.testing.assert_array_equal(got["lam_t"], lam_t0)
