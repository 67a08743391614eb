"""Port parity: the kernel path on decks with the conjugate-heat stage and a
generic-interior tile set that is not a rectangle.

The port's Solver on the kernel path (on CPU tensors its wrappers run the
kernels' plain versions, heat included) against JAX's
``Solver(use_pallas=True, pallas_fuse=1)``, the Pallas kernel in interpret
mode, in float64 over two 6-iteration cycles.  Fields are held to 1e-10 of
each plane's scale, beta by torch_parity.beta_err, RMS and dt_used to rtol
1e-10, DD_max to 1e-8 (rhoV excepted, see test_torch_step.py), and the
integer diags exactly: test_torch_kernel_path.py's tolerances.

* ``reacting_rans_deck(48, 40, wall_bottom=True, adiabatic=False,
  with_step=True)`` with JAX ``pallas_tile=(16, 16)``;
* ``combustor_deck(64, 256, with_step=True, adiabatic=False)`` with JAX
  ``pallas_tile=(16, 128)``: the forward-facing step makes the port's spec
  tile set an L, so its general tile list (the GPU form of the TPU's
  scatter table) holds tiles beside the step, off the grid's outer frame.

The 64x256 step deck does not flip a branch on an exact zero: JAX's
compiled path and JAX run op by op (jax.disable_jit) agree to 2e-14 of S
after both cycles.  The port and JAX part at the ulp level (4.6e-16 of
rhoU after 2 iterations) in the impulsive start at the step face, where
rhoV is born near its float noise, and that difference grows about
tenfold an iteration there, against JAX compiled or op by op alike: after
the first cycle 3e-14 of S, after the second 7.3e-9 of S, beta_err 29.5
at those limits (0.077 at rtol = atol = 1e-3) and DD_max 6.5e-11.  So on
that deck the second cycle holds the fields to 1e-7 of scale, beta to
rtol = atol = 1e-3 and DD_max to 1e-6 (``TOL``); RMS, dt_used and the
integer diags keep those limits on every deck and cycle.
"""

import numpy as np
import pytest
from torch_parity import beta_err, np_fields, port_case, scaled_err

from openhyperflow2d_tpu.examples import combustor_deck, reacting_rans_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.ops.fused_step import TILE
from openhyperflow2d_torch.solver.runner import Solver

FIELDS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu", "mu_t",
          "dt", "y_plus", "Q_conv"]
NOT_NOISE = [e for e in range(9) if e != 2]   # DD_max of rhoV: see beta_err

DECKS = {
    "rans_step_heat": (lambda: reacting_rans_deck(
        48, 40, wall_bottom=True, adiabatic=False, with_step=True), (16, 16)),
    "combustor_step_heat": (lambda: combustor_deck(
        64, 256, with_step=True, adiabatic=False), (16, 128)),
}


# (fields of scale, beta_err (rtol, atol), DD_max) per cycle (see above)
TIGHT = (1e-10, (1e-6, 3e-6), 1e-8)
TOL = {"rans_step_heat": (TIGHT, TIGHT),
       "combustor_step_heat": (TIGHT, (1e-7, (1e-3, 1e-3), 1e-6))}


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-300)))


def off_frame(plan, tiles) -> np.ndarray:
    ti, tj = np.divmod(tiles.numpy(), plan.nby)
    return tiles.numpy()[(ti > 0) & (ti < plan.nbx - 1) & (tj > 0)
                         & (tj < plan.nby - 1)]


def check_heat_tiles(ts):
    """Every heat tile holds an hv_* or hw_* node, and every such node lies
    in a heat tile."""
    from openhyperflow2d_torch.ops.fused_step import heat_node_map
    plan = ts.fused.plan
    hmap = heat_node_map(ts.fused.ctx)
    TX, TY = TILE
    heat = set(plan.heat_tiles.tolist())
    assert heat
    for t in heat:
        ti, tj = divmod(t, plan.nby)
        assert hmap[ti * TX:(ti + 1) * TX, tj * TY:(tj + 1) * TY].any()
    for i, j in zip(*np.nonzero(hmap)):
        assert (i // TX) * plan.nby + j // TY in heat


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_kernel_path_with_heat_matches_pallas_f64(deck):
    make, tile = DECKS[deck]
    jc = jinit.build_case(make())
    jc.Nstep = 6
    js = JSolver(jc, use_pallas=True, pallas_fuse=1, pallas_tile=tile)
    ts = Solver(port_case(jc), device="cpu", use_kernels=True)
    assert ts.use_kernels and ts.fused.has_heat
    check_heat_tiles(ts)
    if deck == "combustor_step_heat":
        plan = ts.fused.plan
        rows, cols = np.nonzero(plan.spec)
        box = plan.spec[rows.min():rows.max() + 1, cols.min():cols.max() + 1]
        assert not box.all()              # the spec set is not a rectangle
        assert off_frame(plan, plan.general_tiles).size > 0
    for cycle in range(2):
        wd, _ = js.run_cycle()
        gd, _ = ts.run_cycle()
        want, got = np_fields(js.state), ts.host_state()
        tol_f, (b_rtol, b_atol), tol_dd = TOL[deck][cycle]
        errs = {f: scaled_err(want, got, f) for f in FIELDS}
        assert max(errs.values()) < tol_f, errs
        assert beta_err(want, got, rtol=b_rtol, atol=b_atol) < 1.0
        assert rel(gd["RMS"], wd["RMS"]) < 1e-10
        assert rel(gd["dt_used"], wd["dt_used"]) < 1e-10
        assert rel(gd["DD_max"][:, NOT_NOISE],
                   np.asarray(wd["DD_max"])[:, NOT_NOISE]) < tol_dd
        for key in ("unstable", "dt_overrun"):
            np.testing.assert_array_equal(gd[key], np.asarray(wd[key]), key)
    assert np.abs(got["Q_conv"]).max() > 0
    assert not gd["unstable"].any()
