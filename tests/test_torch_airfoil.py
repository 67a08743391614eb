"""Port parity: the airfoil deck (``examples.airfoil_deck``, BASELINE
config 3: URANS around a solid NACA body).

The JAX package builds the deck and the port runs it (port_case), both in
float64 on the CPU:

* the eager path against JAX's XLA path run op by op (jax.disable_jit),
  ``airfoil_deck(128, 64)``, 8 iterations: S to 1e-13 of each plane's
  scale, every other field to 1e-10, RMS and dt_used to rtol 1e-12.
  JAX's compiled chunk parts from its own op-by-op run by 2.6e-11 of eps's
  scale and 1e-12 of RMS here (XLA's fusion rounds apart), while the port
  and the op-by-op run agree to 4e-16 (torch_parity.OP_BY_OP);
* the kernel path (the kernels' plain versions on CPU tensors) against
  ``Solver(use_pallas=True, pallas_fuse=1, pallas_tile=(16, 128))``, the
  Pallas kernel in interpret mode, on ``airfoil_deck(128, 128)`` over two
  cycles of 6 iterations.  Its interior solid makes a spec set with holes,
  as the bluff body does (tests/test_torch_kernel_path_bluff.py: general
  tiles off the grid's frame), and the
  impulsive start around the body grows ulp differences the same way: the
  fields to 1e-10 of scale in both cycles, beta at the bluff test's rtol =
  atol = 1e-6 / 3e-6 in the first and 1e-3 in the second (probes on the
  CPU read 3.3e-11 and 6.1e-11 of scale, beta_err 1.68 at the first
  limits in the second cycle).
"""

import numpy as np
from test_torch_kernel_path_bluff import rel
from torch_parity import beta_err, np_copy, port_case, scaled_err

from openhyperflow2d_tpu.core import flags as fl
from openhyperflow2d_tpu.examples import airfoil_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.solver.runner import Solver

FIELDS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu", "mu_t",
          "lam_t", "dt", "y_plus"]
# beta_err (rtol, atol) per cycle (see above)
BETA = ((1e-6, 3e-6), (1e-3, 1e-3))


def test_airfoil_eager_matches_jax():
    import jax
    jc = jinit.build_case(airfoil_deck(128, 64))
    assert jc.grid.is_cond(fl.CT_SOLID_2D).sum() > 40     # the body
    with jax.disable_jit():
        js = JSolver(jc)
        wd = {k: np.asarray(v) for k, v in js.run_iters(8).items()}
        want = np_copy(js.state)
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    gd = ts.run_iters(8)
    got = ts.host_state()
    assert scaled_err(want, got, "S") < 1e-13
    errs = {f: scaled_err(want, got, f) for f in FIELDS}
    assert max(errs.values()) < 1e-10, errs
    assert beta_err(want, got) < 1.0
    for key in ("RMS", "dt_used"):
        assert rel(gd[key], wd[key]) < 1e-12, key
    np.testing.assert_array_equal(gd["unstable"], wd["unstable"])
    assert not gd["unstable"].any()


def test_airfoil_kernel_path_matches_pallas_f64():
    jc = jinit.build_case(airfoil_deck(128, 128))
    jc.Nstep = 6
    js = JSolver(jc, use_pallas=True, pallas_fuse=1, pallas_tile=(16, 128))
    ts = Solver(port_case(jc), device="cpu", use_kernels=True)
    spec = ts.fused.plan.spec
    assert spec.any() and (~spec[1:-1, 1:-1]).any()   # the body's tiles
    for cycle in range(2):
        wd, _ = js.run_cycle()
        gd, _ = ts.run_cycle()
        assert not np.asarray(wd["unstable"]).any()
        want, got = np_copy(js.state), ts.host_state()
        errs = {f: scaled_err(want, got, f) for f in FIELDS}
        assert max(errs.values()) < 1e-10, (cycle, errs)
        b_rtol, b_atol = BETA[cycle]
        assert beta_err(want, got, rtol=b_rtol, atol=b_atol) < 1.0, cycle
        assert rel(gd["RMS"], wd["RMS"]) < 1e-10
        assert rel(gd["dt_used"], wd["dt_used"]) < 1e-10
        for key in ("unstable", "dt_overrun"):
            np.testing.assert_array_equal(gd[key], np.asarray(wd[key]), key)
