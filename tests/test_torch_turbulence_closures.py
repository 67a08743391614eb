"""Port parity: Spalart-Allmaras, Smagorinsky and the Prandtl family on
the eager path.

* Eager, float64, against JAX's XLA path (torch_parity.eager_closure_runs)
  on the 48x40 wall channel of tests/test_turbulence_models.py:
  TurbulenceModel 3 (SA), 5 (Smagorinsky, delta = sqrt(dx dy)) and 2 with
  TurbExtModel Prandtl, van Driest, Escudier and Klebanoff (delta_bl 0.2):
  the initial fill (SA's nu/100 start, the zero-equation mu_t) and a chunk
  of 5 iterations (SA's 3: its impulsive start flags Tg<0 soon after, in
  JAX too; van Driest's after 2 iterations and recalc_y_plus, so that y+
  and mu_t are positive), every field to 1e-10 of its plane's scale, beta
  by beta_err, RMS and dt_used to rtol 1e-10.  ``check_supported``
  accepts each case.
* Escudier and Klebanoff with delta_bl <= 0 fall back to Prandtl's n_0:
  the same bits as TurbExtModel Prandtl.
* SA holds nu_t at 0 on the no-slip wall and writes nu * 0.005 on the
  inflow (FC) nodes.
"""

import numpy as np
import pytest
import torch
from torch_parity import (TURB_CLOSURES, check_eager_chunk,
                          check_eager_init, eager_closure_runs,
                          jax_wall_channel, port_case)

from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.examples import wall_channel_deck
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver, check_supported

CLOSURES = ("sa", "smagorinsky", "prandtl", "van_driest", "escudier",
            "klebanoff")
MODEL = {3: "sa", 5: "smag", 2: "prandtl"}


@pytest.mark.parametrize("name", CLOSURES)
def test_init_fill_matches_jax(name):
    check_eager_init(name)


@pytest.mark.parametrize("name", CLOSURES)
def test_chunk_matches_jax(name):
    check_eager_chunk(name)


@pytest.mark.parametrize("name", CLOSURES)
def test_check_supported_accepts(name):
    tm, tem = TURB_CLOSURES[name]
    p = port_case(jinit.build_case(jax_wall_channel(name))).params
    assert p.models == (MODEL[tm],) and p.tem == getattr(fl, tem)
    check_supported(p)


@pytest.mark.parametrize("tem", [fl.TEM_Escudier, fl.TEM_Klebanoff])
def test_no_boundary_layer_falls_back_to_prandtl(tem):
    out = []
    for t in (fl.TEM_Prandtl, tem):
        s = Solver(build_case(wall_channel_deck(32, 24, 2, t, delta_bl=0.0)),
                   device="cpu", use_kernels=False)
        s.run_iters(4)
        out.append(s.state)
    assert out[0].mu_t.max() > 0
    for f in ("S", "beta", "U", "V", "p", "Tg", "mu_t"):
        assert torch.equal(getattr(out[0], f), getattr(out[1], f)), f


def test_sa_wall_and_inflow_values():
    _, _, got, _ = eager_closure_runs("sa")[1]
    g = jinit.build_case(jax_wall_channel("sa")).grid
    nu_t = got["S"][fl.i2d_nu_t]
    wall = g.is_cond(fl.CT_WALL_NO_SLIP_2D)
    fc = g.is_cond(fl.NT_FC_2D) & ~wall
    assert wall.any() and fc.any()
    assert np.abs(nu_t[wall]).max() == 0.0
    rho = got["S"][fl.i2d_Rho]
    np.testing.assert_allclose(nu_t[fc], (got["mu"] / rho * 0.005)[fc],
                               rtol=1e-12)
    assert np.abs(nu_t[~wall & ~fc]).max() > 0
