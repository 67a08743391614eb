"""Port parity: axisymmetric flow, external sources, d2*-NULL soft BCs and
non-reflected BCs on the eager path.

Eager, float64, against JAX's XLA path (torch_parity.check_axisym_eager)
on five decks, each built by the JAX package and handed to the port:

* ``nrbc_d2``: the JAX package's _nrbc_d2_axisym_deck (48x40,
  tests/test_static_ctx.py:25-37): axisymmetric standard k-eps, an NRBC
  top, d2*-NULL outflow and bottom;
* ``scramjet``: scramjet_deck(64, 48): axisymmetric k-eps with a radial
  fuel line source (external sources) and Zeldovich chemistry;
* ``combustor``: combustor_deck(64, 256) with FlowType=1 (walls, k-eps
  wall treatment, chemistry);
* ``sa``: the 48x40 wall channel of tests/test_turbulence_models.py with
  Spalart-Allmaras and FlowType=1 (SA's axisymmetric add-on);
* ``bubble``: bubble_deck(48, 40) with FlowType=1 (Euler).

The initial fill and one chunk (6 iterations; SA's 3, before its impulsive
start flags Tg<0): every field, F and Src included, to 1e-10 of its
plane's scale, beta by beta_err, RMS and dt_used to rtol 1e-10.  On the
bubble the JAX reference runs op by op (``jax.disable_jit``): JAX's
compiled chunk parts from its own op-by-op run by 1.5e-10 of U's scale at
iteration 2, where the port and the op-by-op run agree below 1e-13
(torch_parity.OP_BY_OP).  ``check_supported`` accepts each case.
"""

import pytest
from torch_parity import (AXISYM_DECKS, check_axisym_eager, jax_axisym_case,
                          port_case)

from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.solver.runner import check_supported


@pytest.mark.parametrize("name", AXISYM_DECKS)
def test_eager_matches_jax(name):
    check_axisym_eager(name)


@pytest.mark.parametrize("name", AXISYM_DECKS)
def test_check_supported_accepts(name):
    p = port_case(jax_axisym_case(name)).params
    assert p.ft == fl.FT_AXISYMMETRIC
    if name == "nrbc_d2":
        assert p.has_d2x and p.has_d2y and p.has_nrbc
    assert p.has_ext_src == (name == "scramjet")
    check_supported(p)
