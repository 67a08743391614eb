"""Port parity: the closures on the kernel path (the closures' gfc forms'
plain version) against JAX's Pallas kernel, part 1: the closures that read
y+, Chien and van Driest (part 2: tests/test_torch_turbulence_kernel_sa.py,
part 3: tests/test_torch_turbulence_kernel_rng.py).

On CPU tensors the kernel wrappers run their plain versions, so these
tests hold the port's kernel path, its K-iteration blocks and the y+ meta
plane (``FusedStep.set_y_plus``, refreshed every chunk) against JAX's
``Solver(use_pallas=True, pallas_tile=(16, 128))``, the Pallas kernel in
interpret mode, float64 (torch_parity.check_kernel_cycles), on the 48x40
wall channel of tests/test_turbulence_models.py, at K = 1 and K = 2, over
two cycles of 6 iterations, the second started from JAX's state after the
first (each cycle ends with recalc_y_plus, so Chien's and van Driest's
second cycle runs with y+ > 0):

* the first cycle to 1e-10 of each plane's scale;
* the second to 1e-6: there JAX against itself, with S perturbed by 1e-15
  of its value at the second cycle's start, parts by 2.1e-7 of S's scale
  after its 6 iterations (rhoV is float noise of the stream along x at
  the wall, and its blending factor noise over noise), against 3.5e-10
  for the standard k-eps (measured on this deck, JAX Pallas interpret
  mode, float64); the port reads 2.1e-7 against JAX there too.

The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py (phase 3f).
"""

import pytest
from torch_parity import check_kernel_cycles

TOLS = {"chien": (1e-10, 1e-6), "van_driest": (1e-10, 1e-6)}


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("name", sorted(TOLS))
def test_kernel_chunk_matches_pallas_f64(name, K):
    check_kernel_cycles(name, K, TOLS[name])
