"""Port parity: the extended kernel forms (``*_ext_kernel``: axisymmetric
flow, external sources, d2*-NULL soft BCs, NRBC) on the kernel path
against JAX's Pallas kernel, part 1: the d2/NRBC axisymmetric k-eps deck
and the scramjet (part 2: tests/test_torch_axisym_kernel_forms.py).

On CPU tensors the kernel wrappers run their plain versions
(``FusedStep.gfc_plain``/``pass12_plain`` with the F planes and the
source field), so these tests hold the port's kernel path, its
K-iteration blocks, the scratch's F planes and the source field against
JAX's ``Solver(use_pallas=True, pallas_tile=(16, 128))``, the Pallas
kernel in interpret mode, float64 (torch_parity.check_axisym_kernel), at
K = 1 and K = 2, over a cycle of 6 iterations: every field to 1e-10 of
its plane's scale, RMS and dt_used to rtol 1e-10, the unstable and
dt_overrun rows exactly.  Decks: the JAX package's _nrbc_d2_axisym_deck
(48x40) and scramjet_deck(64, 48).

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py (phase 3g).
"""

import pytest
from torch_parity import check_axisym_kernel


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("name", ["nrbc_d2", "scramjet"])
def test_kernel_chunk_matches_pallas_f64(name, K):
    check_axisym_kernel(name, K)
