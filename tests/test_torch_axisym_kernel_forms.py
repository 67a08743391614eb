"""Port parity: the extended kernel forms on the kernel path against
JAX's Pallas kernel, part 2: the extended forms of the closures' gfc and
of the Euler gfc (part 1: tests/test_torch_axisym_kernel.py).

As part 1 (torch_parity.check_axisym_kernel: one cycle, K = 1 and K = 2,
every field to 1e-10 of its plane's scale) on the 48x40 wall channel with
Spalart-Allmaras and FlowType=1 (``gfc_closure_ext_kernel``, SA's
axisymmetric add-on; a cycle of 3 iterations, before its impulsive start
flags Tg<0) and on bubble_deck(48, 40) with FlowType=1
(``gfc_euler_ext_kernel``; JAX's Pallas path runs op by op there,
``jax.disable_jit``: compiled, it parts from its own op-by-op run by
1.5e-10 of U's scale at iteration 2, torch_parity.OP_BY_OP).
"""

import pytest
from torch_parity import check_axisym_kernel


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("name", ["sa", "bubble"])
def test_kernel_chunk_matches_pallas_f64(name, K):
    check_axisym_kernel(name, K)
