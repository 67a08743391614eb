"""Port parity: the closures on the kernel path against JAX's Pallas
kernel, part 2: Spalart-Allmaras and Smagorinsky.

As tests/test_torch_turbulence_kernel.py (torch_parity.
check_kernel_cycles: the 48x40 wall channel, K = 1 and K = 2, two cycles,
the second from JAX's state after the first), with SA's cycles of 3
iterations (its impulsive start flags Tg<0 soon after, in JAX too), held
to 1e-10 of each plane's scale in both; Smagorinsky's second cycle to
1e-6, where JAX against itself with S perturbed by 1e-15 parts by 2.1e-7
of S's scale (tests/test_torch_turbulence_kernel.py).
"""

import pytest
from torch_parity import check_kernel_cycles

TOLS = {"sa": (1e-10, 1e-10), "smagorinsky": (1e-10, 1e-6)}


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("name", sorted(TOLS))
def test_kernel_chunk_matches_pallas_f64(name, K):
    check_kernel_cycles(name, K, TOLS[name])
