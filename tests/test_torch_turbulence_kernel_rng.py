"""Port parity: the closures on the kernel path against JAX's Pallas
kernel, part 3: RNG (the k-eps variant chip_smoke.py runs at 2048^2) and
Klebanoff.

As tests/test_torch_turbulence_kernel.py (torch_parity.
check_kernel_cycles: the 48x40 wall channel, K = 1 and K = 2, two cycles
of 6 iterations, the second from JAX's state after the first): the first
cycle to 1e-10 of each plane's scale; RNG's second to 1e-9 (the port
reads 9.7e-11 against JAX, the standard k-eps 9.8e-11); Klebanoff's to
1e-6, where JAX against itself with S perturbed by 1e-15 parts by 2.1e-7
of S's scale.
"""

import pytest
from torch_parity import check_kernel_cycles

TOLS = {"rng": (1e-10, 1e-9), "klebanoff": (1e-10, 1e-6)}


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("name", sorted(TOLS))
def test_kernel_chunk_matches_pallas_f64(name, K):
    check_kernel_cycles(name, K, TOLS[name])
