"""The reference's schedule is the kernel path's: on the CPU, where the
kernel path runs its plain versions, the reference in float32 gives the
program's state bit for bit (its RMS to the order of the sums), and in
float64 stays within float32's rounding."""

import dataclasses

import pytest
import torch

from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver
from portbench import check
from portbench.conftest import tiny_deck
from portbench.reference.solver.init import build_case as ref_build


@pytest.mark.parametrize("K,n", [(8, 17), (1, 3)])
def test_reference_follows_the_program(K, n):
    torch.set_num_threads(2)
    deck = tiny_deck(48)
    case = build_case(deck, dtype="float32")
    case.params = dataclasses.replace(case.params, fast_math=True)
    s = Solver(case, device="cpu", use_kernels=True, fuse_iters=K)
    s.run_cycle()
    prog = check.collect(s, n, check.snapshot(s.state))
    rc = ref_build(deck, dtype="float64")
    rc.params = dataclasses.replace(rc.params, fast_math=True)
    f32 = check.Plain(rc, check.Side("f32", "float32"), "cpu")
    R, dR = f32.run(prog, K)
    for a, b in zip(check.planes(prog["X1"]), check.planes(R)):
        assert torch.equal(a, b)
    assert torch.equal(prog["diags"]["dt_used"], dR["dt_used"])
    # the program sums per-tile partials: another order of the sums
    assert torch.allclose(prog["diags"]["RMS"], dR["RMS"], rtol=1e-5,
                          atol=0)
    ref = check.Plain(rc, check.REFERENCE, "cpu")
    got = check.numbers(prog, ref, K=K)
    assert got["flags_diff"] == got["wall_diff"] == 0
    assert got["unstable_diff"] == 0
    assert got["state_l1"] < 1e-4 and got["dt_gap"] < 1e-6
    assert prog["recalc"] and got["yplus_l1"] < 1e-6


def test_gaps():
    r = torch.ones(4, 4, dtype=torch.float64)
    a = torch.ones(4, 4)
    a[0, 0] = 1.5
    assert check.gaps([a], [r]) == (0.5 / 16, 0.5)
    a[1, 1] = float("nan")
    assert check.gaps([a], [r]) == (float("inf"), float("inf"))
    z = torch.zeros(4, 4, dtype=torch.float64)
    assert check.gaps([z.float()], [z]) == (0.0, 0.0)
    assert check.gaps([a], [z]) == (float("inf"), float("inf"))


def test_the_reference_refuses_what_it_does_not_carry():
    from openhyperflow2d_torch.examples import cylinders_deck
    with pytest.raises(ValueError, match="NumCircles"):
        ref_build(cylinders_deck(32, 32), dtype="float64")
