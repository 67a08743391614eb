"""The control (the reference in float32 with its carried state stored in
bfloat16, put in the program's place) comes out not correct, and the
program correct, under the cell's limits: on the card at a small size over
three seeds, and on the CPU with the planted faults beside them.  At the
cell's own size the same readings come from ``python -m
portbench.calibrate``."""

import pytest
import torch

from portbench import calibrate, faults


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["combustor_tiny_k8", "combustor_tiny_k1"])
def test_control_fails_and_program_holds(cuda, tiny_root, cell):
    for row in calibrate.readings(cell, [1, 2, 3], 0.5, cuda,
                                  root=tiny_root):
        assert row["failed"] == 0
        assert row["program_correct"], row
        assert not row["control_correct"], row


def test_calibration_judges_program_control_and_faults(tiny_root):
    torch.set_num_threads(2)
    rows = calibrate.readings("combustor_tiny_k8", [5], 0.2, "cpu",
                              root=tiny_root, fault_seconds=0.2)
    seed_row, *fault_rows = rows
    assert seed_row["program_correct"] and not seed_row["control_correct"]
    assert "beta_l1" in seed_row["program"]
    assert sorted(r["fault"] for r in fault_rows) == sorted(faults.FAULTS)
    assert not any(r["program_correct"] for r in fault_rows)
