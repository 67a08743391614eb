"""A run whose timed path is broken underneath comes out not correct:
each fault of ``faults.FAULTS`` that the cells can have, on the CPU (the
kernel path's plain versions) at a small size."""

import pytest
import torch

from portbench import faults, harness


@pytest.mark.parametrize("cell", ["combustor_tiny_k8", "combustor_tiny_k1"])
@pytest.mark.parametrize("fault", [None, *sorted(faults.FAULTS)])
def test_a_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    torch.set_num_threads(2)
    if fault is not None:
        faults.FAULTS[fault](monkeypatch.setattr)
    r = harness.run(cell, 11, 0.2, False, device="cpu", root=tiny_root)
    over = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    if fault is None:
        assert r["correct"] and not over, r["checks"]
    else:
        assert not r["correct"]
        assert over or r["failed"], r["checks"]
