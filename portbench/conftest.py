"""Test settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``chip`` marker of tests that need a CUDA card, and
a small copy of the benchmark for runs on the CPU."""

import json
import shutil
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent

# the small cells of the CPU tests, on a 64 x 64 copy of the combustor:
# (cell, traffic); the traffic k1 (a fresh dt every iteration) is written
# into the copy beside the benchmark's k8
TINY = (("combustor_tiny_k8", "k8"), ("combustor_tiny_k1", "k1"))
K1 = {"what": "a fresh dt every iteration", "fuse_iters": 1,
      "dispatch": "lists", "check_iters": 3, "trace_after_cycles": 2,
      "trace_cycles": 2}
# their limits: above what the kernel path's plain versions read against
# the float64 reference at this size on the CPU (state_l1 up to 7e-5,
# state_max 8e-4, rms_gap 4e-4), far below what a fault reads (0.1 or more)
TINY_LIMITS = {"flags_diff": 0, "wall_diff": 0, "unstable_diff": 0,
               "lmin_gap": 1e-5, "init_l1": 1e-5, "init_max": 1e-5,
               "state_l1": 1e-3, "state_max": 1e-2, "dt_gap": 1e-5,
               "rms_gap": 1e-2, "yplus_l1": 1e-5}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where none is present")


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


def tiny_deck(n: int):
    from openhyperflow2d_torch.examples import combustor_deck
    d = combustor_deck(n, n, cfl=0.05)
    d.data["Nmax"] = "20"
    return d


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark (``portbench`` and ``BENCHMARK.json``) with
    the small cells of ``TINY`` added as data; returns its ``portbench``
    directory."""
    from openhyperflow2d_torch.config.deck import deck_to_text
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    d = root / "configs" / "combustor_tiny"
    d.mkdir()
    (d / "deck.dat").write_text(deck_to_text(tiny_deck(64)))
    (d / "config.json").write_text(json.dumps({
        "deck": "deck.dat", "dtype": "float32", "fast_math": True,
        "perturbation": 1e-3, "source": "a small copy of a cell's deck",
        "reduced": [], "assumed": {}}))
    (root / "traffic" / "k1.json").write_text(json.dumps(K1))
    for cell, traffic in TINY:
        (root / "workloads" / f"{cell}.json").write_text(json.dumps({
            "config": "combustor_tiny", "traffic": traffic, "chips": 1,
            "why": "a small cell of the CPU tests", "limits": TINY_LIMITS}))
    return root
