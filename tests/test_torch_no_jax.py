"""The port runs without jax: in a fresh interpreter where ``import jax``
fails, build the combustor, run 3 eager iterations on the CPU, and check
that no jax module was loaded.  This is what lets chip_smoke.py run on a
machine that has torch and no jax."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import json, sys
sys.modules["jax"] = None          # any import of jax now raises
import numpy as np
import torch
torch.set_num_threads(2)
from openhyperflow2d_torch.examples import combustor_deck
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver
s = Solver(build_case(combustor_deck(32, 32)), device="cpu")
d = s.run_iters(3)
print(json.dumps({
    "use_kernels": s.use_kernels,
    "finite": bool(torch.isfinite(s.state.S).all()),
    "unstable": bool(d["unstable"].any()),
    "rms_shape": list(d["RMS"].shape),
    "jax": sorted(m for m, v in sys.modules.items()
                  if v is not None and m.split(".")[0] in ("jax", "jaxlib")),
}))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"use_kernels": False, "finite": True, "unstable": False,
                   "rms_shape": [3, 9], "jax": []}
