"""The port runs without jax and without the JAX package: in a fresh
interpreter where ``import jax`` and ``import openhyperflow2d_tpu`` fail,
build the combustor and the walls+step+heat combustor with the port alone,
run 3 eager iterations of each on the CPU, import the multi-device and
microbenchmark modules, the CLI, the output writers and the checkpoint,
run 3 iterations of the combustor through the eager strip chunk in two
strips (``LocalComm(2)``), and check that no module of jax, jaxlib or the
JAX package was loaded.  This is what lets
chip_smoke.py run on a machine that has torch and no jax."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import json, sys
sys.modules["jax"] = None                  # any import of jax now raises
sys.modules["openhyperflow2d_tpu"] = None  # and of the JAX package
import numpy as np
import torch
torch.set_num_threads(2)
from openhyperflow2d_torch.examples import combustor_deck
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver
import openhyperflow2d_torch.bench.microbench
import openhyperflow2d_torch.parallel.multihost
import openhyperflow2d_torch.parallel.shard_step
import openhyperflow2d_torch.io_out.host
import openhyperflow2d_torch.io_out.swapfile
import openhyperflow2d_torch.io_out.tecplot
import openhyperflow2d_torch.postproc.outcfd
import openhyperflow2d_torch.solver.checkpoint
import openhyperflow2d_torch.cli
from openhyperflow2d_torch.parallel.comm import LocalComm
out = {}
for name, deck in (("combustor", combustor_deck(32, 32)),
                   ("step_heat", combustor_deck(32, 48, with_step=True,
                                                adiabatic=False))):
    s = Solver(build_case(deck), device="cpu")
    d = s.run_iters(3)
    out[name] = {
        "use_kernels": s.use_kernels,
        "finite": bool(torch.isfinite(s.state.S).all()),
        "unstable": bool(d["unstable"].any()),
        "rms_shape": list(d["RMS"].shape),
        "heat": bool(s.state.Q_conv.abs().max() > 0),
    }
s = Solver(build_case(combustor_deck(32, 48)), device="cpu",
           use_kernels=False, comm=LocalComm(2, "cpu"))
d = s.run_iters(3)
full = s.host_state()
out["strips"] = {
    "use_kernels": s.use_kernels,
    "finite": bool(np.isfinite(full["S"]).all()),
    "unstable": bool(d["unstable"].any()),
    "rms_shape": list(d["RMS"].shape),
    "gathered": list(full["S"].shape),
}
out["loaded"] = sorted(m for m, v in sys.modules.items()
                       if v is not None and m.split(".")[0] in
                       ("jax", "jaxlib", "openhyperflow2d_tpu"))
print(json.dumps(out))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    run = {"use_kernels": False, "finite": True, "unstable": False,
           "rms_shape": [3, 9]}
    assert out == {"combustor": {**run, "heat": False},
                   "step_heat": {**run, "heat": True},
                   "strips": {**run, "gathered": [9, 32, 48]},
                   "loaded": []}
