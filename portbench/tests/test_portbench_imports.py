"""No run of the harness loads JAX or the JAX package, and the reference
loads nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "openhyperflow2d_tpu"}

RUN = """
import json, sys
from pathlib import Path
import torch
torch.set_num_threads(2)
from portbench import calibrate, check, harness, inputs, registry, run, trace
root = Path(sys.argv[1])
r = harness.run("combustor_tiny_k1", 7, 0.2, True, device="cpu", root=root)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import portbench.reference.chunk
import portbench.reference.solver.init
import portbench.reference.core.physics
from portbench import check, inputs
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tiny_root):
    top = set(_modules(RUN, tiny_root))
    assert not top & BANNED
    assert "openhyperflow2d_torch" in top


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules(REFERENCE)
    assert not {m.split(".")[0] for m in mods} & BANNED
    assert not [m for m in mods if m.split(".")[0] == "openhyperflow2d_torch"]
