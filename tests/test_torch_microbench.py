"""Port parity: the microbenchmark chains (bench/microbench) against the
JAX scripts' own kernels.

``scripts/shift_microbench.py`` and ``scripts/vpu_div_peak.py`` are loaded
by path; their ``make_kernel`` runs the Pallas kernel in interpret mode on
the CPU (shift_microbench.py:62, vpu_div_peak.py:41), on the scripts' own
input (``default_rng(0)``, a (256, 512) float32 block).  The port's
wrappers take CPU tensors, so they run the plain versions.

* The four shift chains, the exact reciprocal and sqrt: bit for bit.  Each
  step rounds once on both sides (an add, a correctly rounded reciprocal
  times 2, a sqrt plus 1), in the same order.
* div: XLA simplifies ``2 / (2 / q)`` to ``q``, so the script's chain of 96
  divisions returns its input, while the port divides 96 times (as the
  TPU kernel and the CUDA kernel do): held to one ulp, and bit for bit to
  numpy's IEEE chain.
* mul-add, rsqrt and the approximate reciprocal within a stated tolerance
  (``TOL``): XLA's CPU backend contracts ``q * a + b`` into an FMA, rounds
  rsqrt its own way, and interpret mode's ``approx=True`` reciprocal keeps
  about 14 bits.  mul-add is also held bit for bit to numpy's chain with
  the product and the sum rounded apart.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhyperflow2d_torch.bench import microbench as mb

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"

# relative tolerance of the ops that are not pinned, with the reason:
TOL = {
    # the FMA rounds once a step, the product and the sum rounded apart
    # twice: up to one ulp a step of a map whose slope is ~1, 96 ulps of
    # ~1.0 (1.1e-5)
    "mul-add (baseline)": 2e-5,
    # one ulp of values in [1, 2) (see div above)
    "div": 2.4e-7,
    # a few ulps a step of a map whose slope at its fixed point (~1.755) is
    # ~0.22, so the differences do not grow: a few ulps in all
    "rsqrt": 1e-6,
    # interpret mode's approximate reciprocal is good to ~2^-14 (6e-5) a
    # step, and x -> 2/x is a 2-cycle that neither damps nor grows a
    # difference: 96 x 6e-5 (5.9e-3)
    "reciprocal approx": 1e-2,
}
# numpy's float32 chains, each op rounded once (IEEE)
NUMPY_STEP = {
    "mul-add (baseline)": lambda q: q * np.float32(1.000001)
    + np.float32(1e-7),
    "div": lambda q: np.float32(2.0) / q,
}


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shift_script():
    return load_script("shift_microbench")


@pytest.fixture(scope="module")
def div_script():
    return load_script("vpu_div_peak")


def test_constants_match_the_scripts(shift_script, div_script):
    assert (mb.N_SHIFT, mb.SHAPE) == (shift_script.N_CHAIN,
                                      shift_script.SHAPE)
    assert (mb.N_DIV, mb.SHAPE) == (div_script.N_CHAIN, div_script.SHAPE)
    assert mb.DIV_OPS == tuple(div_script.OPS)


@pytest.mark.parametrize("label", list(mb.SHIFTS))
def test_shift_chain_matches_the_script(shift_script, label):
    fn = getattr(shift_script, "shift_" + label.replace("-", "_"))
    x = mb.shift_input()
    want = np.asarray(jax.jit(shift_script.make_kernel(fn))(jnp.asarray(x)))
    mb.reset_launches()
    got = mb.shift_chain(torch.as_tensor(x), *mb.SHIFTS[label]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not any(mb.LAUNCHES.values())    # the plain version ran


@pytest.mark.parametrize("op", mb.DIV_OPS)
def test_div_chain_matches_the_script(div_script, op):
    x = mb.div_input()
    want = np.asarray(div_script.make_kernel(div_script.OPS[op])(
        jnp.asarray(x)))
    got = mb.div_chain(torch.as_tensor(x), op).numpy()
    assert got.dtype == np.float32
    assert np.isfinite(got).all()
    if op in TOL:
        np.testing.assert_allclose(got, want, rtol=TOL[op], atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    if op in NUMPY_STEP:
        q = x
        for _ in range(mb.N_DIV):
            q = NUMPY_STEP[op](q)
        assert q.dtype == np.float32
        np.testing.assert_array_equal(got, q)


def test_wrappers_do_not_fall_back():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel's checks or raises, and nothing is counted."""
    mb.reset_launches()
    x = torch.zeros(mb.SHAPE, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mb.shift_chain(x, 0, False)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mb.div_chain(x, "div")
    with pytest.raises(ValueError, match="unknown op"):
        mb.div_chain(torch.ones(mb.SHAPE), "exp")
    with pytest.raises(ValueError, match="axis"):
        mb.shift_chain(torch.ones(mb.SHAPE), 2, False)
    assert set(mb.LAUNCHES) == set(mb.kernel_names())
    assert not any(mb.LAUNCHES.values())


def test_microbench_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mb.main([]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
