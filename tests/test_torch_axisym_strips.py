"""The strip path on the extended decks: d2*-NULL soft BCs (a halo depth
H = 3), axisymmetric flow and external sources (the source field sliced
per strip with its halos), against the single domain.

On the CPU the kernel strip chunk runs the kernels' plain versions on each
extended strip; every node of a strip computes what the single domain's
does from the same inputs and the dt minimum is exact, so:

* the kernel strip chunk (``LocalComm(4, "cpu")``), sequential and
  overlapped, at K = 1 and K = 2 (halos of 3 and 6 columns on the d2
  deck), is bit for bit the single domain's kernel path at the same K
  after 5 iterations (the diags too, but RMS, summed across the strips
  in another order: rtol 1e-12), on the axisymmetric d2/NRBC k-eps
  channel (the JAX package's _nrbc_d2_axisym_deck at 48x40, the port's
  own build) and on scramjet_deck(64, 48) (its source sliced per strip);
* the eager strip chunk is bit for bit the eager single domain;
* ``Solver.set_sources`` reaches the strips' next chunk: after it the
  strips are bit for bit the single domain given the same field, and both
  part from a run without it.
"""

import functools

import numpy as np
import pytest
import torch

from openhyperflow2d_torch import examples as ex
from openhyperflow2d_torch.ops.fused_step import EXT_KERNEL_NAMES
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

FIELDS = ("S", "beta", "U", "V", "p", "Tg", "Yc", "mu_t", "F", "Src",
          "dt")


def nrbc_d2_axisym_deck():
    """tests/test_static_ctx.py:25-37's deck, built by the port."""
    d = ex.channel_deck(nx=48, ny=40, problem_type=1, turb_model=4,
                        turb_ext_model=0, flow_type=1)
    d.data["Contour1.Bound1.Cond"] = "NT_FARFIELD_2D"
    d.data["Contour1.Bound2.Cond"] = ("NT_D2X_2D, TCT_dkdx_NULL_2D, "
                                      "TCT_depsdx_NULL_2D")
    d.data["Contour1.Bound3.Cond"] = ("NT_D0Y_2D, NT_D2Y_2D, "
                                      "TCT_k_CONST_2D, TCT_eps_CONST_2D")
    return d


DECKS = {"nrbc_d2": nrbc_d2_axisym_deck,
         "scramjet": lambda: ex.scramjet_deck(64, 48)}


@functools.lru_cache(maxsize=None)
def case(name):
    return build_case(DECKS[name]())


def state_of(solver) -> dict:
    return {k: torch.as_tensor(v) for k, v in solver.host_state().items()}


def assert_same_bits(a: dict, b: dict):
    for f in FIELDS:
        assert torch.equal(a[f], b[f]), f


@functools.lru_cache(maxsize=None)
def single(name, K, kernels=True):
    s = Solver(case(name), device="cpu", use_kernels=kernels, fuse_iters=K)
    d = s.run_iters(5)
    return state_of(s), d


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("name", sorted(DECKS))
def test_kernel_strips_match_the_single_domain(name, K, overlap):
    ss = Solver(case(name), device="cpu", use_kernels=True, fuse_iters=K,
                comm=LocalComm(4, "cpu"), overlap=overlap)
    chunk = ss._chunk_fn
    assert chunk.H == (3 if name == "nrbc_d2" else 2)
    assert chunk.halo == chunk.H * K
    assert all(n in EXT_KERNEL_NAMES
               for st in chunk.steps for n in st.iteration_launches())
    d = ss.run_iters(5)
    want, wd = single(name, K)
    assert_same_bits(want, state_of(ss))
    for k in wd:
        if k == "RMS":
            # summed across the strips in another order
            np.testing.assert_allclose(d[k], wd[k], rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(d[k], wd[k], k)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_eager_strips_match_the_single_domain(name):
    ss = Solver(case(name), device="cpu", use_kernels=False,
                comm=LocalComm(4, "cpu"))
    ss.run_iters(5)
    assert_same_bits(single(name, 1, False)[0], state_of(ss))


@pytest.mark.parametrize("kernels", [True, False])
def test_set_sources_reaches_the_strips(kernels):
    """A doubled source field, set between two chunks, reaches the strips'
    next chunk as the single domain's."""
    c = case("scramjet")
    src = torch.as_tensor(c.grid.Src) * 2.0
    runs = {}
    for layout in ("single", "strips", "unset"):
        comm = LocalComm(4, "cpu") if layout == "strips" else None
        s = Solver(c, device="cpu", use_kernels=kernels, comm=comm)
        s.run_iters(2)
        if layout != "unset":
            s.set_sources(src)
        s.run_iters(3)
        runs[layout] = state_of(s)
    assert_same_bits(runs["single"], runs["strips"])
    assert not torch.equal(runs["single"]["S"], runs["unset"]["S"])
