"""Port parity: Euler decks (ProblemType=0) on the kernel path and on the
strip path.

On CPU tensors the port's kernel wrappers run their plain versions:
``gfc_plain`` with the chunk-constant lam_t plane (``FusedStep.mf``'s
META_LAM_T, what ``gfc_euler_kernel`` reads), ``pass12_plain`` as on NS
decks.  Every tile of an Euler deck is general (no spec body outside
SM_NS+k-eps).

* Decks: channel_deck(32, 24), freestream_deck(nx=32, ny=24),
  cylinders_deck(64, 48) (also with conducting walls, isAdiabaticWall=0,
  which runs the heat stage on lam + the lam_t plane) and
  bubble_deck(48, 32).
* The kernel chunk against JAX's ``Solver(use_pallas=True,
  pallas_tile=(16, 128))``, the Pallas kernel in interpret mode, float64,
  at K = 1 and K = 4, over two 6-iteration cycles, the second started from
  JAX's state after the first (as tests/test_torch_fuse.py does): fields
  to 1e-10 of each plane's scale, beta by ``beta_err`` where the equation
  is above 1e-4 of its scale (``BETA_FLOOR``), RMS and dt_used to rtol
  1e-10, the unstable and dt_overrun rows exactly, lam_t unchanged.
  The bubble deck is held to 1e-8 of scale and its RMS to 1e-8: there
  JAX's compiled XLA parts from JAX op by op by 3.5e-10 of U after 5
  iterations (tests/test_torch_euler.py holds the eager port to op-by-op
  JAX at 1e-13).  The conducting cylinders at K = 4 are held to 1e-8 of
  scale too: the heat source reads Tg two nodes from the wall under a dt
  frozen over 4 iterations, and ulp differences at the impulsive start
  grow there as on the step deck of tests/test_torch_kernel_path_heat.py
  (5.5e-10 of S after the second cycle; 1.8e-11 at K = 1).
* The strip chunks against JAX's on the 8-device CPU mesh
  (``make_shard_chunk``, ``make_pallas_shard_chunk(fuse_iters=K,
  tile=(16, 16))``) over 7 iterations, with the lam_t plane extended per
  strip with its halo: fields rtol 1e-10, atol 1e-8, beta atol 3e-6
  (tests/test_torch_shard_step.py's gates), dt_used rtol 1e-12.
* The dual dispatch gives the lists form's bits on an Euler deck, and the
  strips (sequential and overlapped, K = 1 and 2) the single domain's.
* The plain gfc reads lam_t from the meta plane: a changed plane changes
  the heat stage's lam_eff.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch_parity import beta_err, np_fields, port_case, scaled_err

from openhyperflow2d_tpu import examples as jex
from openhyperflow2d_tpu.parallel.mesh import make_mesh
from openhyperflow2d_tpu.parallel.shard_step import (make_pallas_shard_chunk,
                                                     make_shard_chunk)
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core.state import state_from_numpy
from openhyperflow2d_torch.ops.fused_step import META_LAM_T
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.parallel.multihost import gather_state
from openhyperflow2d_torch.solver.runner import Solver

DECKS = {
    "channel": lambda: jex.channel_deck(32, 24),
    "freestream": lambda: jex.freestream_deck(nx=32, ny=24),
    "cylinders": lambda: jex.cylinders_deck(64, 48),
    "bubble": lambda: jex.bubble_deck(48, 32),
    "cylinders_heat": lambda: _conducting(jex.cylinders_deck(64, 48)),
}
FIELDS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu", "mu_t",
          "lam_t", "dt"]
CYCLE = 6
STRIP_ITERS = 7
# beta is compared where the equation's |S| exceeds this share of its
# scale: in these streams along x rhoV sits at 1e-6..1e-4 of its scale
# over much of the field, where a dt one ulp off XLA's (seen against JAX
# op by op as well) moves beta by up to 7e-6 at K = 4
BETA_FLOOR = 1e-4


def _conducting(deck):
    """An Euler deck with conjugate heat at its walls (the heat stage's
    lam_eff is lam + the lam_t plane)."""
    deck.data["isAdiabaticWall"] = "0"
    return deck


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-300)))


@functools.lru_cache(maxsize=None)
def jax_cycles(deck, K):
    """(JAX case, [(fields, diags) after each of two cycles]) of JAX's
    Pallas path at fuse_iters=K."""
    jc = jinit.build_case(DECKS[deck]())
    jc.Nstep = CYCLE
    js = JSolver(jc, use_pallas=True, pallas_fuse=K, pallas_tile=(16, 128))
    out = []
    for _ in range(2):
        wd, _ = js.run_cycle()
        out.append((np_fields(js.state),
                    {k: np.asarray(v) for k, v in wd.items()}))
    return jc, out


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_kernel_chunk_matches_pallas_f64(deck, K):
    jc, want_cycles = jax_cycles(deck, K)
    ts = Solver(port_case(jc), device="cpu", use_kernels=True, fuse_iters=K)
    assert ts.fused.euler and ts.fused.plan.spec_tiles.numel() == 0
    lam_t0 = ts.state.lam_t.clone()
    tol = 1e-8 if deck == "bubble" or (deck, K) == ("cylinders_heat",
                                                    4) else 1e-10
    for c, (want, wd) in enumerate(want_cycles):
        if c:
            ts.state = state_from_numpy(want_cycles[c - 1][0])
        gd, _ = ts.run_cycle()
        got = ts.host_state()
        errs = {f: scaled_err(want, got, f) for f in FIELDS}
        assert max(errs.values()) < tol, errs
        assert beta_err(want, got, floor=BETA_FLOOR) < 1.0
        assert rel(gd["RMS"], wd["RMS"]) < (1e-8 if deck == "bubble"
                                            else 1e-10)
        assert rel(gd["dt_used"], wd["dt_used"]) < tol
        for key in ("unstable", "dt_overrun"):
            np.testing.assert_array_equal(gd[key], wd[key], key)
        assert not gd["unstable"].any()
    assert torch.equal(ts.state.lam_t, torch.as_tensor(
        want_cycles[0][0]["lam_t"])) and torch.equal(lam_t0,
                                                     ts.state.lam_t)


@functools.lru_cache(maxsize=None)
def jax_strips(deck, n, kernel, K=1):
    jc = jinit.build_case(DECKS[deck]())
    s = JSolver(jc)
    args = (s.meta, s.params, s.chem, (s.beta_xs, s.beta_ys),
            (s.cfl_xs, s.cfl_ys), s.params.TurbStartIter, make_mesh(n))
    fn = (make_pallas_shard_chunk(*args, tile=(16, 16), fuse_iters=K)
          if kernel else make_shard_chunk(*args))
    s._chunk_fn = jax.jit(fn, static_argnums=(1,))
    d = {k: np.asarray(v) for k, v in s.run_iters(STRIP_ITERS).items()}
    return jc, np_fields(s.state), d


@pytest.mark.parametrize("deck,n,kernel,K", [
    ("cylinders", 2, False, 1), ("cylinders", 4, True, 1),
    ("cylinders", 2, True, 2), ("channel", 2, True, 1),
    ("channel", 4, False, 1)])
def test_strips_match_jax(deck, n, kernel, K):
    jc, want, wd = jax_strips(deck, n, kernel, K)
    ts = Solver(port_case(jc), device="cpu", use_kernels=kernel,
                comm=LocalComm(n, "cpu"), fuse_iters=K)
    gd = ts.run_iters(STRIP_ITERS)
    got = ts.host_state()
    assert not gd["unstable"].any()
    for f in ["S", "beta", "U", "V", "p", "Tg", "lam_t", "mu_t"]:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-10,
                                   atol=3e-6 if f == "beta" else 1e-8,
                                   err_msg=f)
    np.testing.assert_allclose(gd["dt_used"], wd["dt_used"], rtol=1e-12)
    np.testing.assert_array_equal(gd["unstable"], wd["unstable"])


def _f32(deck):
    import dataclasses

    from openhyperflow2d_torch import examples as tex
    from openhyperflow2d_torch.solver.init import build_case
    case = build_case(getattr(tex, f"{deck}_deck")(64, 48), dtype="float32")
    case.params = dataclasses.replace(case.params, fast_math=True)
    return case


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("S", "beta", "U", "V", "p", "Tg", "Yc", "mu_t",
                         "lam_t"))


def test_dual_gives_the_lists_bits():
    case = _f32("cylinders")
    a = Solver(case, device="cpu", use_kernels=True, dispatch="lists")
    b = Solver(case, device="cpu", use_kernels=True, dispatch="dual")
    assert b.fused.iteration_launches() == ["gfc_euler_kernel<dual>",
                                            "pass12_kernel<dual>"]
    da, db = a.run_iters(9), b.run_iters(9)
    assert _same(a.state, b.state)
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], k)


@pytest.mark.parametrize("overlap,K", [(False, 1), (True, 1), (False, 2),
                                       (True, 2)])
def test_strips_give_the_single_domain_bits(overlap, K):
    case = _f32("cylinders")
    single = Solver(case, device="cpu", use_kernels=True, fuse_iters=K)
    strips = Solver(case, device="cpu", use_kernels=True, fuse_iters=K,
                    comm=LocalComm(2, "cpu"), overlap=overlap)
    for m in (5, 8):
        ds, dp = single.run_iters(m), strips.run_iters(m)
        full = gather_state(strips.state, strips.comm, case.params.MaxX)
        assert _same(single.state, full), m
        np.testing.assert_array_equal(ds["dt_used"], dp["dt_used"])


def test_plain_gfc_reads_the_lam_t_plane():
    """gfc's heat-stage input lam_eff is lam + the lam_t plane on an Euler
    deck: a plane of 1s raises it by 1 at every node."""
    case = _f32("cylinders")
    s = Solver(case, device="cpu", use_kernels=True)
    step, ch = s.fused, s._chunk_fn
    step.has_heat = True        # make gfc_plain write lam_eff
    ca, _, raw, kaux = ch.prologue(s.state, 2, 0)
    dt = s.state.dt

    def lam_eff(plane):
        step.set_lam_t(plane)
        cb, scr = torch.empty_like(ca), torch.empty((31,) + ca.shape[1:])
        pi = torch.zeros((step.plan.n_tiles, 2), dtype=torch.int32)
        step.gfc_plain(ca, cb, scr, dt, kaux[0], pi)
        return scr[29].clone()

    zero = lam_eff(torch.zeros_like(s.state.lam_t))
    one = lam_eff(torch.ones_like(s.state.lam_t))
    assert torch.equal(step.mf[META_LAM_T], torch.ones_like(zero))
    np.testing.assert_allclose((one - zero).numpy(), 1.0, rtol=1e-6)
