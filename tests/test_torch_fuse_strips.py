"""Port parity: the X-strip kernel path's K-iteration blocks.

The port's ``make_kernel_shard_chunk(fuse_iters=K)`` against JAX's
``make_pallas_shard_chunk(fuse_iters=K, tile=(16, 16))`` on the 8-device
CPU mesh of tests/conftest.py, its Pallas kernel in interpret mode, in
float64; the port runs its strips in one process with ``LocalComm``, its
kernel wrappers on their plain versions (CPU tensors).  Both widen the
halo to halo_depth x K columns, take one dt minimum across strips at a
block's entry, run the block's K iterations over the extended strips and
exchange the halo once a block (shard_step.py:256-381).

* K = 2, n = 2 and 4, on the "even" and "uneven" decks of
  tests/test_torch_shard_step.py, 7 iterations (three blocks): fields rtol
  1e-10, atol 1e-8 (beta atol 3e-6), then one more iteration's RMS at rtol
  1e-8, atol 1e-12, as the K = 1 test holds them.
* ``overlap=True`` gives the bits of ``overlap=False`` at K = 2, and
  matches JAX's overlapped chunk (``sharded_inner_overlap``).
* One strip at K against the single domain at K, and the walls+step+heat
  deck's strips at K (a seam at the step face, and an overlapped form
  with inner tiles) against the single domain at K: fields to 1e-10 of
  their scale.
* The prologue and the epilogue at a halo of H K give the bits they give
  at H.
* A strip narrower than the halo (narrower than twice the halo with
  overlap), and fuse_iters > 1 on the eager strip path, raise.

Each JAX run is made once and shared by the tests that read it.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_shard_step import DECKS, FIELDS, assert_fields
from torch_parity import np_fields, port_case, scaled_err

from openhyperflow2d_tpu.parallel.mesh import make_mesh
from openhyperflow2d_tpu.parallel.shard_step import make_pallas_shard_chunk
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core.state import meta_from_grid
from openhyperflow2d_torch.ops.fused_step import TILE
from openhyperflow2d_torch.parallel import shard_step as tshard
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.runner import Solver

ITERS = 7
K = 2


@functools.lru_cache(maxsize=None)
def jax_run(deck, n, overlap=False):
    """(JAX case, fields after ITERS iterations, diags, RMS of one more
    iteration) of JAX's kernel strip chunk at fuse_iters=K."""
    jc = jinit.build_case(DECKS[deck]())
    s = JSolver(jc)
    fn = make_pallas_shard_chunk(
        s.meta, s.params, s.chem, (s.beta_xs, s.beta_ys),
        (s.cfl_xs, s.cfl_ys), s.params.TurbStartIter, make_mesh(n),
        tile=(16, 16), fuse_iters=K, overlap=overlap)
    s._chunk_fn = jax.jit(fn, static_argnums=(1,))
    d = {k: np.asarray(v) for k, v in s.run_iters(ITERS).items()}
    return jc, np_fields(s.state), d, np.asarray(s.run_iters(1)["RMS"])


def port_run(case, n, overlap=False, fuse_iters=K, iters=ITERS):
    """(solver, host state, diags, RMS of one more iteration) of the
    port's kernel strip chunk with n strips in this process."""
    s = Solver(case, device="cpu", use_kernels=True,
               comm=LocalComm(n, "cpu"), overlap=overlap,
               fuse_iters=fuse_iters)
    d = s.run_iters(iters)
    return s, s.host_state(), d, s.run_iters(1)["RMS"]


@pytest.mark.parametrize("deck", ["even", "uneven"])
@pytest.mark.parametrize("n", [2, 4])
def test_fused_strips_match_jax(deck, n):
    jc, want, wd, w_rms = jax_run(deck, n)
    s, got, gd, g_rms = port_run(port_case(jc), n)
    ch = s._chunk_fn
    assert (ch.K, ch.halo, ch.Xext) == (K, 2 * K, ch.X_loc + 4 * K)
    assert not gd["unstable"].any()
    assert_fields(got, want, beta_atol=3e-6)
    np.testing.assert_allclose(g_rms, w_rms, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gd["dt_used"], wd["dt_used"], rtol=1e-12)
    for key in ("unstable", "dt_overrun"):
        np.testing.assert_array_equal(gd[key], wd[key], key)
    # one frozen dt a block of K
    assert (gd["dt_used"][1::2] == gd["dt_used"][2::2]).all()


@pytest.mark.parametrize("deck", ["even", "uneven"])
@pytest.mark.parametrize("n", [2, 4])
def test_fused_overlap_gives_the_same_bits(deck, n):
    case = port_case(jinit.build_case(DECKS[deck]()))
    _, a, da, ra = port_run(case, n)
    s, b, db, rb = port_run(case, n, overlap=True)
    # on 2 strips the block's last pass12 runs over edge and inner tiles
    # apart (4 strips of 16 or 13 columns have no inner tile: every 8-row
    # tile holds a row within 2 halos of an end)
    assert n == 4 or all(st.plan.tiles("spec", "inner").numel()
                         + st.plan.tiles("general", "inner").numel()
                         for st in s._chunk_fn.steps)
    for f, v in a.items():
        np.testing.assert_array_equal(b[f], v, f)
    for k, v in da.items():
        np.testing.assert_array_equal(db[k], v, k)
    np.testing.assert_array_equal(rb, ra)


def test_fused_overlap_matches_jax_overlap():
    jc, want, wd, w_rms = jax_run("even", 2, overlap=True)
    _, got, gd, g_rms = port_run(port_case(jc), 2, overlap=True)
    assert_fields(got, want, beta_atol=3e-6)
    np.testing.assert_allclose(g_rms, w_rms, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gd["dt_used"], wd["dt_used"], rtol=1e-12)


@pytest.mark.parametrize("deck,fuse_iters", [("even", 2), ("even", 4),
                                             ("step_heat", 3)])
def test_one_strip_matches_the_single_domain(deck, fuse_iters):
    """One strip at K is the whole grid with zeroed halos of H K columns:
    the single-domain chunk's fields at K to 1e-10 of their scale."""
    case = port_case(jinit.build_case(DECKS[deck]()))
    ref = Solver(case, device="cpu", use_kernels=True, fuse_iters=fuse_iters)
    rd = ref.run_iters(ITERS)
    _, got, d, _ = port_run(case, 1, fuse_iters=fuse_iters)
    want = ref.host_state()
    errs = {f: scaled_err(want, got, f) for f in FIELDS + ["Yc", "mu_t"]}
    assert max(errs.values()) < 1e-10, errs
    for k, v in rd.items():
        assert d[k].shape == v.shape, k
    np.testing.assert_allclose(d["RMS"], rd["RMS"], rtol=1e-10)
    np.testing.assert_array_equal(d["dt_overrun"], rd["dt_overrun"])


@pytest.mark.parametrize("n,overlap", [(4, False), (2, False), (2, True)])
def test_step_heat_strips_at_k(n, overlap):
    """The walls+step+heat deck's strips at K = 2 against its single
    domain at K = 2 (fields to 1e-10 of scale): 4 strips put a seam at the
    step face, where the heat stage reads gfc's outputs two columns away;
    2 strips leave inner tiles to the overlapped form, whose heat source
    reads gfc's Tg at +-2 rows while the exchange writes the halos."""
    jc = jinit.build_case(DECKS["step_heat"]())
    case = port_case(jc)
    ref = Solver(case, device="cpu", use_kernels=True, fuse_iters=K)
    rd = ref.run_iters(ITERS)
    s, got, d, _ = port_run(case, n, overlap=overlap)
    ch = s._chunk_fn
    assert ch.steps[-1].has_heat or ch.steps[0].has_heat
    if overlap:
        inner = [int(st.plan.tiles("general", "inner").numel()
                     + st.plan.tiles("spec", "inner").numel())
                 for st in ch.steps]
        assert all(inner)
        # an inner tile's rows lie 2 halos or more inside the strip
        rows = [(st.plan.tiles(b, "inner").numpy() // st.plan.nby) * TILE[0]
                for st in ch.steps for b in ("spec", "general")]
        assert min(r.min() for r in rows if r.size) >= 2 * ch.halo
    want = ref.host_state()
    assert np.abs(got["Q_conv"]).max() > 0
    errs = {f: scaled_err(want, got, f)
            for f in FIELDS + ["Yc", "mu_t", "Q_conv"]}
    assert max(errs.values()) < 1e-10, errs
    np.testing.assert_array_equal(d["dt_overrun"], rd["dt_overrun"])


def test_prologue_and_epilogue_at_any_halo():
    """The strips' prologue pass12 and epilogue gfc (eager torch) at a
    halo of H K columns give the bits they give at H: both read at most H
    columns of the halo."""
    case = port_case(jinit.build_case(DECKS["uneven"]()))
    out = {}
    for fuse_iters in (1, 3):
        s = Solver(case, device="cpu", use_kernels=True,
                   comm=LocalComm(2, "cpu"), fuse_iters=fuse_iters)
        ch = s._chunk_fn
        assert ch.halo == ch.H * fuse_iters
        own, diag0 = ch.prologue(s.state, 0)
        ext = [torch.nn.functional.pad(c, (0, 0, ch.halo, ch.halo))
               for c in own]
        ch.fill_halos(ext)
        st, dt_new, uns = ch.epilogue(ext, s.state.strips[0].dt, s.state, 0)
        out[fuse_iters] = (own, diag0, st, dt_new, uns)
    (a_own, a_d, a_st, a_dt, a_u), (b_own, b_d, b_st, b_dt, b_u) = \
        out[1], out[3]
    for x, y in zip(a_own, b_own):
        assert torch.equal(x, y)
    for k in a_d:
        assert torch.equal(a_d[k], b_d[k]), k
    for x, y in zip(a_st.strips, b_st.strips):
        for f, v in x.__dict__.items():
            assert torch.equal(v, getattr(y, f)), f
    assert torch.equal(a_dt, b_dt) and torch.equal(a_u, b_u)


def test_strip_width_and_eager_refusals():
    """A strip narrower than the halo of H K columns, or with overlap=True
    narrower than two halos (shard_step.py:304-309), raises; so does
    fuse_iters > 1 on the eager strip path."""
    jc = jinit.build_case(DECKS["even"]())      # 64 columns: 16 a strip
    case = port_case(jc)
    p = case.params
    args = (meta_from_grid(case.grid, dtype=p.torch_dtype), p)
    s = Solver(case, device="cpu", use_kernels=True, comm=LocalComm(4, "cpu"),
               fuse_iters=8)                     # halo 16: fits
    assert s._chunk_fn.halo == s._chunk_fn.X_loc == 16
    with pytest.raises(ValueError, match="fewer than the halo of 18"):
        Solver(case, device="cpu", use_kernels=True,
               comm=LocalComm(4, "cpu"), fuse_iters=9)
    Solver(case, device="cpu", use_kernels=True, comm=LocalComm(4, "cpu"),
           overlap=True, fuse_iters=4)           # 2 halos of 8: fits
    with pytest.raises(ValueError, match="overlap=True needs strips"):
        Solver(case, device="cpu", use_kernels=True,
               comm=LocalComm(4, "cpu"), overlap=True, fuse_iters=5)
    with pytest.raises(ValueError, match="fuse_iters=2"):
        Solver(case, device="cpu", use_kernels=False,
               comm=LocalComm(2, "cpu"), fuse_iters=2)
    # the eager strip chunk has no blocks: its halo stays H
    assert tshard.ShardChunk(*args, s.chem, s.beta_tab, s.cfl_tab,
                             p.TurbStartIter, LocalComm(2, "cpu")).halo == 2
