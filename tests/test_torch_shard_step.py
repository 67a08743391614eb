"""Port parity: the X-strip path (parallel/shard_step) against JAX's.

Each JAX chunk runs on the 8-device CPU mesh of tests/conftest.py, its
Pallas kernel in interpret mode (as tests/test_shard_step.py runs it), in
float64; the port runs its strips in one process with ``LocalComm``, its
kernel wrappers on their plain versions (CPU tensors).

* The eager strip chunk (``make_shard_chunk``) against JAX's, n = 2 and 4,
  on ``reacting_rans_deck(64, 32)`` and on an X that 4 does not divide
  (``reacting_rans_deck(50, 32)``; JAX's own uneven tests use
  ``channel_deck``, an Euler deck, which the port refuses): rtol 1e-10,
  atol 1e-8 (tests/test_shard_step.py:40).
* The kernel strip chunk against JAX's ``make_pallas_shard_chunk(
  fuse_iters=1, tile=(16, 16))`` on the same decks over 7 iterations:
  fields rtol 1e-10, atol 1e-8, then one more iteration's RMS at rtol 1e-8,
  atol 1e-12 (tests/test_shard_step.py:90-96).
* ``halo_ablate`` against JAX's: the same fields, wrong at the seams.
* ``overlap=True`` gives the same bits as ``overlap=False`` in the port; the
  port's overlapped chunk against JAX's, beta at atol 3e-6
  (tests/test_shard_step.py:122).
* One strip against the single-domain ``KernelChunk``: the fields to 1e-10
  of their scale.
* The walls+step+heat deck with a strip seam at the step face: the heat
  stage reads gfc's outputs two columns away, so this is where a halo of 2
  would show if it were short.  The port's strips against the port's
  single domain and against JAX's strip chunk.

Each JAX run is made once and shared by the tests that read it.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch_parity import np_fields, port_case, scaled_err

from openhyperflow2d_tpu.examples import combustor_deck, reacting_rans_deck
from openhyperflow2d_tpu.parallel.mesh import make_mesh
from openhyperflow2d_tpu.parallel.shard_step import (make_pallas_shard_chunk,
                                                     make_shard_chunk)
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.core.state import meta_from_grid
from openhyperflow2d_torch.ops.fused_step import TILE, FusedStep
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.parallel import shard_step as tshard
from openhyperflow2d_torch.solver.runner import Solver

DECKS = {"even": lambda: reacting_rans_deck(64, 32),
         "uneven": lambda: reacting_rans_deck(50, 32),
         "step_heat": lambda: combustor_deck(48, 40, with_step=True,
                                             adiabatic=False)}
ITERS = 7
FIELDS = ["S", "beta", "U", "V", "p", "Tg"]


@functools.lru_cache(maxsize=None)
def jax_run(deck, n, kernel, overlap=False, halo_ablate=False):
    """(JAX case, fields after ITERS iterations, diags, RMS of one more
    iteration) of JAX's strip chunk on an n-device mesh."""
    jc = jinit.build_case(DECKS[deck]())
    s = JSolver(jc)
    args = (s.meta, s.params, s.chem, (s.beta_xs, s.beta_ys),
            (s.cfl_xs, s.cfl_ys), s.params.TurbStartIter, make_mesh(n))
    fn = (make_pallas_shard_chunk(*args, tile=(16, 16), fuse_iters=1,
                                  overlap=overlap)
          if kernel else make_shard_chunk(*args, halo_ablate=halo_ablate))
    s._chunk_fn = jax.jit(fn, static_argnums=(1,))
    d = {k: np.asarray(v) for k, v in s.run_iters(ITERS).items()}
    fields = np_fields(s.state)
    return jc, fields, d, np.asarray(s.run_iters(1)["RMS"])


def port_run(jc, n, kernel, overlap=False, halo_ablate=False):
    """(solver, host state, diags, RMS of one more iteration) of the
    port's strip chunk with n strips in this process."""
    case = port_case(jc)
    s = Solver(case, device="cpu", use_kernels=kernel,
               comm=LocalComm(n, "cpu"), overlap=overlap)
    if halo_ablate:
        p = s.params
        s._chunk_fn = tshard.make_shard_chunk(
            meta_from_grid(case.grid, dtype=p.torch_dtype), p, s.chem,
            s.beta_tab, s.cfl_tab, p.TurbStartIter, s.comm, halo_ablate=True)
    d = s.run_iters(ITERS)
    st = s.host_state()
    return s, st, d, s.run_iters(1)["RMS"]


def assert_fields(got, want, beta_atol=1e-8):
    for f in FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-10,
                                   atol=beta_atol if f == "beta" else 1e-8,
                                   err_msg=f)


@pytest.mark.parametrize("deck", ["even", "uneven"])
@pytest.mark.parametrize("n", [2, 4])
def test_eager_strips_match_jax(deck, n):
    jc, want, wd, _ = jax_run(deck, n, kernel=False)
    _, got, gd, _ = port_run(jc, n, kernel=False)
    assert not gd["unstable"].any()
    assert_fields(got, want)
    np.testing.assert_allclose(gd["RMS"], wd["RMS"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gd["dt_used"], wd["dt_used"], rtol=1e-12)


def test_halo_ablate_matches_jax():
    """halo_ablate (each strip's own far columns in place of the exchange,
    BASELINE.md's halo-overhead method): wrong at the seams, the same
    wrong fields as JAX's."""
    jc, want, wd, _ = jax_run("even", 2, kernel=False, halo_ablate=True)
    _, got, gd, _ = port_run(jc, 2, kernel=False, halo_ablate=True)
    assert_fields(got, want)
    np.testing.assert_allclose(gd["dt_used"], wd["dt_used"], rtol=1e-12)
    _, exchanged, _, _ = jax_run("even", 2, kernel=False)
    assert not np.allclose(want["S"], exchanged["S"], rtol=1e-6)


@pytest.mark.parametrize("deck", ["even", "uneven"])
@pytest.mark.parametrize("n", [2, 4])
def test_kernel_strips_match_jax(deck, n):
    jc, want, wd, w_rms = jax_run(deck, n, kernel=True)
    s, got, gd, g_rms = port_run(jc, n, kernel=True)
    assert not gd["unstable"].any()
    assert_fields(got, want, beta_atol=3e-6)
    np.testing.assert_allclose(g_rms, w_rms, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gd["dt_used"], wd["dt_used"], rtol=1e-12)
    for key in ("unstable", "dt_overrun"):
        np.testing.assert_array_equal(gd[key], wd[key], key)
    # every strip ran its tile plan over its extended strip
    assert all(st.plan.X == s._chunk_fn.Xext for st in s._chunk_fn.steps)


@pytest.mark.parametrize("deck", ["even", "uneven"])
@pytest.mark.parametrize("n", [2, 4])
def test_overlap_gives_the_same_bits(deck, n):
    jc = jinit.build_case(DECKS[deck]())
    _, a, da, ra = port_run(jc, n, kernel=True)
    _, b, db, rb = port_run(jc, n, kernel=True, overlap=True)
    for f, v in a.items():
        np.testing.assert_array_equal(b[f], v, f)
    for k, v in da.items():
        np.testing.assert_array_equal(db[k], v, k)
    np.testing.assert_array_equal(rb, ra)


def test_overlap_matches_jax_overlap():
    jc, want, wd, w_rms = jax_run("even", 2, kernel=True, overlap=True)
    _, got, gd, g_rms = port_run(jc, 2, kernel=True, overlap=True)
    assert_fields(got, want, beta_atol=3e-6)
    np.testing.assert_allclose(g_rms, w_rms, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("deck", ["even", "step_heat"])
def test_one_strip_matches_the_single_domain(deck):
    """One strip is the whole grid with zeroed halos at both ends: the
    single-domain kernel chunk's fields to 1e-10 of their scale."""
    case = port_case(jinit.build_case(DECKS[deck]()))
    ref = Solver(case, device="cpu", use_kernels=True)
    rd = ref.run_iters(ITERS)
    s = Solver(case, device="cpu", use_kernels=True,
               comm=LocalComm(1, "cpu"))
    d = s.run_iters(ITERS)
    want, got = ref.host_state(), s.host_state()
    assert set(got) == set(want)
    errs = {f: scaled_err(want, got, f) for f in FIELDS + ["Yc", "mu_t"]}
    assert max(errs.values()) < 1e-10, errs
    assert set(d) == set(rd)
    for k, v in rd.items():
        assert d[k].shape == v.shape, k
    np.testing.assert_allclose(d["RMS"], rd["RMS"], rtol=1e-10)


def test_step_heat_seam_at_the_step_face():
    """4 strips of the 48x40 walls+step+heat combustor put a seam at the
    step face: the port's strips against its single domain (fields to
    1e-10 of scale) and against JAX's strip chunk."""
    jc, want, wd, w_rms = jax_run("step_heat", 4, kernel=True)
    solid_cols = np.nonzero((np.asarray(jc.grid.CT) & fl.CT_SOLID_2D)
                            .any(axis=1))[0]
    # the step's face is its first solid column; a seam lies within 2
    X_loc = jc.params.MaxX // 4
    seams = np.arange(1, 4) * X_loc
    assert np.min(np.abs(seams - solid_cols.min())) <= 2
    s, got, gd, g_rms = port_run(jc, 4, kernel=True)
    assert s._chunk_fn.steps[-1].has_heat
    assert np.abs(got["Q_conv"]).max() > 0
    assert_fields(got, want)
    np.testing.assert_allclose(g_rms, w_rms, rtol=1e-8, atol=1e-12)
    ref = Solver(port_case(jc), device="cpu", use_kernels=True)
    ref.run_iters(ITERS)
    single = ref.host_state()
    errs = {f: scaled_err(single, got, f)
            for f in FIELDS + ["Yc", "mu_t", "Q_conv"]}
    assert max(errs.values()) < 1e-10, errs


def test_strip_layout_and_tile_parts():
    """Padded X, zeroed meta at the global edges, the windows, and the
    edge/inner split of each strip's tiles."""
    jc = jinit.build_case(DECKS["uneven"]())
    s = Solver(port_case(jc), device="cpu", use_kernels=True,
               comm=LocalComm(4, "cpu"))
    ch = s._chunk_fn
    H = ch.H
    assert (ch.px, ch.X_loc, ch.Xext) == (2, 13, 13 + 2 * H)
    for k, m in enumerate(ch.meta_ext):
        for f in tshard.ZERO_EDGE:
            a = getattr(m, f)
            assert (k != 0 or not a[:H].any()), (k, f)
            assert (k != 3 or not a[-H:].any()), (k, f)
    # the last strip's two pad columns are inactive
    assert not ch.ctx[3].active[H + ch.X_loc - 2:H + ch.X_loc].any()
    TX = TILE[0]
    for step in ch.steps:
        plan = step.plan
        assert plan.window == (H, H + ch.X_loc)
        for body in ("spec", "general"):
            edge = plan.tiles(body, "edge").numpy()
            inner = plan.tiles(body, "inner").numpy()
            np.testing.assert_array_equal(
                np.sort(np.concatenate([edge, inner])),
                np.sort(plan.tiles(body).numpy()))
            rows = (inner // plan.nby) * TX
            assert ((rows >= 2 * H) & (rows + TX <= plan.X - 2 * H)).all()


def test_window_keeps_halo_rows_out_of_the_partials():
    """FusedStep's plain versions count the window's rows only: the
    partials of a windowed plan equal the full plan's with the outer rows'
    nodes left out."""
    jc = jinit.build_case(DECKS["even"]())
    s = Solver(port_case(jc), device="cpu", use_kernels=True,
               comm=LocalComm(2, "cpu"))
    ch = s._chunk_fn
    step = ch.steps[0]
    full_plan = type(step.plan)(**{**step.plan.__dict__,
                                   "window": (0, ch.Xext)})
    full = FusedStep(step.meta, step.params, step.chem, full_plan,
                     step.dispatch, step.ctx)
    own, _ = ch.prologue(s.state, 0)
    ext = [torch.nn.functional.pad(c, (0, 0, ch.H, ch.H)) for c in own]
    ch.fill_halos(ext)
    ca = ext[0]    # its right halo holds strip 1's first columns
    dt = s.state.strips[0].dt
    aux = torch.tensor([0.5, 0.3, 1.0], dtype=torch.float64)
    out = {}
    for name, st in (("window", step), ("full", full)):
        cb, scr = torch.zeros_like(ca), torch.zeros((31,) + ca.shape[1:],
                                                    dtype=ca.dtype)
        pf = torch.zeros((st.plan.n_tiles, 27), dtype=ca.dtype)
        pi = torch.zeros((st.plan.n_tiles, 2), dtype=torch.int32)
        st.gfc(ca, cb, scr, dt, aux, pi)
        st.pass12(ca, cb, scr, dt, aux, pf)
        out[name] = (cb, pf)
    np.testing.assert_array_equal(out["window"][0], out["full"][0])
    assert (out["window"][1][:, 9:18].sum() <
            out["full"][1][:, 9:18].sum())
