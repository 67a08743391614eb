"""Port parity: the two ends of the kernel strip chunk
(parallel/shard_step.KernelShardChunk.start and .finish) on the kernels'
plain versions, float64.

The kernel strip chunk packs each strip's own state over its extended strip
(``FusedStep.pack_state``), fills the halos of the scratch's S, A and B
from the neighbours and runs pass12's launches over every tile of each
strip (``run_prologue``); its epilogue runs gfc's state form and the heat
stage over every tile (``run_epilogue``) and crops each strip's
SolverState to its own columns (``end_state``).  The eager strip chunk's
ends (``_StripChunk.prologue`` and ``epilogue``: core/step.pass12 and gfc
on each extended strip) are their plain versions.  Held here, from the
same StripState (a warm state with seeded noise, scattered into strips):

* (a) the prologue's extended carries, halos filled, bit for bit the eager
  prologue's own carries padded and filled, its RMS and DD_max to 1e-13
  relative (the per-tile partials sum in another order);
* (b) the epilogue's every SolverState field of every strip, its dt and
  its Tg<0 flag bit for bit the eager epilogue's;
* on the small combustor, walls+step+heat (Q_conv non-zero), the Euler
  cylinders, the axisymmetric combustor, the d2/NRBC channel (a halo of
  3 K), the scramjet, the combustor with moving walls and the Chien
  channel (y+ read by the closure), at n = 2 and 4 strips, K = 1 and 2,
  sequential and overlapped;
* (c) the partials count the own columns only: each strip's per-tile
  partials are the eager fields reduced over its own rows, though the
  halo rows hold non-zero contributions;
* (d) a strip chunk reaches core/step's gfc and pass12 only through
  FusedStep's plain versions and never calls the eager ends.

Each deck's case and warm state are made once (module scope); the JAX
package is not needed: both sides are the port's.
"""

import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.core import step as tstep
from openhyperflow2d_torch.core.state import SolverState
from openhyperflow2d_torch.examples import (channel_deck, combustor_deck,
                                            cylinders_deck, scramjet_deck,
                                            wall_channel_deck)
from openhyperflow2d_torch.ops import fused_step
from openhyperflow2d_torch.ops.fused_step import _tile_reduce
from openhyperflow2d_torch.parallel import shard_step
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

WARM = 3      # iterations of the single domain before the state is taken
SEED = 19
NOISE = 1e-4  # relative noise on S and the primitives
N = (64, 48)


def _axisym(deck):
    deck.data["FlowType"] = "1"
    return deck


def _nrbc_d2():
    """The d2*-NULL / NRBC channel (the JAX package's
    tests/test_static_ctx.py:25-37): halo_depth 3."""
    d = channel_deck(nx=N[0], ny=N[1], problem_type=1, turb_model=4,
                     turb_ext_model=0, flow_type=1)
    d.data["Contour1.Bound1.Cond"] = "NT_FARFIELD_2D"
    d.data["Contour1.Bound2.Cond"] = ("NT_D2X_2D, TCT_dkdx_NULL_2D, "
                                      "TCT_depsdx_NULL_2D")
    d.data["Contour1.Bound3.Cond"] = ("NT_D0Y_2D, NT_D2Y_2D, "
                                      "TCT_k_CONST_2D, TCT_eps_CONST_2D")
    return d


DECKS = {
    "combustor": lambda: combustor_deck(*N),
    "step_heat": lambda: combustor_deck(*N, with_step=True,
                                        adiabatic=False),
    "cylinders": lambda: cylinders_deck(*N),
    "axisym": lambda: _axisym(combustor_deck(*N)),
    "nrbc_d2": _nrbc_d2,
    "scramjet": lambda: scramjet_deck(*N),
    "moving_walls": lambda: combustor_deck(*N),
    "chien": lambda: wall_channel_deck(*N, 4, fl.TEM_k_eps_Chien),
}
UW = 20.0     # the moving walls' velocity on the lower half's no-slip walls


@functools.lru_cache(maxsize=None)
def case_of(name):
    case = build_case(DECKS[name]())
    if name == "moving_walls":
        g = case.grid
        wall = (g.is_cond(fl.CT_WALL_NO_SLIP_2D)
                & ~g.is_cond(fl.CT_WALL_LAW_2D)
                & (np.arange(g.MaxY)[None, :] < g.MaxY // 2))
        g.Uw[wall] = UW
        case.params = dataclasses.replace(case.params, isSrcAdd=True)
    return case


@functools.lru_cache(maxsize=None)
def warm_state(name):
    """The single domain's state after WARM iterations (y+ recomputed), S
    and the primitives moved by seeded relative noise of NOISE."""
    s = Solver(case_of(name), device="cpu", use_kernels=True)
    s.run_iters(WARM)
    if tstep.needs_y_plus(s.params):
        s.recalc_y_plus()
    rng = np.random.default_rng(SEED)
    kw = {}
    for f in ("S", "U", "V", "Tg"):
        a = getattr(s.state, f)
        kw[f] = a * torch.as_tensor(
            1.0 + NOISE * rng.standard_normal(a.shape), dtype=a.dtype)
    return s.state.replace(**kw)


def strips(name, n, K, overlap):
    """(strip solver, its StripState, the iteration it is at)."""
    s = Solver(case_of(name), device="cpu", use_kernels=True,
               comm=LocalComm(n, "cpu"), overlap=overlap, fuse_iters=K)
    return s, s._chunk_fn.scatter(warm_state(name)), WARM


def _bits(t):
    return t.contiguous().view(torch.int64)


def _stage(solver, state):
    """KernelShardChunk.stage_planes as __call__ runs it: the eager
    epilogue's (lam, yp, src)."""
    return solver._chunk_fn.stage_planes(state, solver._src_ext)


COMBOS = [(n, K, ov) for n in (2, 4) for K in (1, 2) for ov in (False, True)]
IDS = [f"n{n}-K{K}-{'overlap' if ov else 'sequential'}" for n, K, ov in COMBOS]


@pytest.mark.parametrize("n,K,overlap", COMBOS, ids=IDS)
@pytest.mark.parametrize("name", sorted(DECKS))
def test_strip_prologue(name, n, K, overlap):
    """(a) start's extended carries and diag against the eager prologue's
    own carries, padded and their halos filled, and diag."""
    solver, state, it = strips(name, n, K, overlap)
    chunk = solver._chunk_fn
    ca, diag0, _, _ = chunk.start(state, 2, it)
    own, want = chunk.prologue(state, it)
    ext = [torch.nn.functional.pad(c, (0, 0, chunk.halo, chunk.halo))
           for c in own]
    chunk.fill_halos(ext)
    for k, (a, b) in enumerate(zip(ca, ext)):
        assert a.shape == b.shape == (31, chunk.Xext, solver.params.MaxY)
        assert torch.equal(_bits(a), _bits(b)), f"strip {k} carry"
    np.testing.assert_allclose(diag0["RMS"].numpy(), want["RMS"].numpy(),
                               rtol=1e-13, atol=0)
    np.testing.assert_allclose(diag0["DD_max"].numpy(),
                               want["DD_max"].numpy(), rtol=1e-13, atol=0)
    assert diag0["dt_used"] is state.strips[0].dt


@pytest.mark.parametrize("n,K,overlap", COMBOS, ids=IDS)
@pytest.mark.parametrize("name", sorted(DECKS))
def test_strip_epilogue(name, n, K, overlap):
    """(b) finish's StripState, dt and Tg<0 flag against the eager
    epilogue's on the prologue's carries and a frozen dt."""
    solver, state, it = strips(name, n, K, overlap)
    chunk = solver._chunk_fn
    ca, _, raw, _, cb, scr, rows = chunk.start(state, 2, it, buffers=True)
    lam, yp, srcs = _stage(solver, state)
    dt = chunk.frozen_dt(ca, state.strips[0].dt, raw.cfl_scen[0])
    want, want_dt, want_uns = chunk.epilogue([c.clone() for c in ca], dt,
                                             state, it + 1, lam, yp, srcs)
    for s in scr:
        s.fill_(float("nan"))
    got, got_dt, got_uns = chunk.finish(ca, cb, scr, dt, state, rows[1])
    assert torch.equal(_bits(got_dt), _bits(want_dt))
    assert bool(got_uns) == bool(want_uns)
    X_loc, Y = chunk.X_loc, solver.params.MaxY
    for k, (a, b) in enumerate(zip(got.strips, want.strips)):
        for f in dataclasses.fields(SolverState):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.shape == y.shape, (k, f.name)
            if x.dim() >= 2:
                assert x.shape[-2:] == (X_loc, Y), (k, f.name)
            assert torch.equal(_bits(x), _bits(y)), f"strip {k} {f.name}"
    if name == "step_heat":
        assert any(st.Q_conv.abs().max() > 0 for st in got.strips)


class _Captured:
    """Spies on each strip's FusedStep.run_prologue / run_epilogue (their
    partials) and on core/step.pass12 / gfc as the eager ends call them
    (their per-node fields)."""

    def __init__(self, chunk, monkeypatch):
        self.parts, self.fields = [], []
        for step in chunk.steps:
            for what in ("run_prologue", "run_epilogue"):
                fn = getattr(step, what)

                def spy(*a, _fn=fn, **kw):
                    out = _fn(*a, **kw)
                    self.parts.append(out)
                    return out
                monkeypatch.setattr(step, what, spy)
        for what in ("pass12", "gfc"):
            fn = getattr(shard_step, what)

            def eager(*a, _fn=fn, **kw):
                out = _fn(*a, **kw)
                self.fields.append(out)
                return out
            monkeypatch.setattr(shard_step, what, eager)


@pytest.mark.parametrize("name", ["step_heat", "nrbc_d2", "chien"])
def test_partials_count_the_own_columns(name, monkeypatch):
    """(c) each strip's per-tile partials of both ends are its eager
    fields reduced over its own rows (plan.window): pass12's RMS
    numerator, denominator and DD max, gfc's least node dt and Tg<0
    count, while the halo rows hold RMS contributions that would move the
    numerator."""
    solver, state, it = strips(name, 4, 2, False)
    chunk = solver._chunk_fn
    p = chunk.p_loc
    cap = _Captured(chunk, monkeypatch)
    ca, _, raw, _, cb, scr, rows = chunk.start(state, 2, it, buffers=True)
    chunk.prologue(state, it)
    lam, yp, srcs = _stage(solver, state)
    dt = chunk.frozen_dt(ca, state.strips[0].dt, raw.cfl_scen[0])
    chunk.epilogue([c.clone() for c in ca], dt, state, it + 1, lam, yp, srcs)
    chunk.finish(ca, cb, scr, dt, state, rows[1])
    n = len(chunk.steps)
    pro, epi = cap.parts[:n], cap.parts[n:]
    eager_pro, eager_epi = cap.fields[:n], cap.fields[n:]
    leaks = 0
    for step, part_f, f in zip(chunk.steps, pro, eager_pro):
        f = f[4]
        own = step.own
        assert step.plan.window == (chunk.halo, chunk.halo + chunk.X_loc)
        acc = (f["abs_dd"] if p.serial_rms_mode else f["abs_dd"] ** 2) \
            if p.isAlternateRMS else f["dd_local"] ** 2
        num = torch.where(f["gate"] & own, acc, 0.0)
        ddm = torch.where(f["gate"] & own, f["dd_local"], 0.0)
        assert torch.equal(_bits(part_f[:, 0:9]),
                           _bits(_tile_reduce(num, step.plan, "sum")))
        assert torch.equal(_bits(part_f[:, 18:27]),
                           _bits(_tile_reduce(ddm, step.plan, "max")))
        leaks += int(torch.where(f["gate"] & ~own, acc, 0.0).ne(0).sum())
    assert leaks > 0, "no halo row holds an RMS contribution"
    for step, (_, _, part_i, part_dt), out in zip(chunk.steps, epi,
                                                  eager_epi):
        _, dt_field, unstable = out
        own = step.own
        assert torch.equal(part_dt, _tile_reduce(
            torch.where(own, dt_field, 1.0), step.plan, "min"))
        assert torch.equal(part_i[:, 0], _tile_reduce(
            (unstable & own).to(torch.int32), step.plan, "sum").to(
                torch.int32))


@pytest.mark.parametrize("name", ["step_heat", "moving_walls", "scramjet"])
def test_strip_chunk_stages(name, monkeypatch):
    """(d) A strip chunk of n iterations calls core/step's gfc and pass12
    only from FusedStep's plain versions, never the eager ends, and its
    ends are one pass12_state, one gfc_state (and heat_state with the heat
    stage) a strip."""
    solver = Solver(case_of(name), device="cpu", use_kernels=True,
                    comm=LocalComm(2, "cpu"), fuse_iters=2)
    chunk = solver._chunk_fn
    plain = {"_gfc_fields", "_pass12_fields", "heat_source_plain"}
    seen = {"gfc": 0, "pass12": 0, "calc_heat_on_wall_sources": 0}

    def spy(name_, fn):
        def wrapped(*a, **kw):
            caller = sys._getframe(1).f_code.co_name
            assert caller in plain, f"{name_} called from {caller}"
            seen[name_] += 1
            return fn(*a, **kw)
        return wrapped

    for name_ in seen:
        monkeypatch.setattr(fused_step, name_,
                            spy(name_, getattr(fused_step, name_)))
    for name_ in ("gfc", "pass12"):
        monkeypatch.setattr(shard_step, name_,
                            spy(name_, getattr(shard_step, name_)))

    def eager_end(*a, **kw):
        raise AssertionError("the kernel strip chunk ran an eager end")
    monkeypatch.setattr(shard_step._StripChunk, "prologue", eager_end)
    monkeypatch.setattr(shard_step._StripChunk, "epilogue", eager_end)
    stages = []
    for step in chunk.steps:
        for stage in ("pass12_state", "gfc_state", "heat_state"):
            fn = getattr(step, stage)

            def counted(*a, _fn=fn, _stage=stage, **kw):
                stages.append(_stage)
                return _fn(*a, **kw)
            monkeypatch.setattr(step, stage, counted)
    n = 4
    d = solver.run_iters(n)
    assert np.isfinite(d["RMS"]).all() and len(d["RMS"]) == n
    heat = sum(step.has_heat for step in chunk.steps)
    assert stages.count("pass12_state") == len(chunk.steps)
    assert stages.count("gfc_state") == len(chunk.steps)
    assert stages.count("heat_state") == heat
    assert heat == 0 or name == "step_heat"
    assert seen["gfc"] >= n * len(chunk.steps)
    assert seen["pass12"] >= n * len(chunk.steps)
    # the launches such a chunk makes on the card, planned without CUDA
    for step in chunk.steps:
        first, last = step.end_launches()
        assert first == [step.pass12_name(b) for b in step._bodies()]
        assert last == [step.gfc_name("state")] + (
            ["heat_kernel"] if step.has_heat else [])
