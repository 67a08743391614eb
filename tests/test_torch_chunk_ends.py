"""Port parity: the two ends of the kernel chunk (ops/fused_step.KernelChunk)
on the kernels' plain versions, float64.

The prologue packs a SolverState into the carry and the scratch
(``FusedStep.pack_scratch``) and runs pass12's launches over every tile,
the heat source read from the state's SrcAdd[rhoE] (the unfolded form) and
the source field from the state's Src; the epilogue runs gfc's state form
over every tile (``FusedStep.gfc_state``) and the heat stage with Q_conv,
and assembles the SolverState from their planes.  Held here:

* (a) the prologue gives core/step.pass12's S and beta bit for bit, its
  DD_max bit for bit and its RMS to 1e-13 relative (the per-tile partials
  sum the grid in another order), on a state from build_case, from a
  chunk's epilogue and from a swap resume (io_out/swapfile), on the
  combustor, the walls+step+heat deck (the heat source), the axisymmetric
  combustor (F), the combustor with moving walls (the SCR_MW planes) and
  the Euler cylinders; and JAX's step.pass12 on the same state to 1e-10 of
  each plane's scale (test_torch_step's rule);
* (b) the epilogue gives every SolverState field, the fresh dt and the
  Tg<0 flag of core/step.gfc (with its heat stage) bit for bit, and
  ``gfc_state_plain`` the per-tile least dt of its dt field; JAX's
  step.gfc on the same state to 1e-10 of each plane's scale;
* (c) a chunk of n iterations reaches core/step's gfc and pass12 only
  through FusedStep's plain versions: its stages are the prologue's
  pass12, n - 1 iterations and the epilogue's state form (and heat);
* (d) the state form stores only the state planes the deck's gfc computes
  (``state_fields``: none on an Euler deck, no k or eps gradient without
  k-eps or SA), the others left as they were, and the epilogue takes the
  expanded zeros and the state's lam_t for them.

Each deck's JAX and port cases are built once (module scope).
"""

import dataclasses
import functools
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_case, scaled_err

from openhyperflow2d_tpu.core import flags as jfl
from openhyperflow2d_tpu.core import state as jstate
from openhyperflow2d_tpu.core import step as jstep
from openhyperflow2d_tpu.examples import combustor_deck, cylinders_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_torch.core import step as tstep
from openhyperflow2d_torch.core.step import expand, lam_t_const
from openhyperflow2d_torch.io_out.swapfile import write_swap_file
from openhyperflow2d_torch.ops import fused_step
from openhyperflow2d_torch.ops.fused_step import (N_STATE, STATE_FIELDS,
                                                  _tile_reduce, carry_views,
                                                  state_fields, state_keep,
                                                  state_views)
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

WARM = 3      # iterations of the chunk whose epilogue state is held


def _axisym(deck):
    deck.data["FlowType"] = "1"
    return deck


# one grid for every deck (JAX compiles its ops once a shape), wide enough
# for spec tiles beside the general ones on the combustor's decks
N = (48, 96)
DECKS = {
    "combustor": lambda: combustor_deck(*N),
    "step_heat": lambda: combustor_deck(*N, with_step=True, adiabatic=False),
    "axisym": lambda: _axisym(combustor_deck(*N)),
    "moving_walls": lambda: combustor_deck(*N),
    "cylinders": lambda: cylinders_deck(*N),
}
UW = 20.0     # the moving walls' velocity on the lower half's no-slip walls


def _moving_walls(jc):
    """isSrcAdd with Uw = UW on the lower half's no-slip walls (the host
    grid the port's case shares)."""
    g = jc.grid
    wall = (g.is_cond(jfl.CT_WALL_NO_SLIP_2D) & ~g.is_cond(jfl.CT_WALL_LAW_2D)
            & (np.arange(g.MaxY)[None, :] < g.MaxY // 2))
    g.Uw[wall] = UW
    jc.params = dataclasses.replace(jc.params, isSrcAdd=True)


@functools.lru_cache(maxsize=None)
def cases(name):
    """(JAX case, its meta, params, chem and scenario tables as the JAX
    Solver stages them, port case)."""
    jc = jinit.build_case(DECKS[name]())
    if name == "moving_walls":
        _moving_walls(jc)
    dtype = jc.params.jdtype
    js = SimpleNamespace(
        meta=jstate.meta_from_grid(jc.grid, dtype=dtype),
        chem=jinit.chem_tables_device(jc.chem, dtype), params=jc.params,
        **{f"{k}_{a}s": jnp.asarray(getattr(getattr(jc, f"{k}_scenario"),
                                            a), dtype)
           for k in ("beta", "cfl") for a in ("x", "y")})
    return jc, js, port_case(jc)


@functools.lru_cache(maxsize=None)
def states(name, tmp_dir):
    """{origin: (port Solver, its state)}: the state build_case gives, the
    state after a chunk of WARM iterations (an epilogue's), and the state
    a swap resume of that gives (dt and last_iter restored)."""
    _, _, case = cases(name)
    fresh = Solver(case, device="cpu", use_kernels=True)
    out = {"build_case": (fresh, fresh.state)}
    run = Solver(case, device="cpu", use_kernels=True, fuse_iters=2)
    run.run_iters(WARM)
    out["epilogue"] = (run, run.state)
    deck = DECKS[name]()
    deck.data["isTurbulenceReset"] = "0"
    deck.data["ProjectName"] = f"ends_{name}"
    write_swap_file(f"{tmp_dir}/ends_{name}.hf2d", run, case.grid)
    rc = build_case(deck, use_swap=True, swap_dir=tmp_dir)
    assert rc.preloaded
    rc.params = case.params          # isSrcAdd, as the written run's
    resumed = Solver(rc, device="cpu", use_kernels=True)
    resumed.state = resumed.state.replace(dt=run.state.dt)
    resumed.last_iter = WARM
    out["swap resume"] = (resumed, resumed.state)
    return out


@pytest.fixture(scope="module")
def swap_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("swap"))


def _jax_state(st):
    return jstate.SolverState(**{
        f.name: jnp.asarray(getattr(st, f.name).numpy())
        for f in dataclasses.fields(jstate.SolverState)})


def _jax_aux(js, it):
    p = js.params
    return jstep.make_aux((js.beta_xs, js.beta_ys), (js.cfl_xs, js.cfl_ys),
                          p.TurbStartIter, jnp.asarray(it), p.jdtype)


def _bits(t):
    return t.contiguous().view(torch.int64)


def _close_scaled(got, want, what):
    err = scaled_err({"x": np.asarray(want)}, {"x": got.numpy()}, "x")
    assert err < 1e-10, (what, err)


@pytest.mark.parametrize("origin", ["build_case", "epilogue", "swap resume"])
@pytest.mark.parametrize("name", sorted(DECKS))
def test_prologue_is_pass12(name, origin, swap_dir):
    """(a) pack_scratch + the unfolded pass12 over every tile against
    core/step.pass12 on the state, and JAX's pass12."""
    solver, st = states(name, swap_dir)[origin]
    chunk, p = solver._chunk_fn, solver.params
    start = solver.last_iter
    ca, diag0, _, _ = chunk.prologue(st, 2, start)
    S, beta, _, _, want = tstep.pass12(st, solver.meta, p,
                                       chunk.aux_at(start),
                                       ctx=chunk.step.ctx)
    assert torch.equal(_bits(ca[0:9]), _bits(S)), "S"
    assert torch.equal(_bits(ca[9:18]), _bits(beta)), "beta"
    assert torch.equal(_bits(diag0["DD_max"]), _bits(want["DD_max"]))
    np.testing.assert_allclose(diag0["RMS"].numpy(), want["RMS"].numpy(),
                               rtol=1e-13, atol=0)
    assert diag0["dt_used"] is st.dt
    # the carry's primitives are the state's
    prims = fused_step.pack_carry(tstep.shrink(st))[18:]
    assert torch.equal(_bits(ca[18:]), _bits(prims))
    _, js, _ = cases(name)
    jS, jbeta, _, _, jdiag = jstep.pass12(_jax_state(st), js.meta, js.params,
                                          _jax_aux(js, start))
    _close_scaled(ca[0:9], jS, "S")
    _close_scaled(diag0["RMS"], jdiag["RMS"], "RMS")


def _eager_epilogue(chunk, ca, dt, st, it):
    """The parent's epilogue: core/step.gfc with its heat stage on the
    expanded carry."""
    p, step = chunk.params, chunk.step
    full = expand(carry_views(ca, dt), p, step.src, step.y_plus(),
                  lam_t_const(st, p))
    out, dt_new, uns = tstep.gfc(full, chunk.meta, p, chunk.chem,
                                 chunk.aux_at(it), ctx=step.ctx)
    return out.replace(dt=dt_new, y_plus=st.y_plus), uns, full


@pytest.mark.parametrize("name", sorted(DECKS))
def test_epilogue_is_gfc(name, swap_dir):
    """(b) the epilogue's SolverState, dt and Tg<0 flag against
    core/step.gfc's, bit for bit, on the carry after a prologue and a
    frozen dt; the per-tile least dt; JAX's gfc to 1e-10."""
    solver, st = states(name, swap_dir)["epilogue"]
    chunk, step, p = solver._chunk_fn, solver.fused, solver.params
    step.set_lam_t(st.lam_t)
    step.set_y_plus(st.y_plus)
    start = solver.last_iter
    ca, _, raw, _, cb, scr, rows = chunk.prologue(st, 2, start,
                                                  buffers=True)
    dt = fused_step.scan_dt(carry_views(ca, st.dt), step.ctx.active, p,
                            raw.cfl_scen[0])
    got, uns = chunk.epilogue(ca, cb, scr, dt, st, rows[1])
    want, want_uns, full = _eager_epilogue(chunk, ca, dt, st, start + 1)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), \
            f.name
    assert bool(uns) == bool(want_uns)
    # the per-tile least dt of the plain state form; the planes it keeps
    # (state_fields), the others untouched
    st_planes = torch.full((N_STATE,) + ca.shape[1:], float("nan"),
                           dtype=ca.dtype)
    part_i = torch.empty((chunk.plan.n_tiles, 2), dtype=torch.int32)
    part_dt = torch.empty(chunk.plan.n_tiles, dtype=ca.dtype)
    step.gfc_state(ca, cb.clone(), scr.clone(), st_planes, dt, rows[1],
                   part_i, part_dt)
    for f, view in state_views(st_planes).items():
        if f in step.state_fields:
            assert torch.equal(_bits(view), _bits(getattr(want, f))), f
        else:
            assert view.isnan().all(), f"{f} written"
    _, dt_field, _ = tstep.gfc(full, chunk.meta, p, chunk.chem,
                               chunk.aux_at(start + 1), return_fields=True,
                               ctx=step.ctx, heat=False)
    assert torch.equal(part_dt, _tile_reduce(dt_field, chunk.plan, "min"))
    _, js, _ = cases(name)
    jout, jdt, _ = jstep.gfc(_jax_state(full), js.meta, js.params, js.chem,
                             _jax_aux(js, start + 1))
    for f in ("S", "A", "B", "F", "SrcAdd", "U", "V", "Tg", "lam_t", "dUdy",
              "droYdx", "Q_conv"):
        _close_scaled(getattr(got, f), getattr(jout, f), f)
    np.testing.assert_allclose(float(got.dt), float(jdt), rtol=1e-12)


@pytest.mark.parametrize("name", ["step_heat", "moving_walls"])
def test_chunk_stages(name, monkeypatch):
    """(c) A chunk of n iterations calls core/step's gfc and pass12 only
    from FusedStep's plain versions, and its FusedStep stages are the
    prologue's pass12, n - 1 iterations' and the epilogue's."""
    _, _, case = cases(name)
    solver = Solver(case, device="cpu", use_kernels=True, fuse_iters=2)
    step = solver.fused
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
    stages = []
    for stage in ("pass12_state", "gfc_state", "path_gfc", "path_pass12",
                  "pass12", "heat", "heat_state", "step_spec"):
        fn = getattr(step, stage)

        def counted(*a, _fn=fn, _stage=stage, **kw):
            stages.append(_stage)
            return _fn(*a, **kw)
        monkeypatch.setattr(step, stage, counted)
    n = 5
    solver.run_iters(n)
    loop = ["path_gfc", "path_pass12", "pass12"] + (
        ["step_spec"] if step.spec_fused else [])
    assert stages.count("pass12_state") == 1    # the prologue's
    assert stages.count("pass12") == n - 1      # path_pass12's
    assert stages.count("path_gfc") == n - 1
    assert stages.count("path_pass12") == n - 1
    assert stages.count("gfc_state") == 1
    assert stages.count("heat_state") == int(step.has_heat)
    assert stages[0] == "pass12_state" and stages[-1] == (
        "heat_state" if step.has_heat else "gfc_state")
    assert set(stages) <= set(loop) | {"pass12_state", "gfc_state",
                                       "heat_state"}
    assert seen["gfc"] >= n and seen["pass12"] >= n
    assert seen["calc_heat_on_wall_sources"] >= int(step.has_heat)
    # the launches a chunk of n makes on the card, planned without CUDA
    first, last = step.end_launches()
    assert first == [step.pass12_name(b) for b in step._bodies()]
    assert last == [step.gfc_name("state")] + (
        ["heat_kernel"] if step.has_heat else [])
    want = dict.fromkeys(step.iteration_launches(), n - 1)
    for name_ in first + last:
        want[name_] = want.get(name_, 0) + 1
    assert step.chunk_launches(n) == want


# (deck, the models the deck's params are given, the fields kept): a deck
# with a closure keeps what core/step.gfc computes under it
KEPT = {"keps": [n for n, _ in STATE_FIELDS],
        "sa": [n for n, _ in STATE_FIELDS if n not in ("depsdx", "depsdy")],
        "none": [n for n, _ in STATE_FIELDS
                 if n not in ("dkdx", "dkdy", "depsdx", "depsdy")]}


@pytest.mark.parametrize("models", sorted(KEPT))
def test_state_fields_are_what_gfc_computes(models):
    """(d) state_fields and state_keep: on an NS deck every plane but the
    k and eps gradients of a closure it lacks; on an Euler deck none; the
    bits are STATE_FIELDS' planes of the fields kept; core/step.gfc leaves
    the planes not kept at the expanded zeros."""
    _, _, case = cases("combustor")
    p = dataclasses.replace(case.params, models={
        "keps": ("keps",), "sa": ("sa",), "none": ()}[models])
    assert list(state_fields(p)) == KEPT[models]
    bits, o = 0, 0
    for name, n in STATE_FIELDS:
        if name in KEPT[models]:
            bits |= ((1 << n) - 1) << o
        o += n
    assert state_keep(p) == bits
    _, _, euler = cases("cylinders")
    assert state_fields(euler.params) == () and state_keep(euler.params) == 0
    if models == "keps":
        return
    # core/step.gfc computes no plane outside state_fields on such a deck
    solver = Solver(dataclasses.replace(case, params=p), device="cpu",
                    use_kernels=True)
    full = expand(tstep.shrink(solver.state), p, solver.state.Src)
    out, _, _ = tstep.gfc(full, solver.meta, p, solver.chem,
                          solver._chunk_fn.aux_at(0))
    for name, _ in STATE_FIELDS:
        if name not in KEPT[models]:
            assert not getattr(out, name).any(), name


@pytest.mark.parametrize("name", ["cylinders", "combustor"])
def test_epilogue_keeps_the_zeros_and_lam_t(name, swap_dir):
    """(d) the epilogue's fields outside state_fields are the expanded
    zeros (read-only views, as ``expand`` gives) and, on an Euler deck, the
    state's own lam_t plane."""
    solver, st = states(name, swap_dir)["epilogue"]
    chunk, step = solver._chunk_fn, solver.fused
    ca, _, raw, _, cb, scr, rows = chunk.prologue(st, 2, solver.last_iter,
                                                  buffers=True)
    got, _ = chunk.epilogue(ca, cb, scr, st.dt, st, rows[1])
    for f, _ in STATE_FIELDS:
        if f in step.state_fields:
            continue
        if f == "lam_t":
            assert getattr(got, f) is st.lam_t
        else:
            assert not getattr(got, f).any(), f
