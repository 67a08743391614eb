"""Port parity: the per-node physics in float64.

fill_node (both variants), the standard k-eps closure and the Zeldovich
chemistry of the port against the JAX package on the same evolved state.
Tolerance: rtol 1e-12, with an absolute floor of 1e-12 of each field's
largest magnitude for entries that cancel to ~0 (fluxes, gradients); the two
packages evaluate the same expressions, so only last-ulp rounding of pow and
the libm calls may differ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import np_fields, port_inputs, to_np

from openhyperflow2d_tpu.core import physics as jphys
from openhyperflow2d_tpu.core.static_ctx import build_static_ctx as jctx_of
from openhyperflow2d_tpu.examples import combustor_deck, reacting_rans_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core import physics as tphys
from openhyperflow2d_torch.core.static_ctx import build_static_ctx

DECKS = {
    "combustor": lambda: combustor_deck(48, 40),
    "rans_wall": lambda: reacting_rans_deck(48, 40, wall_bottom=True),
}
RTOL = 1e-12


def close(got, want, what):
    got, want = to_np(got), np.asarray(want)
    floor = RTOL * max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=floor,
                               err_msg=what)


@pytest.fixture(scope="module", params=sorted(DECKS))
def setup(request):
    """A JAX solver advanced 4 iterations (nonzero gradients, burning
    flame), the same arrays in the port, and a seeded is_mu_t mask."""
    js = JSolver(jinit.build_case(DECKS[request.param]()))
    js.run_iters(4)
    ts, tm, tp, tc = port_inputs(js)
    rng = np.random.default_rng(11)
    mask = rng.random((tp.MaxX, tp.MaxY)) < 0.7
    return js, (ts, tm, tp, tc), mask


@pytest.mark.parametrize("is_init", [False, True], ids=["run", "init"])
@pytest.mark.parametrize("fast_math", [False, True], ids=["ieee", "fast"])
def test_fill_node(setup, is_init, fast_math):
    js, (ts, tm, tp, _), mask = setup
    jp = dataclasses.replace(js.params, fast_math=fast_math)
    tp = dataclasses.replace(tp, fast_math=fast_math)
    want = jphys.fill_node(js.state, js.meta, jp, jnp.asarray(mask), is_init)
    got = tphys.fill_node(ts, tm, tp, torch.as_tensor(mask), is_init)
    for name, a in np_fields(want).items():
        close(getattr(got, name), a, name)


def _planes(st):
    return ([st.S[e] for e in range(9)], [st.A[e] for e in range(9)],
            [st.B[e] for e in range(9)], [st.F[e] for e in range(9)],
            [st.Src[e] for e in range(9)])


@pytest.mark.parametrize("is_init", [False, True], ids=["run", "init"])
def test_turb_mod_rans_keps(setup, is_init):
    js, (ts, tm, tp, _), mask = setup
    assert js.params.models == ("keps",)
    jst = js.state
    jl = _planes(jst)
    tl = _planes(ts)
    jmu, jlam = jphys._turb_mod_rans(
        jst, js.meta, js.params, *jl[:1], jst.U, jst.V, *jl[1:], jst.mu_t,
        jst.lam_t, jnp.asarray(mask), is_init, jctx_of(js.meta, js.params))
    tmu, tlam = tphys._turb_mod_rans(
        ts, tm, tp, *tl[:1], ts.U, ts.V, *tl[1:], ts.mu_t, ts.lam_t,
        torch.as_tensor(mask), is_init, build_static_ctx(tm, tp))
    close(tmu, np.asarray(jmu), "mu_t")
    close(tlam, np.asarray(jlam), "lam_t")
    for lj, lt, what in zip(jl, tl, ("S", "A", "B", "F", "Src")):
        for e in (7, 8):
            close(lt[e], np.asarray(lj[e]), f"{what}[{e}]")


@pytest.mark.parametrize("fast_math", [False, True], ids=["ieee", "fast"])
def test_calc_chemical_reactions(setup, fast_math):
    js, (ts, tm, tp, tc), _ = setup
    jp = dataclasses.replace(js.params, fast_math=fast_math)
    tp = dataclasses.replace(tp, fast_math=fast_math)
    jctx = jctx_of(js.meta, jp)
    tctx = build_static_ctx(tm, tp)
    assert bool(np.asarray(jctx.react).any())
    want = jphys.calc_chemical_reactions(js.state, js.meta, jp, js.chem,
                                         jctx.active, ctx=jctx)
    got = tphys.calc_chemical_reactions(ts, tm, tp, tc, tctx.active,
                                        ctx=tctx)
    for name in ("S", "Yc", "R", "CP", "lam", "mu"):
        close(getattr(got, name), np.asarray(getattr(want, name)), name)
