"""The extended kernels' feature forms and the F identity pass12 rests on.

pass12's extended kernel comes in two forms fixed at compile time
(``ops/csrc/fused_step.cuh`` XF_AXI / XF_ALL; ``ops/fused_step.pass12_form``
on the host, ``hf2d_pass12_ext`` in C, from the same flags): the
axisymmetric-only form ``pass12_axi_kernel`` where axisymmetry is a deck's
one extended feature, and the all-features form ``pass12_ext_kernel`` where
it has sources, d2*-NULL soft BCs or NRBC.  (i) Each extended deck picks the
form chip_smoke.py expects of it (EXT_FORMS), whose names are kernel names
of the extended forms, and a deck without any extended feature has no
form.

(ii) Both forms read F[0], F[1] and F[3..6] as the A and B floats gfc wrote
at the node: F = (B[0], A[2], fn2, B[3..6], f7, f8) under the same guard
(gfc_node; JAX physics.py:238-245, 267-272).  This holds bit for bit at
every node after the eager gfc that the kernel path's plain gfc runs
(``core/step.gfc`` from the chunk's expanded carry, float32, 3 iterations
in; nodes that fail the guard hold the expanded zeros in all three; the
plain gfc, as the kernels, writes only F[2], F[7] and F[8] to the
scratch, tests/test_torch_gfc_forms.py), and after JAX's ``fill_node`` on
inputs made from a seed with numpy (rho set to 0 at a twentieth of the
nodes) at every node that passes its guard; a node that fails it keeps
its input A, B and F, which need not agree.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (axisymmetric, jax_nrbc_d2_axisym_deck,
                          jax_wall_channel)

from openhyperflow2d_torch import examples as ex
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.core.step import expand, gfc
from openhyperflow2d_torch.ops.fused_step import (EXT_KERNEL_NAMES,
                                                  PASS12_FORMS, carry_views,
                                                  pass12_form, scan_dt)
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver


def nrbc_d2_deck():
    """The JAX package's _nrbc_d2_axisym_deck (tests/test_static_ctx.py:
    25-37) with the port's examples."""
    d = ex.channel_deck(nx=48, ny=40, problem_type=1, turb_model=4,
                        turb_ext_model=0, flow_type=1)
    d.data["Contour1.Bound1.Cond"] = "NT_FARFIELD_2D"
    d.data["Contour1.Bound2.Cond"] = ("NT_D2X_2D, TCT_dkdx_NULL_2D, "
                                      "TCT_depsdx_NULL_2D")
    d.data["Contour1.Bound3.Cond"] = ("NT_D0Y_2D, NT_D2Y_2D, "
                                      "TCT_k_CONST_2D, TCT_eps_CONST_2D")
    return d


# the extended decks: (the port's deck, the JAX package's, the k-eps
# variant to set, the feature form of pass12 they run)
DECKS = {
    "combustor": (lambda: axisymmetric(ex.combustor_deck(48, 40)),
                  lambda: axisymmetric(_jex().combustor_deck(48, 40)),
                  None, "axi"),
    "combustor_rng": (lambda: axisymmetric(ex.combustor_deck(48, 40)),
                      lambda: axisymmetric(_jex().combustor_deck(48, 40)),
                      "TEM_k_eps_RNG", "axi"),
    "sa": (lambda: axisymmetric(ex.wall_channel_deck(
               48, 40, 3, fl.TEM_Spalart_Allmaras)),
           lambda: axisymmetric(jax_wall_channel("sa")), None, "axi"),
    "bubble": (lambda: axisymmetric(ex.bubble_deck(48, 40)),
               lambda: axisymmetric(_jex().bubble_deck(48, 40)), None,
               "axi"),
    "nrbc_d2": (nrbc_d2_deck, jax_nrbc_d2_axisym_deck, None, "all"),
    "scramjet": (lambda: ex.scramjet_deck(64, 48),
                 lambda: _jex().scramjet_deck(64, 48), None, "all"),
}


def _jex():
    from openhyperflow2d_tpu import examples
    return examples


def with_tem(params, tem):
    return params if tem is None else dataclasses.replace(
        params, tem=getattr(fl, tem))


@functools.lru_cache(maxsize=None)
def port_case(name):
    deck, _, tem, _ = DECKS[name]
    case = build_case(deck(), dtype="float32")
    return dataclasses.replace(case, params=with_tem(case.params, tem))


@pytest.mark.parametrize("name", sorted(DECKS))
def test_each_deck_picks_its_pass12_form(name):
    form = DECKS[name][3]
    case = port_case(name)
    assert pass12_form(case.params) == form
    step = Solver(case, device="cpu", use_kernels=True).fused
    assert step.pass12_form == form
    for body in ("spec", "general", "dual"):
        kernel = step.pass12_name(body)
        assert kernel == f"{PASS12_FORMS[form]}<{body}>"
        assert kernel in EXT_KERNEL_NAMES
    assert all(n in EXT_KERNEL_NAMES for n in step.iteration_launches())


def test_a_deck_without_extended_features_has_no_form():
    p = port_case("combustor").params
    flat = dataclasses.replace(p, ft=fl.FT_FLAT)
    with pytest.raises(ValueError, match="'axi': False"):
        pass12_form(flat)


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_f_copies_a_and_b_after_the_plain_gfc(name):
    solver = Solver(port_case(name), device="cpu", use_kernels=True)
    solver.run_iters(3)
    chunk, step = solver._chunk_fn, solver.fused
    ca, _, raw, kaux = chunk.prologue(solver.state, 2, solver.last_iter)
    dt = scan_dt(carry_views(ca, solver.state.dt), step.ctx.active,
                 solver.params, raw.cfl_scen[0]).to(torch.float32)
    full = expand(carry_views(ca, dt), step.params, step.src,
                  y_plus=step.y_plus(), lam_t=step.lam_t())
    out, _, _ = gfc(full, step.meta, step.params, step.chem,
                    step._aux(kaux[0]), return_fields=True, ctx=step.ctx,
                    heat=False)
    A, B, F = out.A, out.B, out.F
    assert torch.isfinite(F).all()
    assert torch.equal(bits(F[0]), bits(B[0]))
    assert torch.equal(bits(F[1]), bits(A[2]))
    assert torch.equal(bits(F[3:7]), bits(B[3:7]))
    # F[2] is its own (the hoop stress), not B[2]
    assert not torch.equal(bits(F[2]), bits(B[2]))


@pytest.mark.parametrize("name", sorted(DECKS))
def test_f_copies_a_and_b_in_jax_fill_node(name):
    from openhyperflow2d_tpu.core.physics import _safe_div, fill_node
    from openhyperflow2d_tpu.core.state import meta_from_grid, state_from_grid
    from openhyperflow2d_tpu.core.static_ctx import build_static_ctx
    from openhyperflow2d_tpu.solver import init as jinit
    _, jdeck, tem, _ = DECKS[name]
    case = jinit.build_case(jdeck())
    p = with_tem(case.params, tem)
    meta = meta_from_grid(case.grid, dtype=p.jdtype)
    st = state_from_grid(case.grid, p, case.dt0)
    rng = np.random.default_rng(11)
    kw = {}
    for f in dataclasses.fields(st):
        v = np.asarray(getattr(st, f.name))
        if f.name == "dt" or v.dtype.kind != "f":
            continue
        noise = rng.uniform(-0.05, 0.05, v.shape)
        if f.name in ("A", "B", "F", "dSdx", "dSdy", "dUdx", "dUdy", "dVdx",
                      "dVdy", "dTdx", "dTdy", "droYdx", "droYdy", "dkdx",
                      "dkdy", "depsdx", "depsdy"):
            kw[f.name] = jnp.asarray(v * (1 + noise)
                                     + rng.normal(0, 1, v.shape))
        else:
            kw[f.name] = jnp.asarray(v * (1 + noise))
    # rho = 0 at a twentieth of the nodes: they fail the guard
    S = np.array(kw["S"])
    S[0][rng.random(S[0].shape) < 0.05] = 0.0
    kw["S"] = jnp.asarray(S)
    state = dataclasses.replace(st, **kw)
    ctx = build_static_ctx(meta, p)
    is_mu_t = jnp.ones(np.asarray(st.U).shape, bool)
    out = fill_node(state, meta, p, is_mu_t, False, ctx=ctx)
    k_cpcv = _safe_div(state.CP, state.CP - state.R, 2.0)
    guard = np.asarray(~ctx.solid & (state.S[0] != 0) & (k_cpcv >= 1))
    A, B, F = (np.asarray(x) for x in (out.A, out.B, out.F))
    g = guard
    assert g.any() and (~g).any()
    np.testing.assert_array_equal(F[0][g].view(np.int64),
                                  B[0][g].view(np.int64))
    np.testing.assert_array_equal(F[1][g].view(np.int64),
                                  A[2][g].view(np.int64))
    np.testing.assert_array_equal(F[3:7][:, g].view(np.int64),
                                  B[3:7][:, g].view(np.int64))
    # a node that fails the guard keeps its input A, B and F
    for new, old in ((A, state.A), (B, state.B), (F, state.F)):
        np.testing.assert_array_equal(new[:, ~g], np.asarray(old)[:, ~g])
