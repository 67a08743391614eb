"""Port parity: moving-wall sources (``SolverParams.isSrcAdd``).

At a no-slip wall node fill_node writes SrcAdd for rho, rhoU, rhoV and the
three species from the velocity before the no-slip overwrite, the wall
velocity (Uw, Vw), the wall cosines (BGX, BGY) and the node's own spacing
(JAX physics.py:176-192); pass 1 adds it to S with no factor of dt.  No
deck sets isSrcAdd (the JAX dataclass default), so each case here takes
``dataclasses.replace(params, isSrcAdd=True)`` and a wall velocity set on
the host grid, on the wall channel of tests/test_turbulence_models.py
(standard k-eps) in two forms: its NT_WNS_2D wall (U and V held, so the
sources act at the initial fill, then are the rounding of (U rho)/rho - Uw)
with Uw = 10, and a free no-slip wall (CT_WALL_NO_SLIP_2D without U/V
const, so rhoU evolves and the sources act every iteration) with Uw = 0;
an Euler channel with an NT_WNS_2D wall, the free-wall channel with
FlowType=1 (axisymmetric: the all-features moving-wall forms), and the
free-wall channel with RNG k-eps and with SA (gfc_closure_mw_kernel, every
closure family tested at run time).  Float64, JAX on the CPU.

* the eager path against JAX's XLA path at 1e-10 of each plane's scale
  (SrcAdd among the fields), also on a non-uniform mesh whose dx and dy
  differ at the wall (sa_rho reads the node's own spacing);
* the kernel path's plain versions (gfc_plain writes the six moving-wall
  planes SCR_MW.., pass12_plain adds them) against JAX's
  ``make_pallas_chunk`` in interpret mode at K = 1 and 2;
* the plain strips bit for bit the single domain;
* form choice: every isSrcAdd deck runs the moving-wall forms on its
  general and dual launches whatever its other features (gfc_mw_kernel,
  gfc_closure_mw_kernel or gfc_euler_mw_kernel; pass12's flat one,
  pass12_mw_flat_kernel, where the moving-wall sources are its one
  extended feature, mw_flat, else pass12_mw_kernel), and the all-features
  forms' spec bodies on its spec tiles (which hold no wall node).  The
  decks of the timed 2048^2 cells run the forms they ran before.
"""

import dataclasses
import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
from torch_parity import (KERNEL_FIELDS, beta_err, jax_wall_channel, np_copy,
                          port_case, rel_diff, scaled_err)

from openhyperflow2d_torch import examples as ex
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.ops.fused_step import (EXT_KERNEL_NAMES, MW_EQ,
                                                  MW_KERNEL_NAMES,
                                                  N_SCRATCH, N_SCRATCH_AXI,
                                                  N_SCRATCH_MW,
                                                  _ext_features, gfc_form,
                                                  mw_flat, n_scratch,
                                                  pass12_form)
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

FREE_WALL = "CT_NODE_IS_SET_2D, CT_WALL_NO_SLIP_2D"
CSRC = Path(__file__).resolve().parents[1] / "openhyperflow2d_torch" / \
    "ops" / "csrc"


def assert_mw_forms(names, params, gfc_kernel=None):
    """Every general and dual launch of ``names`` a moving-wall form
    (``gfc_kernel`` where given; pass12's flat form where ``mw_flat``
    takes the deck of ``params``, else its all-features form), every spec
    launch an all-features form's spec body (``gfc_kernel``'s where
    given)."""
    assert names
    pass12 = ("pass12_mw_flat_kernel" if mw_flat(params)
              else "pass12_mw_kernel")
    for n in names:
        kernel, body = n[:-1].split("<")
        if body == "spec":
            assert n in EXT_KERNEL_NAMES, n
            assert kernel.endswith("_ext_kernel"), n
            if gfc_kernel is not None:
                assert kernel in (gfc_kernel.replace("_mw_", "_ext_"),
                                  "pass12_ext_kernel"), n
        else:
            assert n in MW_KERNEL_NAMES, n
            assert kernel.startswith("gfc_") or kernel == pass12, n
            if gfc_kernel is not None:
                assert kernel in (gfc_kernel, pass12), n


def jax_deck(name):
    """The JAX package's deck of ``name``."""
    from openhyperflow2d_tpu.examples import channel_deck
    if name == "euler":
        d = channel_deck(nx=48, ny=40, problem_type=0)
        d.data["Contour1.Bound3.Cond"] = "NT_WNS_2D"
        return d
    # standard k-eps constants, or the closure of a "<closure>_free" deck
    d = jax_wall_channel(name.removesuffix("_free")
                         if name in CLOSURE_FREE else "realisable")
    if name.startswith("keps_free") or name in CLOSURE_FREE:
        d.data["Contour1.Bound3.Cond"] = FREE_WALL
    if name.endswith("_axisym"):
        d.data["FlowType"] = "1"
    return d


# the free-wall channel with a closure (RNG: a deck with spec tiles; SA:
# every tile general)
CLOSURE_FREE = ("rng_free", "sa_free")
UW = {"keps_wns": 10.0, "keps_free": 0.0, "euler": 10.0,
      "keps_free_axisym": 0.0, "rng_free": 0.0, "sa_free": 0.0}


def jax_mw_case(name, dx_map=None, dy_map=None):
    """The JAX case of ``name`` with isSrcAdd and Uw = UW[name] at its
    no-slip wall nodes."""
    from openhyperflow2d_tpu.solver import init as jinit
    jc = jinit.build_case(jax_deck(name), dx_map=dx_map, dy_map=dy_map)
    jc.params = dataclasses.replace(jc.params, isSrcAdd=True)
    g = jc.grid
    wall = g.is_cond(fl.CT_WALL_NO_SLIP_2D)
    assert wall.any()
    g.Uw[wall] = UW[name]
    return jc


def wall_maps(nx=48, ny=40):
    """dx 1.5 and dy 0.5 of the deck's spacing over the two rows at the
    bottom wall, the deck's elsewhere."""
    dx_map = np.full((nx, ny), 0.01)
    dy_map = np.full((nx, ny), 0.01)
    dx_map[:, :2] *= 1.5
    dy_map[:, :2] *= 0.5
    return dx_map, dy_map


FIELDS = KERNEL_FIELDS + ["SrcAdd", "A", "B"]


def eager_pair(name, nonuniform, n=3):
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    jc = jax_mw_case(name, *(wall_maps() if nonuniform else (None, None)))
    js = JSolver(jc)
    w0 = np_copy(js.state)
    wd = {k: np.asarray(v) for k, v in js.run_iters(n).items()}
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    g0 = ts.host_state()
    gd = ts.run_iters(n)
    return (w0, g0), (np_copy(js.state), wd, ts.host_state(), gd)


@pytest.mark.parametrize("name, nonuniform", [
    ("keps_wns", False), ("keps_free", False), ("keps_free", True),
    ("rng_free", False), ("sa_free", False)])
def test_eager_matches_jax(name, nonuniform):
    """The initial fill (the sources from the initial velocity) and 3
    iterations: every field, SrcAdd included, to 1e-10 of its plane's
    scale, RMS and dt_used to rtol 1e-10, the Tg<0 rows exactly; the
    sources non-zero."""
    (w0, g0), (want, wd, got, gd) = eager_pair(name, nonuniform)
    for f in ("S", "SrcAdd", "A", "B", "U", "V"):
        assert scaled_err(w0, g0, f) < 1e-10, ("init", f)
    assert np.abs(g0["SrcAdd"][list(MW_EQ)]).max() > 0
    errs = {f: scaled_err(want, got, f) for f in FIELDS}
    assert max(errs.values()) < 1e-10, errs
    assert beta_err(want, got) < 1.0
    for key in ("RMS", "dt_used"):
        assert rel_diff(gd[key], wd[key]) < 1e-10, key
    np.testing.assert_array_equal(gd["unstable"], wd["unstable"])
    if name == "keps_free" or name in CLOSURE_FREE:
        # the free wall's sources act every iteration
        assert np.abs(got["SrcAdd"][list(MW_EQ)]).max() > 0
        assert not gd["unstable"].any()
    assert np.abs(got["SrcAdd"][fl.i2d_RhoE]).max() == 0


@functools.lru_cache(maxsize=None)
def pallas_cycle(name, K, n=3):
    """(JAX fields, diags) after a cycle of n iterations of JAX's Pallas
    path in interpret mode at fuse_iters=K, float64."""
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    jc = jax_mw_case(name)
    jc.Nstep = n
    js = JSolver(jc, use_pallas=True, pallas_fuse=K, pallas_tile=(16, 128))
    wd, _ = js.run_cycle()
    return jc, np_copy(js.state), {k: np.asarray(v) for k, v in wd.items()}


@pytest.mark.parametrize("name, K", [("keps_free", 1), ("keps_free", 2),
                                     ("keps_wns", 2), ("euler", 1),
                                     ("keps_free_axisym", 1),
                                     ("rng_free", 1), ("sa_free", 1)])
def test_kernel_plain_matches_pallas(name, K):
    """The kernel path's plain versions (the moving-wall forms' names:
    the flat ones on the flat decks, the all-features ones on the
    axisymmetric channel) against make_pallas_chunk in interpret mode:
    every field to 1e-10 of its plane's scale, RMS and dt_used to rtol
    1e-10, beta where the equation is above 1e-4 of its scale, the Tg<0
    and overrun rows exactly."""
    jc, want, wd = pallas_cycle(name, K)
    ts = Solver(port_case(jc), device="cpu", use_kernels=True, fuse_iters=K)
    launches = ts.fused.iteration_launches()
    assert_mw_forms(launches, ts.params)
    assert mw_flat(ts.params) == (not name.endswith("_axisym"))
    if name in CLOSURE_FREE:
        assert "gfc_closure_mw_kernel<general>" in launches
    gd, _ = ts.run_cycle()
    got = ts.host_state()
    errs = {f: scaled_err(want, got, f) for f in KERNEL_FIELDS}
    assert max(errs.values()) < 1e-10, errs
    assert beta_err(want, got, floor=1e-4) < 1.0
    for key in ("RMS", "dt_used"):
        assert rel_diff(gd[key], wd[key]) < 1e-10, key
    for key in ("unstable", "dt_overrun"):
        np.testing.assert_array_equal(gd[key], wd[key], key)


def port_mw_case(deck, uw=10.0, dtype="float64"):
    case = build_case(deck, dtype=dtype)
    case.params = dataclasses.replace(case.params, isSrcAdd=True)
    case.grid.Uw[case.grid.is_cond(fl.CT_WALL_NO_SLIP_2D)] = uw
    return case


@pytest.mark.parametrize("K", [1, 2])
def test_plain_strips_match_single_domain(K):
    """The kernel path's plain versions as 2 X strips (the sources are
    node-local: no new halo) bit for bit the single domain, the diags too
    but RMS (summed across the strips in another order: rtol 1e-12)."""
    d = ex.wall_channel_deck(48, 40, 4, fl.TEM_k_eps_Std)
    d.data["Contour1.Bound3.Cond"] = FREE_WALL
    case = port_mw_case(d, 0.0)
    one = Solver(case, device="cpu", use_kernels=True, fuse_iters=K)
    two = Solver(case, use_kernels=True, fuse_iters=K,
                 comm=LocalComm(2, "cpu"))
    assert n_scratch(case.params) == N_SCRATCH_MW
    for n in (2, 3):
        da, db = one.run_iters(n), two.run_iters(n)
        a, b = one.host_state(), two.host_state()
        for f in a:
            assert np.array_equal(a[f], b[f]), (n, f)
        for k in da:
            if k == "RMS":
                np.testing.assert_allclose(db[k], da[k], rtol=1e-12, atol=0)
            else:
                assert np.array_equal(da[k], db[k]), (n, k)
    assert np.abs(a["SrcAdd"][list(MW_EQ)]).max() > 0


# the form of every gfc family with moving-wall sources, whatever else the
# deck has, and of pass12
def _decks():
    return {
        "combustor": ex.combustor_deck(32, 48),
        "step_heat": ex.combustor_deck(32, 48, with_step=True,
                                       adiabatic=False),
        "cylinders": ex.cylinders_deck(64, 32),
        "rng": ex.combustor_deck(32, 48),
        "combustor_axisym": ex.combustor_deck(32, 48),
        "bubble_axisym": ex.bubble_deck(48, 40),
        "scramjet": ex.scramjet_deck(64, 48),
    }


# what the decks of the timed 2048^2 cells launch (gfc, pass12) without
# moving-wall sources, as before the moving-wall forms existed; with them,
# the moving-wall forms: pass12's flat one where the sources are the
# deck's one extended feature
BEFORE = {"combustor": ("gfc_kernel", "pass12_kernel"),
          "step_heat": ("gfc_kernel", "pass12_kernel"),
          "cylinders": ("gfc_euler_kernel", "pass12_kernel"),
          "rng": ("gfc_keps_var_kernel", "pass12_kernel"),
          "combustor_axisym": ("gfc_axi_kernel", "pass12_axi_kernel"),
          "bubble_axisym": ("gfc_euler_ext_kernel", "pass12_axi_kernel"),
          "scramjet": ("gfc_ext_kernel", "pass12_ext_kernel")}
WITH_MW = {"combustor": ("gfc_mw_kernel", "pass12_mw_flat_kernel"),
           "step_heat": ("gfc_mw_kernel", "pass12_mw_flat_kernel"),
           "cylinders": ("gfc_euler_mw_kernel", "pass12_mw_flat_kernel"),
           "rng": ("gfc_closure_mw_kernel", "pass12_mw_flat_kernel"),
           "combustor_axisym": ("gfc_mw_kernel", "pass12_mw_kernel"),
           "bubble_axisym": ("gfc_euler_mw_kernel", "pass12_mw_kernel"),
           "scramjet": ("gfc_mw_kernel", "pass12_mw_kernel")}


@functools.lru_cache(maxsize=None)
def form_case(kind):
    d = _decks()[kind]
    if kind.endswith("_axisym"):
        d.data["FlowType"] = "1"
    case = build_case(d, dtype="float32")
    if kind == "rng":
        case.params = dataclasses.replace(case.params, tem=fl.TEM_k_eps_RNG)
    return case


@pytest.mark.parametrize("kind", list(BEFORE))
def test_forms_with_and_without_moving_walls(kind):
    case = form_case(kind)
    names = Solver(case, device="cpu", use_kernels=True).fused \
        .iteration_launches()
    gfc_k, p12_k = BEFORE[kind]
    assert all(n.startswith((f"{gfc_k}<", f"{p12_k}<")) for n in names), \
        names
    mw = dataclasses.replace(case, params=dataclasses.replace(
        case.params, isSrcAdd=True))
    step = Solver(mw, device="cpu", use_kernels=True).fused
    names = step.iteration_launches()
    gfc_mw, p12_mw = WITH_MW[kind]
    assert_mw_forms(names, mw.params, gfc_mw)
    for body in ("general", "dual"):
        assert step.gfc_name(body) == f"{gfc_mw}<{body}>"
        assert step.pass12_name(body) == f"{p12_mw}<{body}>"
    if not step.euler:
        assert step.gfc_name("spec") == \
            f"{gfc_mw.replace('_mw_', '_ext_')}<spec>"
        assert step.pass12_name("spec") == "pass12_ext_kernel<spec>"
    dual = Solver(mw, device="cpu", use_kernels=True, dispatch="dual") \
        .fused.iteration_launches()
    assert dual == [f"{gfc_mw}<dual>", f"{p12_mw}<dual>"], dual
    assert n_scratch(mw.params) == N_SCRATCH_MW



# the closure decks with moving-wall sources (the wall channel of
# tests/test_turbulence_models.py at 48 x 96, whose k-eps decks have spec
# tiles): (TurbulenceModel, TurbExtModel, FlowType).  Every one runs
# gfc_closure_mw_kernel on its general and dual launches, whatever its
# families and its other features, and the all-features closures' spec
# body on its spec launches: no deck sets isSrcAdd with a closure, so no
# closure family has a moving-wall form of its own
CLOSURE_MW_DECKS = {
    "chien": (4, fl.TEM_k_eps_Chien, 0),
    "rng": (4, fl.TEM_k_eps_RNG, 0),
    "sa": (3, fl.TEM_Spalart_Allmaras, 0),
    "smagorinsky": (5, fl.TEM_Smagorinsky, 0),
    "van driest": (2, fl.TEM_vanDriest, 0),
    "escudier": (2, fl.TEM_Escudier, 0),
    "two families": (4, fl.TEM_k_eps_JL, 0),
    "sa axisymmetric": (3, fl.TEM_Spalart_Allmaras, 1),
    "rng axisymmetric": (4, fl.TEM_k_eps_RNG, 1)}


@functools.lru_cache(maxsize=None)
def closure_mw_case(name):
    tm, tem, ft = CLOSURE_MW_DECKS[name]
    d = ex.wall_channel_deck(48, 96, tm, tem)
    if name == "two families":
        # k-eps JL inside, the Prandtl family at the no-slip wall
        d.data.update({"isTurbulenceReset": "0",
                       "Contour1.Bound3.TurbulenceModel": "2"})
    d.data["FlowType"] = str(ft)
    return port_mw_case(d, dtype="float32")


@pytest.mark.parametrize("name", list(CLOSURE_MW_DECKS))
def test_each_closure_deck_with_moving_walls_picks_its_form(name):
    """The closures' moving-wall gfc of each deck, in both dispatch forms:
    gfc_closure_mw_kernel on every general and dual launch, the
    all-features closures' spec body on the spec launch of a deck with
    k-eps nodes; pass12's flat form where mw_flat takes the deck."""
    tm, _, ft = CLOSURE_MW_DECKS[name]
    case = closure_mw_case(name)
    p = case.params
    assert mw_flat(p) == (ft == 0)
    for dispatch in ("lists", "dual"):
        step = Solver(case, device="cpu", use_kernels=True,
                      dispatch=dispatch).fused
        names = step.iteration_launches()
        assert_mw_forms(names, p, "gfc_closure_mw_kernel")
        gfc = [n for n in names if n.startswith("gfc_")]
        bodies = (["dual"] if dispatch == "dual" else
                  [b for b in ("spec", "general")
                   if step.plan.tiles(b).numel()])
        # spec tiles: the decks with k-eps nodes, on "lists"
        assert ("spec" in bodies) == (dispatch == "lists" and tm == 4)
        assert gfc == [("gfc_closure_ext_kernel" if b == "spec"
                        else "gfc_closure_mw_kernel") + f"<{b}>"
                       for b in bodies]


@pytest.mark.parametrize("kind", list(BEFORE))
@pytest.mark.parametrize("src_add", [False, True])
def test_mw_flat_form_exactly_where_no_other_feature(kind, src_add):
    """pass12_form gives "mw_flat" exactly where the deck has moving-wall
    sources and none of the other extended features, "mw" where it has
    both, gfc_form "mw" on either, and n_scratch the planes of each: 31
    on a flat deck, 40 on an axisymmetric one, 46 with moving-wall
    sources."""
    case = form_case(kind)
    p = dataclasses.replace(case.params, isSrcAdd=src_add)
    plain = not any(_ext_features(p).values())
    assert mw_flat(p) == (src_add and plain)
    if src_add:
        assert pass12_form(p) == ("mw_flat" if plain else "mw")
        assert gfc_form(p) == "mw"
        assert n_scratch(p) == N_SCRATCH_MW
    else:
        assert n_scratch(p) == (N_SCRATCH_AXI
                                if p.ft == fl.FT_AXISYMMETRIC else N_SCRATCH)
        if plain:
            with pytest.raises(ValueError, match="no extended form"):
                gfc_form(p)
            with pytest.raises(ValueError, match="no extended form"):
                pass12_form(p)
        else:
            assert pass12_form(p) in ("axi", "all")


@functools.lru_cache(maxsize=None)
def chip_smoke():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_one_picking_rule_in_c_and_on_the_host():
    """C's mw_flat (csrc/fused_step.cuh) tests the moving-wall flag and
    exactly the flags of the host's _ext_features, each false, as
    ops/fused_step.mw_flat does (a text check: no nvcc here)."""
    text = (CSRC / "fused_step.cuh").read_text()
    body = re.search(r"inline bool mw_flat\(const C& c\) \{\s*return ([^;]*);",
                     text).group(1)
    terms = [t.strip() for t in body.split("&&")]
    assert terms[0] == "c.wall_src"
    flags = {t.removeprefix("!c.") for t in terms[1:]}
    assert all(t.startswith("!c.") for t in terms[1:])
    p = form_case("combustor").params
    assert flags == set(_ext_features(p))


def test_every_mw_form_is_one_instantiation_and_one_query_entry():
    """Each moving-wall kernel of MW_KERNEL_NAMES is defined once, in
    fused_step_mw.cu, answers hf2d_kernel_info at chip_smoke.py's stage
    (general and dual bodies), and chip_smoke.py names its profiler rows
    and, for mw_ab, a flat deck's launches of either build under one name
    a stage and body."""
    text = {f.name: f.read_text() for f in CSRC.glob("*.cu")}
    mw = text["fused_step_mw.cu"]
    cs = chip_smoke()
    entries = {k: int(v) for v, k in re.findall(
        r"case (\d+):\s*return dual \? \(const void\*\)(\w+)<BODY_DUAL>",
        mw)}
    kernels = {n.split("<")[0] for n in MW_KERNEL_NAMES}
    assert entries == {k: cs._STAGE[k] for k in kernels}
    assert len(set(cs._STAGE.values())) == len(cs._STAGE)
    for k in kernels:
        assert sum(len(re.findall(rf"^{k}\(", t, re.M))
                   for t in text.values()) == 1, k
        for code, body in (("0", "general"), ("2", "dual")):
            row = f"void {k}<{code}>(Consts, float const*, float*)"
            assert cs.profiled_kernel(row) == f"{k}<{body}>"
    same = {"gfc<general>": ("gfc_mw_kernel<0>", "gfc_mw_kernel<0>"),
            "gfc<spec>": ("gfc_ext_kernel<1>", "gfc_ext_kernel<1>"),
            "pass12<general>": ("pass12_mw_flat_kernel<0>",
                                "pass12_mw_kernel<0>"),
            "pass12<dual>": ("pass12_mw_flat_kernel<2>",
                             "pass12_mw_kernel<2>"),
            "pass12<spec>": ("pass12_ext_kernel<1>",
                             "pass12_ext_kernel<1>")}
    for want, rows in same.items():
        assert [cs.mw_ab_kernel(f"void {r}(Consts)") for r in rows] == \
            [want] * 2
    assert cs.mw_ab_kernel("void gfc_closure_mw_kernel<0>(ExtConsts)") \
        is None
