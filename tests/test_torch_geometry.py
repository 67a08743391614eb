"""The port's own host modules against the JAX package's.

The port keeps copies of the JAX package's numpy host code (deck parser,
tables, flags, gas dynamics, geometry, example decks) and imports none of
it.  These tests hold the copies to the originals:

* every example deck function gives the same deck text, key by key, with
  the same tables;
* the port's ``build_case`` builds the same HostGrid, bitwise, the same
  solver parameters and the same chemistry as JAX's ``build_case``, for
  every deck including the solid primitives (rectangle, circles, airfoil),
  which reach the port's ``geometry/solids``;
* a deck the port cannot run yet is refused by name before anything runs;
* the native wall-distance transform and the numpy path agree bitwise on a
  grid above the size where ``geometry/wall`` switches to the native one.
"""

import dataclasses

import numpy as np
import pytest

from openhyperflow2d_tpu import examples as jex
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_torch import examples as tex
from openhyperflow2d_torch.core import flags as tfl
from openhyperflow2d_torch.solver import init as tinit
from openhyperflow2d_torch.solver.runner import Solver

DECKS = {
    "combustor": ("combustor_deck", (32, 48), {}),
    "combustor_step_heat": ("combustor_deck", (32, 48),
                            {"with_step": True, "adiabatic": False}),
    "combustor_bluff": ("combustor_deck", (64, 96), {"bluff_body": True}),
    "rans_wall": ("reacting_rans_deck", (32, 24), {"wall_bottom": True}),
    "rans_step_heat": ("reacting_rans_deck", (48, 40),
                       {"wall_bottom": True, "adiabatic": False,
                        "with_step": True}),
    "cylinders": ("cylinders_deck", (64, 32), {}),
    "airfoil": ("airfoil_deck", (128, 64), {}),
    "channel": ("channel_deck", (24, 16), {}),
    "freestream": ("freestream_deck", (), {"nx": 16, "ny": 16}),
    "bubble": ("bubble_deck", (48, 24), {}),
    "scramjet": ("scramjet_deck", (64, 32), {}),
}


def make(mod, name):
    fn, args, kw = DECKS[name]
    return getattr(mod, fn)(*args, **kw)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_example_decks_match(name):
    want, got = make(jex, name), make(tex, name)
    assert got.data == want.data
    assert sorted(got.tables) == sorted(want.tables)
    for key, t in want.tables.items():
        np.testing.assert_array_equal(got.tables[key].x, t.x, key)
        np.testing.assert_array_equal(got.tables[key].y, t.y, key)


def _grid_fields(grid):
    return {f.name: getattr(grid, f.name) for f in dataclasses.fields(grid)}


@pytest.mark.parametrize("name", sorted(DECKS))
def test_build_case_matches(name):
    want = jinit.build_case(make(jex, name))
    got = tinit.build_case(make(tex, name))
    wg, gg = _grid_fields(want.grid), _grid_fields(got.grid)
    assert sorted(wg) == sorted(gg)
    for f, w in wg.items():
        g = gg[f]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, f)
        elif isinstance(w, dict):
            assert sorted(g) == sorted(w), f
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], f"{f}[{k}]")
        else:
            assert g == w, f
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)
    for f in ("K0", "gamma", "Tf", "R", "H"):
        assert getattr(got.chem, f) == getattr(want.chem, f), f
    assert sorted(got.chem.tables) == sorted(want.chem.tables)
    for key, t in want.chem.tables.items():
        np.testing.assert_array_equal(got.chem.tables[key].x, t.x, key)
        np.testing.assert_array_equal(got.chem.tables[key].y, t.y, key)
    np.testing.assert_array_equal(got.wall_nodes, want.wall_nodes)
    for f in ("dt0", "Nstep", "NOutStep", "MonitorIndex", "ExitMonitorValue"):
        assert getattr(got, f) == getattr(want, f), f


def _refusal(params):
    """What check_supported names for a case, or None."""
    from openhyperflow2d_torch.solver.runner import check_supported
    try:
        check_supported(params)
    except NotImplementedError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(DECKS))
def test_solver_accepts_or_names_what_is_missing(name):
    """Solver either takes the deck, or refuses it before anything runs,
    naming what is missing (Euler decks, other closures, axisymmetric
    flow, ...)."""
    case = tinit.build_case(make(tex, name))
    why = _refusal(case.params)
    if why is None:
        Solver(case, device="cpu")
    else:
        assert why.startswith("not ported yet: ")
        with pytest.raises(NotImplementedError, match="not ported yet"):
            Solver(case, device="cpu")
    # the walled combustor family runs, heat stage and solids included
    if name.startswith(("combustor", "rans_")):
        assert why is None


def test_native_wall_distance_matches_numpy(monkeypatch):
    """Above X * Y * walls = 2e6 (geometry/wall.py) the native transform
    runs; it must give the numpy path's bits."""
    from openhyperflow2d_torch.geometry import native
    deck = tex.combustor_deck(128, 128, with_step=True, adiabatic=False)
    fast = tinit.build_case(deck)
    assert native.available() and native.SOURCE in ("prebuilt", "built")
    assert 128 * 128 * len(fast.wall_nodes) > 2_000_000
    monkeypatch.setattr(native, "available", lambda: False)
    slow = tinit.build_case(tex.combustor_deck(128, 128, with_step=True,
                                               adiabatic=False))
    for f in ("l_min", "i_wall", "j_wall", "S", "U", "y_plus"):
        np.testing.assert_array_equal(getattr(fast.grid, f),
                                      getattr(slow.grid, f), f)


def test_flags_copy_matches():
    from openhyperflow2d_tpu.core import flags as jfl
    names = [n for n in dir(jfl) if n.isupper() or n.startswith(
        ("CT_", "TCT_", "NT_", "i2d_"))]
    assert names
    for n in names:
        assert getattr(tfl, n) == getattr(jfl, n), n
