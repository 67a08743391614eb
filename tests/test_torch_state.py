"""Port parity: case building, staged state and table lookups.

The port's jax-free ``build_case`` must produce the JAX package's host grid,
SolverParams and chemistry tables; the staged tensors and the table lookups
must be bitwise equal to JAX's in float64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import np_fields, to_np

from openhyperflow2d_tpu.config.tables import Table
from openhyperflow2d_tpu.config.tables import table_lookup as jax_lookup
from openhyperflow2d_tpu.core import state as jstate
from openhyperflow2d_tpu.examples import combustor_deck, reacting_rans_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_torch.config.tables import table_lookup
from openhyperflow2d_torch.core import state as tstate
from openhyperflow2d_torch.solver import init as tinit

DECKS = {
    "combustor": lambda: combustor_deck(48, 40),
    "rans_wall": lambda: reacting_rans_deck(48, 40, wall_bottom=True),
}


@pytest.fixture(scope="module", params=sorted(DECKS))
def cases(request):
    deck = DECKS[request.param]
    return jinit.build_case(deck()), tinit.build_case(deck())


def test_build_case_grid_matches_jax(cases):
    jc, tc = cases
    jg, tg = jc.grid, tc.grid
    for f in dataclasses.fields(jg):
        if f.name == "extras":
            continue
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name
    assert sorted(jg.extras) == sorted(tg.extras)
    for k in jg.extras:
        np.testing.assert_array_equal(tg.extras[k], jg.extras[k], err_msg=k)
    np.testing.assert_array_equal(tc.wall_nodes, jc.wall_nodes)


def test_build_case_params_and_run_control_match_jax(cases):
    jc, tc = cases
    assert dataclasses.asdict(tc.params) == dataclasses.asdict(jc.params)
    for f in ("dt0", "Nstep", "NOutStep", "NSaveStep", "MonitorIndex",
              "ExitMonitorValue", "project_name"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("beta_scenario", "cfl_scenario"):
        np.testing.assert_array_equal(getattr(tc, f).x, getattr(jc, f).x)
        np.testing.assert_array_equal(getattr(tc, f).y, getattr(jc, f).y)


def test_chem_tables_match_jax(cases):
    jc, tc = cases
    assert (tc.chem.K0, tc.chem.gamma, tc.chem.Tf, tc.chem.R, tc.chem.H) == \
        (jc.chem.K0, jc.chem.gamma, jc.chem.Tf, jc.chem.R, jc.chem.H)
    jt = np_fields(jinit.chem_tables_device(jc.chem, jnp.float64))
    tt = tinit.chem_tables_device(tc.chem, torch.float64)
    for name, a in jt.items():
        b = to_np(getattr(tt, name))
        np.testing.assert_array_equal(b, a, err_msg=name)
        assert b.dtype == a.dtype, name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_state_and_meta_from_grid_bitwise(cases, dtype):
    jc, _ = cases
    p = dataclasses.replace(jc.params, dtype=dtype)
    tp = tstate.params_from_dict(dataclasses.asdict(p))
    assert tp.torch_dtype == getattr(torch, dtype)
    js = np_fields(jstate.state_from_grid(jc.grid, p, jc.dt0))
    ts = tstate.state_from_grid(jc.grid, tp, jc.dt0)
    for name, a in js.items():
        b = to_np(getattr(ts, name))
        np.testing.assert_array_equal(b, a, err_msg=name)
        assert b.dtype == a.dtype and b.shape == a.shape, name
    jm = np_fields(jstate.meta_from_grid(jc.grid, dtype=p.jdtype))
    tm = tstate.meta_from_grid(jc.grid, dtype=tp.torch_dtype)
    for name, a in jm.items():
        b = getattr(tm, name)
        if a is None:
            assert b is None, name
            continue
        b = to_np(b)
        if a.dtype == np.uint32:          # int32 bit-views in the port
            assert b.dtype == np.int32, name
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=name)
        assert b.dtype == a.dtype, name
    # the converter carries the JAX meta across unchanged
    cm = tstate.meta_from_numpy(jm)
    for name in ("CT", "TCT", "l_min", "idXl"):
        np.testing.assert_array_equal(to_np(getattr(cm, name)),
                                      to_np(getattr(tm, name)))


TABLES = {
    # two knots (the example decks' property tables)
    "two_knot": Table(np.array([200., 1800.]), np.array([1052., 1398.])),
    # several ascending knots (telescoped form applies)
    "ascending": Table(np.array([100., 400., 900., 1500., 2600.]),
                       np.array([0.02, 0.035, 0.061, 0.09, 0.14])),
    # descending knots (reference quirk: boundary checks only)
    "descending": Table(np.array([3000., 1500., 600., 250.]),
                        np.array([0.2, 0.11, 0.05, 0.02])),
    "single": Table(np.array([0.]), np.array([0.95])),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_lookup_bitwise_f64(name):
    t = TABLES[name]
    rng = np.random.default_rng(7)
    q = np.concatenate([rng.uniform(-500., 4000., 4096), t.x,
                        [t.x.min() - 1., t.x.max() + 1.]])
    asc_forms = [False]
    if t.n >= 2 and np.all(np.diff(t.x) > 0):
        asc_forms.append(True)
    for asc in asc_forms:
        want = np.asarray(jax_lookup(jnp.asarray(t.x), jnp.asarray(t.y),
                                     jnp.asarray(q), ascending=asc))
        got = to_np(table_lookup(torch.as_tensor(t.x), torch.as_tensor(t.y),
                                 torch.as_tensor(q), ascending=asc))
        np.testing.assert_array_equal(got, want, err_msg=f"asc={asc}")
        ref = np.array([t.get_val(v) for v in q])
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)
