"""Port parity: the post-processing and y+ paths of the port.

Counterparts of tests/test_outcfd_vectorized.py (the vectorized sweeps of
the port's own copy of postproc/outcfd against the reference's loop order),
tests/test_xcut.py (XCut mass-flow conservation on an Euler channel run by
the port), tests/test_stanton.py (the _REF_TEST_ heat-flux columns on an
NS flat plate run by the port, the port's writer giving the JAX writer's
bytes on the same state, and the columns against JAX's own run: 40
iterations, not JAX's 400, because on this deck JAX's compiled run parts
from JAX run op by op by 1e-2 of Tg's scale after 60 iterations, and the
port follows each as closely; after 40 the three agree to 6e-8) and
tests/test_yplus_device.py (the device y+ update against
``Solver.recalc_y_plus_host``, on one domain and on 2 strips, and a
cycle without a host round trip).
"""

import numpy as np
import pytest

from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.examples import channel_deck
from openhyperflow2d_torch.io_out.host import host_view
from openhyperflow2d_torch.postproc.outcfd import (_fold_max_nonzero,
                                                   _last_wall_value,
                                                   calc_area_x,
                                                   calc_mass_flow_rate_x,
                                                   save_x_heat_flux,
                                                   smooth_x, smooth_y)
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver


def _smooth_x_loop(a):
    X, Y = a.shape
    for j in range(Y):
        for i in range(1, X - 1):
            if a[i + 1, j] > 0.0 and a[i - 1, j] > 0.0:
                a[i, j] = 0.5 * (a[i + 1, j] + a[i - 1, j])
    return a


def _smooth_y_loop(a):
    X, Y = a.shape
    for j in range(1, Y - 1):
        for i in range(X):
            if a[i, j + 1] > 0.0 and a[i, j - 1] > 0.0:
                a[i, j] = 0.5 * (a[i, j + 1] + a[i, j - 1])
    return a


def test_smooth_xy_match_loop_order():
    rng = np.random.default_rng(7)
    a0 = rng.normal(size=(37, 23))
    a0[rng.random(a0.shape) < 0.3] = 0.0
    np.testing.assert_array_equal(smooth_x(a0.copy()),
                                  _smooth_x_loop(a0.copy()))
    np.testing.assert_array_equal(smooth_y(a0.copy()),
                                  _smooth_y_loop(a0.copy()))
    np.testing.assert_array_equal(
        smooth_y(smooth_x(a0.copy())),
        _smooth_y_loop(_smooth_x_loop(a0.copy())))


def test_heatflux_fold_matches_reference_accumulator():
    rng = np.random.default_rng(3)
    X, Y = 29, 17
    q = rng.normal(size=(X, Y))
    q[rng.random((X, Y)) < 0.2] = 0.0
    sel = rng.random((X, Y)) < 0.4
    expect = np.zeros(X)
    for i in range(X):
        for j in range(Y):
            if sel[i, j]:
                expect[i] = (max(expect[i], q[i, j]) if expect[i] != 0.0
                             else q[i, j])
    heat = np.zeros(X)
    for j in range(Y):
        heat = _fold_max_nonzero(heat, sel[:, j], q[:, j])
    np.testing.assert_array_equal(heat, expect)


def test_last_wall_value_matches_loop():
    rng = np.random.default_rng(11)
    X, Y = 19, 13
    vals = rng.normal(size=(X, Y))
    sel = rng.random((X, Y)) < 0.3
    sel[4, :] = False
    expect = np.zeros(X)
    for i in range(X):
        for j in range(Y):
            if sel[i, j]:
                expect[i] = vals[i, j]
    np.testing.assert_array_equal(_last_wall_value(vals, sel), expect)


def test_xcut_mass_flow_conserved_uniform_stream():
    nx, ny = 64, 48
    case = build_case(channel_deck(nx=nx, ny=ny, u=500.0, problem_type=0))
    solver = Solver(case, device="cpu")
    solver.run_iters(10)
    st = host_view(solver.host_state())
    grid = case.grid
    lx, h = nx * grid.dx, ny * grid.dy
    m1 = calc_mass_flow_rate_x(grid, st, 0.3 * lx, 0.0, h)
    m2 = calc_mass_flow_rate_x(grid, st, 0.7 * lx, 0.0, h)
    assert np.isclose(m1, m2, rtol=1e-10)
    i = int(0.3 * lx / grid.dx)
    rhoU = st.S[fl.i2d_RhoU][i, ny // 2]
    area = calc_area_x(grid, 0.3 * lx, 0.0, h)
    assert np.isclose(m1, rhoU * area, rtol=1e-2)
    assert m1 > 0


def test_xcut_area_excludes_solids():
    nx, ny = 96, 48
    case = build_case(channel_deck(nx=nx, ny=ny, u=500.0, problem_type=0,
                                   with_rect=True))
    grid = case.grid
    lx, h = nx * grid.dx, ny * grid.dy
    a_open = calc_area_x(grid, 0.1 * lx, 0.0, h)
    a_cut = calc_area_x(grid, 0.35 * lx, 0.0, h)
    assert a_cut < a_open
    assert a_open > 0


def test_ref_test_heat_flux_columns(tmp_path):
    """The flat plate (NS, laminar, a no-slip bottom wall) run by the port;
    the _REF_TEST_ columns (out_cfd_param.cpp:536-547) from the port's
    writer, byte for byte the JAX writer's on the same host state, and the
    correlation at one column by hand."""
    from openhyperflow2d_tpu.postproc.outcfd import \
        save_x_heat_flux as jax_save_x_heat_flux
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    from openhyperflow2d_tpu.examples import channel_deck as jax_channel
    from openhyperflow2d_tpu.solver.init import build_case as jax_build
    from torch_parity import port_case
    iters = 40
    jc = jax_build(jax_channel(nx=96, ny=48, u=100.0, problem_type=1,
                               turb_model=0, turb_ext_model=0, cfl=0.4,
                               wall_bottom=True, nmax=iters))
    case = port_case(jc)
    s = Solver(case, device="cpu")
    s.run_iters(iters)
    st = host_view(s.host_state())
    js = JSolver(jc)
    js.run_iters(iters)
    want = jax_save_x_heat_flux(str(tmp_path / "jax_run"), case.grid,
                                js.host_state(), case.flow2d_list[0],
                                case.params.Ts0, case.params.MaxY, 0,
                                ref_test=True)
    out, ref = tmp_path / "HeatFlux-X-plate", tmp_path / "jax"
    heat, alpha, q_ref, a_ref, re, pr = save_x_heat_flux(
        str(out), case.grid, st, case.flow2d_list[0], case.params.Ts0,
        case.params.MaxY, 0, ref_test=True)
    jax_save_x_heat_flux(str(ref), case.grid, st, case.flow2d_list[0],
                         case.params.Ts0, case.params.MaxY, 0,
                         ref_test=True)
    assert out.read_bytes() == ref.read_bytes()
    for got, w in zip((heat, alpha, q_ref, a_ref, re, pr), want):
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-12)
    X = case.params.MaxX
    mid = slice(X // 4, 3 * X // 4)
    assert (alpha[mid] > 0).all()
    head = out.read_text().splitlines()[0]
    assert "HeatFluxRef(X)" in head and "Pr(X)" in head
    assert (np.diff(re[mid]) > 0).all()
    assert (0.2 < pr[mid]).all() and (pr[mid] < 1.5).all()
    i = X // 2
    j = int(np.nonzero(case.grid.is_cond(fl.CT_WALL_NO_SLIP_2D)[i])[0][0])
    if re[i] < 5e5:
        nu = 0.332 * np.sqrt(re[i]) * pr[i] ** (1 / 3)
    else:
        nu = 0.0296 * re[i] ** 0.8 * pr[i] ** (1 / 3)
    a_expect = nu * st.lam[i, j] / ((i + 0.5) * case.grid.dx)
    np.testing.assert_allclose(a_ref[i], a_expect, rtol=1e-10)
    re_lin = re[mid] / (np.arange(X)[mid] + 0.5)
    assert re_lin.std() / re_lin.mean() < 0.25
    # the first-cell coefficient against the correlation: smooth along the
    # plate (tests/test_stanton.py's bound)
    ratio = alpha[mid] / np.maximum(a_ref[mid], 1e-30)
    assert (ratio > 0).all()
    assert ratio.max() / ratio.min() < 2.0, ratio
    assert np.sign(heat[mid]).std() == 0


@pytest.fixture(scope="module")
def yplus_case():
    return build_case(channel_deck(nx=64, ny=32, problem_type=1,
                                   turb_model=4, turb_ext_model=4,
                                   with_rect=True, nmax=5))


@pytest.mark.parametrize("strips", [0, 2])
def test_device_yplus_matches_host_oracle(yplus_case, strips):
    from openhyperflow2d_torch.parallel.comm import LocalComm
    comm = LocalComm(strips, "cpu") if strips else None
    s = Solver(yplus_case, device="cpu", comm=comm)
    assert len(yplus_case.wall_nodes) > 0
    s.run_iters(6)
    want = s.recalc_y_plus_host()
    s.recalc_y_plus()
    got = s.host_state()["y_plus"]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def test_run_cycle_no_host_roundtrip(yplus_case, monkeypatch):
    s = Solver(yplus_case, device="cpu")
    calls = []
    orig = Solver.host_state
    monkeypatch.setattr(Solver, "host_state",
                        lambda self: calls.append(1) or orig(self))
    s.run_cycle()
    assert not calls, "run_cycle fetched the full state to host"
