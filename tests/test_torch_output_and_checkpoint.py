"""Port parity: the output writers, post-processing, probes and the
checkpoint of the port.

Counterparts of tests/test_output_and_checkpoint.py on the port's own copies
(io_out/tecplot, postproc/outcfd, solver/checkpoint), read through
``io_out.host.host_view``; its CLI tests are in tests/test_torch_cli.py and
its native wall-distance test in tests/test_torch_geometry.py.  Beyond
them:

* the port's writers give the JAX writers' bytes on the same host state;
* a checkpoint restores across the two packages, the file layout being
  JAX's: a JAX checkpoint into the port continues to JAX's state (float64,
  to 1e-10 of each field's scale), a port checkpoint into JAX too, and into
  the port's strip path (``LocalComm(2)``) to the single domain's bits;
* ``probe_many`` gives the fields at the probes on the single domain and on
  the strips, and JAX's values; ``run_case`` runs the reference's loop.
"""

import numpy as np
import pytest
import torch
from torch_parity import np_fields, port_case, scaled_err

from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.examples import channel_deck, freestream_deck
from openhyperflow2d_torch.io_out.host import host_view
from openhyperflow2d_torch.io_out.tecplot import (read_tecplot_zone,
                                                  save_data_2d)
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.postproc import outcfd
from openhyperflow2d_torch.solver.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver, run_case

FIELDS = ["S", "beta", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu",
          "mu_t", "lam_t", "dt"]


@pytest.fixture(scope="module")
def channel_solver():
    case = build_case(channel_deck(nx=48, ny=32, mach2_v=-80.0))
    s = Solver(case, device="cpu")
    s.run_iters(20)
    return case, s


def test_tecplot_roundtrip(channel_solver, tmp_path):
    case, s = channel_solver
    st = host_view(s.host_state())
    path = str(tmp_path / "out.plt")
    save_data_2d(path, case.grid, st, case.params, s.global_time)
    g = read_tecplot_zone(path, case.params.MaxX, case.params.MaxY)
    np.testing.assert_allclose(g["U"], st.U, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(g["p"], st.p, rtol=2e-5)


def test_writers_give_the_jax_bytes(channel_solver, tmp_path):
    """The port's copies of the writers against the JAX package's on the
    same host state: the snapshot (with p* and a Cp column), RMS and
    monitor rows, both heat-flux profiles."""
    from openhyperflow2d_tpu.io_out import tecplot as jtec
    from openhyperflow2d_tpu.postproc import outcfd as jout
    from openhyperflow2d_torch.io_out import tecplot as ttec
    case, s = channel_solver
    st = host_view(s.host_state())
    X, Y = case.params.MaxX, case.params.MaxY
    cp_arr = np.linspace(-1.0, 1.0, X * Y).reshape(X, Y)
    rms = np.random.default_rng(5).random((7, 9))
    for who, tec, out in (("jax", jtec, jout), ("torch", ttec, outcfd)):
        d = tmp_path / who
        d.mkdir()
        tec.save_data_2d(str(d / "a.plt"), case.grid, st, case.params, 1e-4,
                         is_p_asterisk_out=True, cp_arr=cp_arr)
        tec.save_rms_header(str(d / "rms"))
        tec.save_rms_rows(str(d / "rms"), 10, rms, every=2)
        tec.save_monitors_header(str(d / "mon"), 2)
        tec.save_monitors_row(str(d / "mon"), 1e-4, [(1.0, 2.0), (3.0, 4.)])
        out.save_x_heat_flux(str(d / "hx"), case.grid, st,
                             case.flow2d_list[0], case.params.Ts0, Y, 0)
        out.save_y_heat_flux(str(d / "hy"), case.grid, st, case.params.Ts0)
    for f in ("a.plt", "rms", "mon", "hx", "hy"):
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def test_snapshot_p_asterisk_and_cp_columns(channel_solver, tmp_path):
    case, s = channel_solver
    st = host_view(s.host_state())
    X, Y = case.params.MaxX, case.params.MaxY
    cp_arr = np.linspace(-1.0, 1.0, X * Y).reshape(X, Y)
    path = str(tmp_path / "past.plt")
    save_data_2d(path, case.grid, st, case.params, s.global_time,
                 is_p_asterisk_out=True, cp_arr=cp_arr)
    with open(path) as f:
        assert ", p*," in f.readline()
    g = read_tecplot_zone(path, X, Y)
    ps = outcfd.p_asterisk(st)
    gas = ~case.grid.is_cond(fl.CT_SOLID_2D)
    written = gas & (st.S[0] != 0.0)
    np.testing.assert_allclose(g["mu_t_mu"][written], ps[written],
                               rtol=2e-5)
    np.testing.assert_allclose(g["Cp"], cp_arr, rtol=2e-5, atol=1e-5)
    path2 = str(tmp_path / "mut.plt")
    save_data_2d(path2, case.grid, st, case.params, s.global_time)
    g2 = read_tecplot_zone(path2, X, Y)
    mut = st.mu_t / st.mu
    np.testing.assert_allclose(g2["mu_t_mu"][written], mut[written],
                               rtol=2e-5, atol=1e-8)
    assert (g2["Cp"] == 0).all()


def test_p_asterisk_and_mass_flow(channel_solver):
    case, s = channel_solver
    st = host_view(s.host_state())
    ps = outcfd.p_asterisk(st)
    gas = ~case.grid.is_cond(fl.CT_SOLID_2D)
    assert (ps[gas] >= st.p[gas] - 1e-9).all()
    mp = outcfd.calc_mass_flow_rate_x(case.grid, st, 0.0, 0.0,
                                      case.params.MaxY * case.params.dy)
    expect = (st.S[0, 0, :] * st.U[0, :] * case.params.dy).sum()
    assert mp == pytest.approx(expect, rel=1e-12)


def test_average_pressure(channel_solver):
    case, s = channel_solver
    st = host_view(s.host_state())
    pa = outcfd.calc_average_pressure(case.grid, st, 0.0,
                                      case.params.MaxX * case.params.dx,
                                      case.params.MaxY * case.params.dy)
    assert st.p.min() <= pa <= st.p.max()


def test_checkpoint_roundtrip(tmp_path):
    s1 = Solver(build_case(freestream_deck(nx=16, ny=16)), device="cpu")
    s1.run_iters(7)
    s1.global_time = 1.25e-5
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, s1)
    s2 = Solver(build_case(freestream_deck(nx=16, ny=16)), device="cpu")
    load_checkpoint(path, s2)
    assert s2.last_iter == 7
    assert s2.global_time == pytest.approx(1.25e-5)
    assert torch.equal(s2.state.S, s1.state.S)
    s1.run_iters(5)
    s2.run_iters(5)
    np.testing.assert_allclose(s2.state.S.numpy(), s1.state.S.numpy(),
                               rtol=1e-12)


def test_checkpoint_shape_mismatch(tmp_path):
    s1 = Solver(build_case(freestream_deck(nx=16, ny=16)), device="cpu")
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, s1)
    s2 = Solver(build_case(freestream_deck(nx=24, ny=16)), device="cpu")
    with pytest.raises(ValueError):
        load_checkpoint(path, s2)


@pytest.fixture(scope="module")
def jax_pair():
    """A JAX solver of the channel deck 10 iterations on, and its case."""
    from openhyperflow2d_tpu.examples import channel_deck as jchannel
    from openhyperflow2d_tpu.solver.init import build_case as jbuild
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    jc = jbuild(jchannel(32, 24))
    js = JSolver(jc)
    js.run_iters(10)
    js.global_time = 2.5e-5
    return jc, js


def test_jax_checkpoint_continues_in_the_port(jax_pair, tmp_path):
    from openhyperflow2d_tpu.solver.checkpoint import \
        save_checkpoint as jax_save
    jc, js = jax_pair
    path = str(tmp_path / "jax.npz")
    jax_save(path, js)
    ts = Solver(port_case(jc), device="cpu")
    load_checkpoint(path, ts)
    assert (ts.last_iter, ts.global_time) == (10, 2.5e-5)
    for f in FIELDS:
        np.testing.assert_array_equal(ts.host_state()[f],
                                      np.asarray(getattr(js.state, f)), f)
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    jcont = JSolver(jc)
    from openhyperflow2d_tpu.solver.checkpoint import \
        load_checkpoint as jax_load
    jax_load(path, jcont)
    jcont.run_iters(6)
    ts.run_iters(6)
    want, got = np_fields(jcont.state), ts.host_state()
    errs = {f: scaled_err(want, got, f) for f in FIELDS if f != "beta"}
    assert max(errs.values()) < 1e-10, errs


def test_port_checkpoint_restores_in_jax_and_in_strips(jax_pair, tmp_path):
    from openhyperflow2d_tpu.solver.checkpoint import \
        load_checkpoint as jax_load
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    jc, _ = jax_pair
    ts = Solver(port_case(jc), device="cpu")
    ts.run_iters(9)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, ts)
    js = JSolver(jc)
    jax_load(path, js)
    assert js.last_iter == 9
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js.state, f)),
                                      ts.host_state()[f], f)
    strips = Solver(port_case(jc), device="cpu", comm=LocalComm(2, "cpu"))
    load_checkpoint(path, strips)
    assert strips.last_iter == 9
    ts.run_iters(5)
    strips.run_iters(5)
    a, b = ts.host_state(), strips.host_state()
    for f in FIELDS:
        np.testing.assert_array_equal(b[f], a[f], f)


def test_probes_single_strips_and_jax(jax_pair):
    jc, js = jax_pair
    points = [(mp.x, mp.y) for mp in jc.monitor_points] or [
        (0.05, 0.05), (0.2, 0.1)]
    ts = Solver(port_case(jc), device="cpu")
    strips = Solver(port_case(jc), device="cpu", comm=LocalComm(2, "cpu"))
    ts.run_iters(10)
    strips.run_iters(10)
    single = ts.probe_many(points)
    assert single == strips.probe_many(points)
    assert ts.probe(*points[0]) == single[0]
    np.testing.assert_allclose(np.array(single),
                               np.array(js.probe_many(points)), rtol=1e-10)
    st = ts.host_state()
    for (x, y), (p, T) in zip(points, single):
        i, j = ts._probe_index(x, y)
        assert (p, T) == (st["p"][i, j], st["Tg"][i, j])


def test_run_case_runs_the_reference_loop(capsys):
    case = build_case(channel_deck(16, 16, nmax=5))
    s = run_case(case, max_cycles=2, device="cpu")
    assert s.last_iter == 2 * case.Nstep
    out = capsys.readouterr().out
    assert out.count("Cycle ") == 2 and "Cycle 2: iter=" in out
