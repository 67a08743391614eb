"""Port parity: non-uniform meshes (per-node dx/dy maps,
``build_case(dx_map=, dy_map=)``).

The counterparts of tests/test_nonuniform.py on the port, and the port
against the JAX package.  The reference reads a node's own spacing at three
node-local sites: the moving-wall SrcAdd (tests/test_torch_srcadd.py), the
mixing-length floor min(dx, dy) and the Smagorinsky filter width
sqrt(dx dy); stencil constants, gradients and dt keep the deck's spacing.

* constant maps equal to the deck's spacing are the uniform port bit for
  bit (Prandtl: the floor site; Smagorinsky: the width site), and
  ``with_mesh_maps`` of a uniform case is ``build_case(dx_map=, dy_map=)``;
* a wall-refined dy map changes Smagorinsky's eddy viscosity and stays
  stable;
* the kernel path refuses a non-uniform case, as JAX's Pallas path does;
  bad maps raise ValueError;
* the port against JAX's XLA path (float64) at 1e-10 of each plane's scale:
  Smagorinsky on the stretched map, and Prandtl on a map whose min(dx, dy)
  exceeds l_min at some fluid nodes (asserted, so the floor site runs).
"""

import dataclasses
import functools

import numpy as np
import pytest
from torch_parity import CHUNK_FIELDS, beta_err, np_copy, port_case, \
    rel_diff, scaled_err

from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.examples import wall_channel_deck
from openhyperflow2d_torch.solver.init import build_case, with_mesh_maps
from openhyperflow2d_torch.solver.runner import Solver

NX, NY = 96, 48
DX = DY = 0.01   # channel_deck spacing
CLOSURES = {"prandtl": (2, fl.TEM_Prandtl),
            "smagorinsky": (5, fl.TEM_Smagorinsky)}


def wall_channel(name, nx=NX, ny=NY):
    """tests/test_nonuniform.py's _wall_channel (the port's
    examples.wall_channel_deck: channel_deck at 300 m/s, cfl 0.05, beta
    0.95, a no-slip bottom wall, delta_bl 0.2)."""
    return wall_channel_deck(nx, ny, *CLOSURES[name])


def const_maps(nx=NX, ny=NY):
    return np.full((nx, ny), DX), np.full((nx, ny), DY)


def stretched_dy(nx=NX, ny=NY):
    """The wall-refined dy map of tests/test_nonuniform.py:71-73."""
    dy_col = DY * np.geomspace(0.25, 4.0, ny)     # fine at the wall
    return np.broadcast_to(dy_col, (nx, ny)).copy()


@pytest.mark.parametrize("name", list(CLOSURES))
def test_constant_maps_match_uniform(name):
    """dx_map/dy_map == the deck spacing is the uniform port bit for bit
    (every per-node read sees the same value)."""
    s_u = Solver(build_case(wall_channel(name)), device="cpu")
    s_n = Solver(build_case(wall_channel(name), dx_map=const_maps()[0],
                            dy_map=const_maps()[1]), device="cpu")
    assert not s_n.params.uniform_mesh and not s_n.use_kernels
    d_u = s_u.run_iters(15)
    d_n = s_n.run_iters(15)
    assert not d_n["unstable"].any(), name
    got, want = s_n.host_state(), s_u.host_state()
    for f in want:
        assert np.array_equal(got[f], want[f]), (name, f)
    for k in d_u:
        assert np.array_equal(d_n[k], d_u[k]), (name, k)


def test_with_mesh_maps_is_build_case():
    """with_mesh_maps of a case built without maps is what build_case
    builds with them: the same params and maps, and the same bits after a
    few iterations; the case it was given keeps its uniform mesh."""
    dy_map = stretched_dy()
    case = build_case(wall_channel("smagorinsky"))
    a = with_mesh_maps(case, dy_map=dy_map)
    b = build_case(wall_channel("smagorinsky"), dy_map=dy_map)
    assert case.params.uniform_mesh and "dy_map" not in case.grid.extras
    assert a.params == b.params
    for k in ("dx_map", "dy_map"):
        assert np.array_equal(a.grid.extras[k], b.grid.extras[k])
    sa, sb = Solver(a, device="cpu"), Solver(b, device="cpu")
    sa.run_iters(3)
    sb.run_iters(3)
    got, want = sa.host_state(), sb.host_state()
    assert all(np.array_equal(got[f], want[f]) for f in want)


def test_stretched_map_changes_closure_and_stays_stable():
    """The wall-refined dy map changes the Smagorinsky eddy viscosity (the
    per-node filter width sqrt(dx dy) enters mu_t) without destabilising
    the run."""
    s_u = Solver(build_case(wall_channel("smagorinsky")), device="cpu")
    s_n = Solver(build_case(wall_channel("smagorinsky"),
                            dy_map=stretched_dy()), device="cpu")
    d_n = s_n.run_iters(25)
    s_u.run_iters(25)
    assert not d_n["unstable"].any()
    mu_u = s_u.host_state()["mu_t"]
    st = s_n.host_state()
    assert np.isfinite(st["S"]).all() and np.isfinite(st["mu_t"]).all()
    assert st["mu_t"].max() > 0
    assert np.abs(st["mu_t"] - mu_u).max() > 1e-12


def test_kernel_path_refuses_nonuniform():
    """Solver(use_kernels=True) raises, as JAX's use_pallas=True does; the
    automatic choice takes the eager path and says why."""
    case = build_case(wall_channel("prandtl"), dx_map=const_maps()[0],
                      dy_map=const_maps()[1])
    with pytest.raises(NotImplementedError, match="non-uniform"):
        Solver(case, device="cpu", use_kernels=True)
    from openhyperflow2d_torch.solver.runner import choose_step_path
    use, why = choose_step_path("cuda", "float32", case.params.uniform_mesh)
    assert not use and "non-uniform" in why


def test_bad_map_shape_rejected():
    with pytest.raises(ValueError):
        build_case(wall_channel("prandtl"), dx_map=np.full((8, 8), DX))
    with pytest.raises(ValueError):
        build_case(wall_channel("prandtl"), dy_map=np.zeros((NX, NY)))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def prandtl_maps(nx=48, ny=40):
    """A map whose min(dx, dy) is 3 cells' spacing over the first 6 rows
    and the deck's elsewhere: above l_min at the fluid nodes next to the
    bottom wall."""
    dx_map, dy_map = const_maps(nx, ny)
    dx_map[:, :6] *= 3.0
    dy_map[:, :6] *= 3.0
    return dx_map, dy_map


MAPS = {"smagorinsky": lambda: (None, stretched_dy(48, 40)),
        "prandtl": prandtl_maps}


@functools.lru_cache(maxsize=None)
def jax_and_port(name, n=8):
    """(JAX case, JAX fields, JAX diags, port fields, port diags) after n
    iterations of the 48x40 wall channel with MAPS[name], float64."""
    from openhyperflow2d_tpu.solver import init as jinit
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    from torch_parity import jax_wall_channel
    dx_map, dy_map = MAPS[name]()
    jc = jinit.build_case(jax_wall_channel(name), dx_map=dx_map,
                          dy_map=dy_map)
    js = JSolver(jc)
    wd = {k: np.asarray(v) for k, v in js.run_iters(n).items()}
    want = np_copy(js.state)
    ts = Solver(port_case(jc), device="cpu")
    assert not ts.params.uniform_mesh and not ts.use_kernels
    gd = ts.run_iters(n)
    return jc, want, wd, ts.host_state(), gd


@pytest.mark.parametrize("name", list(MAPS))
def test_nonuniform_matches_jax(name):
    jc, want, wd, got, gd = jax_and_port(name)
    errs = {f: scaled_err(want, got, f) for f in CHUNK_FIELDS}
    assert max(errs.values()) < 1e-10, errs
    assert beta_err(want, got) < 1.0
    for key in ("RMS", "dt_used"):
        assert rel_diff(gd[key], wd[key]) < 1e-10, key
    np.testing.assert_array_equal(gd["unstable"], wd["unstable"])
    assert not gd["unstable"].any()
    if name == "prandtl":
        # the floor site runs: the node's min(dx, dy) exceeds l_min at some
        # fluid nodes, so l = max(l_min, min(dx, dy)) 0.41 reads the map
        g = jc.grid
        fluid = g.is_cond(fl.CT_NODE_IS_SET_2D) & ~g.is_cond(fl.CT_SOLID_2D)
        floor = np.minimum(g.extras["dx_map"], g.extras["dy_map"])
        assert ((floor > g.l_min) & (floor > min(DX, DY)) & fluid).any()
    else:
        # the stretched width moved mu_t off the uniform mesh's
        s_u = Solver(dataclasses.replace(
            port_case(jc), params=dataclasses.replace(
                port_case(jc).params, uniform_mesh=True)), device="cpu")
        s_u.run_iters(8)
        assert np.abs(s_u.host_state()["mu_t"] - got["mu_t"]).max() > 1e-12
