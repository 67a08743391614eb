"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Both packages run on the CPU in one process; data crosses between them as
numpy arrays.  JAX runs with x64 (tests/conftest.py).
"""

import dataclasses
import functools

import numpy as np
import torch

torch.set_num_threads(2)


def np_fields(obj) -> dict:
    """{field: numpy array} of a JAX dataclass pytree (None kept)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = None if v is None else np.asarray(v)
    return out


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def port_case(jcase):
    """The port's Case for a case built by the JAX package: the same host
    grid and deck, the port's SolverParams (built with the converter)."""
    from openhyperflow2d_torch.core.state import params_from_dict
    from openhyperflow2d_torch.solver import init as tinit
    kw = {f.name: getattr(jcase, f.name)
          for f in dataclasses.fields(tinit.Case)}
    kw["params"] = params_from_dict(dataclasses.asdict(jcase.params))
    return tinit.Case(**kw)


def port_inputs(jsolver):
    """(state, meta, params, chem) of the port from a JAX Solver's arrays."""
    from openhyperflow2d_torch.core.state import (chem_from_numpy,
                                                  meta_from_numpy,
                                                  params_from_dict,
                                                  state_from_numpy)
    return (state_from_numpy(np_fields(jsolver.state)),
            meta_from_numpy(np_fields(jsolver.meta)),
            params_from_dict(dataclasses.asdict(jsolver.params)),
            chem_from_numpy(np_fields(jsolver.chem)))


def max_rel_diff(a: dict, b: dict, fields, rtol, atol) -> float:
    """Worst |a-b| / (atol + rtol |a|) over ``fields`` (the form of
    __graft_entry__.dryrun_multichip's max_rel_diff); < 1 means
    allclose(rtol, atol)."""
    worst = 0.0
    for f in fields:
        x = np.asarray(a[f], np.float64)
        y = np.asarray(b[f], np.float64)
        assert x.shape == y.shape, (f, x.shape, y.shape)
        worst = max(worst, float(np.max(np.abs(x - y)
                                        / (atol + rtol * np.abs(x)))))
    return worst


def plane_scales(want: dict, f: str) -> np.ndarray:
    """Scale of each plane of a field: its largest |value| (per equation for
    S, per species for Yc).  The two velocity components (U, V) and the two
    momentum equations (S[1], S[2]) share the vector's scale: in a stream
    along x, V and rhoV are small, and their own maxima would measure
    rounding against noise."""
    if f in ("U", "V"):
        return np.array(max(np.abs(want["U"]).max(), np.abs(want["V"]).max()))
    x = np.abs(np.asarray(want[f], np.float64))
    if x.ndim < 3:
        return np.array(x.max())
    s = x.max(axis=(1, 2))
    if f in ("S", "A", "B") and s.size == 9:
        s[1] = s[2] = max(s[1], s[2])
    return s


def scaled_err(want: dict, got: dict, f: str) -> float:
    """Largest |got - want| of a field relative to its plane's scale
    (``plane_scales``); a plane whose scale is 0 is measured absolutely."""
    x = np.asarray(want[f], np.float64)
    y = np.asarray(got[f], np.float64)
    assert x.shape == y.shape, (f, x.shape, y.shape)
    d = np.abs(x - y)
    s = plane_scales(want, f)
    if d.ndim == 3:
        d = d.reshape(d.shape[0], -1).max(axis=1)
    else:
        d = d.max()
    return float(np.max(np.where(s > 0, d / np.where(s > 0, s, 1.0), d)))


def beta_err(want: dict, got: dict, rtol=1e-6, atol=3e-6,
             floor=1e-6) -> float:
    """max_rel_diff of beta over the nodes whose equation is not at float
    noise there: |S_e| > floor * scale_e (``plane_scales``).  Elsewhere the
    residual ratio dd = |dS / S| is noise over noise, and beta, a function
    of sqrt(dd), moves by O(1) at no cost to S (pass 2 of core/step)."""
    S = np.abs(np.asarray(want["S"], np.float64))
    keep = S > floor * plane_scales(want, "S")[:, None, None]
    x = np.asarray(want["beta"], np.float64)[keep]
    y = np.asarray(got["beta"], np.float64)[keep]
    return float(np.max(np.abs(x - y) / (atol + rtol * np.abs(x)),
                        initial=0.0))


# The turbulence closures of tests/test_torch_turbulence*.py, on the wall
# channel of tests/test_turbulence_models.py: (TurbulenceModel, the
# TurbExtModel's name in core/flags).  "realisable" is a TurbExtModel no
# branch of _turb_mod_rans names: it takes the standard k-eps constants.
TURB_CLOSURES = {
    "chien": (4, "TEM_k_eps_Chien"), "jl": (4, "TEM_k_eps_JL"),
    "lsy": (4, "TEM_k_eps_LSY"), "rng": (4, "TEM_k_eps_RNG"),
    "realisable": (4, "TEM_k_eps_Realisable"),
    "sa": (3, "TEM_Spalart_Allmaras"), "smagorinsky": (5, "TEM_Smagorinsky"),
    "prandtl": (2, "TEM_Prandtl"), "van_driest": (2, "TEM_vanDriest"),
    "escudier": (2, "TEM_Escudier"), "klebanoff": (2, "TEM_Klebanoff"),
}
# the closures that read y+ (van Driest's damping, Chien's f_mu and L_eps)
Y_PLUS_CLOSURES = ("chien", "van_driest")


def jax_wall_channel(name, nx=48, ny=40):
    """The JAX package's deck of ``name`` (TURB_CLOSURES): channel_deck at
    300 m/s with a no-slip bottom wall and delta_bl 0.2, as
    tests/test_turbulence_models.py:38-45 builds it (the port's
    examples.wall_channel_deck)."""
    from openhyperflow2d_tpu.core import flags as fl
    from openhyperflow2d_tpu.examples import channel_deck
    tm, tem = TURB_CLOSURES[name]
    d = channel_deck(nx=nx, ny=ny, u=300.0, problem_type=1, turb_model=tm,
                     turb_ext_model=getattr(fl, tem), cfl=0.05, beta=0.95)
    d.data["Contour1.Bound3.Cond"] = "NT_WNS_2D"
    d.data["delta_bl"] = "0.2"
    return d


def np_copy(obj) -> dict:
    """np_fields with each array copied (a JAX chunk donates its input
    state's buffers)."""
    return {k: None if v is None else np.array(v, copy=True)
            for k, v in np_fields(obj).items()}


@functools.lru_cache(maxsize=None)
def eager_closure_runs(name):
    """JAX's XLA path and the port's eager path, float64, on
    ``jax_wall_channel(name)`` (each deck built once by the JAX package and
    handed to the port, port_case): ``init`` = (JAX fields, port fields)
    after the Solvers' initial FillNode2D; ``chunk`` = (JAX fields, JAX
    diags, port fields, port diags) after a chunk of 5 iterations (SA's 3,
    before its impulsive start flags Tg<0), for the closures that read y+
    after 2 iterations and recalc_y_plus() on both (with y+ = 0 Chien's
    mu_t is 0)."""
    from openhyperflow2d_tpu.solver import init as jinit
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    from openhyperflow2d_torch.solver.runner import Solver
    jc = jinit.build_case(jax_wall_channel(name))
    js = JSolver(jc)
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    init = (np_copy(js.state), ts.host_state())
    if name in Y_PLUS_CLOSURES:
        js.run_iters(2)
        ts.run_iters(2)
        js.recalc_y_plus()
        ts.recalc_y_plus()
    n = 3 if name == "sa" else 5
    wd = {k: np.asarray(v) for k, v in js.run_iters(n).items()}
    gd = ts.run_iters(n)
    return init, (np_copy(js.state), wd, ts.host_state(), gd)


INIT_FIELDS = ["S", "A", "B", "F", "Src", "U", "V", "p", "Tg", "mu_t",
               "lam_t"]
CHUNK_FIELDS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu",
                "mu_t", "lam_t", "dt", "y_plus"]


def rel_diff(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                        / np.maximum(np.abs(want), 1e-300)))


def check_eager_init(name, tol=1e-10):
    """The initial fill (fluxes and the closure's init branch) of both
    packages: every field to ``tol`` of its plane's scale."""
    want, got = eager_closure_runs(name)[0]
    errs = {f: scaled_err(want, got, f) for f in INIT_FIELDS}
    assert max(errs.values()) < tol, errs


def check_eager_chunk(name, tol=1e-10):
    """The chunk of both packages: fields to ``tol`` of each plane's scale,
    beta by beta_err (rtol 1e-6, atol 3e-6 where the equation is not at
    float noise), RMS and dt_used to rtol ``tol``, the unstable rows
    exactly; the closures that read y+ with y+ and mu_t positive."""
    want, wd, got, gd = eager_closure_runs(name)[1]
    errs = {f: scaled_err(want, got, f) for f in CHUNK_FIELDS}
    assert max(errs.values()) < tol, errs
    assert beta_err(want, got) < 1.0
    for key in ("RMS", "dt_used"):
        assert rel_diff(gd[key], wd[key]) < tol, key
    np.testing.assert_array_equal(gd["unstable"], wd["unstable"])
    assert not gd["unstable"].any()
    assert got["mu_t"].max() > 0
    if name in Y_PLUS_CLOSURES:
        assert got["y_plus"].max() > 0


# the closures' kernel-path tests (tests/test_torch_turbulence_kernel*.py):
# two cycles of CLOSURE_CYCLE iterations (SA's 3, before its impulsive
# start flags Tg<0), the second from JAX's state after the first
CLOSURE_CYCLE = 6


@functools.lru_cache(maxsize=None)
def pallas_closure_cycles(name, K):
    """(JAX case, [(fields, diags) after each of two cycles]) of JAX's
    Pallas path in interpret mode at fuse_iters=K on
    ``jax_wall_channel(name)``, float64; run_cycle recalculates y+ after
    each cycle (the solver's MPI-build semantics), so the second cycle of
    Chien and van Driest runs with y+ > 0."""
    from openhyperflow2d_tpu.solver import init as jinit
    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    jc = jinit.build_case(jax_wall_channel(name))
    jc.Nstep = 3 if name == "sa" else CLOSURE_CYCLE
    js = JSolver(jc, use_pallas=True, pallas_fuse=K, pallas_tile=(16, 128))
    out = []
    for _ in range(2):
        wd, _ = js.run_cycle()
        out.append((np_copy(js.state),
                    {k: np.asarray(v) for k, v in wd.items()}))
    return jc, out


KERNEL_FIELDS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu",
                 "mu_t", "lam_t", "dt", "y_plus"]


def check_kernel_cycles(name, K, tols):
    """The port's kernel path (the kernels' plain versions on CPU
    tensors, ``fuse_iters=K``) against ``pallas_closure_cycles``: cycle c
    holds every field to ``tols[c]`` of its plane's scale and RMS and
    dt_used to rtol ``tols[c]``, beta by beta_err where the equation is
    above 1e-4 of its scale, the unstable and dt_overrun rows exactly."""
    from openhyperflow2d_torch.core.state import state_from_numpy
    from openhyperflow2d_torch.ops.fused_step import (CLOSURE_FORMS,
                                                      closure_form)
    from openhyperflow2d_torch.solver.runner import Solver
    jc, cycles = pallas_closure_cycles(name, K)
    ts = Solver(port_case(jc), device="cpu", use_kernels=True, fuse_iters=K)
    assert ts.fused.closure
    assert ts.fused.iteration_launches()[0].startswith(
        CLOSURE_FORMS[closure_form(ts.params)])
    for c, (want, wd) in enumerate(cycles):
        if c:
            ts.state = state_from_numpy(cycles[c - 1][0])
        gd, _ = ts.run_cycle()
        got = ts.host_state()
        errs = {f: scaled_err(want, got, f) for f in KERNEL_FIELDS}
        assert max(errs.values()) < tols[c], (c, errs)
        assert beta_err(want, got, floor=1e-4) < 1.0, c
        for key in ("RMS", "dt_used"):
            assert rel_diff(gd[key], wd[key]) < tols[c], (c, key)
        for key in ("unstable", "dt_overrun"):
            np.testing.assert_array_equal(gd[key], wd[key], key)
    if name in Y_PLUS_CLOSURES:
        assert got["y_plus"].max() > 0 and got["mu_t"].max() > 0


# The axisymmetric, source, d2*-NULL and NRBC decks of
# tests/test_torch_axisym*.py, float64, each built by the JAX package:
# (deck, iterations of a chunk).  SA's chunk is 3 iterations (its
# impulsive start flags Tg<0 soon after, in JAX too).
def jax_nrbc_d2_axisym_deck():
    """The JAX package's tests/test_static_ctx.py:25-37 deck: an
    axisymmetric k-eps channel with an NRBC (FARFIELD) top and d2*-NULL
    soft BCs on the outflow and the bottom."""
    from openhyperflow2d_tpu.examples import channel_deck
    d = channel_deck(nx=48, ny=40, problem_type=1, turb_model=4,
                     turb_ext_model=0, flow_type=1)
    d.data["Contour1.Bound1.Cond"] = "NT_FARFIELD_2D"
    d.data["Contour1.Bound2.Cond"] = ("NT_D2X_2D, TCT_dkdx_NULL_2D, "
                                      "TCT_depsdx_NULL_2D")
    d.data["Contour1.Bound3.Cond"] = ("NT_D0Y_2D, NT_D2Y_2D, "
                                      "TCT_k_CONST_2D, TCT_eps_CONST_2D")
    return d


def axisymmetric(deck):
    """The deck with FlowType=1."""
    deck.data["FlowType"] = "1"
    return deck


def _axisym_decks():
    from openhyperflow2d_tpu import examples as jex
    return {
        "nrbc_d2": (jax_nrbc_d2_axisym_deck, 6),
        "scramjet": (lambda: jex.scramjet_deck(64, 48), 6),
        "combustor": (lambda: axisymmetric(jex.combustor_deck(64, 256)), 6),
        "sa": (lambda: axisymmetric(jax_wall_channel("sa")), 3),
        "bubble": (lambda: axisymmetric(jex.bubble_deck(48, 40)), 6),
    }


# the decks whose JAX reference runs op by op (jax.disable_jit): on the
# axisymmetric bubble JAX's compiled chunk parts from its own op-by-op run
# by 1.5e-10 of U's scale at iteration 2 (a branch taken apart at one
# node, as combustor_deck(64, 384) does, ROADMAP's limits of the
# comparison), while the port and the op-by-op run agree below 1e-13
OP_BY_OP = ("bubble",)


AXISYM_DECKS = ("nrbc_d2", "scramjet", "combustor", "sa", "bubble")


@functools.lru_cache(maxsize=None)
def jax_axisym_case(name):
    from openhyperflow2d_tpu.solver import init as jinit
    return jinit.build_case(_axisym_decks()[name][0]())


@functools.lru_cache(maxsize=None)
def eager_axisym_runs(name):
    """JAX's XLA path and the port's eager path, float64, on the axisym
    deck ``name``: ``init`` = (JAX fields, port fields) after the initial
    FillNode2D; ``chunk`` = (JAX fields, JAX diags, port fields, port
    diags) after one chunk of the deck's iterations."""
    import contextlib

    import jax

    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    from openhyperflow2d_torch.solver.runner import Solver
    jc = jax_axisym_case(name)
    n = _axisym_decks()[name][1]
    with (jax.disable_jit() if name in OP_BY_OP
          else contextlib.nullcontext()):
        js = JSolver(jc)
        w0 = np_copy(js.state)
        wd = {k: np.asarray(v) for k, v in js.run_iters(n).items()}
        want = np_copy(js.state)
    ts = Solver(port_case(jc), device="cpu", use_kernels=False)
    init = (w0, ts.host_state())
    gd = ts.run_iters(n)
    return init, (want, wd, ts.host_state(), gd)


def check_axisym_eager(name, tol=1e-10):
    """The initial fill and the chunk of both packages: every field (F
    and Src included) to ``tol`` of its plane's scale, beta by beta_err,
    RMS and dt_used to rtol ``tol``, the unstable rows exactly."""
    (w0, g0), (want, wd, got, gd) = eager_axisym_runs(name)
    errs = {f: scaled_err(w0, g0, f) for f in INIT_FIELDS}
    assert max(errs.values()) < tol, ("init", errs)
    errs = {f: scaled_err(want, got, f)
            for f in CHUNK_FIELDS + ["F", "Src", "A", "B"]}
    assert max(errs.values()) < tol, ("chunk", errs)
    assert beta_err(want, got) < 1.0
    for key in ("RMS", "dt_used"):
        assert rel_diff(gd[key], wd[key]) < tol, key
    np.testing.assert_array_equal(gd["unstable"], wd["unstable"])
    assert not gd["unstable"].any()


@functools.lru_cache(maxsize=None)
def pallas_axisym_cycle(name, K):
    """(JAX fields, diags) after one cycle of the axisym deck ``name``'s
    iterations on JAX's Pallas path in interpret mode at fuse_iters=K,
    float64."""
    import contextlib

    import jax

    from openhyperflow2d_tpu.solver.runner import Solver as JSolver
    jc = jax_axisym_case(name)
    jc.Nstep = _axisym_decks()[name][1]
    with (jax.disable_jit() if name in OP_BY_OP
          else contextlib.nullcontext()):
        js = JSolver(jc, use_pallas=True, pallas_fuse=K,
                     pallas_tile=(16, 128))
        wd, _ = js.run_cycle()
        return np_copy(js.state), {k: np.asarray(v) for k, v in wd.items()}


def check_axisym_kernel(name, K, tol=1e-10):
    """The port's kernel path (the kernels' plain versions on CPU tensors,
    fuse_iters=K, the extended forms) against ``pallas_axisym_cycle``:
    every field to ``tol`` of its plane's scale, RMS and dt_used to rtol
    ``tol``, beta by beta_err where the equation is above 1e-4 of its
    scale, the unstable and dt_overrun rows exactly."""
    from openhyperflow2d_torch.ops.fused_step import EXT_KERNEL_NAMES
    from openhyperflow2d_torch.solver.runner import Solver
    want, wd = pallas_axisym_cycle(name, K)
    jc = jax_axisym_case(name)
    ts = Solver(port_case(jc), device="cpu", use_kernels=True, fuse_iters=K)
    ts.case.Nstep = _axisym_decks()[name][1]
    assert all(n in EXT_KERNEL_NAMES for n in ts.fused.iteration_launches())
    gd, _ = ts.run_cycle()
    got = ts.host_state()
    errs = {f: scaled_err(want, got, f) for f in KERNEL_FIELDS + ["F"]}
    assert max(errs.values()) < tol, errs
    assert beta_err(want, got, floor=1e-4) < 1.0
    for key in ("RMS", "dt_used"):
        assert rel_diff(gd[key], wd[key]) < tol, key
    for key in ("unstable", "dt_overrun"):
        np.testing.assert_array_equal(gd[key], wd[key], key)
