"""The spec tiles' fused iteration (``step_spec_kernel``) on the CPU.

On a flat standard k-eps deck in the "lists" form an iteration of the
kernel path is gfc's general launch, ``step_spec_kernel`` (gfc on each spec
tile and its one-node ring, then pass12 from shared memory) and pass12's
general launch (ops/fused_step.py ``path_gfc``/``path_pass12``).  On CPU
tensors the fused kernel's wrapper runs its plain version,
``step_spec_plain``, a mirror of the kernel's tile decomposition: a ring
node of a spec tile recomputed, one of a general tile read from the
scratch gfc<general> wrote, the border scratch written where pass12's
general body reads it.  The chunks start from a scratch of NaN, so a ring
read from the wrong source, or a missing border write, shows.  All runs in
float64.

* The fused mirror is bit for bit the two-launch plain path
  (``spec_fused=False``) over 3 kernel iterations at K = 1 and K = 2 on
  ``combustor_deck(64, 256)``, on the walls+step+heat deck (its L-shaped
  spec set) and on that deck as 4 X strips, sequential and overlapped.
* The fused path against JAX's ``make_pallas_chunk`` (``Solver(
  use_pallas=True)``, the Pallas kernel in interpret mode) at K = 1, at
  tests/test_torch_fuse.py's tolerances (that file, and every other CPU
  test of the kernel path on a flat standard k-eps deck, holds the fused
  path against JAX at its own K): fields to 1e-10 of each
  plane's scale, beta by beta_err, RMS and dt_used to rtol 1e-10, DD_max
  to 1e-8 where the equation is not at float noise, the integer diags
  exactly.
* ``iteration_launches()`` names the 3 launches; the forms that keep the
  pair (the dual form, ``spec_fused=False``, Euler, closure and extended
  decks) name theirs.
* The tile plan's edge masks and border masks against a brute-force
  reading of the spec map, and a strip plan's spec "edge" part holds every
  spec tile beside a general "edge" tile.
* The wrapper launches its kernel or raises on anything but CPU tensors:
  no fallback.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch_parity import beta_err, np_fields, port_case, scaled_err

from openhyperflow2d_tpu.examples import combustor_deck
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.ops import fused_step
from openhyperflow2d_torch.ops.fused_step import (EDGE_BITS, SPEC_KERNEL,
                                                  TILE, make_tile_plan)
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.runner import Solver

ITERS = 4          # run_iters(4): 3 kernel iterations
FIELDS = ["S", "U", "V", "p", "Tg", "Yc", "R", "CP", "lam", "mu", "mu_t",
          "dt", "y_plus", "Q_conv"]
NOT_NOISE = [e for e in range(9) if e != 2]   # DD_max of rhoV: see beta_err
DECKS = {
    "combustor": lambda: combustor_deck(64, 256),
    "step_heat": lambda: combustor_deck(64, 256, with_step=True,
                                        adiabatic=False),
}


@functools.lru_cache(maxsize=None)
def jax_case(deck):
    return jinit.build_case(DECKS[deck]())


def steps_of(solver):
    ch = solver._chunk_fn
    return ch.steps if hasattr(ch, "steps") else [ch.step]


def port_run(deck, fused, fuse_iters, comm=None, overlap=False):
    """(host state, diags) of the port's kernel path after ITERS
    iterations, the spec tiles fused or on the pair."""
    s = Solver(port_case(jax_case(deck)), device="cpu", use_kernels=True,
               fuse_iters=fuse_iters, comm=comm, overlap=overlap)
    for st in steps_of(s):
        assert st.spec_fused
        st.spec_fused = fused
    d = s.run_iters(ITERS)
    return s.host_state(), d


def assert_same_bits(a, b):
    (sa, da), (sb, db) = a, b
    for f, v in sa.items():
        np.testing.assert_array_equal(np.asarray(sb[f]), np.asarray(v), f)
    for k, v in da.items():
        np.testing.assert_array_equal(np.asarray(db[k]), np.asarray(v), k)


@pytest.mark.parametrize("deck", list(DECKS))
@pytest.mark.parametrize("K", [1, 2])
def test_fused_mirror_is_the_pair_bit_for_bit(deck, K):
    assert_same_bits(port_run(deck, True, K), port_run(deck, False, K))


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("overlap", [False, True])
def test_fused_strips_are_the_pair_bit_for_bit(K, overlap):
    """The walls+step+heat deck as 4 X strips: the fused mirror against
    the pair, sequential and overlapped (whose last pass12 of a block runs
    its "edge" and "inner" parts apart)."""
    fused = port_run("step_heat", True, K, LocalComm(4, "cpu"), overlap)
    assert_same_bits(fused, port_run("step_heat", False, K,
                                     LocalComm(4, "cpu"), overlap))
    assert np.abs(np.asarray(fused[0]["Q_conv"])).max() > 0


@functools.lru_cache(maxsize=None)
def jax_run(K):
    js = JSolver(jax_case("combustor"), use_pallas=True, pallas_fuse=K,
                 pallas_tile=(16, 128))
    wd = {k: np.asarray(v) for k, v in js.run_iters(ITERS).items()}
    return np_fields(js.state), wd


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-300)))


@pytest.mark.parametrize("K", [1])
def test_fused_path_matches_pallas_f64(K):
    want, wd = jax_run(K)
    got, gd = port_run("combustor", True, K)
    errs = {f: scaled_err(want, got, f) for f in FIELDS if f != "Q_conv"}
    assert max(errs.values()) < 1e-10, errs
    assert beta_err(want, got) < 1.0
    assert rel(gd["RMS"], wd["RMS"]) < 1e-10
    assert rel(gd["dt_used"], wd["dt_used"]) < 1e-10
    assert rel(gd["DD_max"][:, NOT_NOISE], wd["DD_max"][:, NOT_NOISE]) < 1e-8
    for key in ("unstable", "dt_overrun"):
        np.testing.assert_array_equal(gd[key], wd[key], key)


@pytest.mark.parametrize("dispatch,fused,want", [
    ("lists", True, ["gfc_kernel<general>", SPEC_KERNEL,
                     "pass12_kernel<general>"]),
    ("lists", False, ["gfc_kernel<spec>", "gfc_kernel<general>",
                      "pass12_kernel<spec>", "pass12_kernel<general>"]),
    ("dual", True, ["gfc_kernel<dual>", "pass12_kernel<dual>"]),
])
def test_iteration_launches(dispatch, fused, want):
    s = Solver(port_case(jax_case("step_heat")), device="cpu",
               use_kernels=True, dispatch=dispatch)
    st = s.fused
    assert st.spec_fused == (dispatch == "lists")
    st.spec_fused = st.spec_fused and fused
    assert st.iteration_launches() == want


def test_pair_kept_off_the_flat_standard_decks():
    """The decks whose spec launches are not gfc_kernel<spec> +
    pass12_kernel<spec> keep them: a k-eps variant (a closures' form), an
    axisymmetric deck (the extended forms), an Euler deck (no spec
    tiles)."""
    p = port_case(jax_case("combustor")).params
    for q in (dict(tem=fl.TEM_k_eps_RNG), dict(ft=fl.FT_AXISYMMETRIC),
              dict(sm=fl.SM_EULER)):
        assert not fused_step.spec_fusable(dataclasses.replace(p, **q),
                                           "lists", 0), q
    assert fused_step.spec_fusable(p, "lists", 0)
    assert not fused_step.spec_fusable(p, "dual", 0)
    assert not fused_step.spec_fusable(p, "lists",
                                       fused_step.CHEM_COEF_MAX + 1)


def brute_edges(spec):
    nbx, nby = spec.shape
    out = np.zeros_like(spec, np.int32)
    for ti in range(nbx):
        for tj in range(nby):
            if not spec[ti, tj]:
                continue
            for (di, dj), bit in EDGE_BITS.items():
                a, b = ti + di, tj + dj
                if 0 <= a < nbx and 0 <= b < nby and not spec[a, b]:
                    out[ti, tj] |= bit
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_plan_edges_and_parts(seed):
    """Edge masks, border masks and a strip plan's parts on random spec
    maps (with the ragged edge of a grid that is no multiple of the
    tile)."""
    TX, TY = TILE
    rng = np.random.default_rng(seed)
    X, Y, halo = 11 * TX + 3, 7 * TY + 5, 4
    tiles = rng.random((12, 8)) < 0.6
    spec_map = np.repeat(np.repeat(tiles, TX, 0), TY, 1)[:X, :Y]
    # and a few nodes off generic interior inside a tile
    spec_map[rng.integers(0, X, 5), rng.integers(0, Y, 5)] = False
    plan = make_tile_plan(X, Y, spec_map, "cpu", halo=halo)
    np.testing.assert_array_equal(plan.edges, brute_edges(plan.spec))
    np.testing.assert_array_equal(plan.edge_flags.numpy(),
                                  plan.edges.reshape(-1))
    assert plan.spec.any() and (plan.edges != 0).any()
    ga, gb = plan.border_masks(plan.spec_tiles)
    ti, tj = np.divmod(np.arange(X)[:, None] // TX * plan.nby
                       + np.arange(Y)[None, :] // TY, plan.nby)
    e = plan.edges[ti, tj]
    li, lj = np.arange(X)[:, None] % TX, np.arange(Y)[None, :] % TY
    want_a = (((li == 0) & (e & 1 != 0)) | ((li == TX - 1) & (e & 2 != 0)))
    want_b = (((lj == 0) & (e & 4 != 0)) | ((lj == TY - 1) & (e & 8 != 0)))
    np.testing.assert_array_equal(ga.numpy(), want_a)
    np.testing.assert_array_equal(gb.numpy(), want_b)
    # the parts split each list; a spec tile beside a general "edge" tile
    # is in the spec "edge" part
    for body in ("spec", "general"):
        both = np.sort(np.concatenate([plan.tiles(body, p).numpy()
                                       for p in fused_step.PARTS]))
        np.testing.assert_array_equal(both, np.sort(plan.tiles(body)
                                                    .numpy()))
    gen_edge = set(plan.tiles("general", "edge").tolist())
    spec_edge = set(plan.tiles("spec", "edge").tolist())
    for t in plan.tiles("spec").tolist():
        a, b = divmod(t, plan.nby)
        for di, dj in EDGE_BITS:
            if (0 <= a + di < plan.nbx and 0 <= b + dj < plan.nby
                    and (a + di) * plan.nby + b + dj in gen_edge):
                assert t in spec_edge, t


def test_wrapper_takes_plain_on_cpu_and_raises_off_its_form():
    s = Solver(port_case(jax_case("combustor")), device="cpu",
               use_kernels=True)
    st = s.fused
    ca = torch.zeros((31, st.plan.X, st.plan.Y), dtype=torch.float64)
    args = (ca, ca.clone(), torch.zeros((31,) + ca.shape[1:],
                                        dtype=torch.float64),
            torch.tensor(1e-6, dtype=torch.float64), torch.zeros(3),
            torch.zeros(3),
            torch.zeros((st.plan.n_tiles, 2), dtype=torch.int32),
            torch.zeros((st.plan.n_tiles, 27)))
    # a CPU tensor never reaches the kernel's launch
    with pytest.raises(ValueError, match="mixed devices"):
        st.launch_step_spec(*args)
    st.spec_fused = False
    with pytest.raises(ValueError, match="spec_fused is off"):
        st.launch_step_spec(*args)


def test_launch_arguments_match_the_c_signature(monkeypatch):
    """The wrapper's arguments are the C entry's (ops/build._SIGNATURES):
    ctypes passes an int where no argtypes are set, which cuts a
    pointer."""
    import ctypes

    from openhyperflow2d_torch.ops.build import _SIGNATURES
    s = Solver(port_case(jax_case("combustor")), device="cpu",
               use_kernels=True)
    st = s.fused
    seen = []
    monkeypatch.setattr(fused_step.FusedStep, "_check_cuda",
                        lambda self, *t: None)
    monkeypatch.setattr(fused_step.FusedStep, "_launch",
                        lambda self, entry, name, args: seen.append(
                            (entry, name, args)))
    ca = torch.zeros((31, st.plan.X, st.plan.Y))
    st.launch_step_spec(ca, ca.clone(), ca.clone(), torch.zeros(()),
                        torch.zeros(3), torch.zeros(3),
                        torch.zeros((st.plan.n_tiles, 2), dtype=torch.int32),
                        torch.zeros((st.plan.n_tiles, 27)))
    (entry, name, args), = seen
    assert (entry, name) == ("hf2d_step_spec", SPEC_KERNEL)
    sig = _SIGNATURES[entry]
    assert len(sig) == len(args) + 1          # then the stream
    for a, t in zip(args, sig):
        if t is ctypes.c_int:
            assert a == st.plan.spec_tiles.numel()
        else:
            assert a is None or a > 2**32 or a == 0, (a, t)


def test_sass_report_reads_the_fused_kernel():
    """bench/sass reads step_spec_kernel (no template argument) beside the
    pair it fuses."""
    from openhyperflow2d_torch.bench import sass
    listing = "\n".join([
        "\t\tFunction : _Z16step_spec_kernel6ConstsPKfPfS2_S1_S1_PKi",
        "        /*0000*/   LDS R4, [R2] ;",
        "        /*0010*/   BAR.SYNC.DEFER_BLOCKING 0x0 ;",
        "        /*0020*/   SHFL.DOWN PT, R5, R4, 0x10, 0x1f ;",
        "\t\tFunction : _Z10gfc_kernelILi1EEv6ConstsPKfPfS2_",
        "        /*0000*/   LDG.E R4, [R2.64] ;"])
    assert sass.report(listing) == [
        "gfc_kernel<spec>: 1 instructions, LDG 1",
        "step_spec_kernel: 3 instructions, LDS 1, BAR 1, SHFL 1"]
