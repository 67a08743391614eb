"""The closures on the strip path, and the closure kernel's plumbing.

* Chien as 2 X strips (kernel path, plain versions; and the eager strip
  path) against JAX's strip chunks on the CPU mesh
  (``make_pallas_shard_chunk(tile=(16, 16))``, ``make_shard_chunk``),
  float64: 3 iterations, recalc_y_plus() on both, 3 more, so that y+ (> 0
  after the recalc) crosses the seam: each strip reads its neighbours' y+
  in its halo (``_StripChunk.yp_ext``).  Fields rtol 1e-10, atol 1e-8
  and dt_used rtol 1e-12 (tests/test_torch_shard_step.py's gates); beta
  by beta_err where the equation is above 1e-4 of its scale: at 47 of
  17,280 nodes rhoV is float noise of the stream, and its blending factor
  noise over noise (atol 3e-6 there reads 7.5e-5).
* The same deck in float32 as 2 strips gives the single domain's bits
  after a recalc_y_plus between two chunks, y+ included, sequential and
  overlapped, at K = 1 and 2.
* ``kernel_consts`` of each closure (the closure flag, the family bits,
  the Prandtl and k-eps forms, C_mu ** 0.75, delta_bl, Escudier's cap,
  Smagorinsky's (Cs delta)^2); ``struct Consts`` of csrc/fused_step.cu
  declares KernelConsts' fields in KernelConsts' order; the header's meta
  plane indices, family bits and TurbExtModel ids are fused_step.py's and
  core/flags'.
* An iteration's launches on a closure deck name its closures' form in
  both dispatch forms; the staged body raises; the y+ plane is refreshed
  every chunk, so a recalc_y_plus between chunks gives Chien a positive
  mu_t on the kernel path.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_parity import (TURB_CLOSURES, beta_err, jax_wall_channel,
                          np_copy, port_case)

from openhyperflow2d_tpu.parallel.mesh import make_mesh
from openhyperflow2d_tpu.parallel.shard_step import (make_pallas_shard_chunk,
                                                     make_shard_chunk)
from openhyperflow2d_tpu.solver import init as jinit
from openhyperflow2d_tpu.solver.runner import Solver as JSolver
from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.examples import wall_channel_deck
from openhyperflow2d_torch.ops import fused_step as fs
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.parallel.multihost import gather_state
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

CSRC = Path(fs.__file__).parent / "csrc"
ITERS = 3


@functools.lru_cache(maxsize=None)
def jax_chien_strips(kernel):
    jc = jinit.build_case(jax_wall_channel("chien"))
    s = JSolver(jc)
    args = (s.meta, s.params, s.chem, (s.beta_xs, s.beta_ys),
            (s.cfl_xs, s.cfl_ys), s.params.TurbStartIter, make_mesh(2))
    fn = (make_pallas_shard_chunk(*args, tile=(16, 16), fuse_iters=1)
          if kernel
          else make_shard_chunk(*args))
    s._chunk_fn = jax.jit(fn, static_argnums=(1,))
    d = [s.run_iters(ITERS)]
    s.recalc_y_plus()
    d.append(s.run_iters(ITERS))
    dt = np.concatenate([np.asarray(x["dt_used"]) for x in d])
    return jc, np_copy(s.state), dt


@pytest.mark.parametrize("kernel", [True, False])
def test_chien_strips_match_jax(kernel):
    jc, want, wdt = jax_chien_strips(kernel)
    ts = Solver(port_case(jc), device="cpu", use_kernels=kernel,
                comm=LocalComm(2, "cpu"))
    d = [ts.run_iters(ITERS)]
    ts.recalc_y_plus()
    d.append(ts.run_iters(ITERS))
    got = ts.host_state()
    assert want["y_plus"].max() > 0 and got["mu_t"].max() > 0
    assert not any(x["unstable"].any() for x in d)
    for f in ["S", "U", "V", "p", "Tg", "mu_t", "y_plus"]:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-10, atol=1e-8,
                                   err_msg=f)
    assert beta_err(want, got, floor=1e-4) < 1.0
    np.testing.assert_allclose(np.concatenate([x["dt_used"] for x in d]),
                               wdt, rtol=1e-12)


def _f32(name, nx=48, ny=40):
    tm, tem = TURB_CLOSURES[name]
    case = build_case(wall_channel_deck(nx, ny, tm, getattr(fl, tem)),
                      dtype="float32")
    case.params = dataclasses.replace(case.params, fast_math=True)
    return case


FIELDS = ("S", "beta", "U", "V", "p", "Tg", "Yc", "mu_t", "y_plus")


@pytest.mark.parametrize("overlap,K", [(False, 1), (True, 1), (False, 2),
                                       (True, 2)])
def test_chien_strips_give_the_single_domain_bits(overlap, K):
    case = _f32("chien")
    single = Solver(case, device="cpu", use_kernels=True, fuse_iters=K)
    strips = Solver(case, device="cpu", use_kernels=True, fuse_iters=K,
                    comm=LocalComm(2, "cpu"), overlap=overlap)
    for r, m in enumerate((5, 7)):
        if r:
            single.recalc_y_plus()
            strips.recalc_y_plus()
        ds, dp = single.run_iters(m), strips.run_iters(m)
        full = gather_state(strips.state, strips.comm, case.params.MaxX)
        for f in FIELDS:
            assert torch.equal(getattr(single.state, f),
                               getattr(full, f)), (r, f)
        np.testing.assert_array_equal(ds["dt_used"], dp["dt_used"])
    assert single.state.mu_t.max() > 0 and single.state.y_plus.max() > 0


# (closure, models bits, Prandtl form, k-eps form, C_mu of eps_of_k)
CONSTS = {
    "chien": (2, fl.TEM_Prandtl, fl.TEM_k_eps_Chien, 0.09),
    "jl": (2, fl.TEM_Prandtl, fl.TEM_k_eps_JL, 0.09),
    "lsy": (2, fl.TEM_Prandtl, fl.TEM_k_eps_LSY, 0.09),
    "rng": (2, fl.TEM_Prandtl, fl.TEM_k_eps_RNG, 0.0845),
    "realisable": (2, fl.TEM_Prandtl, fl.TEM_k_eps_Std, 0.09),
    "sa": (4, fl.TEM_Prandtl, fl.TEM_k_eps_Std, 0.09),
    "smagorinsky": (8, fl.TEM_Prandtl, fl.TEM_k_eps_Std, 0.09),
    "prandtl": (1, fl.TEM_Prandtl, fl.TEM_k_eps_Std, 0.09),
    "van_driest": (1, fl.TEM_vanDriest, fl.TEM_k_eps_Std, 0.09),
    "escudier": (1, fl.TEM_Escudier, fl.TEM_k_eps_Std, 0.09),
    "klebanoff": (1, fl.TEM_Klebanoff, fl.TEM_k_eps_Std, 0.09),
}


@pytest.mark.parametrize("name", sorted(CONSTS))
def test_kernel_consts_of_each_closure(name):
    models, prandtl, keps, c_mu = CONSTS[name]
    s = Solver(_f32(name, 32, 24), device="cpu", use_kernels=True)
    p, c = s.params, s.fused.consts
    f32 = np.float32
    assert c.closure == int(name != "realisable") == int(s.fused.closure)
    assert (c.models, c.prandtl_form, c.keps_form) == (models, prandtl, keps)
    assert f32(c.c_mu075) == f32(c_mu ** 0.75)
    assert f32(c.delta_bl) == f32(0.2) and f32(c.esc_l) == f32(0.09 * 0.2)
    assert f32(c.smag_cs2) == f32((0.1 * (p.dx * p.dy) ** 0.5) ** 2)
    assert s.fused.has_y_plus == (name in ("chien", "van_driest"))
    assert s.fused.mf.shape[0] == (7 if s.fused.has_y_plus else 5)


@pytest.mark.parametrize("tem", [fl.TEM_Escudier, fl.TEM_Klebanoff])
def test_no_boundary_layer_runs_prandtls_length(tem):
    case = build_case(wall_channel_deck(32, 24, 2, tem, delta_bl=0.0),
                      dtype="float32")
    c = fs.kernel_consts(case.params, fs.make_tile_plan(32, 24, None, "cpu"),
                         False)
    assert (c.closure, c.prandtl_form) == (1, fl.TEM_Prandtl)


def test_consts_struct_matches_kernel_consts():
    """KernelConsts is struct Consts, then ClosureConsts' own fields, then
    ExtConsts' (the structs of fused_step.cuh)."""
    text = (CSRC / "fused_step.cuh").read_text()
    names = []
    for struct in (r"struct Consts", r"struct ClosureConsts : Consts",
                   r"struct ExtConsts : ClosureConsts"):
        body = re.search(struct + r" \{(.*?)\n\};", text, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        for decl in body.split(";"):
            decl = decl.strip()
            if decl:
                names += [re.match(r"(\w+)", v.strip().split()[-1]
                                   if i == 0 else v.strip()).group(1)
                          for i, v in enumerate(decl.split(","))]
    assert names == [f for f, _ in fs.KernelConsts._fields_]


def test_header_constants_match_python():
    text = (CSRC / "hf2d_ctx_bits.cuh").read_text() + (
        CSRC / "fused_step.cuh").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[;,]", text).group(1))

    assert const("META_LMIN") == fs.META_LMIN
    assert const("META_LAM_T") == fs.META_LAM_T
    assert const("META_Y_PLUS") == fs.META_Y_PLUS
    for fam, bit in fs.MODEL_BITS.items():
        assert const(f"MODEL_{'SMAG' if fam == 'smag' else fam.upper()}") \
            == bit
    for cu, py in (("TEM_VAN_DRIEST", "TEM_vanDriest"),
                   ("TEM_ESCUDIER", "TEM_Escudier"),
                   ("TEM_KLEBANOFF", "TEM_Klebanoff"),
                   ("TEM_CHIEN", "TEM_k_eps_Chien"),
                   ("TEM_JL", "TEM_k_eps_JL"), ("TEM_LSY", "TEM_k_eps_LSY"),
                   ("TEM_RNG", "TEM_k_eps_RNG")):
        assert const(cu) == getattr(fl, py), cu


@pytest.mark.parametrize("name,spec,gfc", [
    ("chien", True, "gfc_keps_var_kernel"), ("sa", False, "gfc_sa_kernel")])
def test_closure_launches(name, spec, gfc):
    case = _f32(name, 48, 96)     # a middle column of complete tiles
    for dispatch in fs.DISPATCH_FORMS:
        s = Solver(case, device="cpu", use_kernels=True, dispatch=dispatch)
        got = s.fused.iteration_launches()
        if dispatch == "dual":
            assert got == [f"{gfc}<dual>", "pass12_kernel<dual>"]
        else:
            bodies = ["spec", "general"] if spec else ["general"]
            assert got == ([f"{gfc}<{b}>" for b in bodies]
                           + [f"pass12_kernel<{b}>" for b in bodies])
    with pytest.raises(NotImplementedError, match="staged"):
        s.fused.launch_gfc("staged", None, None, None, None, None, None)
    assert set(fs.CLOSURE_KERNEL_NAMES) <= set(fs.PATH_KERNEL_NAMES)


def test_y_plus_plane_follows_recalc():
    """The kernel path reads y+ from meta plane META_Y_PLUS, set from the
    state at every chunk: after recalc_y_plus the plane holds the new y+
    and Chien's mu_t (0 while y+ is 0) turns positive."""
    s = Solver(_f32("chien"), device="cpu", use_kernels=True)
    s.run_iters(3)
    assert float(s.state.mu_t.max()) == 0.0
    s.recalc_y_plus()
    assert float(s.state.y_plus.max()) > 0
    s.run_iters(2)
    assert torch.equal(s.fused.mf[fs.META_Y_PLUS], s.state.y_plus)
    assert float(s.state.mu_t.max()) > 0
