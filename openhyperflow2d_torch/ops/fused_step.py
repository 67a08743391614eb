"""The kernel path of the solver iteration.

Counterpart of ``openhyperflow2d_tpu/ops/pallas_step.py``:
``make_kernel_chunk`` has the prologue ``pass12``, the loop of K-iteration
blocks and the epilogue ``gfc`` of ``make_pallas_chunk(fuse_iters=K)``
(pallas_step.py:1069-1143).  JAX runs the two ends in XLA
(pallas_step.py:1085, 1116-1119); here they run on the kernels too: the
prologue packs the state into the carry and the scratch
(``FusedStep.pack_scratch``) and launches pass12 over every tile, the
epilogue launches gfc's state form over every tile (``gfc_state``: the
general body, which also keeps the gradients, lam_t and each tile's least
dt) and heat_kernel with Q_conv, and assembles the SolverState from the
launches' buffers (``KernelChunk.prologue``, ``epilogue``).  The chunk's
n - 1 kernel iterations run as ``divmod(n - 1, K)`` blocks of K, then a
block of the remainder (pallas_step.py:1099-1113).  Each block
(``make_block``, pallas_step.py:925-1030)

1. freezes dt from the carried primitives at its entry (``scan_dt``,
   pallas_step.py:859-871) for all its iterations: one iteration behind
   the reference's dt at K = 1, up to K behind in a block of K, as on the
   TPU path (the ``dt_overrun`` diag flags an iteration whose frozen dt
   exceeds some node's fresh CFL limit);
2. runs K iterations, each ``gfc_kernel`` then ``pass12_kernel``
   (ops/csrc/fused_step.cu), ping-ponging the carry.  The TPU kernel loops
   over the K iterations inside one invocation; here each iteration is its
   own launches, so every tile reads its neighbours' values of the
   iteration before (Jacobi), as in the TPU kernel.  On a flat standard
   k-eps deck in the "lists" form (``spec_fusable``) the spec tiles run
   both stages in one launch, ``step_spec_kernel``
   (ops/csrc/fused_step_spec.cu: gfc on each tile and its one-node ring
   into shared memory, then pass12, as the TPU kernel's iteration body
   runs them in VMEM): an iteration is gfc's general launch,
   ``step_spec_kernel``, then pass12's general launch
   (``FusedStep.path_gfc``, ``path_pass12``).  pass12's general body
   computes the conjugate wall heat source of its own node on decks with
   non-adiabatic walls next to solids (the heat stage folded; its
   separate form, ``heat_kernel`` between the two launches and
   ``launch_pass12(..., fold=False)``, is an A/B candidate of the
   iteration: heat_kernel runs in the epilogue, the unfolded pass12 in
   the prologue);
3. writes iteration i's per-tile partials into slot i of (K, tiles, ...)
   buffers and combines them once into the block's K rows of the RMS,
   DD_max, unstable and dt_overrun diags; its K ``dt_used`` are the frozen
   dt (pallas_step.py:1014-1028).

Two dispatch forms issue gfc and pass12 (``dispatch``):

* ``"lists"``: one launch per body over its device tile list, the
  specialized tiles and the general tiles.  The general launch over an
  arbitrary tile table is the GPU form of the TPU's scatter call
  (``make_fused(scatter_n=...)``, pallas_step.py:506-510, 879-889), which
  runs the non-rectangular general remainder of a multi-rectangle cover.
* ``"dual"``: one launch over all tiles, each CTA branching on a device
  per-tile flag to the specialized or the general body: the GPU form of
  ``make_fused(body="dual")`` (pallas_step.py:702-718).  With the heat
  stage folded an iteration is then two launches, as on the TPU.

Each tile runs the same body in both forms, so they give the same bits.

Euler decks (ProblemType=0) have no spec tiles: every tile runs the general
body, gfc in its Euler form (``gfc_euler_kernel``, which reads lam_t from
the chunk-constant meta plane META_LAM_T; the TPU kernel's non-NS staging,
pallas_step.py:405-414), pass12 as on NS decks.  NS decks with any
closure but standard k-eps (``is_closure``: the Prandtl family, SA,
Smagorinsky, or a k-eps variant) run gfc in a closures' form
(csrc/fused_step_closure.cu, ``closure_form``): the one family of a deck
whose p.models holds one (``gfc_keps_var_kernel``, ``gfc_sa_kernel``,
``gfc_smag_kernel``, ``gfc_prandtl_kernel``), else ``gfc_closure_kernel``,
whose node code carries every closure of the JAX package; they read y+
from the chunk-constant meta plane META_Y_PLUS where the closure does (van
Driest, Chien; JAX stages it at pallas_step.py:407-410).  Their spec tiles
exist only where the deck has k-eps nodes (``spec_supported``).  A deck with
moving-wall sources (``isSrcAdd``) runs the moving-wall forms of every
family (csrc/fused_step_mw.cu) on its general and dual launches: gfc
writes the SrcAdd of the equations MW_EQ at its no-slip wall nodes into
scratch planes SCR_MW.., pass12 adds them there, beside the folded heat
source of rhoE.  Where the moving-wall sources are the deck's one
extended feature (``mw_flat``), pass12 runs its flat moving-wall form
(``pass12_mw_flat_kernel``: the flat node code and the sources), else
the all-features one.  No spec tile holds a wall node, so its spec
launches run the all-features forms' spec bodies
(``*_ext_kernel<spec>``).  The kernel path runs uniform meshes only, as
JAX's Pallas path does.

The loop reads nothing back to the host and copies nothing to the device:
dt and the per-iteration scalars stay on the device, in the working dtype,
and the kernels read them through pointers.  They pass through float32
even in a float64 run, as the TPU kernel's float32 scalar vector did
(pallas_step.py:946-958), so the two packages agree in float64 too.

``FusedStep`` holds the kernels' wrappers and their plain torch versions
(``gfc_plain``/``heat_plain``/``pass12_plain``: core/step.gfc without its
heat stage, core/physics.calc_heat_on_wall_sources and core/step.pass12
over the whole grid, ``pass12_plain`` with the heat source of
``heat_source_plain`` or a given one, returning the same planes and
per-tile partials; ``gfc_state_plain``, gfc's fields with the state
planes and the per-tile least dt; ``step_spec_plain``, the spec tiles'
fused stages as the kernel decomposes them).
A wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors; there is no other fallback.

A tile plan carries a window of rows ``(x0, x1)``: every node is computed,
but only the nodes with ``x0 <= i < x1`` count in the per-tile partials.
The single-domain path's window is the whole grid; an X strip of the
multi-device path (parallel/shard_step) is its own rows between two halos
(the counterpart of ``interior_x``, pallas_step.py:594-598).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core import flags as fl
from ..core.physics import _safe_div, calc_heat_on_wall_sources
from ..core.state import (_CHEM_PROPS, _CHEM_SPECIES, ChemTables, GridMeta,
                          SolverParams, SolverState)
from ..core.static_ctx import (_CTX_BOOL_PLANES, _CTX_BOOL_STACKS,
                               build_packed_ctx, build_static_ctx)
from ..core.step import (SlimState, StepAux, expand, gfc, has_heat_stage,
                         make_aux, needs_y_plus, pass12, shrink)

# CTA tile (rows i, columns j); csrc/hf2d_ctx_bits.cuh TILE_X / TILE_Y
TILE = (8, 32)

# slim carry (31, X, Y) and gfc->pass12 scratch (31, X, Y) plane layouts;
# csrc/hf2d_ctx_bits.cuh CARRY_* / SCR_*
CARRY_FIELDS = (("S", 9), ("beta", 9), ("U", 1), ("V", 1), ("p", 1),
                ("Tg", 1), ("Yc", 4), ("R", 1), ("CP", 1), ("lam", 1),
                ("mu", 1), ("mu_t", 1))
N_CARRY = 31
N_SCRATCH = 31
SCR_LAM_EFF = 29    # lam + lam_t after chemistry, written by gfc<general>
SCR_SRCADD_E = 30   # SrcAdd of rhoE, written by heat_kernel and read by
                    # the unfolded pass12 (the A/B candidates only)
SCR_F = 31          # axisymmetric decks: the 9 radial fluxes F, of which
                    # gfc's extended forms write and pass12's read only
                    # F_OWN (radial_fluxes)
N_SCRATCH_AXI = SCR_F + 9
F_OWN = (2, 7, 8)
# decks with moving-wall sources (isSrcAdd): SrcAdd of the equations MW_EQ
# in 6 planes after the F planes, which the moving-wall forms write and read
# at no-slip wall nodes alone
SCR_MW = N_SCRATCH_AXI
MW_EQ = (0, 1, 2, 4, 5, 6)
N_SCRATCH_MW = SCR_MW + len(MW_EQ)
_PRIMS = 18   # carry planes from here on are written by gfc

# the kernels the solver's paths launch (on Euler decks gfc_euler_kernel
# in place of gfc_kernel: the general body's Euler form; on NS decks with
# any closure but standard k-eps a closures' form, CLOSURE_FORMS; pass12
# has neither; heat_kernel, the heat stage as a launch of its own, in the
# chunk's epilogue: in the iterations it is folded into pass12's general
# body, which saves the launch and the SrcAdd plane's round trip and won
# the A/B on an H100);
# then the forms no path launches, which stay as chip_smoke.py's A/B
# candidates: the general body on staged windows, which lost to the
# general body on an H100 (PERF.md, Findings)
NS_KERNEL_NAMES = ("gfc_kernel<spec>", "gfc_kernel<general>",
                   "pass12_kernel<spec>", "pass12_kernel<general>",
                   "gfc_kernel<dual>", "pass12_kernel<dual>")
# both stages of the spec tiles in one launch (csrc/fused_step_spec.cu), in
# the place of gfc_kernel<spec> + pass12_kernel<spec> where spec_fusable
SPEC_KERNEL = "step_spec_kernel"
EULER_KERNEL_NAMES = ("gfc_euler_kernel<general>", "gfc_euler_kernel<dual>")
# the closures' gfc in forms fixed at compile time (csrc/
# fused_step_closure.cu; ``closure_form``): a family's own where p.models
# holds that family alone, else every family's ("all", each tested at run
# time); spec bodies only in the forms that carry k-eps (no other family
# makes spec tiles, static_ctx.spec_supported)
CLOSURE_FORMS = {"all": "gfc_closure_kernel", "keps": "gfc_keps_var_kernel",
                 "sa": "gfc_sa_kernel", "smag": "gfc_smag_kernel",
                 "prandtl": "gfc_prandtl_kernel"}
CLOSURE_SPEC_FORMS = ("all", "keps")
CLOSURE_KERNEL_NAMES = tuple(
    f"{kernel}<{body}>" for form, kernel in CLOSURE_FORMS.items()
    for body in (("spec", "general", "dual") if form in CLOSURE_SPEC_FORMS
                 else ("general", "dual")))
# the extended forms (axisymmetric flow, external sources; pass12's also
# d2*-NULL soft BCs and NRBC): kernels of their own, so the flat,
# sourceless decks keep their symbols and code (``gfc_ext``,
# ``pass12_ext``); gfc (standard k-eps) and pass12 in two feature forms
# each (``gfc_form``, ``pass12_form``), and in a moving-wall form (pass12:
# two)
GFC_FORMS = {"axi": "gfc_axi_kernel", "all": "gfc_ext_kernel",
             "mw": "gfc_mw_kernel"}
PASS12_FORMS = {"axi": "pass12_axi_kernel", "all": "pass12_ext_kernel",
                "mw": "pass12_mw_kernel",
                "mw_flat": "pass12_mw_flat_kernel"}
EXT_KERNEL_NAMES = tuple(
    f"{GFC_FORMS[form]}<{body}>" for form in ("axi", "all")
    for body in ("spec", "general", "dual")) + (
    "gfc_closure_ext_kernel<spec>", "gfc_closure_ext_kernel<general>",
    "gfc_closure_ext_kernel<dual>", "gfc_euler_ext_kernel<general>",
    "gfc_euler_ext_kernel<dual>") + tuple(
    f"{PASS12_FORMS[form]}<{body}>" for form in ("axi", "all")
    for body in ("spec", "general", "dual"))
# the moving-wall forms (csrc/fused_step_mw.cu): every deck with isSrcAdd,
# whatever its other features, runs these on its general and dual launches
# (pass12's flat one where ``mw_flat`` takes it; its spec launches: the
# all-features forms' spec bodies)
MW_KERNEL_NAMES = tuple(
    f"{kernel}<{body}>" for kernel in ("gfc_mw_kernel",
                                       "gfc_closure_mw_kernel",
                                       "gfc_euler_mw_kernel",
                                       "pass12_mw_kernel",
                                       "pass12_mw_flat_kernel")
    for body in ("general", "dual"))
# the chunk's epilogue: every gfc kernel's general body in its state form
# (``body="state"``, fused_step.cuh BODY_STATE: over every tile, also the
# gradients, lam_t and each tile's least dt), the one of the deck's form
# (``FusedStep.gfc_name("state")``), then heat_kernel with Q_conv on decks
# with the heat stage
STATE_KERNEL_NAMES = tuple(
    f"{kernel}<state>" for kernel in (
        "gfc_kernel", "gfc_euler_kernel", *CLOSURE_FORMS.values(),
        "gfc_axi_kernel", "gfc_ext_kernel", "gfc_closure_ext_kernel",
        "gfc_euler_ext_kernel", "gfc_mw_kernel", "gfc_closure_mw_kernel",
        "gfc_euler_mw_kernel"))
PATH_KERNEL_NAMES = (NS_KERNEL_NAMES + (SPEC_KERNEL,) + EULER_KERNEL_NAMES
                     + CLOSURE_KERNEL_NAMES + EXT_KERNEL_NAMES
                     + MW_KERNEL_NAMES + STATE_KERNEL_NAMES
                     + ("heat_kernel",))
KERNEL_NAMES = PATH_KERNEL_NAMES + ("gfc_kernel<staged>",
                                    "pass12_kernel<staged>")
DISPATCH_FORMS = ("lists", "dual")
# "lists": on an H100 the dual form never beat it on the 2048^2
# walls+step+heat deck, and the 2048^2 combustor's calls disagreed
# (PERF.md, Findings)
DEFAULT_DISPATCH = "lists"
_BODY_CODE = {"general": 0, "spec": 1, "dual": 2,
              "staged": 3, "state": 4}   # fused_step.cuh BODY_*
# the state form's planes (19, X, Y) (csrc/hf2d_ctx_bits.cuh ST_*): the
# SolverState fields gfc computes that no other form keeps
STATE_FIELDS = (("droYdx", 4), ("droYdy", 4), ("dUdx", 1), ("dUdy", 1),
                ("dVdx", 1), ("dVdy", 1), ("dTdx", 1), ("dTdy", 1),
                ("dkdx", 1), ("dkdy", 1), ("depsdx", 1), ("depsdy", 1),
                ("lam_t", 1))
N_STATE = sum(n for _, n in STATE_FIELDS)
# tile subsets of a strip plan (make_tile_plan's ``halo``): "edge" holds
# every tile with a row in the two halos or in the halo's width of own rows
# next to them, and every spec tile beside a general tile of those (whose
# pass12 reads the spec tile's border scratch, which step_spec_kernel
# writes), "inner" the rest
PARTS = ("edge", "inner")
# a spec tile's edge mask (csrc/fused_step_spec.cu EDGE_*): the bit of a
# side whose neighbour tile is a general tile, by the side's (di, dj)
EDGE_BITS = {(-1, 0): 1, (1, 0): 2, (0, -1): 4, (0, 1): 8}


def halo_depth(params) -> int:
    """Stencil dependency depth of one iteration: 2, or 3 with d2*-NULL
    soft BCs (pallas_step.py:79-99, without its HF2D_HALO override)."""
    return 3 if (params.has_d2x or params.has_d2y) else 2


def is_euler(params) -> bool:
    """An Euler deck (ProblemType=0): gfc runs the general body's Euler
    form (``gfc_euler_kernel``) with lam_t as a chunk-constant input plane
    (the TPU kernel's staging outside SM_NS, pallas_step.py:405-414)."""
    return params.sm != fl.SM_NS


# the k-eps variants with constants or terms of their own (physics.py
# _turb_mod_rans); any other TurbExtModel takes the standard constants
KEPS_VARIANTS = (fl.TEM_k_eps_Chien, fl.TEM_k_eps_JL, fl.TEM_k_eps_LSY,
                 fl.TEM_k_eps_RNG)
# csrc/fused_step.cu Consts::models: a bit per closure family of p.models
MODEL_BITS = {"prandtl": 1, "keps": 2, "sa": 4, "smag": 8}


def is_closure(params) -> bool:
    """An NS deck with a closure other than standard k-eps (a Prandtl,
    SA or Smagorinsky family, or a k-eps variant): gfc runs a closures'
    form (``closure_form``; physics.py:299-542 of the JAX package)."""
    p = params
    return p.sm == fl.SM_NS and (
        any(m != "keps" for m in p.models)
        or ("keps" in p.models and p.tem in KEPS_VARIANTS))


def closure_form(params) -> str:
    """The closures' form of a closure deck's flat gfc (a key of
    CLOSURE_FORMS), as the C entry hf2d_gfc_closure picks it from
    ClosureConsts::models: the deck's family where p.models holds one
    (k-eps there is a variant: standard k-eps alone is no closure deck),
    else "all"."""
    models = tuple(params.models)
    return models[0] if len(models) == 1 else "all"


def gfc_ext(params) -> bool:
    """Whether gfc runs an extended form (``*_ext_kernel``, or ``*_mw_kernel``
    with moving-wall sources): axisymmetric flow (the radial fluxes F into
    scratch planes SCR_F.., the V / r terms), external sources (the
    turbulence sources fall back to the source field's, as fill_node's do)
    or moving-wall sources (their moving-wall forms,
    csrc/fused_step_mw.cu)."""
    return (params.ft == fl.FT_AXISYMMETRIC or params.has_ext_src
            or params.isSrcAdd)


def pass12_ext(params) -> bool:
    """Whether pass12 runs an extended form (``pass12_form``):
    gfc's (F / (j + 1), Src dt), or d2*-NULL soft BCs or NRBC (the general
    and dual bodies: no spec tile holds such a node)."""
    p = params
    return gfc_ext(p) or p.has_d2x or p.has_d2y or p.has_nrbc


def _ext_features(p) -> dict:
    return {"axi": p.ft == fl.FT_AXISYMMETRIC, "src": bool(p.has_ext_src),
            "d2x": bool(p.has_d2x), "d2y": bool(p.has_d2y),
            "nrbc": bool(p.has_nrbc)}


def mw_flat(params) -> bool:
    """A moving-wall deck (isSrcAdd) with no other extended feature: its
    pass12 general and dual launches run the flat moving-wall form, as
    the C entry decides from ExtConsts (csrc/fused_step.cuh mw_flat)."""
    return bool(params.isSrcAdd) and not any(_ext_features(params).values())


def pass12_form(params) -> str:
    """The feature form of pass12's extended kernel a deck runs (a key of
    PASS12_FORMS), as the C entry hf2d_pass12_ext picks it from the same
    flags: "axi" (``pass12_axi_kernel``, F / (j + 1) and no other
    feature's code) where axisymmetry is the deck's one extended feature,
    "all" (``pass12_ext_kernel``, each feature tested at run time) where it
    has sources, d2*-NULL soft BCs or NRBC; on a deck with moving-wall
    sources "mw_flat" (``pass12_mw_flat_kernel``, the flat form and the
    sources) where they are its one extended feature (``mw_flat``), else
    "mw" (``pass12_mw_kernel``, the all-features form and the sources);
    the spec launches of either run "all" (FusedStep.pass12_name).  Raises
    for a deck with none (it runs the flat ``pass12_kernel``)."""
    f = _ext_features(params)
    if params.isSrcAdd:
        return "mw_flat" if mw_flat(params) else "mw"
    if f["src"] or f["d2x"] or f["d2y"] or f["nrbc"]:
        return "all"
    if f["axi"]:
        return "axi"
    raise ValueError(f"pass12 has no extended form for the features {f}")


def gfc_form(params) -> str:
    """The feature form of gfc's extended kernel (standard k-eps; a key of
    GFC_FORMS), as the C entry hf2d_gfc_ext picks it from the same flags:
    "all" (``gfc_ext_kernel``, the source field read where c.src) on a
    deck with sources, else "axi" (``gfc_axi_kernel``, no source code) on
    an axisymmetric one; d2*-NULL and NRBC are pass12's alone.  Raises for
    a deck with neither (it runs the flat ``gfc_kernel``); "mw"
    (``gfc_mw_kernel``; its spec launches run "all", FusedStep.gfc_name)
    on a deck with moving-wall sources, whatever else it has.  The
    closures' and the Euler gfc have one extended form each and a
    moving-wall form each."""
    f = _ext_features(params)
    if params.isSrcAdd:
        return "mw"
    if f["src"]:
        return "all"
    if f["axi"]:
        return "axi"
    raise ValueError(f"gfc has no extended form for the features {f}")


def spec_fusable(params, dispatch: str, n_coef: int) -> bool:
    """Whether step_spec_kernel can run a deck's spec tiles: a flat
    standard k-eps deck (its spec launches would be gfc_kernel<spec> and
    pass12_kernel<spec>: no Euler, closure or extended form) in the
    "lists" form, whose tables' coefficient block fits the staged
    CHEM_COEF_MAX floats (``n_coef``).  The dual form keeps its one launch
    a stage."""
    return (dispatch == "lists" and not is_euler(params)
            and not is_closure(params) and not pass12_ext(params)
            and n_coef <= CHEM_COEF_MAX)


def radial_fluxes(scr: torch.Tensor) -> torch.Tensor:
    """The 9 radial fluxes F of an axisymmetric deck's scratch as pass12
    reads them (csrc/fused_step.cuh radial_flux): F[0] = B[0], F[1] =
    A[2] and F[3..6] = B[3..6], the floats gfc writes there under the same
    guard, and F_OWN from their planes; gfc writes no other F plane."""
    A, B = scr[9:18], scr[18:27]
    return torch.stack([B[0], A[2], scr[SCR_F + 2], B[3], B[4], B[5], B[6],
                        scr[SCR_F + 7], scr[SCR_F + 8]])


def n_scratch(params) -> int:
    """Planes of the gfc -> pass12 scratch: 31, and 9 for F on
    axisymmetric decks; with moving-wall sources the 6 planes from SCR_MW
    (after the 9 F planes, which a flat deck leaves unwritten)."""
    if params.isSrcAdd:
        return N_SCRATCH_MW
    return N_SCRATCH_AXI if params.ft == fl.FT_AXISYMMETRIC else N_SCRATCH


def carry_views(carry: torch.Tensor, dt) -> SlimState:
    """SlimState of views into a (31, X, Y) carry."""
    kw, o = {}, 0
    for name, n in CARRY_FIELDS:
        kw[name] = carry[o:o + n] if n > 1 else carry[o]
        o += n
    return SlimState(dt=dt, **kw)


def pack_carry(slim: SlimState) -> torch.Tensor:
    parts = []
    for name, n in CARRY_FIELDS:
        t = getattr(slim, name)
        parts.append(t if n > 1 else t[None])
    return torch.cat(parts)


def state_views(st: torch.Tensor) -> dict:
    """{SolverState field: view} of the state form's (19, X, Y) planes."""
    kw, o = {}, 0
    for name, n in STATE_FIELDS:
        kw[name] = st[o:o + n] if n > 1 else st[o]
        o += n
    return kw


def state_fields(params) -> tuple:
    """The STATE_FIELDS gfc's state form stores on a deck: core/step.gfc
    computes the others nowhere on it, so they stay the expanded state's
    zeros, lam_t the state's own (lam_t_const).  None on an Euler deck
    (outside SM_NS); dkdx and dkdy with k-eps or SA, depsdx and depsdy
    with k-eps alone."""
    p = params
    if is_euler(p):
        return ()
    drop = set()
    if "keps" not in p.models and "sa" not in p.models:
        drop |= {"dkdx", "dkdy"}
    if "keps" not in p.models:
        drop |= {"depsdx", "depsdy"}
    return tuple(name for name, _ in STATE_FIELDS if name not in drop)


def state_keep(params) -> int:
    """The bits of the state planes (csrc/hf2d_ctx_bits.cuh ST_*) the
    state form stores on a deck (``state_fields``): StateOut's ``keep``."""
    kept, bits, o = state_fields(params), 0, 0
    for name, n in STATE_FIELDS:
        if name in kept:
            bits |= ((1 << n) - 1) << o
        o += n
    return bits


# ---------------------------------------------------------------------------
# host tile table
# ---------------------------------------------------------------------------
@dataclass
class TilePlan:
    """The grid cut into TILE-sized CTAs; a tile is specialized when it is
    complete and every node in it is generic interior (its nodes then decode
    to the constants of specialized_interior_ctx).  A heat tile holds a
    node of the conjugate-heat stage (a solid node next to a wall gas node,
    or that gas node).  ``window``: the rows (x0, x1) whose nodes count in
    the partials.  ``parts``: a strip plan's tile lists by (body, part),
    part one of PARTS."""

    X: int
    Y: int
    nbx: int
    nby: int
    spec: np.ndarray              # (nbx, nby) bool, host
    spec_tiles: torch.Tensor      # int32 tile ids (ti * nby + tj), device
    general_tiles: torch.Tensor
    heat_tiles: torch.Tensor
    flags: torch.Tensor           # int32 per tile id: 1 = spec (row-major)
    window: tuple
    parts: dict
    edges: np.ndarray             # (nbx, nby) int32 edge masks, host
    edge_flags: torch.Tensor      # the same per tile id, device

    @property
    def n_tiles(self) -> int:
        return self.nbx * self.nby

    def tiles(self, body: str, part: str = None) -> torch.Tensor:
        """The tile list of the "spec" or the "general" body ("staged"
        runs the general list), or of its ``part`` on a strip plan."""
        body = "general" if body == "staged" else body
        if part is not None:
            return self.parts[body, part]
        return {"spec": self.spec_tiles, "general": self.general_tiles}[body]

    def launch_grid(self, body: str, part: str = None):
        """(tile list pointer or None, CTAs) of one launch of ``body``; the
        dual form runs every tile, CTA b on tile b, and reads no list."""
        if body == "dual":
            return None, self.n_tiles
        t = self.tiles(body, part)
        return t.data_ptr(), t.numel()

    def node_mask(self, tiles: torch.Tensor) -> torch.Tensor:
        """(X, Y) bool mask of the nodes of a tile list."""
        TX, TY = TILE
        m = torch.zeros(self.n_tiles, dtype=torch.bool, device=tiles.device)
        m[tiles.long()] = True
        m = m.reshape(self.nbx, 1, self.nby, 1).expand(
            self.nbx, TX, self.nby, TY)
        return m.reshape(self.nbx * TX, self.nby * TY)[:self.X, :self.Y]

    def border_masks(self, tiles: torch.Tensor):
        """(X, Y) bool masks of the nodes of a spec tile list that
        step_spec_kernel writes to the scratch: (S and A: a row on an
        i-edge facing a general tile, S and B: a column on a j-edge facing
        one)."""
        TX, TY = TILE
        e = np.zeros((self.nbx, self.nby), np.int32)
        ids = tiles.long().cpu().numpy()
        e.reshape(-1)[ids] = self.edges.reshape(-1)[ids]

        def nodes(bit, axis, at):
            m = np.zeros((self.nbx, TX, self.nby, TY), bool)
            on = (e & bit) != 0
            if axis == 0:
                m[:, at] = on[:, :, None]
            else:
                m[:, :, :, at] = on[:, None, :]
            m = m.reshape(self.nbx * TX, self.nby * TY)[:self.X, :self.Y]
            return torch.as_tensor(m, device=tiles.device)

        ga = (nodes(EDGE_BITS[-1, 0], 0, 0)
              | nodes(EDGE_BITS[1, 0], 0, TX - 1))
        gb = (nodes(EDGE_BITS[0, -1], 1, 0)
              | nodes(EDGE_BITS[0, 1], 1, TY - 1))
        return ga, gb


def _tile_any(node_map, nbx: int, nby: int) -> np.ndarray:
    """(nbx, nby): whether any node of the tile is set (ragged edges
    included)."""
    TX, TY = TILE
    X, Y = node_map.shape
    m = np.zeros((nbx * TX, nby * TY), bool)
    m[:X, :Y] = node_map
    return m.reshape(nbx, TX, nby, TY).any(axis=(1, 3))


def make_tile_plan(X: int, Y: int, spec_map, device, heat_map=None,
                   halo: int = 0) -> TilePlan:
    """``spec_map``: the host generic-interior map (None: no spec tiles);
    ``heat_map``: the host map of heat-stage nodes (None: no heat tiles).
    ``halo`` > 0 makes the plan of an X strip whose first and last ``halo``
    rows are halos: its window is the rows between them, and its parts
    split each body's list into the tiles with a row in [0, 2 halo) or
    [X - 2 halo, X) ("edge") and the rest ("inner")."""
    TX, TY = TILE
    nbx, nby = -(-X // TX), -(-Y // TY)
    spec = np.zeros((nbx, nby), bool)
    if spec_map is not None:
        fx, fy = X // TX, Y // TY   # complete tiles only
        m = np.asarray(spec_map, bool)[:fx * TX, :fy * TY]
        spec[:fx, :fy] = m.reshape(fx, TX, fy, TY).all(axis=(1, 3))
    heat = (np.zeros((nbx, nby), bool) if heat_map is None
            else _tile_any(np.asarray(heat_map, bool), nbx, nby))
    ids = np.arange(nbx * nby, dtype=np.int32).reshape(nbx, nby)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    def beside(m):
        """(nbx, nby): for each side, a tile of ``m`` across it, by side
        ((di, dj) -> map)."""
        out = {}
        for (di, dj) in EDGE_BITS:
            p = np.zeros((nbx + 2, nby + 2), bool)
            p[1:-1, 1:-1] = m
            out[di, dj] = p[1 + di:nbx + 1 + di, 1 + dj:nby + 1 + dj]
        return out

    # the edge mask: a spec tile's sides whose neighbour is a general tile
    edges = np.zeros((nbx, nby), np.int32)
    for side, m in beside(~spec).items():
        edges |= np.where(spec & m, EDGE_BITS[side], 0).astype(np.int32)
    parts = {}
    if halo:
        rows = np.arange(nbx)[:, None] * TX
        edge = np.broadcast_to((rows < 2 * halo) | (rows + TX > X - 2 * halo),
                               (nbx, nby))
        # a spec tile beside a general "edge" tile is an "edge" tile
        spec_edge = spec & (edge | np.any(
            list(beside(~spec & edge).values()), axis=0))
        for body, m, e in (("spec", spec, spec_edge),
                           ("general", ~spec, edge)):
            parts[body, "edge"] = dev(ids[m & e])
            parts[body, "inner"] = dev(ids[m & ~e])
    return TilePlan(X, Y, nbx, nby, spec, dev(ids[spec]),
                    dev(ids[~spec]), dev(ids[heat]), dev(spec.reshape(-1)),
                    (halo, X - halo), parts, edges, dev(edges.reshape(-1)))


# ---------------------------------------------------------------------------
# CPU mirror of the staged general body (csrc/fused_step.cu
# gfc_window_kernel, pass12_window_kernel, stage_tile; the "staged" body,
# which no solver path launches): its persistent schedule and the index
# math of each copy into its stage (the analogue of Pallas
# interpret=True; the CUDA kernel runs on the card only)
# ---------------------------------------------------------------------------
WIN_ROW, WIN_J0 = 40, 4     # fused_step.cu: floats a window row, column j0
WIN_X = TILE[0] + 2         # window rows
# carry plane of each field's first plane, and the scratch planes and the
# meta plane the stages read (hf2d_ctx_bits.cuh CARRY_*, SCR_*, META_*)
CARRY = {name: sum(n for _, n in CARRY_FIELDS[:k])
         for k, (name, _) in enumerate(CARRY_FIELDS)}
SCR_S, SCR_A, SCR_B, SCR_SRC_K, SCR_SRC_EPS = 0, 9, 18, 27, 28
META_LMIN = 4       # FusedStep.mf: BGX, BGY, Uw, Vw, l_min
META_LAM_T = 5      # and on Euler decks lam_t (hf2d_ctx_bits.cuh)
META_Y_PLUS = 6     # and where the closure reads y+ (needs_y_plus), y+
# the planes each stage reads, by slot (fused_step.cu GfcPlanes,
# Pass12Planes): at +-1 from its stencil stack (gfc the carry, pass12 the
# scratch; a window each), at the node from the stencil stack and from its
# aux stack (gfc the meta plane l_min, pass12 the carry's beta; a node
# tile each)
_S = CARRY["S"]
STAGE_PLANES = {
    "gfc": {"window": (_S, *range(_S + 4, _S + 9), CARRY["U"], CARRY["V"],
                       CARRY["Tg"]),
            "node": (*range(_S + 1, _S + 4), CARRY["p"],
                     *range(CARRY["Yc"], CARRY["mu_t"] + 1)),
            "aux": (META_LMIN,)},
    "pass12": {"window": tuple(range(SCR_S, SCR_B + 9)),
               "node": (SCR_SRC_K, SCR_SRC_EPS, SCR_SRCADD_E),
               "aux": tuple(range(CARRY["beta"], CARRY["beta"] + 9))}}
_BIT = {name: 9 * len(_CTX_BOOL_STACKS) + k
        for k, name in enumerate(_CTX_BOOL_PLANES)}


def persistent_schedule(n_tiles: int, ctas: int) -> list:
    """The entries of a tile list that each CTA of the persistent launch
    runs, in its order: the grid is G = min(n_tiles, ctas) and CTA b runs
    entries b, b + G, b + 2G, ..."""
    g = min(n_tiles, ctas)
    return [list(range(b, n_tiles, g)) for b in range(g)]


def window_copies(tile: int, X: int, Y: int, nby: int, n_slots: int,
                  vec: bool):
    """The copies stage_tile issues for the windows of ``tile``, element
    by element (a 16-byte piece as its 4 elements): arrays (slot, offset in
    the slot's window, source row, source column).  ``vec``: the stack
    allows 16-byte pieces (16-byte aligned, Y % 4 == 0); a tile cut by the
    grid's last column copies 4-byte pieces all the same."""
    TX, TY = TILE
    i0, j0 = (tile // nby) * TX, (tile % nby) * TY

    def row(r):
        return np.clip(i0 + r, 0, X - 1)

    def col(q):
        return np.clip(j0 + q, 0, Y - 1)

    if vec and j0 + TY <= Y:
        q = np.arange(n_slots * WIN_X * (TY // 4))
        s, r, k = (q // (WIN_X * (TY // 4)), (q // (TY // 4)) % WIN_X,
                   q % (TY // 4))
        e = np.arange(4)
        piece = (np.repeat(s, 4), ((r * WIN_ROW + WIN_J0 + 4 * k)[:, None]
                                   + e).ravel(),
                 np.repeat(row(r - 1), 4), ((j0 + 4 * k)[:, None]
                                            + e).ravel())
        q = np.arange(n_slots * WIN_X * 2)
        s, r, side = q // (WIN_X * 2), (q // 2) % WIN_X, q % 2
        halo = (s, r * WIN_ROW + np.where(side, WIN_J0 + TY, WIN_J0 - 1),
                row(r - 1), col(np.where(side, TY, -1)))
        return tuple(np.concatenate(ab) for ab in zip(piece, halo))
    q = np.arange(n_slots * WIN_X * (TY + 2))
    s, r, k = (q // (WIN_X * (TY + 2)), (q // (TY + 2)) % WIN_X,
               q % (TY + 2))
    return s, r * WIN_ROW + WIN_J0 - 1 + k, row(r - 1), col(k - 1)


def stage_windows(planes: np.ndarray, stage: str, tile: int, nby: int,
                  vec: bool) -> np.ndarray:
    """(slots, WIN_X * WIN_ROW) windows of ``tile`` as stage_tile fills
    them from the (n_planes, X, Y) stack ``planes`` (NaN where no copy
    lands)."""
    ids = STAGE_PLANES[stage]["window"]
    X, Y = planes.shape[1:]
    win = np.full((len(ids), WIN_X * WIN_ROW), np.nan, planes.dtype)
    s, o, r, c = window_copies(tile, X, Y, nby, len(ids), vec)
    win[s, o] = planes[np.asarray(ids)[s], r, c]
    return win


def stage_nodes(stack: np.ndarray, ids, tile: int, nby: int) -> np.ndarray:
    """(len(ids),) + TILE node tiles of planes ``ids`` of an (n, X, Y)
    stack at the tile's own nodes, as stage_tile copies them (rows and
    columns past the grid clamped): the planes read at the node, the ctx
    words and the neighbour flags."""
    TX, TY = TILE
    X, Y = stack.shape[1:]
    rows = np.clip((tile // nby) * TX + np.arange(TX), 0, X - 1)
    cols = np.clip((tile % nby) * TY + np.arange(TY), 0, Y - 1)
    return stack[np.asarray(ids)][:, rows[:, None], cols[None, :]]


def window_offsets(words: np.ndarray, tile: int, X: int, Y: int, nby: int):
    """The window offsets each node of the tile reads at (C, L, R, U, D),
    (5, TILE), from its staged ctx words and the collapse of
    fused_step.cu (an absent neighbour reads the node itself), and the
    (TILE) mask of the nodes inside the grid."""
    TX, TY = TILE
    i = (tile // nby) * TX + np.arange(TX)[:, None]
    j = (tile % nby) * TY + np.arange(TY)[None, :]
    w = words.astype(np.int64) & 0xFFFFFFFF

    def bit(name):
        b = _BIT[name]
        return ((w[b // 32] >> (b % 32)) & 1).astype(bool)

    o = (np.arange(TX)[:, None] + 1) * WIN_ROW + WIN_J0 + np.arange(TY)
    offs = np.stack([o, np.where(bit("bXl") & (i > 0), o - WIN_ROW, o),
                     np.where(bit("bXr") & (i < X - 1), o + WIN_ROW, o),
                     np.where(bit("bYu") & (j < Y - 1), o + 1, o),
                     np.where(bit("bYd") & (j > 0), o - 1, o)])
    return offs, (i < X) & (j < Y)


def heat_node_map(ctx) -> np.ndarray:
    """Host (X, Y) map of the nodes the heat stage reads or writes: the
    hv_* solid nodes and the hw_* wall gas nodes of the StaticCtx."""
    m = (ctx.hv_xl | ctx.hv_yd | ctx.hv_yu | ctx.hv_xr | ctx.hw_down
         | ctx.hw_up | ctx.hw_left | ctx.hw_right)
    return m.cpu().numpy()


def _tile_reduce(x: torch.Tensor, plan: TilePlan, op: str) -> torch.Tensor:
    """(..., X, Y) -> (n_tiles, ...) per-tile sum, max or min (padding
    adds 0 to a sum or a max, 1 to a min: the dt field's value off the
    active nodes)."""
    TX, TY = TILE
    lead_shape = x.shape[:-2]
    pads = (0, plan.nby * TY - plan.Y, 0, plan.nbx * TX - plan.X)
    xp = F.pad(x, pads, value=1.0) if op == "min" else F.pad(x, pads)
    xp = xp.reshape(*lead_shape, plan.nbx, TX, plan.nby, TY)
    r = (xp.sum(dim=(-3, -1)) if op == "sum" else xp.amax(dim=(-3, -1))
         if op == "max" else xp.amin(dim=(-3, -1)))
    return r.reshape(*lead_shape, plan.n_tiles).movedim(-1, 0)


# ---------------------------------------------------------------------------
# kernel arguments
# ---------------------------------------------------------------------------
class KernelConsts(ctypes.Structure):
    """Mirror of ``struct Consts`` in csrc/fused_step.cu."""
    _fields_ = [(f, ctypes.c_float) for f in (
        "dx", "dy", "dxx", "dyy", "min_dxdy", "cfl", "beta0", "sig_w",
        "sig_f", "k0", "k0_div", "tf", "c_mu075")] + [
        ("hu", ctypes.c_float * 4)] + [(f, ctypes.c_int) for f in (
            "X", "Y", "nby", "has_walls", "fast_math", "bff", "alt_rms",
            "serial_rms", "zeldovich", "heat", "x0", "x1", "heat_fold",
            "euler", "closure", "models", "prandtl_form", "keps_form")] + [
        (f, ctypes.c_float) for f in ("delta_bl", "esc_l", "smag_cs2")] + [
        (f, ctypes.c_int) for f in ("axi", "src", "d2x", "d2y",
                                    "nrbc")] + [
        ("nrbc_beta0", ctypes.c_float), ("wall_src", ctypes.c_int)]


def closure_forms(p: SolverParams) -> tuple:
    """(Prandtl length form, k-eps form) of the closure kernel, as
    TurbExtModel ids: the Prandtl family's van Driest, Escudier or
    Klebanoff where the case runs it (the last two with delta_bl > 0),
    else Prandtl's; the k-eps variant, else the standard constants
    (physics.py _turb_mod_rans)."""
    tem = p.tem
    prandtl = (tem if tem == fl.TEM_vanDriest
               or (tem in (fl.TEM_Escudier, fl.TEM_Klebanoff)
                   and p.delta_bl > 0) else fl.TEM_Prandtl)
    return prandtl, tem if tem in KEPS_VARIANTS else fl.TEM_k_eps_Std


def kernel_consts(p: SolverParams, plan: TilePlan, heat: bool,
                  fold: bool = True) -> KernelConsts:
    # ctypes rounds each double to float32, as the working dtype does
    # (the closures' constants are folded in float64 first, as JAX folds
    # its Python floats)
    prandtl, keps = closure_forms(p)
    c_mu = 0.0845 if keps == fl.TEM_k_eps_RNG else 0.09
    return KernelConsts(
        dx=p.dx, dy=p.dy, dxx=p.dy / (p.dx + p.dy), dyy=p.dx / (p.dx + p.dy),
        min_dxdy=min(p.dx, p.dy), cfl=p.CFL, beta0=p.beta0, sig_w=p.SigW,
        sig_f=p.SigF, k0=p.K0, k0_div=max(p.K0, 1e-30), tf=p.Tf,
        c_mu075=c_mu ** 0.75, hu=(ctypes.c_float * 4)(*p.Hu),
        X=p.MaxX, Y=p.MaxY, nby=plan.nby, has_walls=int(p.has_walls),
        fast_math=int(p.fast_math), bff=p.bff,
        alt_rms=int(p.isAlternateRMS), serial_rms=int(p.serial_rms_mode),
        zeldovich=int(p.chemistry == fl.CRM_ZELDOVICH), heat=int(heat),
        x0=plan.window[0], x1=plan.window[1], heat_fold=int(fold),
        euler=int(is_euler(p)), closure=int(is_closure(p)),
        models=sum(MODEL_BITS[m] for m in p.models), prandtl_form=prandtl,
        keps_form=keps, delta_bl=p.delta_bl, esc_l=0.09 * p.delta_bl,
        smag_cs2=(0.1 * (p.dx * p.dy) ** 0.5) ** 2,
        axi=int(p.ft == fl.FT_AXISYMMETRIC), src=int(p.has_ext_src),
        d2x=int(p.has_d2x), d2y=int(p.has_d2y), nrbc=int(p.has_nrbc),
        nrbc_beta0=p.nrbc_beta0, wall_src=int(p.isSrcAdd))


# the extended and the closures' gfc forms' table coefficients
# (csrc/fused_step.cuh coef_lookup), which a CTA stages in CHEM_COEF_MAX
# floats of shared memory
CHEM_COEF_MAX = 1024


def chem_coef(tables) -> np.ndarray:
    """The coefficient block of ``tables`` ((xs, ys, ascending) a table,
    in chemi's order), float32: a head of (x0, y0, m1, code) a table, then
    the tails.  m_s = (y_s - y_{s-1}) / (x_s - x_{s-1}) and m_s - m_{s-1}
    in float32, whose division and subtraction round as the kernel's
    table_lookup does, so they are the floats it computes at every node.
    code 0: two ascending knots (y0 + m1 (q - x0)); > 0: more, at that
    offset of the block a pair (k, 0) and k pairs (x_{s-1}, m_s -
    m_{s-1}), s = 2..n-1; -1 (head zeros): one knot or not ascending, which
    keep table_lookup's code."""
    head, tail = [], []
    base = 4 * len(tables)
    for xs, ys, asc in tables:
        x = np.asarray(xs, dtype=np.float32)
        y = np.asarray(ys, dtype=np.float32)
        if not asc or x.size == 1:
            head += [0.0, 0.0, 0.0, -1.0]
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            m = (y[1:] - y[:-1]) / (x[1:] - x[:-1])
        code = 0
        if x.size > 2:
            code = base + len(tail)
            tail += [x.size - 2, 0.0]
            for s in range(2, x.size):
                tail += [x[s - 1], m[s - 1] - m[s - 2]]
        head += [x[0], y[0], m[0], code]
    return np.array(head + tail, dtype=np.float32)


def pack_chem(chem: ChemTables, p: SolverParams):
    """(chemf, chemi): R of the 4 species then each table's xs and ys, in
    (prop, species) order; chemi holds (offset, knots, ascending) per
    table.  Then, for the extended and the closures' gfc forms
    (chem_coef), the coefficient block at the end of chemf, and its length
    and offset at the end of chemi (which the other flat forms do not
    read)."""
    vals = [getattr(chem, f"R_{sp}").reshape(1) for sp in _CHEM_SPECIES]
    off, meta, tables = 4, [], []
    for prop in _CHEM_PROPS:
        for sp in _CHEM_SPECIES:
            xs = getattr(chem, f"{prop}_{sp}_x")
            ys = getattr(chem, f"{prop}_{sp}_y")
            asc = f"{prop}_{sp}" in p.chem_asc
            meta += [off, xs.numel(), int(asc)]
            vals += [xs, ys]
            tables.append((xs.float().cpu().numpy(),
                           ys.float().cpu().numpy(), asc))
            off += 2 * xs.numel()
    coef = torch.from_numpy(chem_coef(tables)).to(vals[0])
    chemf = torch.cat(vals + [coef])
    meta += [coef.numel(), off]
    return chemf, torch.tensor(meta, dtype=torch.int32, device=chemf.device)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


# pass12's division F / (j + 1) (csrc/fused_step.cuh div_jp1): one
# reciprocal of j + 1 a node and a Markstein correction a quotient, bit for
# bit IEEE division for j + 1 <= DIV_JP1_MAX; its check kernel's launches
DIV_JP1_MAX = 4096
DIV_CHECK_LAUNCHES = {"div_jp1_check_kernel": 0}


def div_jp1_check(a: torch.Tensor, jp1_lo: int, jp1_hi: int,
                  out: bool = False):
    """div_jp1 against IEEE division (__fdiv_rn) for every float of ``a``
    (1-D float32) and every j + 1 in [jp1_lo, jp1_hi]: (the number of
    quotients whose bits differ, the last such (a, j + 1) or None, the
    (jp1_hi - jp1_lo + 1, n) quotients with ``out``, else None).  On a CPU
    tensor its plain version, IEEE division, which differs nowhere."""
    jp1 = torch.arange(jp1_lo, jp1_hi + 1, dtype=torch.float32,
                       device=a.device)
    if a.device.type == "cpu":
        return 0, None, (a[None] / jp1[:, None] if out else None)
    if a.dtype != torch.float32 or a.dim() != 1 or not a.is_contiguous():
        raise ValueError("div_jp1_check takes a contiguous 1-D float32 "
                         "tensor")
    from .build import load_kernels
    lib = load_kernels()
    q = (torch.empty((jp1.numel(), a.numel()), dtype=torch.float32,
                     device=a.device) if out else None)
    bad = torch.zeros(2, dtype=torch.int64, device=a.device)
    lib.check(lib.lib.hf2d_div_jp1_check(
        _ptr(a), a.numel(), jp1_lo, jp1_hi, _ptr(q) if out else None,
        _ptr(bad), torch.cuda.current_stream().cuda_stream),
        "div_jp1_check_kernel")
    DIV_CHECK_LAUNCHES["div_jp1_check_kernel"] += 1
    n_bad, last = (int(x) & (2**64 - 1) for x in bad.cpu())
    where = None
    if n_bad:
        bits_a = np.array([last >> 32], dtype=np.uint32)
        where = (float(bits_a.view(np.float32)[0]), last & 0xffffffff)
    return n_bad, where, q


class FusedStep:
    """One kernel-path iteration: ``gfc``, ``heat`` and ``pass12`` over the
    grid with a frozen dt.  Holds the static kernel inputs of a case, the
    wrappers and their plain versions, and a launch count per kernel
    instantiation (``launches``; a wrapper counts a launch where it
    launches, nowhere else).  ``dispatch`` is the form gfc and pass12 are
    issued in (DISPATCH_FORMS).  With the heat stage, pass12's general
    body computes its nodes' heat source itself: an iteration launches no
    heat_kernel (``iteration_launches``); the chunk's epilogue does
    (``end_launches``).  On an Euler deck gfc is
    ``gfc_euler_kernel`` and reads lam_t from meta plane META_LAM_T, which
    the chunk sets from its state (``set_lam_t``).  On an NS deck with a
    closure other than standard k-eps (``is_closure``) gfc is its
    closures' form (``closure_form``); where the closure reads y+ (van
    Driest, Chien) it reads meta plane META_Y_PLUS, which the chunk sets
    from its state (``set_y_plus``), so a ``recalc_y_plus`` between chunks
    reaches the next one.  On an axisymmetric deck or one with external
    sources
    gfc runs its extended form (``gfc_ext``; standard k-eps in the feature
    form ``gfc_form``), and pass12 runs its own there and on decks with
    d2*-NULL soft BCs or NRBC (``pass12_ext``, in the feature form
    ``pass12_form``); they read the source field the chunk sets
    (``set_src``).  With moving-wall sources both run their moving-wall
    forms.  Where ``spec_fusable``, the path runs the spec tiles on
    step_spec_kernel (``spec_fused``; ``path_gfc``, ``path_pass12``);
    setting ``spec_fused`` to False runs them on the pair, as
    chip_smoke.py's A/B does."""

    def __init__(self, meta: GridMeta, params: SolverParams,
                 chem: ChemTables, plan: TilePlan, dispatch: str, ctx):
        p = params
        if dispatch not in DISPATCH_FORMS:
            raise ValueError(f"dispatch {dispatch!r} is not one of "
                             f"{DISPATCH_FORMS}")
        self.meta, self.params, self.chem, self.plan = meta, p, chem, plan
        self.dispatch, self.ctx = dispatch, ctx
        # the heat stage runs where the case has it and some node reaches
        # it; otherwise SrcAdd stays 0, as in core/step.gfc
        self.has_heat = has_heat_stage(p) and plan.heat_tiles.numel() > 0
        self.euler = is_euler(p)
        self.closure = is_closure(p)
        self.closure_form = closure_form(p) if self.closure else None
        self.has_y_plus = needs_y_plus(p)
        self.gfc_ext, self.pass12_ext = gfc_ext(p), pass12_ext(p)
        # the feature forms of gfc_ext_kernel and pass12's extended kernel
        self.gfc_form = (gfc_form(p) if self.gfc_ext and not self.euler
                         and not self.closure else None)
        self.pass12_form = pass12_form(p) if self.pass12_ext else None
        self.axi = p.ft == fl.FT_AXISYMMETRIC
        self.mw = p.isSrcAdd
        self.idn = torch.stack([meta.idXl, meta.idXr, meta.idYu, meta.idYd])
        # the lam_t plane on Euler decks; y+ after a (zero) lam_t plane
        n_more = META_Y_PLUS + 1 - META_LAM_T if self.has_y_plus \
            else int(self.euler)
        self.mf = torch.stack([meta.BGX, meta.BGY, meta.Uw, meta.Vw,
                               meta.l_min] + [torch.zeros_like(meta.l_min)]
                              * n_more).to(p.torch_dtype)
        self.ctxw = build_packed_ctx(meta, p)
        self.chemf, self.chemi = pack_chem(chem, p)
        n_coef = int(self.chemi[-2])
        if (self.gfc_ext or self.closure) and n_coef > CHEM_COEF_MAX:
            raise NotImplementedError(
                f"the chemistry tables' coefficient block holds {n_coef} "
                f"floats; the extended and the closures' gfc kernels stage "
                f"at most {CHEM_COEF_MAX}")
        self._spec_fusable = spec_fusable(p, "lists", n_coef)
        self.spec_fused = True
        self.zero_src = torch.zeros((fl.NUM_EQ, p.MaxX, p.MaxY),
                                    dtype=p.torch_dtype, device=meta.CT.device)
        # the external source field (9, X, Y) the extended forms read
        self.src = self.zero_src
        self.consts = kernel_consts(p, plan, self.has_heat)
        # pass12 reading heat_kernel's SrcAdd plane (launch_pass12's fold)
        self.consts_unfolded = kernel_consts(p, plan, self.has_heat, False)
        # (X, 1) rows of the window, for the plain versions' partials
        rows = torch.arange(p.MaxX, device=meta.CT.device)[:, None]
        self.own = (rows >= plan.window[0]) & (rows < plan.window[1])
        # the state form's tile table: every tile (T4's launch), and the
        # state planes it stores
        self.all_tiles = torch.arange(plan.n_tiles, dtype=torch.int32,
                                      device=meta.CT.device)
        self.state_fields = state_fields(p)
        self.state_keep = state_keep(p)
        self.launches = dict.fromkeys(KERNEL_NAMES, 0)

    def reset_launches(self) -> None:
        self.launches = dict.fromkeys(KERNEL_NAMES, 0)

    @property
    def spec_fused(self) -> bool:
        """Whether the path runs the spec tiles on step_spec_kernel: asked
        for, the deck spec_fusable, and the "lists" form (a step whose
        dispatch is switched to "dual" runs the dual body)."""
        return self._spec_fused and self.dispatch == "lists"

    @spec_fused.setter
    def spec_fused(self, on: bool) -> None:
        self._spec_fused = bool(on) and self._spec_fusable

    def set_lam_t(self, lam_t: torch.Tensor) -> None:
        """The chunk-constant lam_t plane of an Euler deck (the state's
        lam_t at the chunk's entry, JAX step.py:569); nothing on NS."""
        if self.euler:
            self.mf[META_LAM_T].copy_(lam_t)

    def set_y_plus(self, y_plus: torch.Tensor) -> None:
        """The chunk-constant y+ plane of a closure that reads it (the
        state's y+ at the chunk's entry, JAX pallas_step.py:407-410);
        nothing elsewhere."""
        if self.has_y_plus:
            self.mf[META_Y_PLUS].copy_(y_plus)

    def set_src(self, src: torch.Tensor) -> None:
        """The chunk's external source field (9, X, Y) on a deck with
        sources (JAX pallas_step.py:445-497); the zeros elsewhere."""
        if self.params.has_ext_src:
            self.src = src.to(self.zero_src.dtype).contiguous()

    def gfc_name(self, body: str) -> str:
        """The name of gfc's kernel instantiation for ``body`` (the
        moving-wall forms have no spec body: a moving-wall deck's spec
        launch runs the all-features form's)."""
        mw = self.mw and body != "spec"
        if self.gfc_form is not None:
            form = ("all" if self.gfc_form == "mw" and body == "spec"
                    else self.gfc_form)
            return f"{GFC_FORMS[form]}<{body}>"
        if self.closure and not self.gfc_ext:
            return f"{CLOSURE_FORMS[self.closure_form]}<{body}>"
        kernel = ("gfc_euler" if self.euler else
                  "gfc_closure" if self.closure else "gfc")
        form = ("_mw" if mw else "_ext" if self.gfc_ext else "")
        return f"{kernel}{form}_kernel<{body}>"

    def pass12_name(self, body: str) -> str:
        """The name of pass12's kernel instantiation for ``body`` (as
        gfc_name's on a moving-wall deck's spec launch)."""
        if not self.pass12_ext:
            return f"pass12_kernel<{body}>"
        form = ("all" if self.pass12_form in ("mw", "mw_flat")
                and body == "spec" else self.pass12_form)
        return f"{PASS12_FORMS[form]}<{body}>"

    def end_launches(self) -> tuple:
        """The kernels a chunk launches outside its iterations (no launch
        needs CUDA to be planned): (the prologue's pass12 launches over
        every tile, the epilogue's: gfc's state form, then heat_kernel
        with the heat stage)."""
        return ([self.pass12_name(b) for b in self._bodies()],
                [self.gfc_name("state")]
                + (["heat_kernel"] if self.has_heat else []))

    def chunk_launches(self, n_iters: int) -> dict:
        """{kernel: launches} of a KernelChunk of ``n_iters`` iterations:
        its prologue, n_iters - 1 kernel iterations
        (``iteration_launches``), its epilogue (``end_launches``)."""
        first, last = self.end_launches()
        out = {}
        for names, k in ((first, 1), (self.iteration_launches(),
                                      n_iters - 1), (last, 1)):
            for name in names:
                out[name] = out.get(name, 0) + k
        return out

    def pack_scratch(self, state: SolverState) -> torch.Tensor:
        """The gfc -> pass12 scratch (n_scratch planes) of a SolverState:
        the inverse of gfc's plane map (``_put_gfc``), so that pass12 reads
        the state's own fields: S, A and B, Src's k and eps slots; with the
        heat stage lam + lam_t at SCR_LAM_EFF and SrcAdd[rhoE] at
        SCR_SRCADD_E (the unfolded pass12 reads it); F's own planes on an
        axisymmetric deck (the others are A and B floats, radial_fluxes);
        the moving-wall SrcAdd planes.  Planes no launch reads are NaN."""
        scr = torch.empty((n_scratch(self.params),) + state.S.shape[1:],
                          dtype=state.S.dtype, device=state.S.device)
        planes = {SCR_S: state.S, SCR_A: state.A, SCR_B: state.B,
                  SCR_SRC_K: state.Src[fl.i2d_k:]}
        if self.has_heat:
            planes[SCR_LAM_EFF] = (state.lam + state.lam_t)[None]
            planes[SCR_SRCADD_E] = state.SrcAdd[fl.i2d_RhoE][None]
        if self.axi:
            for e in F_OWN:
                planes[SCR_F + e] = state.F[e][None]
        if self.mw:
            planes[SCR_MW] = state.SrcAdd[list(MW_EQ)]
        unread = set(range(scr.shape[0]))
        for q, v in planes.items():
            scr[q:q + v.shape[0]] = v
            unread -= set(range(q, q + v.shape[0]))
        scr[sorted(unread)] = float("nan")
        return scr

    def iteration_launches(self) -> list:
        """The kernels one iteration launches, in order (no launch needs
        CUDA to be planned): with ``spec_fused``, gfc's general launch,
        step_spec_kernel, pass12's general launch."""
        bodies = self._bodies()
        if self.spec_fused and "spec" in bodies:
            return ([self.gfc_name(b) for b in bodies if b != "spec"]
                    + [SPEC_KERNEL]
                    + [self.pass12_name(b) for b in bodies if b != "spec"])
        return ([self.gfc_name(b) for b in bodies]
                + [self.pass12_name(b) for b in bodies])

    # ------------------------------------------------------------------
    # wrappers
    # ------------------------------------------------------------------
    def _check_cuda(self, *tensors):
        for t in tensors:
            if t.device.type != "cuda":
                raise ValueError(f"mixed devices: {t.device} among CUDA "
                                 f"kernel arguments")
            if t.dtype != torch.float32:
                raise NotImplementedError(
                    f"the CUDA kernels are float32; got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError("kernel arguments must be contiguous")
        p = self.params
        if tensors[0].shape[-2:] != (p.MaxX, p.MaxY):
            raise ValueError(f"grid {tuple(tensors[0].shape[-2:])} does not "
                             f"match the case ({p.MaxX}, {p.MaxY})")

    def _launch(self, entry, name, args):
        """Launch one C entry, check its error code and count the
        launch."""
        from .build import load_kernels
        lib = load_kernels()
        code = getattr(lib.lib, entry)(*args,
                                       torch.cuda.current_stream().cuda_stream)
        lib.check(code, name)
        self.launches[name] += 1

    def _bodies(self, part=None, bodies=None):
        """The gfc/pass12 launches of one iteration (or of one part of a
        strip plan's tiles): the dual form's one, or each list with tiles
        (spec first); ``bodies``: of these lists only."""
        if self.dispatch == "dual":
            if part is not None:
                raise ValueError("the dual form runs every tile in one "
                                 "launch; a part needs dispatch=\"lists\"")
            return ["dual"]
        return [b for b in ("spec", "general")
                if self.plan.tiles(b, part).numel()
                and (bodies is None or b in bodies)]

    def launch_gfc(self, body, cin, cout, scr, dt, aux, part_i):
        """One gfc_kernel instantiation over its tiles (CUDA tensors);
        ``body`` is "spec", "general", "dual" or "staged" (the window
        kernel on its persistent grid).  On an Euler deck, the general or
        the dual body of gfc_euler_kernel (no spec tiles; the staged form,
        an A/B candidate of the NS decks, has no Euler form)."""
        if self.euler and body not in ("general", "dual"):
            raise NotImplementedError(
                f"gfc_euler_kernel has no {body!r} body (an Euler deck's "
                f"gfc runs the general body's Euler form)")
        if (self.closure or self.gfc_ext) and body == "staged":
            raise NotImplementedError(
                f"{self.gfc_name(body)} has no staged body (the staged form "
                f"is an A/B candidate of the standard k-eps decks)")
        self._check_cuda(cin, cout, scr, dt, aux, self.mf, self.chemf,
                         self.src)
        tiles, n_tiles = self.plan.launch_grid(body)
        args = (_BODY_CODE[body], ctypes.addressof(self.consts), _ptr(cin),
                _ptr(cout), _ptr(scr), _ptr(self.idn), _ptr(self.mf),
                _ptr(self.ctxw), _ptr(self.chemf), _ptr(self.chemi),
                _ptr(dt), _ptr(aux), tiles, n_tiles, _ptr(self.plan.flags),
                _ptr(part_i))
        if self.gfc_ext:
            self._launch("hf2d_gfc_ext", self.gfc_name(body),
                         args + (_ptr(self.src),))
        else:
            self._launch("hf2d_gfc", self.gfc_name(body), args)

    def launch_pass12(self, body, cin, cout, scr, dt, aux, part_f,
                      part=None, fold=True, src=None):
        """One pass12_kernel instantiation over its tiles, or over its
        tiles of ``part`` (CUDA tensors).  ``fold=False``: the general
        body reads the heat source from scratch plane SCR_SRCADD_E (which
        heat_kernel wrote, the separate form of the A/B, or the chunk's
        prologue packed from its state; the staged body always reads it).
        ``src``: the source field its extended forms read (default the
        chunk's, ``set_src``)."""
        if self.pass12_ext and body == "staged":
            raise NotImplementedError(
                f"{self.pass12_name(body)} has no staged body (the staged "
                f"form is an A/B candidate of the standard k-eps decks)")
        src = self.src if src is None else src
        self._check_cuda(cin, cout, scr, dt, aux, part_f, src)
        tiles, n_tiles = self.plan.launch_grid(body, part)
        consts = self.consts if fold else self.consts_unfolded
        args = (_BODY_CODE[body], ctypes.addressof(consts), _ptr(cin),
                _ptr(cout), _ptr(scr), _ptr(self.idn), _ptr(self.ctxw),
                _ptr(dt), _ptr(aux), tiles, n_tiles, _ptr(self.plan.flags),
                _ptr(part_f))
        if self.pass12_ext:
            self._launch("hf2d_pass12_ext", self.pass12_name(body),
                         args + (_ptr(src),))
        else:
            self._launch("hf2d_pass12", self.pass12_name(body), args)

    def launch_step_spec(self, cin, cout, scr, dt, aux, aux_next, part_i,
                         part_f, part=None):
        """step_spec_kernel over the spec tiles, or over its spec tiles of
        ``part`` (CUDA tensors): gfc at each tile and its ring, pass12 at
        the tile, the tile's counts and partials; S and A or B at the
        nodes on an edge facing a general tile into ``scr``, whose other
        general-tile nodes it reads (gfc<general>'s, launched before)."""
        if not self.spec_fused:
            raise ValueError(f"step_spec_kernel does not run this deck's "
                             f"spec tiles (spec_fused is off: "
                             f"{self.dispatch!r}, {self.gfc_name('spec')})")
        self._check_cuda(cin, cout, scr, dt, aux, aux_next, part_f, self.mf,
                         self.chemf)
        tiles, n_tiles = self.plan.launch_grid("spec", part)
        self._launch("hf2d_step_spec", SPEC_KERNEL, (
            ctypes.addressof(self.consts), _ptr(cin), _ptr(cout), _ptr(scr),
            _ptr(self.mf), _ptr(self.chemf), _ptr(self.chemi), _ptr(dt),
            _ptr(aux), _ptr(aux_next), tiles, n_tiles,
            _ptr(self.plan.edge_flags), _ptr(part_i), _ptr(part_f)))

    def launch_gfc_state(self, cin, cout, scr, st, dt, aux, part_i,
                         part_dt):
        """The state form of the deck's gfc (``gfc_name("state")``: the
        general body over every tile) (CUDA tensors): gfc's outputs, the
        planes of ``state_fields`` in ``st`` (N_STATE planes; the others
        untouched) and each tile's least node dt into ``part_dt``
        (n_tiles)."""
        self._check_cuda(cin, cout, scr, st, dt, aux, part_dt, self.mf,
                         self.chemf, self.src)
        self._launch("hf2d_gfc_state", self.gfc_name("state"), (
            ctypes.addressof(self.consts), _ptr(cin), _ptr(cout), _ptr(scr),
            _ptr(self.idn), _ptr(self.mf), _ptr(self.ctxw), _ptr(self.chemf),
            _ptr(self.chemi), _ptr(dt), _ptr(aux), _ptr(self.all_tiles),
            self.plan.n_tiles, _ptr(part_i), _ptr(self.src), _ptr(st),
            _ptr(part_dt), self.state_keep))

    def launch_heat(self, cout, scr, dt, q_conv=None):
        """heat_kernel over the heat tiles (CUDA tensors); ``q_conv``:
        also the (X, Y) Q_conv plane at their nodes."""
        self._check_cuda(cout, scr, dt,
                         *(() if q_conv is None else (q_conv,)))
        tiles = self.plan.heat_tiles
        self._launch("hf2d_heat", "heat_kernel", (
            ctypes.addressof(self.consts), _ptr(cout), _ptr(scr),
            _ptr(self.ctxw), _ptr(dt), _ptr(tiles), tiles.numel(),
            None if q_conv is None else _ptr(q_conv)))

    def gfc(self, cin, cout, scr, dt, aux, part_i, bodies=None):
        """gfc_kernel: gradients, fill, dt field and chemistry of iteration
        k from carry ``cin``; writes the scratch, the primitives of
        ``cout`` and per-tile (Tg<0, dt overrun) counts into ``part_i``.
        ``dt`` is the frozen dt (0-d), ``aux`` the (beta, cfl, is_mu_t)
        row of iteration k; ``bodies``: the launches of these tile lists
        only (default: every launch of the dispatch form)."""
        if cin.device.type == "cpu":
            return self.gfc_plain(cin, cout, scr, dt, aux, part_i, bodies)
        for body in self._bodies(bodies=bodies):
            self.launch_gfc(body, cin, cout, scr, dt, aux, part_i)

    def pass12_state(self, cin, cout, scr, dt, aux, part_f, src=None):
        """pass12 of the chunk's prologue: the dispatch form's launches over
        every tile from the state packed into ``cin`` and ``scr``
        (``pack_scratch``), in the unfolded form (the heat source is the
        state's SrcAdd[rhoE], scratch plane SCR_SRCADD_E) on the source
        field ``src`` (the state's Src; default the chunk's).  A wrapper of
        its own: routing the iterations' ``pass12`` elsewhere leaves it."""
        if cin.device.type == "cpu":
            return self.pass12_plain(cin, cout, scr, dt, aux, part_f,
                                     fold=False, src=src)
        for body in self._bodies():
            self.launch_pass12(body, cin, cout, scr, dt, aux, part_f,
                               fold=False, src=src)

    def gfc_state(self, cin, cout, scr, st, dt, aux, part_i, part_dt):
        """gfc of the chunk's last iteration over every tile in its state
        form: ``gfc``'s outputs for the whole grid, and what the chunk
        returns besides them: the gradients and lam_t the deck computes
        into the state planes ``st`` (``state_fields`` of STATE_FIELDS; the
        others untouched), each tile's least node dt (over the window's
        rows; 1 off the active nodes) into ``part_dt``."""
        if cin.device.type == "cpu":
            return self.gfc_state_plain(cin, cout, scr, st, dt, aux, part_i,
                                        part_dt)
        self.launch_gfc_state(cin, cout, scr, st, dt, aux, part_i, part_dt)

    def heat(self, cout, scr, dt):
        """heat_kernel (the separate form of the heat stage): the
        conjugate wall-heat source SrcAdd[rhoE] of iteration k into scratch
        plane SCR_SRCADD_E at the wall gas nodes, from gfc's Tg in ``cout``
        and lam_eff in scratch plane SCR_LAM_EFF."""
        if cout.device.type == "cpu":
            return self.heat_plain(cout, scr, dt)
        self.launch_heat(cout, scr, dt)

    def heat_state(self, cout, scr, dt, q_conv):
        """heat_kernel in the chunk's epilogue: ``heat``'s SrcAdd[rhoE]
        and the wall heat flux Q_conv into the (X, Y) plane ``q_conv`` at
        the nodes of the heat tiles (calc_heat_on_wall_sources' Q_conv;
        the plane's other nodes keep their zeros)."""
        if cout.device.type == "cpu":
            return self.heat_plain(cout, scr, dt, q_conv)
        self.launch_heat(cout, scr, dt, q_conv)

    def pass12(self, cin, cout, scr, dt, aux, part_f, part=None,
               bodies=None):
        """pass12_kernel: pass 1 + pass 2 from the scratch at +-1 and the
        blending factors of ``cin``; writes S and beta of ``cout`` and
        per-tile (RMS numerator, denominator, DD max) x 9 into ``part_f``.
        ``aux`` is the row of iteration k+1.  ``part`` (one of PARTS)
        restricts the launches to that part of a strip plan's tiles,
        ``bodies`` to these tile lists.  With the heat stage the general
        body adds SrcAdd[rhoE], computed from gfc's Tg in ``cout`` and
        lam_eff in ``scr``."""
        if cin.device.type == "cpu":
            return self.pass12_plain(cin, cout, scr, dt, aux, part_f, part,
                                     bodies=bodies)
        for body in self._bodies(part, bodies):
            self.launch_pass12(body, cin, cout, scr, dt, aux, part_f, part)

    def step_spec(self, cin, cout, scr, dt, aux, aux_next, part_i, part_f,
                  part=None):
        """step_spec_kernel: both stages of iteration k over the spec tiles
        (of ``part``): gfc's primitives, counts and the border scratch as
        ``gfc``, S, beta and partials as ``pass12`` with the row
        ``aux_next``; reads the scratch gfc<general> wrote at the general
        tiles' nodes around them."""
        if cin.device.type == "cpu":
            return self.step_spec_plain(cin, cout, scr, dt, aux, aux_next,
                                        part_i, part_f, part)
        self.launch_step_spec(cin, cout, scr, dt, aux, aux_next, part_i,
                              part_f, part)

    def path_gfc(self, cin, cout, scr, dt, aux, part_i):
        """The iteration's launches before its pass12 ones, as the path
        runs them: every gfc launch, or with ``spec_fused`` gfc's general
        launch alone (the spec tiles' gfc is step_spec_kernel's)."""
        self.gfc(cin, cout, scr, dt, aux, part_i,
                 bodies=("general",) if self.spec_fused else None)

    def path_pass12(self, cin, cout, scr, dt, aux, aux_next, part_i, part_f,
                    part=None):
        """The iteration's other launches (of ``part``), as the path runs
        them: every pass12 launch, or with ``spec_fused``
        step_spec_kernel (gfc and pass12 of the spec tiles) and pass12's
        general launch, which reads the border scratch it writes."""
        if not self.spec_fused:
            return self.pass12(cin, cout, scr, dt, aux_next, part_f, part)
        if self.plan.tiles("spec", part).numel():
            self.step_spec(cin, cout, scr, dt, aux, aux_next, part_i,
                           part_f, part)
        self.pass12(cin, cout, scr, dt, aux_next, part_f, part,
                    bodies=("general",))

    # ------------------------------------------------------------------
    # plain versions
    # ------------------------------------------------------------------
    @staticmethod
    def _aux(row):
        return StepAux(beta_scen=row[0], cfl_scen=row[1],
                       is_mu_t_iter=row[2] > 0.5)

    def lam_t(self):
        """The lam_t ``expand`` takes: the Euler plane, else None (mu_t*CP
        under SM_NS)."""
        return self.mf[META_LAM_T] if self.euler else None

    def y_plus(self):
        """The y+ ``expand`` takes: the y+ plane where the closure reads
        it, else None (zeros)."""
        return self.mf[META_Y_PLUS] if self.has_y_plus else None

    def _gfc_fields(self, cin, dt, aux, dt_min=False):
        """core/step.gfc of carry ``cin`` over the whole grid (no heat
        stage): (its output state, the per-tile (Tg<0, dt overrun) counts
        of the window's rows, (n_tiles, 2)); ``dt_min``: and each tile's
        least node dt over the window's rows (the dt field: 1 off the
        active nodes), (n_tiles,)."""
        full = expand(carry_views(cin, dt), self.params, self.src,
                      y_plus=self.y_plus(), lam_t=self.lam_t())
        out, dt_field, unstable = gfc(full, self.meta, self.params,
                                      self.chem, self._aux(aux),
                                      return_fields=True, ctx=self.ctx,
                                      heat=False)
        counts = torch.stack([
            _tile_reduce((unstable & self.own).to(torch.int32), self.plan,
                         "sum"),
            _tile_reduce(((dt > dt_field) & self.own).to(torch.int32),
                         self.plan, "sum")], 1).to(torch.int32)
        if not dt_min:
            return out, counts
        return out, counts, _tile_reduce(
            torch.where(self.own, dt_field, 1.0), self.plan, "min")

    def _tiles_of(self, bodies, part=None) -> torch.Tensor:
        """The tile ids of the launches of ``bodies`` (of ``part``), long."""
        lists = [self.plan.tiles(b, part) for b in bodies]
        return torch.cat(lists or [torch.zeros(0, dtype=torch.int32)]).long()

    def gfc_plain(self, cin, cout, scr, dt, aux, part_i, bodies=None):
        """``bodies``: write the nodes and counts of these tile lists only
        (what their launches write; default: the whole grid)."""
        out, counts = self._gfc_fields(cin, dt, aux)
        self._put_gfc(out, counts, cout, scr, part_i, bodies)

    def gfc_state_plain(self, cin, cout, scr, st, dt, aux, part_i,
                        part_dt):
        """The state form's plain version: core/step.gfc's fields over
        the whole grid, gfc_plain's planes, the state planes of
        ``state_fields`` and the per-tile least dt (``_gfc_fields``)."""
        out, counts, dt_min = self._gfc_fields(cin, dt, aux, dt_min=True)
        self._put_gfc(out, counts, cout, scr, part_i)
        views = state_views(st)
        for name in self.state_fields:
            views[name][...] = getattr(out, name)
        part_dt[:] = dt_min

    def _put_gfc(self, out, counts, cout, scr, part_i, bodies=None):
        """gfc's output state ``out`` into the scratch and carry planes
        its kernels write, its counts into ``part_i``, at the nodes of
        ``bodies``' tiles (default: the whole grid)."""
        planes = {0: out.S, 9: out.A, 18: out.B,
                  # k and eps, or SA's nu_t (elsewhere the source field's,
                  # or 0)
                  27: out.Src[fl.i2d_k:]}
        if self.axi:
            # F's own planes only, as the extended kernels (radial_fluxes)
            for e in F_OWN:
                planes[SCR_F + e] = out.F[e][None]
        if self.mw:
            # the moving-wall sources (0 but at guarded no-slip wall nodes)
            for k, e in enumerate(MW_EQ):
                planes[SCR_MW + k] = out.SrcAdd[e][None]
        if self.has_heat:
            # what the heat stage reads (core/physics.py): lam + lam_t of
            # gfc's output, lam after chemistry and lam_t from the CP
            # before it
            planes[SCR_LAM_EFF] = (out.lam + out.lam_t)[None]
        prims = pack_carry(shrink(out))[_PRIMS:]
        if bodies is None:
            for q, v in planes.items():
                scr[q:q + v.shape[0]] = v
            cout[_PRIMS:] = prims
            part_i[:] = counts
            return
        tiles = self._tiles_of(self._bodies(bodies=bodies))
        m = self.plan.node_mask(tiles)
        for q, v in planes.items():
            scr[q:q + v.shape[0]] = torch.where(m, v, scr[q:q + v.shape[0]])
        cout[_PRIMS:] = torch.where(m, prims, cout[_PRIMS:])
        part_i[tiles] = counts[tiles]

    def step_spec_plain(self, cin, cout, scr, dt, aux, aux_next, part_i,
                        part_f, part=None):
        """step_spec_kernel's plain version, its tile decomposition: gfc
        at each spec tile (of ``part``) and its ring, a ring node of a
        spec tile recomputed, one of a general tile read from ``scr``
        (gfc<general>'s), then pass12 at the tile on those values; the
        tile's primitives, counts, S, beta and partials, and S and A or B
        at its nodes on an edge facing a general tile into ``scr``
        (plan.border_masks).  The windows are gathered as one (29, X, Y)
        stack, each node from its own tile's source, which is what every
        window holds at that node."""
        plan = self.plan
        tiles = plan.tiles("spec", part).long()
        own = plan.node_mask(tiles)
        out, counts = self._gfc_fields(cin, dt, aux)
        fresh = torch.cat([out.S, out.A, out.B, out.Src[fl.i2d_k:]])
        win = torch.where(plan.node_mask(plan.spec_tiles), fresh, scr[:29])
        cout[_PRIMS:] = torch.where(own, pack_carry(shrink(out))[_PRIMS:],
                                    cout[_PRIMS:])
        part_i[tiles] = counts[tiles]
        ga, gb = plan.border_masks(tiles)
        scr[0:9] = torch.where(ga | gb, fresh[0:9], scr[0:9])
        scr[9:18] = torch.where(ga, fresh[9:18], scr[9:18])
        scr[18:27] = torch.where(gb, fresh[18:27], scr[18:27])
        # no spec tile holds a heat or a wall node: no SrcAdd
        S_c, beta_c, new_f = self._pass12_fields(cin, cout, win, dt,
                                                 aux_next, add=False)
        cout[0:18] = torch.where(own, torch.cat([S_c, beta_c]), cout[0:18])
        part_f[tiles] = new_f[tiles]

    def heat_source_plain(self, cout, scr, dt, q_conv=False):
        """(X, Y) SrcAdd[rhoE] of calc_heat_on_wall_sources on gfc's
        outputs: Tg of ``cout`` and lam_eff as lam with lam_t = 0 (lam_eff
        + 0 is lam_eff); ``q_conv``: (it, its Q_conv)."""
        p = self.params
        zero = torch.zeros_like(scr[SCR_LAM_EFF])
        state = expand(carry_views(cout, dt), p, self.zero_src,
                       lam_t=zero).replace(lam=scr[SCR_LAM_EFF])
        out = calc_heat_on_wall_sources(state, self.meta, p, ctx=self.ctx)
        if q_conv:
            return out.SrcAdd[fl.i2d_RhoE], out.Q_conv
        return out.SrcAdd[fl.i2d_RhoE]

    def heat_plain(self, cout, scr, dt, q_conv=None):
        src_e, q = self.heat_source_plain(cout, scr, dt, q_conv=True)
        scr[SCR_SRCADD_E] = src_e
        if q_conv is not None:
            q_conv[...] = q

    def pass12_plain(self, cin, cout, scr, dt, aux, part_f, part=None,
                     heat_src=None, bodies=None, fold=True, src=None):
        """``heat_src``: the (X, Y) SrcAdd[rhoE] to add with the heat
        stage (default: heat_source_plain of ``cout`` and ``scr``, the folded
        form; ``fold=False``: scratch plane SCR_SRCADD_E).  ``part``,
        ``bodies``: compute the whole grid, write the nodes and partials of
        the tiles of that part and of those lists only (what their launches
        write).  ``src``: the source field (default the chunk's)."""
        if heat_src is None and not fold:
            heat_src = scr[SCR_SRCADD_E]
        S_c, beta_c, new_f = self._pass12_fields(cin, cout, scr, dt, aux,
                                                 heat_src, src=src)
        if part is None and bodies is None:
            cout[0:9] = S_c
            cout[9:18] = beta_c
            part_f[:] = new_f
            return
        tiles = self._tiles_of(self._bodies(part, bodies), part)
        m = self.plan.node_mask(tiles)
        cout[0:18] = torch.where(m, torch.cat([S_c, beta_c]), cout[0:18])
        part_f[tiles] = new_f[tiles]

    def _pass12_fields(self, cin, cout, scr, dt, aux, heat_src=None,
                       add=True, src=None):
        """core/step.pass12 over the whole grid from the scratch ``scr``
        and the carry ``cin``: (S, beta, per-tile partials (n_tiles, 27)).
        ``add``: with the heat stage's and the moving walls' SrcAdd (the
        heat source of ``heat_src``, else heat_source_plain of ``cout`` and
        ``scr``).  ``src``: the source field whose planes 0-6 pass 1 adds
        (default the chunk's)."""
        p = self.params
        src = self.src if src is None else src
        src = torch.cat([src[:fl.i2d_k], scr[27:29]])
        state = expand(carry_views(cin, dt), p, src).replace(
            S=scr[0:9], A=scr[9:18], B=scr[18:27])
        if self.axi:
            state = state.replace(F=radial_fluxes(scr))
        if add and (self.has_heat or self.mw):
            src_add = list(self.zero_src.unbind(0))
            if self.has_heat:
                src_add[fl.i2d_RhoE] = (
                    self.heat_source_plain(cout, scr, dt)
                    if heat_src is None else heat_src)
            if self.mw:
                for k, e in enumerate(MW_EQ):
                    src_add[e] = scr[SCR_MW + k]
            state = state.replace(SrcAdd=torch.stack(src_add))
        S_c, beta_c, _, _, f = pass12(state, self.meta, p, self._aux(aux),
                                      return_fields=True, ctx=self.ctx)
        gate = f["gate"] & self.own
        if p.isAlternateRMS:
            acc = (f["abs_dd"] if p.serial_rms_mode
                   else f["abs_dd"] * f["abs_dd"])
            num = torch.where(gate, acc, 0.0)
            den = torch.where(gate, f["tmp"] * f["tmp"], 0.0)
        else:
            num = torch.where(gate, f["dd_local"] * f["dd_local"], 0.0)
            den = gate.to(num.dtype)
        ddm = torch.where(gate, f["dd_local"], 0.0)
        return S_c, beta_c, torch.cat([_tile_reduce(num, self.plan, "sum"),
                                       _tile_reduce(den, self.plan, "sum"),
                                       _tile_reduce(ddm, self.plan, "max")],
                                      1)


def tile_totals(part_f: torch.Tensor, part_i: torch.Tensor):
    """Per-tile partials (..., tiles, 27) and (..., tiles, 2) summed over
    the tiles: (RMS numerator (..., 9), denominator (..., 9), DD max
    (..., 9), (Tg<0, dt overrun) counts (..., 2)); a leading dim holds a
    block's iterations."""
    return (part_f[..., 0:9].sum(-2), part_f[..., 9:18].sum(-2),
            part_f[..., 18:27].amax(-2), part_i.sum(-2))


def rms_of(nsum, dsum, p: SolverParams):
    """The RMS of each equation from its summed numerator and
    denominator."""
    if p.isAlternateRMS:
        fb = torch.zeros_like(nsum) if p.serial_rms_mode else nsum
        return torch.where((nsum > 0) & (dsum > 0),
                           torch.sqrt(_safe_div(nsum, dsum)), fb)
    return torch.where(dsum > 0, torch.sqrt(_safe_div(nsum, dsum)), nsum)


def combine(part_f: torch.Tensor, part_i: torch.Tensor, p: SolverParams):
    """Per-tile partials of a block's K iterations, (K, tiles, ...) ->
    (RMS (K, 9), DD_max (K, 9), unstable (K,), dt_overrun (K,))
    (pallas_step.py:1014-1028)."""
    nsum, dsum, ddm, counts = tile_totals(part_f, part_i)
    return rms_of(nsum, dsum, p), ddm, counts[..., 0] > 0, counts[..., 1] > 0


def fuse_blocks(n_iters: int, K: int) -> list:
    """(first iteration, length) of the blocks of a chunk's n_iters - 1
    kernel iterations, counted from the chunk's first: ``divmod(n_iters -
    1, K)`` blocks of K, then one of the remainder (pallas_step.py:
    1099-1113)."""
    nb, rem = divmod(n_iters - 1, K)
    return [(j * K, K) for j in range(nb)] + ([(nb * K, rem)] if rem else [])


def chunk_diags(diag0: dict, blocks: list, unstable_last) -> dict:
    """A chunk's diags: the prologue pass12's diag, each block's rows in
    order (RMS, DD_max, unstable, dt_overrun as ``combine`` gives them,
    then dt_used), and the epilogue gfc's unstable flag
    (make_pallas_chunk's all_diag, pallas_step.py:1122-1142)."""
    def rows(k, first=(), last=()):
        return torch.cat([*first, *(b[k] for b in blocks), *last])

    return {"RMS": rows(0, first=[diag0["RMS"][None]]),
            "dt_used": rows(4, first=[diag0["dt_used"].reshape(1)]),
            "DD_max": rows(1, first=[diag0["DD_max"][None]]),
            "unstable": rows(2, last=[unstable_last.reshape(1)]),
            # the epilogue gfc computes a fresh dt (no freeze)
            "dt_overrun": rows(3, last=[torch.zeros(
                1, dtype=torch.bool, device=unstable_last.device)])}


def local_dt(slim: SlimState, active, p: SolverParams, cfl_scen):
    """min(1, the least CFL dt over the active nodes) of the carried
    primitives: the part of ``scan_dt`` before a reduction across
    shards."""
    # min(CFL, cfl_scen) in the working dtype, without a host-to-device
    # copy of the constant
    cfl_min = cfl_scen.clamp_max(p.CFL)
    k_new = _safe_div(slim.CP, slim.CP - slim.R, 2.0)
    aaa = torch.sqrt(torch.clamp_min(k_new * slim.R * slim.Tg, 0.0))
    dtn = cfl_min * torch.minimum(p.dx / (aaa + torch.abs(slim.U)),
                                  p.dy / (aaa + torch.abs(slim.V)))
    return torch.clamp_max(torch.where(active, dtn, 1.0).amin(), 1.0)


def serial_dt(dt_new, dt_prev, p: SolverParams):
    """The serial build's monotone dt (deeps2d_core.cpp:846-852), in the
    working dtype."""
    if p.serial_dt_mode:
        dt_new = torch.minimum(dt_new, dt_prev)
    return dt_new.to(dt_prev.dtype)


def scan_dt(slim: SlimState, active, p: SolverParams, cfl_scen):
    """Global dt from the carried primitives (deeps2d_core.cpp:1317-1327
    with the kernel path's one-iteration primitive lag)."""
    return serial_dt(local_dt(slim, active, p, cfl_scen), slim.dt, p)


class KernelChunk:
    """chunk(state, n_iters, start_iter, src_ext) -> (state', diags) on the
    kernel path (make_pallas_chunk's interface).  ``fuse_iters`` (K): the
    kernel iterations run in blocks of K on one frozen dt (fuse_blocks).
    The prologue is pass12's launches over every tile from the state
    packed into the carry and the scratch (``prologue``); an iteration
    launches ``step.iteration_launches()``: gfc, then pass12 (with the heat
    stage folded into its general body), the spec tiles' two in one where
    ``spec_fused``; the epilogue is gfc's state form over every tile, then
    heat_kernel with Q_conv where the deck has the heat stage
    (``epilogue``).  No stage runs the plain versions on CUDA tensors.  The
    loop's scratch starts as NaN, so a value no launch wrote shows where it
    is read."""

    def __init__(self, meta, params, chem, beta_tab, cfl_tab, turb_start,
                 spec_map=None, dispatch="lists", fuse_iters=1):
        p = params
        if int(fuse_iters) < 1:
            raise ValueError(f"fuse_iters must be >= 1, got {fuse_iters}")
        self.K = int(fuse_iters)
        self.meta, self.params, self.chem = meta, p, chem
        self.beta_tab, self.cfl_tab, self.turb_start = (beta_tab, cfl_tab,
                                                        turb_start)
        ctx = build_static_ctx(meta, p)
        heat_map = heat_node_map(ctx) if has_heat_stage(p) else None
        self.plan = make_tile_plan(p.MaxX, p.MaxY, spec_map, meta.CT.device,
                                   heat_map)
        self.step = FusedStep(meta, p, chem, self.plan, dispatch, ctx)

    def aux_at(self, it):
        return make_aux(self.beta_tab, self.cfl_tab, self.turb_start, it,
                        self.params.torch_dtype)

    def prologue(self, state: SolverState, n_iters: int, start_iter: int,
                 buffers: bool = False):
        """Iteration start_iter's pass12 (the fluxes are already in
        ``state``) and the chunk's per-iteration scalars: the state packed
        into a carry (``pack_carry``) and a scratch
        (``FusedStep.pack_scratch``), then pass12's launches over every
        tile with dt = state.dt, the heat source read from the state's
        SrcAdd[rhoE] (the unfolded form: the state comes from the last
        chunk, build_case, a checkpoint or a swap resume) and, on a deck
        with sources, the state's own Src, as core/step.pass12 reads them;
        its diag from the per-tile partials.  It reads nothing the chunk
        sets per state (``set_lam_t``, ``set_y_plus``, ``set_src``).
        Returns (carry, pass12 diag, StepAux of iterations start_iter..,
        kernel scalar rows): row b holds (beta_scen, cfl_scen, is_mu_t) of
        iteration start_iter + b, rounded through float32 as the TPU
        kernel's scalar vector was (a no-op in a float32 run); with
        ``buffers`` also (the other carry buffer, the scratch, the
        unrounded rows), which the chunk's iterations and epilogue take, as
        core/step takes make_aux's scalars."""
        p, step = self.params, self.step
        dtype = p.torch_dtype
        raw = self.aux_at(torch.arange(start_iter, start_iter + n_iters))
        rows = torch.stack([raw.beta_scen, raw.cfl_scen,
                            raw.is_mu_t_iter.to(dtype)], 1)
        cin = pack_carry(shrink(state))
        cout = torch.empty_like(cin)
        cout[_PRIMS:] = cin[_PRIMS:]
        scr = step.pack_scratch(state)
        part_f = torch.empty((self.plan.n_tiles, 27), dtype=dtype,
                             device=cin.device)
        src = (state.Src.to(dtype).contiguous() if p.has_ext_src
               else None)
        step.pass12_state(cin, cout, scr, state.dt, rows[0], part_f, src)
        nsum, dsum = part_f[:, 0:9].sum(0), part_f[:, 9:18].sum(0)
        diag0 = {"RMS": rms_of(nsum, dsum, p),
                 "DD_max": part_f[:, 18:27].amax(0), "dt_used": state.dt}
        kaux = rows.to(torch.float32).to(dtype)
        if not buffers:
            return cout, diag0, raw, kaux
        return cout, diag0, raw, kaux, cin, scr, rows

    def epilogue(self, ca, cb, scr, dt, state: SolverState, row):
        """Iteration ``row``'s gfc on carry ``ca`` in its state form over
        every tile (into ``cb``, ``scr`` and the state planes), then the
        heat stage with Q_conv where the deck has it, both with the block's
        ``dt``.  Returns (SolverState, Tg<0 flag): every field of
        core/step.gfc's, as views of the launches' buffers where the field
        is a plane of one (S, A, B of the scratch, beta of ``ca``, the
        primitives of ``cb``, the state planes of ``state_fields``), the
        zeros of ``expand`` where gfc computes none (dSdx, dSdy, F on a
        flat deck, the gradients outside ``state_fields``), the state's
        own lam_t where gfc keeps it (an Euler deck: lam_t_const), Src and
        SrcAdd assembled from their planes, y+ passed through; dt =
        serial_dt(min(1, the least node dt), dt)."""
        p, step, plan = self.params, self.step, self.plan
        X, Y = ca.shape[1:]
        st = torch.empty((N_STATE, X, Y), dtype=ca.dtype, device=ca.device)
        part_i = torch.empty((plan.n_tiles, 2), dtype=torch.int32,
                             device=ca.device)
        part_dt = torch.empty(plan.n_tiles, dtype=ca.dtype, device=ca.device)
        step.gfc_state(ca, cb, scr, st, dt, row, part_i, part_dt)
        z1 = torch.zeros((X, Y), dtype=ca.dtype, device=ca.device)
        z9 = z1.expand(fl.NUM_EQ, X, Y)
        q_conv = z1
        if step.has_heat:
            q_conv = torch.zeros_like(z1)
            scr[SCR_SRCADD_E] = 0.0
            step.heat_state(cb, scr, dt, q_conv)
        src_add = z9
        if step.has_heat or step.mw:
            planes = [z1] * fl.NUM_EQ
            if step.has_heat:
                planes[fl.i2d_RhoE] = scr[SCR_SRCADD_E]
            if step.mw:
                for k, e in enumerate(MW_EQ):
                    planes[e] = scr[SCR_MW + k]
            src_add = torch.stack(planes)
        prims = carry_views(cb, dt)
        views = state_views(st)
        kept = {name: views[name] if name in step.state_fields
                else z1.expand(n, X, Y) if n > 1 else z1
                for name, n in STATE_FIELDS}
        if "lam_t" not in step.state_fields:
            kept["lam_t"] = state.lam_t
        out = SolverState(
            S=scr[SCR_S:SCR_S + 9], beta=ca[CARRY["beta"]:CARRY["beta"] + 9],
            A=scr[SCR_A:SCR_A + 9], B=scr[SCR_B:SCR_B + 9],
            F=radial_fluxes(scr) if step.axi else z9, dSdx=z9, dSdy=z9,
            Src=torch.cat([step.src[:fl.i2d_k], scr[SCR_SRC_K:SCR_SRC_EPS + 1]]),
            SrcAdd=src_add, y_plus=state.y_plus, Q_conv=q_conv,
            dt=serial_dt(part_dt.amin().clamp_max(1.0), dt, p),
            **{f: getattr(prims, f) for f in ("U", "V", "p", "Tg", "Yc", "R",
                                              "CP", "lam", "mu", "mu_t")},
            **kept)
        return out, part_i[:, 0].sum() > 0

    def __call__(self, state: SolverState, n_iters: int, start_iter: int,
                 src_ext=None):
        p, step = self.params, self.step
        dtype = p.torch_dtype
        ctx = step.ctx
        step.set_lam_t(state.lam_t)
        step.set_y_plus(state.y_plus)
        step.set_src(src_ext)
        ca, diag0, raw, kaux, cb, scr, rows = self.prologue(
            state, n_iters, start_iter, buffers=True)
        # the loop's scratch starts as NaN, as pack_scratch left the planes
        # the prologue must not read
        scr.fill_(float("nan"))
        # slot i holds iteration i of a block
        part_f = torch.zeros((self.K, self.plan.n_tiles, 27), dtype=dtype,
                             device=ca.device)
        part_i = torch.zeros((self.K, self.plan.n_tiles, 2),
                             dtype=torch.int32, device=ca.device)

        dt = state.dt
        blocks = []
        for b0, kk in fuse_blocks(n_iters, self.K):
            dt = scan_dt(carry_views(ca, dt), ctx.active, p, raw.cfl_scen[b0])
            # the kernels take dt through float32 too (see prologue)
            dt_k = dt.to(torch.float32).to(dtype)
            for i, b in enumerate(range(b0, b0 + kk)):
                step.path_gfc(ca, cb, scr, dt_k, kaux[b], part_i[i])
                step.path_pass12(ca, cb, scr, dt_k, kaux[b], kaux[b + 1],
                                 part_i[i], part_f[i])
                ca, cb = cb, ca
            blocks.append((*combine(part_f[:kk], part_i[:kk], p),
                           dt.expand(kk)))

        out, unstable_last = self.epilogue(ca, cb, scr, dt, state, rows[-1])
        return out, chunk_diags(diag0, blocks, unstable_last)


def make_kernel_chunk(meta: GridMeta, params: SolverParams, chem: ChemTables,
                      beta_tab, cfl_tab, turb_start, spec_map=None,
                      dispatch: str = "lists",
                      fuse_iters: int = 1) -> KernelChunk:
    """The analog of ``make_pallas_chunk(fuse_iters=K)``; ``spec_map`` is
    the host generic-interior map (None: every tile runs the general
    body); ``dispatch`` one of DISPATCH_FORMS; ``fuse_iters`` the K of the
    blocks on one frozen dt."""
    return KernelChunk(meta, params, chem, beta_tab, cfl_tab, turb_start,
                       spec_map, dispatch, fuse_iters)
