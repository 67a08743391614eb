"""The kernel path of the solver iteration.

Counterpart of ``openhyperflow2d_tpu/ops/pallas_step.py`` at
``fuse_iters=1``: ``make_kernel_chunk`` has the prologue ``pass12``, the
per-iteration loop and the epilogue ``gfc`` of ``make_pallas_chunk``
(pallas_step.py:1069-1143).  Each loop iteration

1. freezes dt from the carried primitives (``scan_dt``, pallas_step.py:
   859-871), one iteration behind the reference's dt, as on the TPU path;
2. runs ``gfc_kernel``, then ``heat_kernel`` on decks with non-adiabatic
   walls next to solids, then ``pass12_kernel`` (ops/csrc/fused_step.cu);
3. combines the per-tile partials into the RMS, DD_max, unstable and
   dt_overrun diags (pallas_step.py:1014-1028).

Two dispatch forms issue gfc and pass12 (``dispatch``):

* ``"lists"``: one launch per body over its device tile list, the
  specialized tiles and the general tiles.  The general launch over an
  arbitrary tile table is the GPU form of the TPU's scatter call
  (``make_fused(scatter_n=...)``, pallas_step.py:506-510, 879-889), which
  runs the non-rectangular general remainder of a multi-rectangle cover.
* ``"dual"``: one launch over all tiles, each CTA branching on a device
  per-tile flag to the specialized or the general body: the GPU form of
  ``make_fused(body="dual")`` (pallas_step.py:702-718).

Each tile runs the same body in both forms, so they give the same bits.

Nothing in the loop synchronizes with the host: dt and the per-iteration
scalars stay on the device, in the working dtype, and the kernels read them
through pointers.  They pass through float32 even in a float64 run, as
the TPU kernel's float32 scalar vector did (pallas_step.py:946-958), so the
two packages agree in float64 too.

``FusedStep`` holds the kernels' wrappers and their plain torch versions
(``gfc_plain``/``heat_plain``/``pass12_plain``: core/step.gfc without its
heat stage, core/physics.calc_heat_on_wall_sources and core/step.pass12
over the whole grid, returning the same planes and per-tile partials).  A wrapper runs the plain
version for CPU tensors and launches its kernel for CUDA tensors; there is
no other fallback.
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
from ..core.static_ctx import build_packed_ctx, build_static_ctx
from ..core.step import (SlimState, StepAux, expand, gfc, has_heat_stage,
                         lead, make_aux, pass12, shrink, trail)

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
SCR_SRCADD_E = 30   # SrcAdd of rhoE, written by heat, zeroed per chunk
_PRIMS = 18   # carry planes from here on are written by gfc

KERNEL_NAMES = ("gfc_kernel<spec>", "gfc_kernel<general>",
                "pass12_kernel<spec>", "pass12_kernel<general>",
                "heat_kernel", "gfc_kernel<dual>", "pass12_kernel<dual>")
DISPATCH_FORMS = ("lists", "dual")
# "lists": on an H100 the dual form ran the 2048^2 walls+step+heat deck
# slower (PERF.md, Findings)
DEFAULT_DISPATCH = "lists"
_BODY_CODE = {"general": 0, "spec": 1, "dual": 2}   # fused_step.cu BODY_*


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


# ---------------------------------------------------------------------------
# host tile table
# ---------------------------------------------------------------------------
@dataclass
class TilePlan:
    """The grid cut into TILE-sized CTAs; a tile is specialized when it is
    complete and every node in it is generic interior (its nodes then decode
    to the constants of specialized_interior_ctx).  A heat tile holds a
    node of the conjugate-heat stage (a solid node next to a wall gas node,
    or that gas node)."""

    X: int
    Y: int
    nbx: int
    nby: int
    spec: np.ndarray              # (nbx, nby) bool, host
    spec_tiles: torch.Tensor      # int32 tile ids (ti * nby + tj), device
    general_tiles: torch.Tensor
    heat_tiles: torch.Tensor
    flags: torch.Tensor           # int32 per tile id: 1 = spec (row-major)

    @property
    def n_tiles(self) -> int:
        return self.nbx * self.nby

    def tiles(self, body: str) -> torch.Tensor:
        """The tile list of the "spec" or the "general" body."""
        return {"spec": self.spec_tiles, "general": self.general_tiles}[body]

    def launch_grid(self, body: str):
        """(tile list pointer or None, CTAs) of one launch of ``body``; the
        dual form runs every tile, CTA b on tile b, and reads no list."""
        if body == "dual":
            return None, self.n_tiles
        t = self.tiles(body)
        return t.data_ptr(), t.numel()


def _tile_any(node_map, nbx: int, nby: int) -> np.ndarray:
    """(nbx, nby): whether any node of the tile is set (ragged edges
    included)."""
    TX, TY = TILE
    X, Y = node_map.shape
    m = np.zeros((nbx * TX, nby * TY), bool)
    m[:X, :Y] = node_map
    return m.reshape(nbx, TX, nby, TY).any(axis=(1, 3))


def make_tile_plan(X: int, Y: int, spec_map, device,
                   heat_map=None) -> TilePlan:
    """``spec_map``: the host generic-interior map (None: no spec tiles);
    ``heat_map``: the host map of heat-stage nodes (None: no heat tiles)."""
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

    return TilePlan(X, Y, nbx, nby, spec, dev(ids[spec]),
                    dev(ids[~spec]), dev(ids[heat]), dev(spec.reshape(-1)))


def heat_node_map(ctx) -> np.ndarray:
    """Host (X, Y) map of the nodes the heat stage reads or writes: the
    hv_* solid nodes and the hw_* wall gas nodes of the StaticCtx."""
    m = (ctx.hv_xl | ctx.hv_yd | ctx.hv_yu | ctx.hv_xr | ctx.hw_down
         | ctx.hw_up | ctx.hw_left | ctx.hw_right)
    return m.cpu().numpy()


def _tile_reduce(x: torch.Tensor, plan: TilePlan, op: str) -> torch.Tensor:
    """(..., X, Y) -> (n_tiles, ...) per-tile sum or max (padding adds 0)."""
    TX, TY = TILE
    lead_shape = x.shape[:-2]
    xp = F.pad(x, (0, plan.nby * TY - plan.Y, 0, plan.nbx * TX - plan.X))
    xp = xp.reshape(*lead_shape, plan.nbx, TX, plan.nby, TY)
    r = xp.sum(dim=(-3, -1)) if op == "sum" else xp.amax(dim=(-3, -1))
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
            "serial_rms", "zeldovich", "heat")]


def kernel_consts(p: SolverParams, plan: TilePlan,
                  heat: bool) -> KernelConsts:
    # ctypes rounds each double to float32, as the working dtype does
    return KernelConsts(
        dx=p.dx, dy=p.dy, dxx=p.dy / (p.dx + p.dy), dyy=p.dx / (p.dx + p.dy),
        min_dxdy=min(p.dx, p.dy), cfl=p.CFL, beta0=p.beta0, sig_w=p.SigW,
        sig_f=p.SigF, k0=p.K0, k0_div=max(p.K0, 1e-30), tf=p.Tf,
        c_mu075=0.09 ** 0.75, hu=(ctypes.c_float * 4)(*p.Hu),
        X=p.MaxX, Y=p.MaxY, nby=plan.nby, has_walls=int(p.has_walls),
        fast_math=int(p.fast_math), bff=p.bff,
        alt_rms=int(p.isAlternateRMS), serial_rms=int(p.serial_rms_mode),
        zeldovich=int(p.chemistry == fl.CRM_ZELDOVICH), heat=int(heat))


def pack_chem(chem: ChemTables, p: SolverParams):
    """(chemf, chemi): R of the 4 species then each table's xs and ys, in
    (prop, species) order; chemi holds (offset, knots, ascending) per
    table."""
    vals = [getattr(chem, f"R_{sp}").reshape(1) for sp in _CHEM_SPECIES]
    off, meta = 4, []
    for prop in _CHEM_PROPS:
        for sp in _CHEM_SPECIES:
            xs = getattr(chem, f"{prop}_{sp}_x")
            ys = getattr(chem, f"{prop}_{sp}_y")
            meta += [off, xs.numel(), int(f"{prop}_{sp}" in p.chem_asc)]
            vals += [xs, ys]
            off += 2 * xs.numel()
    chemf = torch.cat(vals)
    return chemf, torch.tensor(meta, dtype=torch.int32, device=chemf.device)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


class FusedStep:
    """One kernel-path iteration: ``gfc``, ``heat`` and ``pass12`` over the
    grid with a frozen dt.  Holds the static kernel inputs of a case, the
    wrappers and their plain versions, and a launch count per kernel
    instantiation (``launches``; a wrapper counts a launch where it
    launches, nowhere else).  ``dispatch`` is the form gfc and pass12 are
    issued in (DISPATCH_FORMS)."""

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
        self.idn = torch.stack([meta.idXl, meta.idXr, meta.idYu, meta.idYd])
        self.mf = torch.stack([meta.BGX, meta.BGY, meta.Uw, meta.Vw,
                               meta.l_min]).to(p.torch_dtype)
        self.ctxw = build_packed_ctx(meta, p)
        self.chemf, self.chemi = pack_chem(chem, p)
        self.zero_src = torch.zeros((fl.NUM_EQ, p.MaxX, p.MaxY),
                                    dtype=p.torch_dtype, device=meta.CT.device)
        self.consts = kernel_consts(p, plan, self.has_heat)
        self.launches = dict.fromkeys(KERNEL_NAMES, 0)

    def reset_launches(self) -> None:
        self.launches = dict.fromkeys(KERNEL_NAMES, 0)

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

    def _bodies(self):
        """The gfc/pass12 launches of one iteration: the dual form's one,
        or each list with tiles (spec first)."""
        if self.dispatch == "dual":
            return ["dual"]
        return [b for b in ("spec", "general") if self.plan.tiles(b).numel()]

    def launch_gfc(self, body, cin, cout, scr, dt, aux, part_i):
        """One gfc_kernel instantiation over its tiles (CUDA tensors);
        ``body`` is "spec", "general" or "dual"."""
        self._check_cuda(cin, cout, scr, dt, aux, self.mf, self.chemf)
        tiles, n_tiles = self.plan.launch_grid(body)
        self._launch("hf2d_gfc", f"gfc_kernel<{body}>", (
            _BODY_CODE[body], ctypes.addressof(self.consts), _ptr(cin),
            _ptr(cout), _ptr(scr), _ptr(self.idn), _ptr(self.mf),
            _ptr(self.ctxw), _ptr(self.chemf), _ptr(self.chemi), _ptr(dt),
            _ptr(aux), tiles, n_tiles, _ptr(self.plan.flags), _ptr(part_i)))

    def launch_pass12(self, body, cin, cout, scr, dt, aux, part_f):
        """One pass12_kernel instantiation over its tiles (CUDA tensors)."""
        self._check_cuda(cin, cout, scr, dt, aux, part_f)
        tiles, n_tiles = self.plan.launch_grid(body)
        self._launch("hf2d_pass12", f"pass12_kernel<{body}>", (
            _BODY_CODE[body], ctypes.addressof(self.consts), _ptr(cin),
            _ptr(cout), _ptr(scr), _ptr(self.idn), _ptr(self.ctxw), _ptr(dt),
            _ptr(aux), tiles, n_tiles, _ptr(self.plan.flags), _ptr(part_f)))

    def launch_heat(self, cout, scr, dt):
        """heat_kernel over the heat tiles (CUDA tensors)."""
        self._check_cuda(cout, scr, dt)
        tiles = self.plan.heat_tiles
        self._launch("hf2d_heat", "heat_kernel", (
            ctypes.addressof(self.consts), _ptr(cout), _ptr(scr),
            _ptr(self.ctxw), _ptr(dt), _ptr(tiles), tiles.numel()))

    def gfc(self, cin, cout, scr, dt, aux, part_i):
        """gfc_kernel: gradients, fill, dt field and chemistry of iteration
        k from carry ``cin``; writes the scratch, the primitives of
        ``cout`` and per-tile (Tg<0, dt overrun) counts into ``part_i``.
        ``dt`` is the frozen dt (0-d), ``aux`` the (beta, cfl, is_mu_t)
        row of iteration k."""
        if cin.device.type == "cpu":
            return self.gfc_plain(cin, cout, scr, dt, aux, part_i)
        for body in self._bodies():
            self.launch_gfc(body, cin, cout, scr, dt, aux, part_i)

    def heat(self, cout, scr, dt):
        """heat_kernel: the conjugate wall-heat source SrcAdd[rhoE] of
        iteration k into scratch plane SCR_SRCADD_E, from gfc's Tg in
        ``cout`` and lam_eff in scratch plane SCR_LAM_EFF."""
        if cout.device.type == "cpu":
            return self.heat_plain(cout, scr, dt)
        self.launch_heat(cout, scr, dt)

    def pass12(self, cin, cout, scr, dt, aux, part_f):
        """pass12_kernel: pass 1 + pass 2 from the scratch at +-1 and the
        blending factors of ``cin``; writes S and beta of ``cout`` and
        per-tile (RMS numerator, denominator, DD max) x 9 into ``part_f``.
        ``aux`` is the row of iteration k+1."""
        if cin.device.type == "cpu":
            return self.pass12_plain(cin, cout, scr, dt, aux, part_f)
        for body in self._bodies():
            self.launch_pass12(body, cin, cout, scr, dt, aux, part_f)

    # ------------------------------------------------------------------
    # plain versions
    # ------------------------------------------------------------------
    @staticmethod
    def _aux(row):
        return StepAux(beta_scen=row[0], cfl_scen=row[1],
                       is_mu_t_iter=row[2] > 0.5)

    def gfc_plain(self, cin, cout, scr, dt, aux, part_i):
        full = expand(carry_views(cin, dt), self.params, self.zero_src)
        out, dt_field, unstable = gfc(full, self.meta, self.params,
                                      self.chem, self._aux(aux),
                                      return_fields=True, ctx=self.ctx,
                                      heat=False)
        scr[0:9] = out.S
        scr[9:18] = out.A
        scr[18:27] = out.B
        scr[27:29] = out.Src[fl.i2d_k:]
        if self.has_heat:
            # what the heat stage reads (core/physics.py): lam + lam_t of
            # gfc's output, lam after chemistry and lam_t from the CP
            # before it
            scr[SCR_LAM_EFF] = out.lam + out.lam_t
        cout[_PRIMS:] = pack_carry(shrink(out))[_PRIMS:]
        part_i[:, 0] = _tile_reduce(unstable.to(torch.int32), self.plan,
                                    "sum")
        part_i[:, 1] = _tile_reduce((dt > dt_field).to(torch.int32),
                                    self.plan, "sum")

    def heat_plain(self, cout, scr, dt):
        """calc_heat_on_wall_sources on gfc's outputs: Tg of ``cout`` and
        lam_eff as lam with lam_t = 0 (lam_eff + 0 is lam_eff)."""
        p = self.params
        zero = torch.zeros_like(scr[SCR_LAM_EFF])
        state = expand(carry_views(cout, dt), p, self.zero_src,
                       lam_t=zero).replace(lam=scr[SCR_LAM_EFF])
        out = calc_heat_on_wall_sources(state, self.meta, p, ctx=self.ctx)
        scr[SCR_SRCADD_E] = out.SrcAdd[fl.i2d_RhoE]

    def pass12_plain(self, cin, cout, scr, dt, aux, part_f):
        p = self.params
        src = torch.cat([self.zero_src[:fl.i2d_k], scr[27:29]])
        state = expand(carry_views(cin, dt), p, src).replace(
            S=scr[0:9], A=scr[9:18], B=scr[18:27])
        if self.has_heat:
            state = state.replace(SrcAdd=torch.cat([
                self.zero_src[:fl.i2d_RhoE], scr[SCR_SRCADD_E][None],
                self.zero_src[fl.i2d_RhoE + 1:]]))
        S_c, beta_c, _, _, f = pass12(state, self.meta, p, self._aux(aux),
                                      return_fields=True, ctx=self.ctx)
        cout[0:9] = S_c
        cout[9:18] = beta_c
        gate = f["gate"]
        if p.isAlternateRMS:
            acc = (f["abs_dd"] if p.serial_rms_mode
                   else f["abs_dd"] * f["abs_dd"])
            num = torch.where(gate, acc, 0.0)
            den = torch.where(gate, f["tmp"] * f["tmp"], 0.0)
        else:
            num = torch.where(gate, f["dd_local"] * f["dd_local"], 0.0)
            den = gate.to(num.dtype)
        ddm = torch.where(gate, f["dd_local"], 0.0)
        part_f[:, 0:9] = _tile_reduce(num, self.plan, "sum")
        part_f[:, 9:18] = _tile_reduce(den, self.plan, "sum")
        part_f[:, 18:27] = _tile_reduce(ddm, self.plan, "max")


def combine(part_f: torch.Tensor, part_i: torch.Tensor, p: SolverParams):
    """Per-tile partials -> (RMS (9,), DD_max (9,), unstable, dt_overrun)
    of one iteration (pallas_step.py:1014-1028)."""
    nsum = part_f[:, 0:9].sum(0)
    dsum = part_f[:, 9:18].sum(0)
    if p.isAlternateRMS:
        fb = torch.zeros_like(nsum) if p.serial_rms_mode else nsum
        rms = torch.where((nsum > 0) & (dsum > 0),
                          torch.sqrt(_safe_div(nsum, dsum)), fb)
    else:
        rms = torch.where(dsum > 0, torch.sqrt(_safe_div(nsum, dsum)), nsum)
    counts = part_i.sum(0)
    return rms, part_f[:, 18:27].amax(0), counts[0] > 0, counts[1] > 0


def scan_dt(slim: SlimState, active, p: SolverParams, cfl_scen):
    """Global dt from the carried primitives (deeps2d_core.cpp:1317-1327
    with the kernel path's one-iteration primitive lag)."""
    dtype = slim.U.dtype
    cfl_min = torch.minimum(torch.tensor(p.CFL, dtype=dtype,
                                         device=slim.U.device), cfl_scen)
    k_new = _safe_div(slim.CP, slim.CP - slim.R, 2.0)
    aaa = torch.sqrt(torch.clamp_min(k_new * slim.R * slim.Tg, 0.0))
    dtn = cfl_min * torch.minimum(p.dx / (aaa + torch.abs(slim.U)),
                                  p.dy / (aaa + torch.abs(slim.V)))
    dt_new = torch.clamp_max(torch.where(active, dtn, 1.0).amin(), 1.0)
    if p.serial_dt_mode:
        dt_new = torch.minimum(dt_new, slim.dt)
    return dt_new.to(dtype)


class KernelChunk:
    """chunk(state, n_iters, start_iter, src_ext) -> (state', diags) on the
    kernel path (make_pallas_chunk's interface at fuse_iters=1)."""

    def __init__(self, meta, params, chem, beta_tab, cfl_tab, turb_start,
                 spec_map=None, dispatch="lists"):
        p = params
        if p.has_ext_src:
            raise NotImplementedError("external sources are not ported")
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

    def prologue(self, state: SolverState, n_iters: int, start_iter: int):
        """Iteration start_iter's pass12 (the fluxes are already in
        ``state``) and the chunk's per-iteration scalars.  Returns (carry,
        pass12 diag, StepAux of iterations start_iter.., kernel scalar
        rows): row b holds (beta_scen, cfl_scen, is_mu_t) of iteration
        start_iter + b, rounded through float32 as the TPU kernel's scalar
        vector was (a no-op in a float32 run)."""
        p, dtype = self.params, self.params.torch_dtype
        S_c, beta_c, _, _, diag0 = pass12(state, self.meta, p,
                                          self.aux_at(start_iter),
                                          ctx=self.step.ctx)
        carry = pack_carry(shrink(state.replace(S=S_c, beta=beta_c)))
        raw = self.aux_at(torch.arange(start_iter, start_iter + n_iters))
        kaux = torch.stack([raw.beta_scen, raw.cfl_scen,
                            raw.is_mu_t_iter.to(dtype)], 1)
        return carry, diag0, raw, kaux.to(torch.float32).to(dtype)

    def __call__(self, state: SolverState, n_iters: int, start_iter: int,
                 src_ext=None):
        p, meta, step = self.params, self.meta, self.step
        dtype = p.torch_dtype
        ctx = step.ctx
        ca, diag0, raw, kaux = self.prologue(state, n_iters, start_iter)
        cb = torch.empty_like(ca)
        scr = torch.empty((N_SCRATCH,) + ca.shape[1:], dtype=dtype,
                          device=ca.device)
        # general tiles outside the heat tiles read a zero heat source
        scr[SCR_SRCADD_E].zero_()
        part_f = torch.zeros((self.plan.n_tiles, 27), dtype=dtype,
                             device=ca.device)
        part_i = torch.zeros((self.plan.n_tiles, 2), dtype=torch.int32,
                             device=ca.device)

        dt = state.dt
        rms, ddm, dts, uns, ovr = [], [], [], [], []
        for b in range(n_iters - 1):
            dt = scan_dt(carry_views(ca, dt), ctx.active, p, raw.cfl_scen[b])
            # the kernels take dt through float32 too (see prologue)
            dt_k = dt.to(torch.float32).to(dtype)
            step.gfc(ca, cb, scr, dt_k, kaux[b], part_i)
            if step.has_heat:
                step.heat(cb, scr, dt_k)
            step.pass12(ca, cb, scr, dt_k, kaux[b + 1], part_f)
            r, m, u, o = combine(part_f, part_i, p)
            rms.append(r)
            ddm.append(m)
            uns.append(u)
            ovr.append(o)
            dts.append(dt)
            ca, cb = cb, ca

        # epilogue: the final iteration's gfc on the whole grid
        full = expand(carry_views(ca, dt), p, step.zero_src)
        out, dt_new, unstable_last = gfc(full, meta, p, self.chem,
                                         self.aux_at(start_iter + n_iters - 1),
                                         ctx=ctx)
        # beta is the only carry view that passes through gfc unchanged
        out = out.replace(dt=dt_new, y_plus=state.y_plus,
                          beta=out.beta.clone())
        diags = {
            "RMS": lead(diag0["RMS"], rms),
            "dt_used": lead(diag0["dt_used"], dts),
            "DD_max": lead(diag0["DD_max"], ddm),
            "unstable": trail(uns, unstable_last),
            # the epilogue gfc computes a fresh dt (no freeze)
            "dt_overrun": trail(ovr, torch.zeros((), dtype=torch.bool,
                                                 device=ca.device)),
        }
        return out, diags


def make_kernel_chunk(meta: GridMeta, params: SolverParams, chem: ChemTables,
                      beta_tab, cfl_tab, turb_start, spec_map=None,
                      dispatch: str = "lists") -> KernelChunk:
    """The analog of ``make_pallas_chunk(fuse_iters=1)``; ``spec_map`` is
    the host generic-interior map (None: every tile runs the general
    body); ``dispatch`` one of DISPATCH_FORMS."""
    return KernelChunk(meta, params, chem, beta_tab, cfl_tab, turb_start,
                       spec_map, dispatch)
