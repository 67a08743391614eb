"""Case construction: deck -> host grid -> solver configuration.

Counterpart of ``openhyperflow2d_tpu.solver.init`` without jax: the grid
construction is the port's own copy of the JAX package's numpy geometry
code (``geometry/``, ``gasdyn/``, ``config/deck``), and this module
rebuilds ``build_case`` around the port's SolverParams and ChemTables, so a
case builds on a machine that has torch and neither jax nor the JAX
package.  The build order mirrors ``InitSharedData`` / ``InitDEEPS2D``
(libDEEPS2D/deeps2d_core.cpp:160-499, 2835-4682), with the swap-file
resume (``use_swap``) and the non-uniform-mesh maps (``dx_map``/``dy_map``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
from dataclasses import dataclass, field

import numpy as np

from ..config.deck import Deck
from ..config.tables import Table
from ..core import flags as fl
from ..core.state import ChemTables, SolverParams
from ..gasdyn.flow import FV_MACH, FV_VELOCITY, Flow, Flow2D
from ..geometry.areas import fill_area
from ..geometry.bounds import (Bound, BoundContour, parse_cond_string,
                               set_bound, turb_model_id_to_tct)
from ..geometry.grid import HostGrid
from ..geometry.solids import add_airfoil, add_circle, add_rect
from ..geometry.sources import apply_sources, build_source_list
from ..geometry.wall import (get_wall_nodes, set_init_boundary_layer,
                             set_min_distance_to_wall, set_nonreflected_bc,
                             set_wall_nodes)
from ..io_out.swapfile import (NODE_SIZE, grid_from_swap, read_swap_file,
                               swap_size_matches)
from ..spans import span

Y_FUEL = (1.0, 0.0, 0.0, 0.0)
Y_OX = (0.0, 1.0, 0.0, 0.0)
Y_CP = (0.0, 0.0, 1.0, 0.0)
Y_AIR = (0.0, 0.0, 0.0, 1.0)


@dataclass
class ChemData:
    """ChemicalReactionsModelData2D equivalent."""
    K0: float
    gamma: float
    Tf: float
    R: dict
    H: dict
    tables: dict          # {(prop, species): Table}

    def props_at(self, species: int, Tg: float):
        """(Cp, lam, mu, R) for a component index at temperature Tg
        (deeps2d_core.cpp:2937-2981)."""
        names = ["Fuel", "OX", "cp", "air"]
        sp = names[species]
        return (self.tables[("Cp", sp)].get_val(Tg),
                self.tables[("lam", sp)].get_val(Tg),
                self.tables[("mu", sp)].get_val(Tg),
                self.R[sp])

    def mixture_props_at(self, Ymix, Tg: float):
        names = ["Fuel", "OX", "cp", "air"]
        cp = lam = mu = R = 0.0
        for w, sp in zip(Ymix, names):
            cp += w * self.tables[("Cp", sp)].get_val(Tg)
            lam += w * self.tables[("lam", sp)].get_val(Tg)
            mu += w * self.tables[("mu", sp)].get_val(Tg)
            R += w * self.R[sp]
        return cp, lam, mu, R


@dataclass
class MonitorPoint:
    x: float
    y: float
    p: float = 0.0
    T: float = 0.0


@dataclass
class Case:
    """Everything needed to run a deck."""
    deck: Deck
    grid: HostGrid
    params: SolverParams
    chem: ChemData
    flow_list: list
    flow2d_list: list
    wall_nodes: np.ndarray
    dt0: float
    # run control
    Nstep: int
    NOutStep: int
    NSaveStep: int
    MonitorIndex: int
    ExitMonitorValue: float
    monitor_points: list
    beta_scenario: Table
    cfl_scenario: Table
    xcuts: list = field(default_factory=list)
    project_name: str = ""
    is_p_asterisk_out: bool = False
    is_Cx_calc: bool = False
    is_Cd_calc: bool = False
    Cx_params: dict = field(default_factory=dict)
    isVerboseOutput: bool = True
    AddSrcStartIter: int = 0
    sources: list = field(default_factory=list)
    isOutHeatFluxX: bool = False
    isOutHeatFluxY: bool = False
    # HeatFlux-X call-site keys (deeps2d_core.cpp:1796, 2894-2902):
    # Cp_Flow_index selects the normalization flow, y_max/y_min window the
    # per-column wall scan; required (reference aborts) when isOutHeatFluxX
    heatflux_params: dict = field(default_factory=dict)
    isRecalcYplus: bool = False
    # output-file name suffixes: OutFileName = ProjectName + OutputFile,
    # ErrFileName = ProjectName + ErrorFile (deeps2d_core.cpp:2884-2887);
    # the Tecplot transient file is "tp-" + OutFileName (2886)
    output_suffix: str = ".plt"
    error_suffix: str = "-err.plt"
    # swap-file resume (PreloadFlag semantics, deeps2d_core.cpp:3197-3252)
    preloaded: bool = False
    preload_time: float = 0.0
    swap_path: str = ""


def load_chem_data(deck: Deck) -> ChemData:
    """Species thermo/transport tables (deeps2d_core.cpp:379-498)."""
    R = {}
    H = {}
    tables = {}
    for sp in ("Fuel", "OX", "cp", "air"):
        R[sp] = deck.get_float(f"R_{sp}")
        H[sp] = deck.get_float(f"H_{sp}")
        for prop in ("lam", "mu", "Cp"):
            tables[(prop, sp)] = deck.get_table(f"{prop}_{sp}")
    return ChemData(K0=deck.get_float("K0"), gamma=deck.get_float("gamma"),
                    Tf=deck.get_float("Tf"), R=R, H=H, tables=tables)


def load_flows(deck: Deck, chem: ChemData):
    """Flow / Flow2D lists (deeps2d_core.cpp:2862-3164)."""
    flow_list = []
    n_flow = deck.get_int("NumFlow", 0, required=False)
    for i in range(1, n_flow + 1):
        Pg = deck.get_float(f"Flow{i}.p")
        Tg = deck.get_float(f"Flow{i}.T")
        comp = deck.get_int(f"Flow{i}.CompIndex")
        if comp == 4:
            Ymix = [deck.get_float(f"Flow{i}.Y_fuel"),
                    deck.get_float(f"Flow{i}.Y_ox"),
                    deck.get_float(f"Flow{i}.Y_cp"), 0.0]
            # reference computes Y_air = 1 - Y0 + Y1 + Y2 (sic, 2977)
            Ymix[3] = 1 - Ymix[0] + Ymix[1] + Ymix[2]
            Cp, lam, mu, Rg = chem.mixture_props_at(Ymix, Tg)
        else:
            Cp, lam, mu, Rg = chem.props_at(comp, Tg)
        f = Flow(Cp, Tg, Pg, Rg, lam, mu)
        if deck.get_int(f"Flow{i}.Type") == 0:
            f.LAM(deck.get_float(f"Flow{i}.Lam"))
        else:
            f.Wg(deck.get_float(f"Flow{i}.W"))
        flow_list.append(f)

    flow2d_list = []
    n_flow2d = deck.get_int("NumFlow2D", 0, required=False)
    for i in range(1, n_flow2d + 1):
        comp = deck.get_int(f"Flow2D-{i}.CompIndex")
        Pg = deck.get_float(f"Flow2D-{i}.p")
        Tg = deck.get_float(f"Flow2D-{i}.T")
        if comp == 4:
            Ymix = [deck.get_float(f"Flow2D-{i}.Y_fuel"),
                    deck.get_float(f"Flow2D-{i}.Y_ox"),
                    deck.get_float(f"Flow2D-{i}.Y_cp"), 0.0]
            Ymix[3] = 1 - Ymix[0] + Ymix[1] + Ymix[2]
            Cp, lam, mu, Rg = chem.mixture_props_at(Ymix, Tg)
        else:
            Cp, lam, mu, Rg = chem.props_at(comp, Tg)
        Ug = deck.get_float(f"Flow2D-{i}.U")
        Vg = deck.get_float(f"Flow2D-{i}.V")
        mode = deck.get_int(f"Flow2D-{i}.Mode")
        if mode == 2:
            Ug = Vg = 0.0
        f = Flow2D(mu, lam, Cp, Tg, Pg, Rg, Ug, Vg)
        if mode == 0:
            f.correct_flow(Tg, Pg, math.sqrt(Ug * Ug + Vg * Vg + 1.e-30),
                           FV_VELOCITY)
        if mode in (2, 3):
            mach = deck.get_float(f"Flow2D-{i}.Mach")
            angle = deck.get_float(f"Flow2D-{i}.Angle")
            if mode == 2:
                f.correct_flow(Tg, Pg, mach, FV_MACH)
            f.MACH(mach)
            Wg = Flow.Wg(f)
            f.Wg(math.cos(math.radians(angle)) * Wg,
                 math.sin(math.radians(angle)) * Wg)
        flow2d_list.append(f)
    return flow_list, flow2d_list


def comp_index_Y(comp: int, deck: Deck, prefix: str):
    if comp == 0:
        return Y_FUEL
    if comp == 1:
        return Y_OX
    if comp == 2:
        return Y_CP
    if comp == 3:
        return Y_AIR
    y0 = deck.get_float(f"{prefix}.Y_fuel", 0, required=False)
    y1 = deck.get_float(f"{prefix}.Y_ox", 0, required=False)
    y2 = deck.get_float(f"{prefix}.Y_cp", 0, required=False)
    return (y0, y1, y2, 1 - y0 + y1 + y2)


def _resolve_bound_flow(deck: Deck, key_prefix: str, flow_list, flow2d_list):
    """Flow2D index takes precedence over Flow (deeps2d_core.cpp:3458-3491).
    Returns (flow, flow2d, Y)."""
    fi2 = deck.get_int(f"{key_prefix}.Flow2D", 0, required=False)
    if fi2 >= 1 and fi2 <= len(flow2d_list):
        comp = deck.get_int(f"Flow2D-{fi2}.CompIndex")
        return None, flow2d_list[fi2 - 1], comp_index_Y(
            comp, deck, f"Flow2D-{fi2}")
    fi = deck.get_int(f"{key_prefix}.Flow", 0, required=False)
    if fi >= 1 and fi <= len(flow_list):
        comp = deck.get_int(f"Flow{fi}.CompIndex")
        return flow_list[fi - 1], None, comp_index_Y(comp, deck, f"Flow{fi}")
    raise ValueError(f"Bad Flow index for {key_prefix}")


def build_case(deck: Deck, dtype: str = "float64",
               serial_dt_mode: bool = False,
               serial_rms_mode: bool = None,
               use_swap: bool = False, swap_dir: str = ".",
               dx_map=None, dy_map=None) -> Case:
    """Build a Case from a deck.

    With ``use_swap``, the reference's swap-file auto-resume semantics are
    active: if ``<swap_dir>/<ProjectName><GasSwapFile>`` exists with the
    right size it is preloaded (PreloadFlag=1) — the whole node matrix
    comes from the file, the fresh-init blocks (node wipe, solids, areas,
    first-init loop, non-reflected BC scan, initial boundary layer) are
    skipped as the reference's !PreloadFlag guards do
    (deeps2d_core.cpp:3859, 4081, 4166, 4287, 4299, 4510, 4639-4647),
    bound state is re-applied only for bounds whose deck ``.isReset`` key
    is set (3493-3505, 3751-3759), and GlobalTime is restored from
    node(0,0).time (4618-4621).  A file of the wrong size is not read.

    ``dx_map``/``dy_map`` (optional (MaxX, MaxY) arrays) activate the
    non-uniform-mesh mode (per-node dx/dy, hyper_flow_node.hpp:150).  The
    maps feed exactly the code the reference reads FlowNode2D::dx/dy from
    (moving-wall sources, mixing length, Smagorinsky filter width); the
    stencil constants and local dt keep the deck's global dx/dy
    (deeps2d_core.cpp:643-644, 843-844).  Geometry construction is
    index-based and still uses the deck's dx/dy.
    """
    chem = load_chem_data(deck)
    MaxX = deck.get_int("MaxX")
    MaxY = deck.get_int("MaxY")
    dx = deck.get_float("dx")
    dy = deck.get_float("dy")
    ft = deck.get_int("FlowType")
    sm = deck.get_int("ProblemType")
    CFL = deck.get_float("CFL")
    beta0 = deck.get_float("beta")
    nrbc_beta0 = deck.get_float("beta_NonReflectedBC")
    bff = deck.get_int("BFF")
    turb_mod = deck.get_int("TurbulenceModel")
    Ts0 = deck.get_float("Ts0")
    delta_bl = deck.get_float("delta_bl")
    isTurbulenceReset = deck.get_int("isTurbulenceReset")

    params = SolverParams(
        MaxX=MaxX, MaxY=MaxY, dx=dx, dy=dy, ft=ft, sm=sm,
        tem=deck.get_int("TurbExtModel"), bff=bff, beta0=beta0,
        nrbc_beta0=nrbc_beta0, CFL=CFL,
        SigW=deck.get_float("SigW"), SigF=deck.get_float("SigF"),
        delta_bl=delta_bl, K0=chem.K0, gamma_c=chem.gamma, Tf=chem.Tf,
        Ts0=Ts0,
        Hu=(chem.H["Fuel"], chem.H["OX"], chem.H["cp"], chem.H["air"]),
        isAdiabaticWall=bool(deck.get_int("isAdiabaticWall")),
        isAlternateRMS=bool(deck.get_int("isAlternateRMS")),
        TurbStartIter=deck.get_int("TurbStartIter"),
        turb_mod=turb_mod, serial_dt_mode=serial_dt_mode,
        serial_rms_mode=(serial_dt_mode if serial_rms_mode is None
                         else serial_rms_mode), dtype=dtype)

    flow_list, flow2d_list = load_flows(deck, chem)

    grid = HostGrid(MaxX, MaxY, dx, dy, ft=ft,
                    Hu=np.array(params.Hu), Tf=chem.Tf)

    if dx_map is not None or dy_map is not None:
        params = _set_mesh_maps(grid, params, dx_map, dy_map)

    # ---- swap-file preload (LoadSwapFile2D, 3197-3252) ----------------------
    # the reference reads the GasSwapFile suffix key (2882) and maps the
    # node matrix from <ProjectName><suffix> when it exists with the right
    # size; every per-node field then comes from the file.  A file of
    # another size is not read, and a swap write replaces it (the run says
    # so)
    preload = False
    swap_path = ""
    preload_time = 0.0
    if use_swap:
        proj = deck.get_str("ProjectName", "", required=False)
        suffix = deck.get_str("GasSwapFile", ".hf2d", required=False)
        swap_path = os.path.join(swap_dir, f"{proj}{suffix}")
        if swap_size_matches(swap_path, MaxX, MaxY):
            grid_from_swap(grid, read_swap_file(swap_path, MaxX, MaxY))
            preload = True
            preload_time = float(grid.time[0, 0])
        elif os.path.exists(swap_path):
            print(f"Swap file {swap_path!r} holds "
                  f"{os.path.getsize(swap_path)} bytes, not the "
                  f"{MaxX * MaxY * NODE_SIZE} of a {MaxX}x{MaxY} grid: not "
                  f"preloaded (PreloadFlag=0); a swap write overwrites it",
                  flush=True)

    cfl_scenario = deck.get_table("CFL_Scenario")
    beta_scenario = deck.get_table("beta_Scenario")

    def bound_reset(key_prefix: str) -> bool:
        """Per-bound isReset: forced to 1 when no swap was preloaded
        (deeps2d_core.cpp:3493-3496, 3751-3753)."""
        if not preload:
            return True
        return bool(deck.get_int(f"{key_prefix}.isReset", 0,
                                 required=False))

    # ---- SingleBounds (3267-3521) -----------------------------------------
    n_single = deck.get_int("NumSingleBounds", 0, required=False)
    for i in range(1, n_single + 1):
        name = f"SingleBound{i}"
        pts = deck.get_table(f"{name}.Points")
        s_x = max(int(pts.x[0] / dx), 0)
        s_y = max(int(pts.y[0] / dy), 0)
        e_x = max(int(pts.x[1] / dx), 0)
        e_y = max(int(pts.y[1] / dy), 0)
        ct, tct = parse_cond_string(
            deck.get_str(f"{name}.Cond"),
            turb_model_id_to_tct(
                deck.get_int(f"{name}.TurbulenceModel", 0, required=False)))
        if ct == 0:
            raise ValueError(f"Unknown condition type in {name}")
        flow, flow2d, Yb = _resolve_bound_flow(deck, name, flow_list,
                                               flow2d_list)
        if not bound_reset(name):
            # flags (and Y) still applied; field state kept from the swap
            # (reference nulls the flow pointers, 3505-3506)
            flow = flow2d = None
        set_bound(grid, Bound((s_x, s_y), (e_x, e_y), ct, tct, flow, flow2d,
                              Yb, name))

    # ---- Contours (3523-3803) ---------------------------------------------
    n_contour = deck.get_int("NumContour", 0, required=False)
    for jc in range(1, n_contour + 1):
        cname = f"Contour{jc}"
        ctab = deck.get_table(cname)
        ix = max(int(ctab.x[0] / dx), 0)
        iy = max(int(ctab.y[0] / dy - 1), 0)
        bc = BoundContour(grid, ix, iy, cname)
        npts = ctab.n
        last_args = None
        for i in range(1, npts + 1):
            cond = deck.get_str(f"{cname}.Bound{i}.Cond")
            ct, tct = parse_cond_string(
                cond,
                turb_model_id_to_tct(
                    deck.get_int(f"{cname}.Bound{i}.TurbulenceModel", 0,
                                 required=False)))
            if ct == 0 and tct == 0:
                raise ValueError(f"Unknown condition in {cname}.Bound{i}")
            flow, flow2d, Yb = _resolve_bound_flow(
                deck, f"{cname}.Bound{i}", flow_list, flow2d_list)
            if not bound_reset(f"{cname}.Bound{i}"):
                flow = flow2d = None
            last_args = (ct, flow, flow2d, Yb, tct)
            if i < npts:
                bx = max(int(ctab.x[i] / dx), 0)
                by = max(int(ctab.y[i] / dy - 1), 0)
                bc.add_bound(bx, by, ct, flow, flow2d, Yb, tct,
                             name=f"{cname}.Bound{i}")
        ct, flow, flow2d, Yb, tct = last_args
        bc.close_contour(ct, flow, flow2d, Yb, tct,
                         name=f"{cname}.Bound{npts}")
        if not bc.is_closed():
            raise ValueError(f"{cname} is not looped")
        bc.set_bounds()

    # ---- XCuts ------------------------------------------------------------
    xcuts = []
    for i in range(1, deck.get_int("NumXCut", 0, required=False) + 1):
        xcuts.append((deck.get_float(f"CutX-{i}.x0"),
                      deck.get_float(f"CutX-{i}.y0"),
                      deck.get_float(f"CutX-{i}.dy")))

    # ---- initial dt from the flow lists (3845-3857) ------------------------
    dt0 = 1.0
    cfl_min0 = min(CFL, cfl_scenario.get_val(0))
    for f in flow_list + flow2d_list:
        a = f.Asound()
        w = Flow.Wg(f) if isinstance(f, Flow2D) else f.Wg()
        dt0 = min(dt0, cfl_min0 * min(dx / (a + w), dy / (a + w)))

    # ---- node wipe loop (3859-3887): clobbers bound cosines ----------------
    grid.Tf = chem.Tf
    if not preload:
        grid.BGX[:] = 1.0
        grid.BGY[:] = 1.0
        grid.NGX[:] = 0
        grid.NGY[:] = 0
        grid.Src[:] = 0.0

    # ---- solid primitives (4000-4297; skipped on preload: 4081/4166/4287) --
    if not preload:
        for i in range(1, deck.get_int("NumRects", 0, required=False) + 1):
            add_rect(grid, deck, f"Rect{i}", flow_list, flow2d_list)
        for i in range(1, deck.get_int("NumCircles", 0,
                                       required=False) + 1):
            add_circle(grid, deck, f"Circle{i}", flow_list, flow2d_list)
        for i in range(1, deck.get_int("NumAirfoils", 0,
                                       required=False) + 1):
            add_airfoil(grid, deck, f"Airfoil{i}", flow_list, flow2d_list)

    # ---- areas (4298-4508) --------------------------------------------------
    # The reference flood fill runs a FULL FillNode2D(is_mu_t=1, is_init=0)
    # on every filled gas node (hyper_flow_area.cpp:174) under the AREA's
    # turbulence model — populating A/B for the turbulence equations with
    # the fill-time state (l_min still 0, gradients 0).  A later
    # isTurbulenceReset re-flags the model and zeroes S/Src/mu_t for eqs 7-8
    # but NOT A/B (deeps2d_core.cpp:2196-2204) — stale area-model fluxes
    # persist into the first iterations (and, when the area model differs
    # from the run model, e.g. k-eps area + SA run, destabilize the run
    # exactly as the reference does).  ``full_fill_mask`` records the nodes
    # that received the full fill so the staged A/B planes can be computed
    # below, just before the reset.
    full_fill_mask = np.zeros((MaxX, MaxY), bool)
    n_area = 0 if preload else deck.get_int("NumArea", 0, required=False)
    for i in range(1, n_area + 1):
        aname = f"Area{i}"
        atab = deck.get_table(aname)
        seed_x, seed_y = int(atab.x[0]), int(atab.y[0])
        atype = deck.get_int(f"{aname}.Type", 1, required=False)
        if atype == 0:   # solid area
            fill_area(grid, seed_x, seed_y, fl.CT_SOLID_2D)
        else:
            fi2 = deck.get_int(f"{aname}.Flow2D", 0, required=False)
            if fi2 >= 1:
                comp = deck.get_int(f"Flow2D-{fi2}.CompIndex")
                Yb = comp_index_Y(comp, deck, f"Flow2D-{fi2}")
                tct = turb_model_id_to_tct(
                    deck.get_int(f"{aname}.TurbulenceModel", 0,
                                 required=False))
                full_fill_mask |= fill_area(grid, seed_x, seed_y, 0,
                                            flow2d_list[fi2 - 1], Yb, tct)
            else:
                fi = deck.get_int(f"{aname}.Flow", 0, required=False)
                comp = deck.get_int(f"Flow{fi}.CompIndex")
                Yb = comp_index_Y(comp, deck, f"Flow{fi}")
                tct = turb_model_id_to_tct(
                    deck.get_int(f"{aname}.TurbulenceModel", 0,
                                 required=False))
                full_fill_mask |= fill_area(grid, seed_x, seed_y, 0,
                                            Flow2D(flow=flow_list[fi - 1]),
                                            Yb, tct)

    # ---- first-initialization loop (4510-4571; skipped on preload) ----------
    if not preload:
        solid = grid.is_cond(fl.CT_SOLID_2D)
        grid.idXl[:] = 1
        grid.idXr[:] = 1
        grid.idYu[:] = 1
        grid.idYd[:] = 1
        grid.l_min[:] = min(dx * MaxX, dy * MaxY)
        grid.beta[:] = beta0
        grid.idYd[:, 0] = 0
        grid.idYd[:, 1:] &= np.uint8(1) - solid[:, :-1].astype(np.uint8)
        grid.idYu[:, -1] = 0
        grid.idYu[:, :-1] &= np.uint8(1) - solid[:, 1:].astype(np.uint8)
        grid.idXl[0, :] = 0
        grid.idXl[1:, :] &= np.uint8(1) - solid[:-1, :].astype(np.uint8)
        grid.idXr[-1, :] = 0
        grid.idXr[:-1, :] &= np.uint8(1) - solid[1:, :].astype(np.uint8)

        wall = (grid.is_cond(fl.CT_WALL_NO_SLIP_2D)
                | grid.is_cond(fl.CT_WALL_LAW_2D))
        ngx = (grid.idXl.astype(np.int8) - grid.idXr.astype(np.int8)
               + (grid.idXl * grid.idXr).astype(np.int8))
        ngy = (grid.idYd.astype(np.int8) - grid.idYu.astype(np.int8)
               + (grid.idYd * grid.idYu).astype(np.int8))
        grid.NGX[wall] = ngx[wall]
        grid.NGY[wall] = ngy[wall]

        if not deck.get_int("isIgnoreUnsetNodes", 0, required=False):
            unset = ~grid.is_cond(fl.CT_NODE_IS_SET_2D)
            if unset.any():
                i, j = np.argwhere(unset)[0]
                raise ValueError(
                    f"Node ({i},{j}) has not CT_NODE_IS_SET flag — "
                    f"possible missing Area objects")

        grid.Tg[solid] = Ts0
        grid.Tg[(grid.p == 0.0)] = Ts0

    # ---- Cx/Cy + Cd/Cv probe windows (3968-3998) ----------------------------
    cx_params = {}
    if deck.get_int("is_Cx_calc", 0, required=False):
        cx_params["x0_body"] = deck.get_float("x_body")
        cx_params["y0_body"] = deck.get_float("y_body")
        cx_params["dx_body"] = deck.get_float("dx_body")
        cx_params["dy_body"] = deck.get_float("dy_body")
        cx_params["Cx_Flow_index"] = deck.get_int("Cx_Flow_Index")
    if deck.get_int("is_Cd_calc", 0, required=False):
        cx_params["x0_nozzle"] = deck.get_float("x_nozzle")
        cx_params["y0_nozzle"] = deck.get_float("y_nozzle")
        cx_params["dy_nozzle"] = deck.get_float("dy_nozzle")
        cx_params["Cd_Flow_index"] = deck.get_int("Cd_Flow_Index")
        cx_params["p_ambient"] = deck.get_float("p_ambient")

    # ---- HeatFlux-X window (deeps2d_core.cpp:2894-2902: read iff
    # isOutHeatFluxX, abort when missing — all three are required) ---------
    heatflux_params = {}
    if deck.get_int("isOutHeatFluxX", 0, required=False):
        heatflux_params["Cp_Flow_index"] = deck.get_int("Cp_Flow_Index")
        heatflux_params["y_max"] = deck.get_int("y_max")
        heatflux_params["y_min"] = deck.get_int("y_min")

    # ---- wall scan / decomposition bookkeeping (4625-4650) ------------------
    if sm == fl.SM_NS:
        set_wall_nodes(grid)
    # ---- fill-time turbulence fluxes (hyper_flow_area.cpp:174) --------------
    # Replays the A/B planes the reference's per-node FillNode2D(1) left for
    # the turbulence equations: at fill time all gradients are zero and
    # l_min=0 (l = min(dx,dy)*0.41), so A7=Sk*U, B7=Sk*V, A8=Se*U, B8=Se*V
    # with Sk = 1.5*(I*|W|)^2*rho, Se = C_mu^0.75*(Sk/rho)^1.5/l (k-eps
    # areas, hyper_flow_node.hpp:786-800) and A7=Snu*U, B7=Snu*V with
    # Snu = mu/rho/100 (SA areas, hpp:899-908).  The Src[7..8] the fill also
    # leaves behind are always wiped by the reset below (all runnable
    # reference decks set isTurbulenceReset=1), so they are not staged.
    m_gas = full_fill_mask & ~grid.is_cond(fl.CT_SOLID_2D)
    if sm == fl.SM_NS and m_gas.any():
        init_A = np.zeros((fl.NUM_EQ, MaxX, MaxY))
        init_B = np.zeros((fl.NUM_EQ, MaxX, MaxY))
        rho_f = grid.S[fl.i2d_Rho]
        rho_sf = np.where(rho_f != 0, rho_f, 1.0)
        U_f = grid.S[fl.i2d_RhoU] / rho_sf
        V_f = grid.S[fl.i2d_RhoV] / rho_sf
        m_ke = m_gas & ((grid.TCT & fl.TCT_k_eps_Model_2D) != 0)
        m_sa_f = (m_gas & ((grid.TCT & fl.TCT_Spalart_Allmaras_Model_2D) != 0)
                  & ~m_ke)
        w2 = U_f * U_f + V_f * V_f + 1.e-30
        tmpI = 0.005 * np.sqrt(w2)            # FlowNodeTurbulence2D::I
        Sk_f = 1.5 * tmpI * tmpI * rho_f
        l_fill = min(dx, dy) * 0.41
        Se_f = 0.09 ** 0.75 * np.maximum(Sk_f / rho_sf, 0.0) ** 1.5 / l_fill
        init_A[fl.i2d_k][m_ke] = (Sk_f * U_f)[m_ke]
        init_B[fl.i2d_k][m_ke] = (Sk_f * V_f)[m_ke]
        init_A[fl.i2d_eps][m_ke] = (Se_f * U_f)[m_ke]
        init_B[fl.i2d_eps][m_ke] = (Se_f * V_f)[m_ke]
        if m_sa_f.any():
            Snu_f = grid.mu / rho_sf / 100.0
            init_A[fl.i2d_nu_t][m_sa_f] = (Snu_f * U_f)[m_sa_f]
            init_B[fl.i2d_nu_t][m_sa_f] = (Snu_f * V_f)[m_sa_f]
        grid.extras["init_A"] = init_A
        grid.extras["init_B"] = init_B

    # ScanArea turbulence reset (2165-2205)
    active = grid.is_cond(fl.CT_NODE_IS_SET_2D) & ~grid.is_cond(
        fl.CT_SOLID_2D)
    grid.CT[active] |= fl.CT_NODE_IS_SET_2D
    if isTurbulenceReset and sm == fl.SM_NS:
        tm = turb_model_id_to_tct(turb_mod)
        clear = (fl.TCT_Integral_Model_2D | fl.TCT_Prandtl_Model_2D
                 | fl.TCT_Spalart_Allmaras_Model_2D | fl.TCT_k_eps_Model_2D
                 | fl.TCT_Smagorinsky_Model_2D)
        grid.TCT &= ~np.int64(clear)
        grid.TCT |= tm
        grid.S[fl.i2d_k][:] = 0.0
        grid.S[fl.i2d_eps][:] = 0.0
        grid.Src[fl.i2d_k][:] = 0.0
        grid.Src[fl.i2d_eps][:] = 0.0
        grid.mu_t[:] = 0.0
        grid.lam_t[:] = 0.0

    # ---- gas sources -------------------------------------------------------
    sources = build_source_list(deck, chem, grid)
    if sources:
        apply_sources(grid, sources, 0)

    if not preload:
        set_nonreflected_bc(grid)     # skipped on preload (4639-4642)

    wall_nodes = np.zeros((0, 2), np.int32)
    if sm == fl.SM_NS:
        if not preload:
            set_init_boundary_layer(grid, delta_bl)   # InitDEEPS2D:4647
            # (l_min still the domain-size init here, as in the reference)
        wall_nodes = get_wall_nodes(grid)
        with span("case.wall_distance", wall_nodes=len(wall_nodes)):
            set_min_distance_to_wall(grid, wall_nodes)
        recalc_y_plus(grid)
        if not preload:
            set_init_boundary_layer(grid, delta_bl)   # hf2d_start.cpp:132

    monitor_points = []
    for i in range(1, deck.get_int("NumMonitorPoints", 0,
                                   required=False) + 1):
        mx = deck.get_float(f"Point-{i}.X")
        my = deck.get_float(f"Point-{i}.Y")
        if 0 <= mx <= MaxX * dx and 0 <= my <= MaxY * dy:
            monitor_points.append(MonitorPoint(mx, my))

    # ---- static specialization: which turbulence-model / wall code paths
    # can any node of THIS case reach?  The stages skip the others.
    models = []
    if (grid.TCT & np.int64(fl.TCT_Prandtl_Model_2D)).any():
        models.append("prandtl")
    if (grid.TCT & np.int64(fl.TCT_k_eps_Model_2D)).any():
        models.append("keps")
    if (grid.TCT & np.int64(fl.TCT_Spalart_Allmaras_Model_2D)).any():
        models.append("sa")
    if (grid.TCT & np.int64(fl.TCT_Smagorinsky_Model_2D)).any():
        models.append("smag")
    has_walls = bool(grid.is_cond(fl.CT_WALL_NO_SLIP_2D).any()
                     | grid.is_cond(fl.CT_WALL_LAW_2D).any())
    # 2nd-order soft-BC flags (pass-1 dSdx/dSdy averaging branch)
    d2x_ct = fl.CT_d2Ydx2_NULL_2D
    d2y_ct = fl.CT_d2Ydy2_NULL_2D
    for k in range(4):
        d2x_ct |= fl.CT_d2Rhodx2_NULL_2D << k
        d2y_ct |= fl.CT_d2Rhody2_NULL_2D << k
    d2_tct_x = fl.TCT_d2kdx2_NULL_2D | (fl.TCT_d2kdx2_NULL_2D << 1)
    d2_tct_y = fl.TCT_d2kdy2_NULL_2D | (fl.TCT_d2kdy2_NULL_2D << 1)
    has_d2x = bool(((grid.CT & np.int64(d2x_ct)) != 0).any()
                   or ((grid.TCT & np.int64(d2_tct_x)) != 0).any())
    has_d2y = bool(((grid.CT & np.int64(d2y_ct)) != 0).any()
                   or ((grid.TCT & np.int64(d2_tct_y)) != 0).any())
    has_nrbc = bool((grid.CT & np.int64(fl.CT_NONREFLECTED_2D)).any())
    # strictly-ascending chem tables take the exact telescoped fast path
    chem_asc = tuple(
        f"{prop}_{sp}" for prop in ("Cp", "lam", "mu")
        for sp in ("Fuel", "OX", "cp", "air")
        if chem.tables[(prop, sp)].n >= 2
        and bool(np.all(np.diff(chem.tables[(prop, sp)].x) > 0)))
    params = dataclasses.replace(params, models=tuple(models),
                                 has_walls=has_walls,
                                 has_d2x=has_d2x, has_d2y=has_d2y,
                                 has_nrbc=has_nrbc,
                                 has_ext_src=bool(sources),
                                 chem_asc=chem_asc)

    return Case(
        deck=deck, grid=grid, params=params, chem=chem,
        flow_list=flow_list, flow2d_list=flow2d_list,
        wall_nodes=wall_nodes, dt0=dt0,
        # InitSharedData: if NOutStep >= Nmax, Nstep = NOutStep+1 (275-276)
        Nstep=(deck.get_int("Nmax")
               if deck.get_int("Nmax") > max(deck.get_int("NOutStep"), 1)
               else max(deck.get_int("NOutStep"), 1) + 1),
        NOutStep=max(deck.get_int("NOutStep"), 1),
        NSaveStep=deck.get_int("NSaveStep"),
        MonitorIndex=deck.get_int("MonitorIndex"),
        ExitMonitorValue=deck.get_float("ExitMonitorValue"),
        monitor_points=monitor_points,
        beta_scenario=beta_scenario, cfl_scenario=cfl_scenario,
        xcuts=xcuts, project_name=deck.get_str("ProjectName", "",
                                               required=False),
        output_suffix=deck.get_str("OutputFile", ".plt", required=False),
        error_suffix=deck.get_str("ErrorFile", "-err.plt", required=False),
        is_p_asterisk_out=bool(deck.get_int("is_p_asterisk_out", 0,
                                            required=False)),
        is_Cx_calc=bool(deck.get_int("is_Cx_calc", 0, required=False)),
        is_Cd_calc=bool(deck.get_int("is_Cd_calc", 0, required=False)),
        Cx_params=cx_params,
        isVerboseOutput=bool(deck.get_int("isVerboseOutput", 1,
                                          required=False)),
        AddSrcStartIter=deck.get_int("AddSrcStartIter", 0, required=False),
        sources=sources,
        isOutHeatFluxX=bool(deck.get_int("isOutHeatFluxX", 0,
                                         required=False)),
        isOutHeatFluxY=bool(deck.get_int("isOutHeatFluxY", 0,
                                         required=False)),
        heatflux_params=heatflux_params,
        isRecalcYplus=bool(deck.get_int("isRecalcYplus", 0,
                                        required=False)),
        preloaded=preload, preload_time=preload_time, swap_path=swap_path)


def _set_mesh_maps(grid: HostGrid, params: SolverParams, dx_map,
                   dy_map) -> SolverParams:
    """Check the per-node spacing maps (shape (MaxX, MaxY), positive; a
    missing one is the deck's spacing), put them into ``grid.extras`` and
    return the params of a non-uniform mesh."""
    X, Y = params.MaxX, params.MaxY
    dx_map = (np.full((X, Y), params.dx) if dx_map is None
              else np.asarray(dx_map, np.float64))
    dy_map = (np.full((X, Y), params.dy) if dy_map is None
              else np.asarray(dy_map, np.float64))
    if dx_map.shape != (X, Y) or dy_map.shape != (X, Y):
        raise ValueError(f"dx_map/dy_map must be ({X}, {Y}) node-spacing "
                         f"maps")
    if (dx_map <= 0).any() or (dy_map <= 0).any():
        raise ValueError("dx_map/dy_map entries must be positive")
    grid.extras["dx_map"] = dx_map
    grid.extras["dy_map"] = dy_map
    return dataclasses.replace(params, uniform_mesh=False)


def with_mesh_maps(case: Case, dx_map=None, dy_map=None) -> Case:
    """``case`` on a non-uniform mesh: what ``build_case(deck, dx_map=,
    dy_map=)`` returns, from a case built without the maps (they enter no
    part of the geometry, which is index-based).  The grid is a shallow
    copy whose ``extras`` hold the maps; ``case`` is left as it was."""
    grid = copy.copy(case.grid)
    grid.extras = dict(case.grid.extras)
    params = _set_mesh_maps(grid, case.params, dx_map, dy_map)
    return dataclasses.replace(case, grid=grid, params=params)


def recalc_y_plus(grid: HostGrid) -> None:
    """Serial Recalc_y_plus (deeps2d_core.cpp:2364-2388)."""
    active = (grid.is_cond(fl.CT_NODE_IS_SET_2D)
              & ~grid.is_cond(fl.CT_SOLID_2D))
    iw = grid.i_wall
    jw = grid.j_wall
    tau_w = (np.abs(grid.extras.get("dUdy", np.zeros_like(grid.U))[iw, jw])
             + np.abs(grid.extras.get("dVdx",
                                      np.zeros_like(grid.U))[iw, jw])) \
        * grid.mu[iw, jw]
    rho_w = grid.S[fl.i2d_Rho][iw, jw]
    ok = active & (rho_w > 0) & (tau_w > 0)
    u_w = np.sqrt(np.where(rho_w > 0, tau_w / np.where(rho_w > 0, rho_w, 1),
                           0.0) + 1e-30)
    mind = min(grid.dx, grid.dy)
    mu_s = np.where(grid.mu != 0, grid.mu, 1)
    yp = np.abs(u_w * mind * grid.S[fl.i2d_Rho] / mu_s)
    grid.y_plus = np.where(ok, yp, np.where(active, 0.0, grid.y_plus))


def chem_tables_device(chem: ChemData, dtype, device=None) -> ChemTables:
    return ChemTables.from_tables(chem.R, chem.tables, dtype=dtype,
                                  device=device)
