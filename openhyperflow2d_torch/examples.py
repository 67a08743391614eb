"""Programmatic example decks (uniform stream, shock layer, benchmark cases).

These build deck *text* in the reference format, so the whole pipeline
(parser -> geometry -> solver) is exercised even for synthetic cases.
"""

from __future__ import annotations

from .config.deck import Deck, parse_deck

AIR_TABLES = """
<data/H_cp=0.0>
<data/R_cp=428.59>
<table=lam_cp/2>
300. 0.026
3000. 0.38
<endtable>
<table=mu_cp/2>
300. 1.8e-5
3000. 9e-5
<endtable>
<table=Cp_cp/2>
300. 1557.
3000. 1924.
<endtable>
<data/H_Fuel=0.0>
<data/R_Fuel=4157.0>
<table=lam_Fuel/2>
220. 0.15
1000. 0.45
<endtable>
<table=mu_Fuel/2>
20. 2.5e-6
2000. 33.6e-6
<endtable>
<table=Cp_Fuel/2>
20. 10000.
1500. 16050.
<endtable>
<data/H_OX=0.0>
<data/R_OX=290.0>
<table=lam_OX/2>
200. 0.018
1800. 0.116
<endtable>
<table=mu_OX/2>
200. 1.3e-5
1800. 6e-5
<endtable>
<table=Cp_OX/2>
200. 1052.
1800. 1398.
<endtable>
<data/H_air=0.>
<data/R_air=287.05>
<table=lam_air/2>
90. 0.015
3500. 0.17341
<endtable>
<table=mu_air/2>
90. 5.0e-6
3500. 93.149e-6
<endtable>
<table=Cp_air/2>
90. 1004.
3500. 1004.
<endtable>
"""


def channel_deck(nx: int = 64, ny: int = 64, u: float = 500.0,
                 v: float = 0.0, problem_type: int = 0, turb_model: int = 0,
                 turb_ext_model: int = 0, flow_type: int = 0,
                 mach2_v: float = None, cfl: float = 0.5,
                 beta: float = 0.98, bff: int = 4, nmax: int = 100,
                 with_rect: bool = False,
                 wall_bottom: bool = False,
                 step_bottom: bool = False) -> Deck:
    """A supersonic channel: inflow at x=0 and (optionally deflected) top
    stream, D0X outflow, D0Y bottom — the ObliqueShock topology at an
    arbitrary size.  Optionally drops a solid rectangle into the stream
    (duct-narrowing / bluff-body benchmark config); ``wall_bottom`` turns
    the bottom boundary into a no-slip wall (flat-plate configuration for
    the Stanton-correlation validation, out_cfd_param.cpp:536-547);
    ``step_bottom`` carves a forward-facing solid step out of the contour
    the way Wedge.dat carves its wedge (wall bounds with
    TCT_eps_Cmk2kXn_WALL + a Type=0 solid Area fill) — the walls+solid
    +conjugate-heat configuration that k-eps supports (a bare
    SolidBoundRect2D sets TCT_eps_mud2kdy2_WALL, which TurbModRANS2D
    never reads — reference quirk, hyper_flow_node.hpp:765-779 — so eps
    is unpinned at rect walls and diverges)."""
    dx = dy = 0.01
    lx, ly = nx * dx, ny * dy
    v2 = mach2_v if mach2_v is not None else v
    # k-eps no-slip walls need the eps wall treatment (eps pinned from k,
    # TCT_eps_Cmk2kXn_WALL) exactly like the shipped Wedge deck's wedge
    # surface — without it the wall-adjacent eps source term
    # C2eps*eps^2/k is numerically unbounded as k->0 at the wall
    wall_bc = ("NT_WNS_2D, TCT_eps_Cmk2kXn_WALL_2D" if turb_model == 4
               else "NT_WNS_2D")
    bc_bottom = (wall_bc if wall_bottom
                 else "NT_D0Y_2D, CT_V_CONST_2D")

    def bounds_block(conds, flows):
        out = []
        for b, (c, fw) in enumerate(zip(conds, flows), start=1):
            out += [f"<data/Contour1.Bound{b}.Cond={c}>",
                    f"<data/Contour1.Bound{b}.Flow2D={fw}>",
                    f"<data/Contour1.Bound{b}.TurbulenceModel={turb_model}>",
                    f"<data/Contour1.Bound{b}.isReset=0>"]
        return "\n".join(out)

    if step_bottom:
        # forward-facing step carved from the contour (Wedge.dat pattern:
        # wall bounds + Type=0 solid area fill inside the cut-off corner)
        xs, h = 0.75 * lx, 0.25 * ly
        pts = [(0.0, ly), (lx, ly), (lx, h), (xs, h), (xs, 0.0),
               (0.0, 0.0)]
        conds = ["NT_FC_2D",                                   # top stream
                 "NT_D0X_2D, TCT_dkdx_NULL_2D, TCT_depsdx_NULL_2D",
                 wall_bc,                                      # step top
                 wall_bc,                                      # step face
                 bc_bottom,                                    # bottom
                 "NT_FC_2D"]                                   # inlet
        flows = [2, 1, 1, 1, 1, 1]
        pts_txt = "\n".join(f"{x} {y}" for (x, y) in pts)
        seed_i = int(xs / dx) + max(2, int(0.05 * nx))
        seed_j = max(1, int(h / dy) // 2)
        contour_block = f"""<data/NumContour=1>
<table=Contour1/{len(pts)}>
{pts_txt}
<endtable>
<data/Contour1.MaterialID=0>
{bounds_block(conds, flows)}
<data/NumArea=2>
<table=Area1/1>
3 3
<endtable>
<data/Area1.Type=1>
<data/Area1.Flow2D=1>
<data/Area1.TurbulenceModel={turb_model}>
<data/Area1.MaterialID=0>
<table=Area2/1>
{seed_i} {seed_j}
<endtable>
<data/Area2.Type=0>
<data/Area2.MaterialID=1>"""
    else:
        conds = ["NT_FC_2D", "NT_D0X_2D", bc_bottom, "NT_FC_2D"]
        flows = [2, 1, 1, 1]
        contour_block = f"""<data/NumContour=1>
<table=Contour1/4>
0.0   {ly}
{lx} {ly}
{lx} 0.0
0.0   0.0
<endtable>
<data/Contour1.MaterialID=0>
{bounds_block(conds, flows)}
<data/NumArea=1>
<table=Area1/1>
3 3
<endtable>
<data/Area1.Type=1>
<data/Area1.Flow2D=1>
<data/Area1.TurbulenceModel={turb_model}>"""
    rect = ""
    nrects = 0
    if with_rect:
        nrects = 1
        rect = f"""
<data/Rect1.Xstart={lx * 0.3}>
<data/Rect1.Ystart=0.0>
<data/Rect1.DX={lx * 0.1}>
<data/Rect1.DY={ly * 0.25}>
<data/Rect1.Flow2D=1>
<data/Rect1.TurbulenceModel={turb_model}>
"""
    text = f"""
<start/Channel>
<data/ProjectName=Channel>
<data/isVerboseOutput=0>
<data/BFF={bff}>
<data/MaxX={nx}>
<data/MaxY={ny}>
<data/dx={dx}>
<data/dy={dy}>
<data/SigW=1.0>
<data/SigF=1.0>
<data/delta_bl=0.05>
<data/TurbulenceModel={turb_model}>
<data/TurbStartIter=2>
<data/TurbExtModel={turb_ext_model}>
<data/isTurbulenceReset=1>
<data/FlowType={flow_type}>
<data/ProblemType={problem_type}>
<data/CFL={cfl}>
<table=CFL_Scenario/1>
0 {cfl}
<endtable>
<data/NSaveStep=1>
<data/Nmax={nmax}>
<data/NOutStep=10>
<data/isAlternateRMS=1>
<data/isIgnoreUnsetNodes=0>
<data/MonitorIndex=5>
<data/ExitMonitorValue=1.0>
<data/NumMonitorPoints=0>
<data/beta={beta}>
<data/beta_NonReflectedBC=0.25>
<table=beta_Scenario/1>
0 {beta}
<endtable>
<data/K0=34.>
<data/gamma=0.>
<data/Tf=1000.>
<data/isAdiabaticWall=1>
{AIR_TABLES}
<data/Ts0=300.>
<data/NumFlow=0>
<data/NumFlow2D=2>
<data/Flow2D-1.CompIndex=3>
<data/Flow2D-1.Mode=0>
<data/Flow2D-1.p=100000.0>
<data/Flow2D-1.T=300.0>
<data/Flow2D-1.U={u}>
<data/Flow2D-1.V={v}>
<data/Flow2D-2.CompIndex=3>
<data/Flow2D-2.Mode=0>
<data/Flow2D-2.p=200000.0>
<data/Flow2D-2.T=350.0>
<data/Flow2D-2.U={u * 0.9}>
<data/Flow2D-2.V={v2}>
<data/NumRects={nrects}>
{rect}
<data/NumCircles=0>
<data/NumSingleBounds=0>
<data/NumAirfoils=0>
{contour_block}
<data/InitTime=0.>
<data/NumSrc=0>
<data/NumXCut=0>
<data/is_Cx_calc=0>
<data/is_Cd_calc=0>
<data/isOutHeatFluxX=0>
<data/isOutHeatFluxY=0>
<data/is_p_asterisk_out=0>
<data/isSingleGPU=0>
<data/ActiveSingleGPU=0>
<data/ThreadBlockSize=0>
<data/isRecalcYplus=0>
<data/GasSwapFile=.hf2d>
<data/OutputFile=.plt>
<data/ErrorFile=-err.plt>
<end/Channel>
"""
    return parse_deck(text)


def wall_channel_deck(nx: int, ny: int, turb_model: int,
                      turb_ext_model: int, delta_bl: float = 0.2) -> Deck:
    """An NS channel at 300 m/s with a no-slip bottom wall (Bound3), the
    turbulence deck of the JAX package's tests/test_turbulence_models.py
    (``_wall_channel``) at any size: ``turb_model`` is the deck's
    TurbulenceModel (2 the Prandtl family, 3 Spalart-Allmaras, 4 k-eps, 5
    Smagorinsky), ``turb_ext_model`` its TurbExtModel (the closure),
    ``delta_bl`` the boundary-layer thickness Escudier's and Klebanoff's
    lengths read."""
    d = channel_deck(nx=nx, ny=ny, u=300.0, problem_type=1,
                     turb_model=turb_model, turb_ext_model=turb_ext_model,
                     cfl=0.05, beta=0.95)
    d.data["Contour1.Bound3.Cond"] = "NT_WNS_2D"
    d.data["delta_bl"] = str(delta_bl)
    return d


def freestream_deck(problem_type: int = 0, u: float = 500.0, v: float = 0.0,
                    nx: int = 16, ny: int = 16) -> Deck:
    """Uniform stream with FC boundaries on all four sides."""
    d = channel_deck(nx=nx, ny=ny, u=u, v=v, problem_type=problem_type)
    # make all four bounds the same uniform flow
    for b in range(1, 5):
        d.data[f"Contour1.Bound{b}.Cond"] = "NT_FC_2D"
        d.data[f"Contour1.Bound{b}.Flow2D"] = "1"
    return d


def reacting_rans_deck(nx: int, ny: int, turb_model: int = 4,
                       turb_ext_model: int = 4, cfl: float = 0.25,
                       wall_bottom: bool = False,
                       adiabatic: bool = True,
                       with_step: bool = False) -> Deck:
    """Benchmark case: reacting (fuel stream + hot oxidizer coflow) RANS
    channel, the headline perf config (BASELINE.md).

    ``wall_bottom=True, adiabatic=False, with_step=True`` is the walls-on
    bench variant: a no-slip bottom wall plus a contour-carved solid step
    with conjugate heat flux — the full Wedge-class physics (wall
    law/no-slip + CalcHeatOnWallSources against the solid's nodes + sigma
    weighting, hyper_flow_node.hpp:447-488, deeps2d_core.cpp:2679-2833)
    at benchmark scale (a boundary-edge wall alone has no solid neighbor,
    so the conjugate-heat stage needs the solid; see channel_deck's
    step_bottom note on why a Rect solid cannot host k-eps walls)."""
    d = channel_deck(nx=nx, ny=ny, u=600.0, v=0.0, problem_type=1,
                     turb_model=turb_model, turb_ext_model=turb_ext_model,
                     cfl=cfl, beta=0.95, nmax=100,
                     wall_bottom=wall_bottom, step_bottom=with_step)
    # fuel-rich hot top stream ignites against oxidizer interior.
    # NOTE (round 5): this wall-less configuration is only a VALID solve
    # up to ~512^2 — without walls l_min defaults to the domain extent,
    # so the k-eps length scales grow with the grid and the implied
    # viscous dt limit (dx^2/4nu_eff) drops below the reference's
    # convective-only dt from ~1024^2 (Tg<0 on BOTH paths at any CFL;
    # the reference's own abort contract would fire identically).  The
    # HEADLINE benchmark is combustor_deck below — wall-bounded, flame
    # near the wall, valid at 4096^2.  This deck remains for the
    # small-grid correctness tests.
    d.data["Flow2D-2.CompIndex"] = "0"   # fuel
    d.data["Flow2D-2.T"] = "1400."
    d.data["Flow2D-1.CompIndex"] = "1"   # oxidizer
    if not adiabatic:
        d.data["isAdiabaticWall"] = "0"
    return d


def combustor_deck(nx: int, ny: int, cfl: float = 0.2,
                   with_step: bool = False,
                   adiabatic: bool = True,
                   bluff_body: bool = False) -> Deck:
    """Headline benchmark (round 5): wall-bounded reacting RANS
    combustor, valid as a SOLVE at 4096^2.

    Geometry: a channel with no-slip top/bottom walls (k-eps wall
    treatment, TCT_eps_Cmk2kXn_WALL like the shipped Wedge deck), a
    split inlet on the left — hot fuel (1400 K > Tf) in the band next to
    the bottom wall, oxidizer above — and D0X outflow.  The flame sheet
    then sits where the wall distance (and so the k-eps length scale) is
    SMALL, and l_min is bounded by the channel half-height everywhere,
    so the turbulence viscosity stays inside the convective-dt stability
    envelope at any grid size — unlike the wall-less reacting_rans_deck
    whose l_min (and mu_t) scale with the domain (see note there).

    ``with_step``: carve a forward-facing solid step from the bottom
    wall with conjugate heat (the walls+solid variant, BENCH_WALLS=1).

    ``bluff_body``: place an interior SolidBoundRect flame holder
    mid-duct (V-gutter style, above the fuel band).  The
    generic-interior tile set then has a hole away from the boundary
    frame, so the Pallas path exercises the multi-rectangle
    specialization cover + scatter remainder (ops/pallas_step) instead
    of the single-rectangle region split.
    """
    dx = dy = 0.01
    lx, ly = nx * dx, ny * dy
    # fuel-band height is FIXED IN METERS (not a domain fraction): the
    # flame sheet must sit where the wall distance — hence the k-eps
    # length scale and the eddy viscosity it implies — stays small at
    # every grid size, or the viscosity exceeds the convective-only dt's
    # viscous stability envelope (the l_min ∝ domain failure mode of the
    # wall-less deck, in milder form)
    h = round(min(0.64, ly * 0.25), 6)
    wall_bc = "NT_WNS_2D, TCT_eps_Cmk2kXn_WALL_2D"
    if with_step:
        # forward-facing step carved from the bottom wall downstream
        # (height capped in meters for the same reason as ``h``)
        xs, hs = round(0.75 * lx, 6), round(min(0.64, 0.25 * ly), 6)
        pts = [(0.0, ly), (lx, ly), (lx, hs), (xs, hs), (xs, 0.0),
               (0.0, 0.0), (0.0, h)]
        conds = [wall_bc,                                  # top wall
                 "NT_D0X_2D, TCT_dkdx_NULL_2D, TCT_depsdx_NULL_2D",
                 wall_bc,                                  # step top
                 wall_bc,                                  # step face
                 wall_bc,                                  # bottom wall
                 "NT_FC_2D",                               # fuel inlet
                 "NT_FC_2D"]                               # ox inlet
        flows = [1, 1, 1, 1, 1, 2, 1]
        seed_i = int(xs / dx) + max(2, int(0.05 * nx))
        seed_j = max(1, int(hs / dy) // 2)
        area_block = f"""<data/NumArea=2>
<table=Area1/1>
3 {max(2, int(h / dy) // 2)}
<endtable>
<data/Area1.Type=1>
<data/Area1.Flow2D=1>
<data/Area1.TurbulenceModel=4>
<data/Area1.MaterialID=0>
<table=Area2/1>
{seed_i} {seed_j}
<endtable>
<data/Area2.Type=0>
<data/Area2.MaterialID=1>"""
    else:
        pts = [(0.0, ly), (lx, ly), (lx, 0.0), (0.0, 0.0), (0.0, h)]
        conds = [wall_bc,                                  # top wall
                 "NT_D0X_2D, TCT_dkdx_NULL_2D, TCT_depsdx_NULL_2D",
                 wall_bc,                                  # bottom wall
                 "NT_FC_2D",                               # fuel inlet
                 "NT_FC_2D"]                               # ox inlet
        flows = [1, 1, 1, 2, 1]
        area_block = """<data/NumArea=1>
<table=Area1/1>
3 3
<endtable>
<data/Area1.Type=1>
<data/Area1.Flow2D=1>
<data/Area1.TurbulenceModel=4>"""
    pts_txt = "\n".join(f"{x} {y}" for (x, y) in pts)
    # interior bluff-body flame holder mid-duct (V-gutter style); sized
    # in meters (like ``h``) so the wall-distance field it induces —
    # hence the k-eps length scale — is grid-size-independent
    if bluff_body:
        bh = round(0.5 * h, 6)
        rect_block = (f"<data/Rect1.Xstart={round(0.45 * lx, 6)}>\n"
                      f"<data/Rect1.Ystart={round(0.5 * ly - bh / 2, 6)}>\n"
                      f"<data/Rect1.DX={round(min(0.32, 0.06 * lx), 6)}>\n"
                      f"<data/Rect1.DY={bh}>\n"
                      "<data/Rect1.Flow2D=1>\n"
                      "<data/Rect1.TurbulenceModel=4>\n")
    else:
        rect_block = ""
    bounds = []
    for b, (c, fw) in enumerate(zip(conds, flows), start=1):
        bounds += [f"<data/Contour1.Bound{b}.Cond={c}>",
                   f"<data/Contour1.Bound{b}.Flow2D={fw}>",
                   f"<data/Contour1.Bound{b}.TurbulenceModel=4>",
                   f"<data/Contour1.Bound{b}.isReset=0>"]
    bounds_txt = "\n".join(bounds)
    text = f"""
<start/Combustor>
<data/ProjectName=Combustor>
<data/isVerboseOutput=0>
<data/BFF=4>
<data/MaxX={nx}>
<data/MaxY={ny}>
<data/dx={dx}>
<data/dy={dy}>
<data/SigW=1.0>
<data/SigF=1.0>
<data/delta_bl=0.05>
<data/TurbulenceModel=4>
<data/TurbStartIter=2>
<data/TurbExtModel=4>
<data/isTurbulenceReset=1>
<data/FlowType=0>
<data/ProblemType=1>
<data/CFL={cfl}>
<table=CFL_Scenario/1>
0 {cfl}
<endtable>
<data/NSaveStep=1>
<data/Nmax=100>
<data/NOutStep=10>
<data/isAlternateRMS=1>
<data/isIgnoreUnsetNodes=0>
<data/MonitorIndex=5>
<data/ExitMonitorValue=1.0>
<data/NumMonitorPoints=0>
<data/beta=0.95>
<data/beta_NonReflectedBC=0.25>
<table=beta_Scenario/1>
0 0.95
<endtable>
<data/K0=34.>
<data/gamma=0.>
<data/Tf=1000.>
<data/isAdiabaticWall={1 if adiabatic else 0}>
{AIR_TABLES}
<data/Ts0=300.>
<data/NumFlow=0>
<data/NumFlow2D=2>
<data/Flow2D-1.CompIndex=1>
<data/Flow2D-1.Mode=0>
<data/Flow2D-1.p=100000.0>
<data/Flow2D-1.T=300.0>
<data/Flow2D-1.U=600.>
<data/Flow2D-1.V=0.>
<data/Flow2D-2.CompIndex=0>
<data/Flow2D-2.Mode=0>
<data/Flow2D-2.p=100000.0>
<data/Flow2D-2.T=1400.0>
<data/Flow2D-2.U=600.>
<data/Flow2D-2.V=0.>
<data/NumRects={1 if bluff_body else 0}>
{rect_block}<data/NumCircles=0>
<data/NumSingleBounds=0>
<data/NumAirfoils=0>
<data/NumContour=1>
<table=Contour1/{len(pts)}>
{pts_txt}
<endtable>
<data/Contour1.MaterialID=0>
{bounds_txt}
{area_block}
<data/InitTime=0.>
<data/NumSrc=0>
<data/NumXCut=0>
<data/is_Cx_calc=0>
<data/is_Cd_calc=0>
<data/isOutHeatFluxX=0>
<data/isOutHeatFluxY=0>
<data/is_p_asterisk_out=0>
<data/isSingleGPU=0>
<data/ActiveSingleGPU=0>
<data/ThreadBlockSize=0>
<data/isRecalcYplus=0>
<data/GasSwapFile=.hf2d>
<data/OutputFile=.plt>
<data/ErrorFile=-err.plt>
<end/Combustor>
"""
    return parse_deck(text)


def cylinders_deck(nx: int = 192, ny: int = 96, mach: float = 3.0,
                   turb_model: int = 0, problem_type: int = 0) -> Deck:
    """Hypersonic flow around three staggered cylinders (BASELINE.json
    config 2).  Cylinder bounds are NT_WNS solids filled via BoundCircle."""
    d = channel_deck(nx=nx, ny=ny, u=mach * 347.0, v=0.0,
                     problem_type=problem_type, turb_model=turb_model,
                     cfl=0.08, beta=0.97, bff=5)
    dx = 0.01
    lx, ly = nx * dx, ny * dx
    r = ly * 0.08
    centers = [(lx * 0.25, ly * 0.5), (lx * 0.45, ly * 0.3),
               (lx * 0.45, ly * 0.7)]
    d.data["NumCircles"] = "3"
    for i, (cx, cy) in enumerate(centers, 1):
        d.data[f"Circle{i}.Xstart"] = str(cx - r)
        d.data[f"Circle{i}.Ystart"] = str(cy)
        d.data[f"Circle{i}.X0"] = str(cx)
        d.data[f"Circle{i}.Y0"] = str(cy)
        d.data[f"Circle{i}.MaterialID"] = "1"
        d.data[f"Circle{i}.Flow2D"] = "1"
        d.data[f"Circle{i}.TurbulenceModel"] = str(turb_model)
    # all four outer bounds: inflow left, D0X right, D0Y top/bottom
    d.data["Contour1.Bound1.Cond"] = "NT_D0Y_2D, CT_V_CONST_2D"
    d.data["Contour1.Bound1.Flow2D"] = "1"
    return d


def airfoil_deck(nx: int = 256, ny: int = 128, mach: float = 0.8,
                 attack_deg: float = 2.0, problem_type: int = 1,
                 turb_model: int = 4) -> Deck:
    """Transonic flow around a NACA-style airfoil (BASELINE.json config 3:
    URANS airfoil)."""
    d = channel_deck(nx=nx, ny=ny, u=mach * 340.0, v=0.0,
                     problem_type=problem_type, turb_model=turb_model,
                     turb_ext_model=4 if turb_model == 4 else 0,
                     cfl=0.08, beta=0.97, bff=5)
    dx = 0.01
    lx, ly = nx * dx, ny * dx
    d.data["NumAirfoils"] = "1"
    d.data["Airfoil1.Xstart"] = str(lx * 0.3)
    d.data["Airfoil1.Ystart"] = str(ly * 0.5)
    d.data["Airfoil1.Type"] = "0"
    d.data["Airfoil1.pp"] = "0.4"
    d.data["Airfoil1.mm"] = "0.02"
    d.data["Airfoil1.thick"] = "0.12"
    d.data["Airfoil1.scale"] = str(lx * 0.3)
    # reference passes the deck angle straight into sin/cos => radians
    d.data["Airfoil1.attack_angle"] = str(attack_deg * 3.14159265 / 180.0)
    d.data["Airfoil1.Flow2D"] = "1"
    d.data["Airfoil1.TurbulenceModel"] = str(turb_model)
    d.data["Contour1.Bound1.Cond"] = "NT_D0Y_2D, CT_V_CONST_2D"
    d.data["Contour1.Bound1.Flow2D"] = "1"
    d.data["is_Cx_calc"] = "1"
    d.data["x_body"] = str(lx * 0.3)
    d.data["y_body"] = str(ly * 0.4)
    d.data["dx_body"] = str(lx * 0.35)
    d.data["dy_body"] = str(ly * 0.2)
    d.data["Cx_Flow_Index"] = "1"
    return d


def bubble_deck(nx: int = 200, ny: int = 100) -> Deck:
    """Shock / light-gas bubble interaction (BASELINE.json config 4):
    multicomponent non-reacting, the bubble is a fuel-component gas circle
    re-filled inside the air stream."""
    d = channel_deck(nx=nx, ny=ny, u=200.0, v=0.0, problem_type=0,
                     cfl=0.05, beta=0.96, bff=5)
    dx = 0.01
    lx, ly = nx * dx, ny * dx
    # a gas (MaterialID=0) circle of pure fuel at rest
    d.data["NumCircles"] = "1"
    d.data["Circle1.Xstart"] = str(lx * 0.4 - ly * 0.15)
    d.data["Circle1.Ystart"] = str(ly * 0.5)
    d.data["Circle1.X0"] = str(lx * 0.4)
    d.data["Circle1.Y0"] = str(ly * 0.5)
    d.data["Circle1.MaterialID"] = "0"
    d.data["Circle1.Flow2D"] = "3"
    d.data["Circle1.TurbulenceModel"] = "0"
    d.data["NumFlow2D"] = "3"
    d.data["Flow2D-3.CompIndex"] = "0"     # fuel (light gas)
    d.data["Flow2D-3.Mode"] = "0"
    d.data["Flow2D-3.p"] = "100000.0"
    d.data["Flow2D-3.T"] = "300.0"
    d.data["Flow2D-3.U"] = "0.01"
    d.data["Flow2D-3.V"] = "0.0"
    # no combustion: Tf above any temperature reached
    d.data["Tf"] = "100000."
    return d


def scramjet_deck(nx: int = 384, ny: int = 128) -> Deck:
    """Axisymmetric reacting SCRAMJET-like duct (BASELINE.json config 5):
    axisymmetric, k-eps RANS, hot oxidizer stream + wall fuel source with
    Zeldovich combustion."""
    d = channel_deck(nx=nx, ny=ny, u=1200.0, v=0.0, problem_type=1,
                     turb_model=4, turb_ext_model=4, flow_type=1,
                     cfl=0.1, beta=0.95)
    d.data["Flow2D-1.CompIndex"] = "1"   # oxidizer stream
    d.data["Flow2D-1.T"] = "900."
    d.data["Flow2D-2.CompIndex"] = "1"
    d.data["Tf"] = "1000."
    # radial fuel injector: vertical line source (a horizontal axisym line
    # source divides by zero in the reference area formula,
    # hyper_flow_source.cpp:82-84)
    d.data["NumSrc"] = "1"
    d.data["Src1.GasSrcSX"] = str(nx // 4)
    d.data["Src1.GasSrcSY"] = "2"
    d.data["Src1.GasSrcEX"] = str(nx // 4)
    d.data["Src1.GasSrcEY"] = "6"
    d.data["Src1.GasSrcIndex"] = "0"     # fuel
    d.data["Src1.Msrc"] = "0.05"
    d.data["Src1.Tsrc"] = "1200."
    d.data["Src1.Tf_src"] = "900."
    return d
