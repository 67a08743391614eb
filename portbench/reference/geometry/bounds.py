"""Boundary segments and contours.

Re-implements Bound2D / BoundContour2D construction
(libOpenHyperFLOW2D/hyper_flow_bound.cpp:258-351,
hyper_flow_bound_contour.cpp:52-207): a bound is a straight node segment
rasterized slope-wise; each touched node ORs the condition bits, stores the
wall cosines, copies species mass fractions and imports the Flow/Flow2D
state.  Deck "Cond" strings are decoded with the same substring semantics as
deeps2d_core.cpp:3311-3439.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..core import flags as fl
from ..gasdyn.flow import Flow, Flow2D
from .grid import HostGrid


def parse_cond_string(cond: str, model_tct: int = 0):
    """Deck condition string -> (CT bits, TCT bits).

    Substring matching like the reference (strstr), including the else-if
    groups for turbulence-model names (deeps2d_core.cpp:3372-3381) and the
    macro node types (3414-3439).  ``model_tct`` is the model bit derived
    from the bound's ``TurbulenceModel`` key — the reference ORs it into
    TmpTurbulenceCT BEFORE the per-flag strstr gate
    (deeps2d_core.cpp:3548-3560 then 3384-3414), so TCT_* boundary flags in
    the cond string are honored whenever the bound's model is k-eps or SA
    even if no model name appears in the string itself.
    """
    ct = 0
    tct = model_tct
    for name, flag in fl.CT_NAME_TO_FLAG.items():
        if name in cond:
            ct |= flag
    # turbulence model selection is an else-if chain
    if "TCT_k_eps_Model_2D" in cond:
        tct |= fl.TCT_k_eps_Model_2D
    elif "TCT_Smagorinsky_Model_2D" in cond:
        tct |= fl.TCT_Smagorinsky_Model_2D
    elif "TCT_Spalart_Allmaras_Model_2D" in cond:
        tct |= fl.TCT_Spalart_Allmaras_Model_2D
    elif "TCT_Prandtl_Model_2D" in cond:
        tct |= fl.TCT_Prandtl_Model_2D
    elif "TCT_Integral_Model_2D" in cond:
        tct |= fl.TCT_Integral_Model_2D
    if tct & (fl.TCT_k_eps_Model_2D | fl.TCT_Spalart_Allmaras_Model_2D):
        for name, flag in fl.TCT_NAME_TO_FLAG.items():
            if name in cond:
                tct |= flag
    # macro node types
    if "NT_AX_2D" in cond:
        ct |= fl.NT_AX_2D
    elif "NT_AY_2D" in cond:
        ct |= fl.NT_AY_2D
    for name in ("NT_D0X_2D", "NT_D0Y_2D", "NT_D2X_2D", "NT_D2Y_2D"):
        if name in cond:
            ct |= fl.NT_NAME_TO_FLAG[name]
    if "NT_WALL_LAW_2D" in cond:
        ct |= fl.NT_WALL_LAW_2D
    elif "NT_WNS_2D" in cond:
        ct |= fl.NT_WNS_2D
    for name in ("NT_FC_2D", "NT_FARFIELD_2D", "NT_S_2D"):
        if name in cond:
            ct |= fl.NT_NAME_TO_FLAG[name]
    if "NT_FALSE_2D" in cond:
        ct |= fl.CT_NODE_IS_SET_2D
    return ct, tct


def turb_model_id_to_tct(turb_mod: int) -> int:
    """Deck per-bound TurbulenceModel id -> TCT model bit
    (deeps2d_core.cpp:3297-3308)."""
    return fl.TURB_MODEL_ID_TO_TCT.get(turb_mod, fl.TCT_No_Turbulence_2D)


@dataclass
class Bound:
    """One straight boundary segment in node coordinates."""

    start: tuple          # (x, y) node indices (may be float for rotation)
    end: tuple
    ct: int
    tct: int = 0
    flow: Flow = None
    flow2d: Flow2D = None
    Y: tuple = None       # 4 mass fractions
    name: str = ""

    def rotate(self, x0: float, y0: float, angle_deg: float,
               dx: float, dy: float):
        """RotateBound2D (hyper_flow_bound.cpp:580-638): rotate endpoints
        about the physical point (x0, y0) by angle (degrees)."""
        a = math.radians(angle_deg)
        ca, sa = math.cos(a), math.sin(a)

        def rot(p):
            px, py = p[0] * dx, p[1] * dy
            qx = x0 + (px - x0) * ca - (py - y0) * sa
            qy = y0 + (px - x0) * sa + (py - y0) * ca
            return (qx / dx, qy / dy)

        self.start = rot(self.start)
        self.end = rot(self.end)


def set_bound(grid: HostGrid, bound: Bound, collect=None):
    """Rasterize one bound onto the grid (``Bound2D::SetBound``,
    hyper_flow_bound.cpp:258-351)."""
    X, Y = grid.MaxX, grid.MaxY
    sx, sy = int(bound.start[0]), int(bound.start[1])
    ex, ey = int(bound.end[0]), int(bound.end[1])
    if sx > X or sy > Y or ex > X or ey > Y:
        raise ValueError(f"bound {bound.name!r} out of range")
    sx = min(sx, X - 1)
    sy = min(sy, Y - 1)
    ex = min(ex, X - 1)
    ey = min(ey, Y - 1)

    DX = bound.start[0] - bound.end[0]
    DY = bound.start[1] - bound.end[1]
    if DX != 0:
        alpha = math.atan(DY / DX)
    else:
        alpha = math.pi / 2.0

    points = []
    if abs(DX) > abs(DY):
        j1 = min(sx, ex)
        k1 = sy if j1 == sx else ey
        j2 = max(sx, ex)
        for i in range(j1, j2 + 1):
            j = k1 + int((i - j1) * math.tan(alpha))
            points.append((i, j))
    else:
        j1 = min(sy, ey)
        k1 = sx if j1 == sy else ex
        j2 = max(sy, ey)
        t = math.tan(alpha)
        for i in range(j1, j2 + 1):
            j = k1 + int((i - j1) / t) if t != 0.0 else k1
            points.append((j, i))

    import numpy as np
    ii = np.asarray([p[0] for p in points], np.intp)
    jj = np.asarray([p[1] for p in points], np.intp)
    idx = (ii, jj)
    grid.CT[idx] |= bound.ct | fl.CT_NODE_IS_SET_2D
    grid.TCT[idx] = bound.tct
    grid.NGX[idx] = 3 - grid.idXr[idx] - grid.idXl[idx]
    grid.NGY[idx] = 3 - grid.idYu[idx] - grid.idYd[idx]
    grid.BGX[idx] = math.cos(alpha)
    grid.BGY[idx] = math.sin(alpha)
    if bound.Y is not None:
        for c in range(4):
            grid.Y[c][idx] = bound.Y[c]
    if bound.flow is not None:
        grid.set_node_from_flow(idx, bound.flow)
    elif bound.flow2d is not None:
        grid.set_node_from_flow2d(idx, bound.flow2d)
    if collect is not None:
        collect.extend(points)
    return points


class BoundContour:
    """Closed polyline of bounds with a current-point cursor
    (BoundContour2D, hyper_flow_bound_contour.hpp/cpp)."""

    def __init__(self, grid: HostGrid, x: int, y: int, name: str = ""):
        self.grid = grid
        self.first = (x, y)
        self.current = (x, y)
        self.bounds: list[Bound] = []
        self.closed = False
        self.activated = False
        self.name = name

    def add_bound(self, x, y, ct, flow=None, flow2d=None, Y=None, tct=0,
                  name=""):
        if self.activated or self.closed:
            return -1
        self.bounds.append(Bound(self.current, (x, y), ct, tct, flow, flow2d,
                                 Y, name))
        self.current = (x, y)
        return len(self.bounds)

    def close_contour(self, ct, flow=None, flow2d=None, Y=None, tct=0,
                      name=""):
        if self.activated or self.closed or len(self.bounds) < 2:
            return -1
        self.bounds.append(Bound(self.current, self.first, ct, tct, flow,
                                 flow2d, Y, name))
        self.current = self.first
        self.closed = True
        return len(self.bounds)

    def is_closed(self) -> bool:
        return self.closed

    def rotate(self, x0, y0, angle_deg):
        if self.activated:
            return 0
        for b in self.bounds:
            b.rotate(x0, y0, angle_deg, self.grid.dx, self.grid.dy)
        return 1

    def set_bounds(self, collect=None):
        if not self.closed:
            return -1
        for b in self.bounds:
            set_bound(self.grid, b, collect)
        self.activated = True
        return len(self.bounds)
