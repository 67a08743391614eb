"""Solid boundary primitives: rectangles, circles, airfoils.

Re-implements SolidBoundRect2D (hyper_flow_solid_bound_rect.cpp:14-132),
BoundCircle2D (hyper_flow_bound_circle.cpp:14-86) and SolidBoundAirfoil2D
(hyper_flow_airfoil.cpp:13-293) plus their deck-driven construction
(deeps2d_core.cpp:4000-4297).  All coordinates use the reference's
``x/dx + 0.4999`` node rounding.
"""

from __future__ import annotations

import math

from ..core import flags as fl
from ..gasdyn.flow import Flow2D
from .areas import fill_area
from .bounds import BoundContour, turb_model_id_to_tct
from .grid import HostGrid

PI = math.pi


def _nx(v, d):
    return int(v / d + 0.4999)


def _resolve_flow2d_Y(deck, prefix, flow2d_list):
    from ..solver.init import comp_index_Y   # late import, avoids cycle
    fi = deck.get_int(f"{prefix}.Flow2D")
    if fi < 1 or fi > len(flow2d_list):
        raise ValueError(f"Bad Flow index [{fi}] for {prefix}")
    comp = deck.get_int(f"Flow2D-{fi}.CompIndex")
    return flow2d_list[fi - 1], comp_index_Y(comp, deck, f"Flow2D-{fi}")


def solid_rect(grid: HostGrid, x: float, y: float, DX: float, DY: float,
               flow2d: Flow2D, Y, tct: int, ct: int = None):
    """SolidBoundRect2D: 4 wall bounds + solid flood fill.

    The per-side k-eps wall flags (TCT_eps_mud2k*_WALL etc.) are auto-added
    exactly as the reference does (hyper_flow_solid_bound_rect.cpp:67-123).
    """
    ct = fl.NT_WNS_2D if ct is None else ct
    dx, dy = grid.dx, grid.dy
    if flow2d is not None:
        flow2d.U(0.0)
        flow2d.V(0.0)

    def tt_y():
        if tct & fl.TCT_k_eps_Model_2D:
            return (tct | fl.TCT_dkdy_NULL_2D | fl.TCT_k_CONST_2D
                    | fl.TCT_eps_mud2kdy2_WALL_2D)
        return tct

    def tt_x():
        if tct & fl.TCT_k_eps_Model_2D:
            return (tct | fl.TCT_dkdx_NULL_2D | fl.TCT_k_CONST_2D
                    | fl.TCT_eps_mud2kdx2_WALL_2D)
        return tct

    bc = BoundContour(grid, _nx(x, dx), _nx(y, dy))
    bc.add_bound(_nx(x + DX, dx), _nx(y, dy), ct, None, flow2d, Y, tt_y())
    bc.add_bound(_nx(x + DX, dx), _nx(y + DY, dy), ct, None, flow2d, Y,
                 tt_x())
    bc.add_bound(_nx(x, dx), _nx(y + DY, dy), ct, None, flow2d, Y, tt_y())
    bc.close_contour(ct, None, flow2d, Y, tt_x())
    bc.set_bounds()
    fill_area(grid, _nx(x + DX / 2, dx), _nx(y + DY / 2, dy), fl.NT_S_2D)


def bound_circle(grid: HostGrid, x: float, y: float, x1: float, y1: float,
                 flow2d: Flow2D, Y, tct: int, material_id: int):
    """BoundCircle2D: circle through (x,y) centered at (x1,y1); solid when
    material_id != 0, else a gas region re-fill."""
    dx, dy = grid.dx, grid.dy
    r = math.sqrt((x - x1) ** 2 + (y - y1) ** 2 + 1.e-30)
    fi0 = math.atan2(y1 - y, x1 - x)
    if flow2d is not None:
        flow2d.U(0.0)
        flow2d.V(0.0)
    ct = fl.NT_WNS_2D if material_id else fl.CT_NODE_IS_SET_2D
    k = max(1, int(2 * PI * r / math.sqrt(dx * dx + dy * dy)))
    bc = BoundContour(grid, int(x / dx + 0.4999), int(y / dy + 0.4999))
    for i in range(k):
        xx2 = x1 + r * math.sin(fi0 + (2.0 * PI * i) / k - PI / 2.0)
        yy2 = y1 + r * math.cos(fi0 + (2.0 * PI * i) / k - PI / 2.0)
        ix = int(xx2 / dx + 0.499999)
        iy = int(yy2 / dy + 0.499999)
        if 0 <= ix <= grid.MaxX - 1 and 0 <= iy <= grid.MaxY - 1:
            bc.add_bound(ix, iy, ct, None, flow2d, Y, tct)
    bc.close_contour(ct, None, flow2d, Y, tct)
    bc.set_bounds()
    sx, sy = int(x1 / dx), int(y1 / dy)
    if material_id:
        fill_area(grid, sx, sy, fl.NT_S_2D)
    else:
        fill_area(grid, sx, sy, fl.NT_F_2D, flow2d, Y, tct)


# ---------------------------------------------------------------------------
# Airfoils
# ---------------------------------------------------------------------------
def _binom(n, i):
    return math.comb(n, i)


def _bez(n, i, t):
    return _binom(n, i) * (t ** i) * ((1.0 - t) ** (n - i))


def naca_mean_y(mm, t):
    m = [0.0, 0.1, 0.1, 0.1, 0.0]
    return sum(m[i] * mm * _bez(4, i, t) for i in range(5))


def naca_mean_x(pp, t):
    p = [0.0, pp / 2.0, pp, (pp + 1.0) / 2.0, 1.0]
    return sum(p[i] * _bez(4, i, t) for i in range(5))


_ZX = [0.0, 0.0, 0.03571, 0.10714, 0.21429, 0.35714, 0.53571, 0.75, 1.0]
_ZY = [0.0, 0.18556, 0.34863, 0.48919, 0.58214, 0.55724, 0.44992, 0.30281,
       0.01050]


def naca_z_x(x):
    return sum(_ZX[i] * _bez(8, i, x) for i in range(9))


def naca_z_y(x, tk):
    return sum(_ZY[i] * tk * _bez(8, i, x) for i in range(9))


def airfoil_xy(mm, pp, thick, t):
    zx = naca_z_x(t)
    return (naca_mean_x(pp, zx),
            naca_mean_y(mm, zx) + naca_z_y(t, thick),
            naca_mean_y(mm, zx) - naca_z_y(t, thick),
            naca_mean_y(mm, zx))


def solid_airfoil_naca(grid: HostGrid, x: float, y: float, mm: float,
                       pp: float, thick: float, flow2d: Flow2D, Y, tct: int,
                       scale: float, attack_angle: float):
    """NACA-style Bezier airfoil (hyper_flow_airfoil.cpp:187-293)."""
    dx, dy = grid.dx, grid.dy
    k = int(scale / dx)
    dt = 2.0 / k
    ct = fl.NT_WNS_2D
    bc = BoundContour(grid, _nx(x, dx), _nx(y, dy))
    for i in range(k // 2):
        ax, ay1, _, _ = airfoil_xy(mm, pp, thick, (i + 1) * dt)
        bc.add_bound(_nx(x + scale * ax, dx), _nx(y + scale * ay1, dy), ct,
                     None, flow2d, Y, tct)
    for i in range(k // 2, 0, -1):
        ax, _, ay2, _ = airfoil_xy(mm, pp, thick, (i - 1) * dt)
        bc.add_bound(_nx(x + scale * ax, dx), _nx(y + scale * ay2, dy), ct,
                     None, flow2d, Y, tct)
    bc.close_contour(ct, None, flow2d, Y, tct)

    ax, _, _, aym = airfoil_xy(mm, pp, thick, 0.5)
    xx1 = x + scale * ax
    yy1 = y + scale * aym
    if attack_angle != 0.0:
        # NOTE: the reference rotates the fill seed with dcx = x - xx1
        # (hyper_flow_airfoil.cpp:260-265), i.e. the vector from mid-chord
        # TO the anchor — landing the seed at the mirror image of the
        # mid-chord for any nonzero angle, so its rotated-airfoil fill is
        # unconditionally broken (solid/gas inversion or abort).  Here the
        # mid-chord point is rotated with the same transform as the contour.
        xx1, yy1 = _rotate_point(xx1 / dx, yy1 / dy, x / dx, y / dy,
                                 attack_angle)
        xx1 *= dx
        yy1 *= dy
        _rotate_contour(bc, x / dx, y / dy, attack_angle)
    bc.set_bounds()
    fill_area(grid, *_interior_seed(grid, _nx(xx1, dx), _nx(yy1, dy)),
              fl.NT_S_2D)


def solid_airfoil_tsagi(grid: HostGrid, x: float, y: float, upper, lower,
                        flow2d: Flow2D, Y, tct: int, scale: float,
                        attack_angle: float):
    """Tabulated ("TsAGI") airfoil from UpperSurface/LowerSurface tables
    (hyper_flow_airfoil.cpp:79-185)."""
    dx, dy = grid.dx, grid.dy
    ct = fl.NT_WNS_2D
    bc = BoundContour(grid, _nx(x, dx), _nx(y, dy))
    for i in range(upper.n):
        bc.add_bound(_nx(x + scale * upper.x[i], dx),
                     _nx(y + scale * upper.y[i], dy), ct, None, flow2d, Y,
                     tct)
    for i in range(lower.n - 1, 0, -1):
        bc.add_bound(_nx(x + scale * lower.x[i], dx),
                     _nx(y + scale * lower.y[i], dy), ct, None, flow2d, Y,
                     tct)
    bc.close_contour(ct, None, flow2d, Y, tct)
    xx1 = x + scale * upper.x[upper.n // 2]
    yy1 = y + scale * (upper.y[upper.n // 2] + lower.y[lower.n // 2]) / 2.0
    if attack_angle != 0.0:
        xx1, yy1 = _rotate_point(xx1 / dx, yy1 / dy, x / dx, y / dy,
                                 attack_angle)
        xx1 *= dx
        yy1 *= dy
        _rotate_contour(bc, x / dx, y / dy, attack_angle)
    bc.set_bounds()
    fill_area(grid, *_interior_seed(grid, _nx(xx1, dx), _nx(yy1, dy)),
              fl.NT_S_2D)


def _rotate_point(px, py, x0n, y0n, angle):
    """The RotateBound2D point transform (hyper_flow_bound.cpp:582-595) in
    node space."""
    dxs = px - x0n
    dys = py - y0n
    fi = math.atan2(dxs, dys)
    r = math.sqrt(dxs * dxs + dys * dys + 1.e-30)
    return (x0n + r * math.sin(fi + angle), y0n + r * math.cos(fi + angle))


def _interior_seed(grid: HostGrid, sx: int, sy: int):
    """Robust interior seed for thin rotated profiles.

    The reference seeds the fill at the rotated mid-chord point; for thin
    airfoils under rotation the integer-rounded seed can fall outside the
    contour, which floods the whole domain (the reference either aborts on
    an already-set seed or silently solidifies the gas region — its
    attack-angle path is additionally broken by the Start=x/dx rescaling in
    RotateBound2D, hyper_flow_bound.cpp:599-608).  Here: if the nominal
    seed's connected component is more than a quarter of the domain, pick
    the nearest unset cell in a small neighborhood whose component is
    enclosed (small)."""
    import numpy as np
    from scipy import ndimage
    unset = ~grid.is_cond(fl.CT_NODE_IS_SET_2D)
    lab, _ = ndimage.label(unset, structure=np.array(
        [[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool))
    limit = unset.sum() / 4
    best = None
    for radius in range(0, 10):
        for di in range(-radius, radius + 1):
            for dj in range(-radius, radius + 1):
                if max(abs(di), abs(dj)) != radius:
                    continue
                ii, jj = sx + di, sy + dj
                if not (0 <= ii < grid.MaxX and 0 <= jj < grid.MaxY):
                    continue
                l = lab[ii, jj]
                if l == 0:
                    continue
                if (lab == l).sum() < limit:
                    return ii, jj
                if best is None:
                    best = (ii, jj)
    return best if best is not None else (sx, sy)


def _rotate_contour(bc: BoundContour, x0n: float, y0n: float, angle: float):
    """RotateBound2D formula (hyper_flow_bound.cpp:580-611) applied in node
    space; ``angle`` in radians as the reference passes it through."""
    for b in bc.bounds:
        def rot(pt):
            dxs = pt[0] - x0n
            dys = pt[1] - y0n
            fi = math.atan2(dxs, dys)
            r = math.sqrt(dxs * dxs + dys * dys + 1.e-30)
            return (x0n + r * math.sin(fi + angle),
                    y0n + r * math.cos(fi + angle))
        b.start = rot(b.start)
        b.end = rot(b.end)


# ---------------------------------------------------------------------------
# deck-driven constructors (deeps2d_core.cpp:4000-4297)
# ---------------------------------------------------------------------------
def add_rect(grid, deck, name, flow_list, flow2d_list):
    xs = deck.get_float(f"{name}.Xstart")
    ys = deck.get_float(f"{name}.Ystart")
    DX = deck.get_float(f"{name}.DX")
    DY = deck.get_float(f"{name}.DY")
    tct = turb_model_id_to_tct(deck.get_int(f"{name}.TurbulenceModel", 0,
                                            required=False))
    flow2d, Y = _resolve_flow2d_Y(deck, name, flow2d_list)
    solid_rect(grid, xs, ys, DX, DY, flow2d, Y, tct)


def add_circle(grid, deck, name, flow_list, flow2d_list):
    xs = deck.get_float(f"{name}.Xstart")
    ys = deck.get_float(f"{name}.Ystart")
    x0 = deck.get_float(f"{name}.X0")
    y0 = deck.get_float(f"{name}.Y0")
    mat = deck.get_int(f"{name}.MaterialID", 1, required=False)
    tct = turb_model_id_to_tct(deck.get_int(f"{name}.TurbulenceModel", 0,
                                            required=False))
    flow2d, Y = _resolve_flow2d_Y(deck, name, flow2d_list)
    bound_circle(grid, xs, ys, x0, y0, flow2d, Y, tct, mat)


def add_airfoil(grid, deck, name, flow_list, flow2d_list):
    xs = deck.get_float(f"{name}.Xstart")
    ys = deck.get_float(f"{name}.Ystart")
    af_type = deck.get_int(f"{name}.Type", 0, required=False)
    scale = deck.get_float(f"{name}.scale")
    attack = deck.get_float(f"{name}.attack_angle")
    tct = turb_model_id_to_tct(deck.get_int(f"{name}.TurbulenceModel", 0,
                                            required=False))
    flow2d, Y = _resolve_flow2d_Y(deck, name, flow2d_list)
    if af_type == 0:
        pp = deck.get_float(f"{name}.pp")
        mm = deck.get_float(f"{name}.mm")
        thick = deck.get_float(f"{name}.thick")
        solid_airfoil_naca(grid, xs, ys, mm, pp, thick, flow2d, Y, tct,
                           scale, attack)
    else:
        from ..config.deck import load_deck
        sub = load_deck(deck.get_str(f"{name}.InputData"))
        solid_airfoil_tsagi(grid, xs, ys, sub.get_table("UpperSurface"),
                            sub.get_table("LowerSurface"), flow2d, Y, tct,
                            scale, attack)
