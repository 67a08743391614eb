"""Benchmark reference: a frozen copy of the port's wall-node code, with
the nearest-wall search as torch blocks in place of the native library.

Wall-node machinery: marking, collection, min-distance transform.

Re-implements SetWallNodes / GetWallNodes / SetMinDistanceToWall2D /
SetNonReflectedBC (libDEEPS2D/deeps2d_core.cpp:2025-2104, 4783-4832,
4835-4889) with vectorized numpy.  The O(N_nodes x N_wall) brute-force
distance search of the reference is kept semantically (nearest wall node and
its index) but evaluated in chunked vectorized form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import flags as fl
from .grid import HostGrid


def set_wall_nodes(grid: HostGrid) -> int:
    """Mark NT_WNS on gas nodes adjacent to solids
    (deeps2d_core.cpp:2025-2079)."""
    solid = grid.is_cond(fl.CT_SOLID_2D)
    fc = grid.is_cond(fl.NT_FC_2D)
    candidate = ~solid & ~fc

    near_solid = np.zeros_like(solid)
    near_solid[:, :-1] |= solid[:, 1:]    # up neighbor solid
    near_solid[:, 1:] |= solid[:, :-1]    # down
    near_solid[1:, :] |= solid[:-1, :]    # left
    near_solid[:-1, :] |= solid[1:, :]    # right

    mask = candidate & near_solid
    grid.CT[mask] |= fl.NT_WNS_2D
    return int(mask.sum())


def get_wall_nodes(grid: HostGrid) -> np.ndarray:
    """Collect (i, j) of non-solid wall nodes in the reference scan order
    (j outer, i inner; deeps2d_core.cpp:2081-2104)."""
    wall = (~grid.is_cond(fl.CT_SOLID_2D)
            & (grid.is_cond(fl.CT_WALL_LAW_2D)
               | grid.is_cond(fl.CT_WALL_NO_SLIP_2D)))
    jj, ii = np.nonzero(wall.T)
    return np.stack([ii, jj], axis=1).astype(np.int32)


def set_min_distance_to_wall(grid: HostGrid, wall_nodes: np.ndarray,
                             x0: float = 0.0, chunk: int = 8192,
                             device="cpu") -> None:
    """SetMinDistanceToWall2D (deeps2d_core.cpp:4783-4832), by brute force
    over every wall node in blocks of ``chunk`` nodes on the torch
    ``device``, in float64 with the reference's operation order.

    For every active gas node: l_min = max(min(dx,dy), min distance to any
    wall node), i_wall/j_wall = the *last* wall node (in list order) whose
    distance is at most max(min(dx,dy), that minimum), the reference's
    tie-break, which y+ recalculation keys off.

    Also reproduces the "phantom solid" fixup: active nodes with Tg != 0 and
    p == 0 are converted to solids.
    """
    X, Y = grid.MaxX, grid.MaxY
    dx, dy = grid.dx, grid.dy
    min_l = min(dx, dy)

    phantom = (grid.is_cond(fl.CT_NODE_IS_SET_2D)
               & ~grid.is_cond(fl.CT_SOLID_2D)
               & (grid.Tg != 0) & (grid.p == 0.0))
    grid.CT[phantom] |= fl.CT_SOLID_2D

    active = (grid.is_cond(fl.CT_NODE_IS_SET_2D)
              & ~grid.is_cond(fl.CT_SOLID_2D))
    l_init = max(x0 + dx * X, dy * Y)
    grid.l_min[active] = l_init
    if wall_nodes is None or len(wall_nodes) == 0:
        return

    f64 = torch.float64
    wall = torch.as_tensor(np.asarray(wall_nodes, np.int64), device=device)
    wx = wall[:, 0].to(f64) * dx                          # (W,)
    wy = wall[:, 1].to(f64) * dy
    W = wall.shape[0]
    ai, aj = np.nonzero(active)
    l_out = np.empty(len(ai), np.float64)
    w_out = np.empty(len(ai), np.int64)
    for s in range(0, len(ai), chunk):
        i = torch.as_tensor(ai[s:s + chunk], device=device)
        j = torch.as_tensor(aj[s:s + chunk], device=device)
        ex = x0 + i.to(f64) * dx
        ey = j.to(f64) * dy
        ddx = ex[:, None] - wx[None, :]
        ddy = ey[:, None] - wy[None, :]
        d = torch.sqrt(ddx * ddx + ddy * ddy)             # (c, W)
        best = torch.clamp_max(d.amin(1), l_init)
        hit = d <= torch.clamp_min(best, min_l)[:, None]
        last = W - 1 - torch.flip(hit, [1]).to(torch.int8).argmax(1)
        l_out[s:s + chunk] = torch.clamp_min(best, min_l).cpu().numpy()
        w_out[s:s + chunk] = torch.where(hit.any(1), last, -1).cpu().numpy()
    grid.l_min[ai, aj] = l_out
    found = w_out >= 0
    grid.i_wall[ai[found], aj[found]] = wall_nodes[w_out[found], 0]
    grid.j_wall[ai[found], aj[found]] = wall_nodes[w_out[found], 1]


def set_init_boundary_layer(grid: HostGrid, delta: float) -> None:
    """SetInitBoundaryLayer (deeps2d_core.cpp:2243-2257).

    NOTE(reference quirk, reproduced intentionally): the C++ has a missing
    brace, so RhoU is scaled only where l_min <= delta, while RhoV is scaled
    by l_min/delta on *every* active node with time == 0 when delta > 0.
    """
    if delta <= 0:
        return
    active = (grid.is_cond(fl.CT_NODE_IS_SET_2D)
              & ~grid.is_cond(fl.CT_SOLID_2D) & (grid.time == 0.0))
    scale = grid.l_min / delta
    inner = active & (grid.l_min <= delta)
    grid.S[fl.i2d_RhoU][inner] *= scale[inner]
    grid.S[fl.i2d_RhoV][active] *= scale[active]


def set_nonreflected_bc(grid: HostGrid) -> int:
    """SetNonReflectedBC (deeps2d_core.cpp:4835-4889): mark neighbors of
    NT_FARFIELD nodes with CT_NONREFLECTED; returns the counted nodes."""
    far = grid.is_cond(fl.NT_FARFIELD_2D)
    eligible = (grid.is_cond(fl.CT_NODE_IS_SET_2D)
                & ~grid.is_cond(fl.CT_WALL_NO_SLIP_2D)
                & ~grid.is_cond(fl.CT_SOLID_2D)
                & ~grid.is_cond(fl.NT_FC_2D))
    count = int(far.sum())
    total_marks = 0
    for shift, axis in ((-1, 0), (1, 0), (-1, 1), (1, 1)):
        nb = np.zeros_like(far)
        if axis == 0:
            if shift == -1:
                nb[:-1, :] = far[1:, :]
            else:
                nb[1:, :] = far[:-1, :]
        else:
            if shift == -1:
                nb[:, :-1] = far[:, 1:]
            else:
                nb[:, 1:] = far[:, :-1]
        mark = nb & eligible
        total_marks += int(mark.sum())
        grid.CT[mark] |= fl.CT_NONREFLECTED_2D
    return count + total_marks
