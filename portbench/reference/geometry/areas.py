"""Area flood fill.

Re-implements ``Area2D::FillArea2D`` (libOpenHyperFLOW2D/
hyper_flow_area.cpp:66-186): BFS from a seed through nodes without
CT_NODE_IS_SET, stamping the area's condition/turbulence bits, importing the
Flow2D state, and maintaining gas/solid interface neighbor flags
(idXl/idXr/idYu/idYd + NGX/NGY zeroing) on already-set neighbors.

The BFS is evaluated as a vectorized connected-component labeling (4-way
connectivity over the unset mask) — semantically identical to the
reference's generation-wise fill, since every per-node side effect is
idempotent and order-independent.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from ..core import flags as fl
from ..gasdyn.flow import Flow, Flow2D
from .grid import HostGrid

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


class AreaError(RuntimeError):
    pass


def fill_area(grid: HostGrid, X: int, Y: int, bnt: int, flow2d: Flow2D = None,
              p_Y=None, att: int = 0):
    """Flood fill from node (X, Y).

    ``bnt``/``att`` are the CT / TCT bits stamped on filled nodes (the
    reference ORs CT_NODE_IS_SET automatically).  When ``flow2d`` is given
    the gas state is imported into every filled node; passing CT_SOLID_2D in
    ``bnt`` marks a solid region.
    """
    if isinstance(flow2d, Flow) and not isinstance(flow2d, Flow2D):
        flow2d = Flow2D(flow=flow2d)
    XMax, YMax = grid.MaxX, grid.MaxY
    if not (XMax > X and YMax > Y):
        raise AreaError("fill seed out of range")
    if grid.is_cond(fl.CT_NODE_IS_SET_2D, X, Y):
        raise AreaError(f"fill seed ({X},{Y}) is already set")

    ant = bnt | fl.CT_NODE_IS_SET_2D
    unset = ~grid.is_cond(fl.CT_NODE_IS_SET_2D)
    labels, _ = ndimage.label(unset, structure=_CROSS)
    region = labels == labels[X, Y]

    grid.CT[region] = ant
    grid.TCT[region] = att
    if p_Y is not None:
        for c in range(4):
            grid.Y[c][region] = p_Y[c]
    if flow2d is not None:
        grid.set_node_from_flow2d(region, flow2d)
    grid.BGX[region] = 1.0
    grid.BGY[region] = 1.0
    grid.NGX[region] = 1
    grid.NGY[region] = 1
    grid.idXl[region] = 1
    grid.idYu[region] = 1
    grid.idXr[region] = 1
    grid.idYd[region] = 1

    if ant & fl.CT_SOLID_2D:
        # already-set non-solid neighbors of the freshly filled solid lose
        # the facing neighbor flag and wall-direction coefficient
        # (hyper_flow_area.cpp:127-171)
        other = ~region & ~grid.is_cond(fl.CT_SOLID_2D) \
            & grid.is_cond(fl.CT_NODE_IS_SET_2D)
        # neighbor-of-region masks per direction
        right_of = np.zeros_like(region)
        right_of[1:, :] = region[:-1, :]     # node has region to its LEFT
        left_of = np.zeros_like(region)
        left_of[:-1, :] = region[1:, :]      # region to its RIGHT
        above = np.zeros_like(region)
        above[:, 1:] = region[:, :-1]        # region BELOW it
        below = np.zeros_like(region)
        below[:, :-1] = region[:, 1:]        # region ABOVE it
        m = other & right_of
        grid.NGX[m] = 0
        grid.idXl[m] = 0
        m = other & left_of
        grid.NGX[m] = 0
        grid.idXr[m] = 0
        m = other & above
        grid.NGY[m] = 0
        grid.idYd[m] = 0
        m = other & below
        grid.NGY[m] = 0
        grid.idYu[m] = 0
    return region
