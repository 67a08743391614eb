"""The conjugate heat stage's work at a wall gas node beside a solid, on a
deck whose walls are not adiabatic: Tg of the node and of its solid
neighbour read, lam_eff read, 12 B a node (chip_smoke.py ``fold_work``,
one solid neighbour a node).  No node on an adiabatic deck."""

import numpy as np

from portbench.reference.core import flags as fl

# bytes added at nodes that a class of the flow nodes counts already
ADDS = True
BYTES_PER_NODE = 12


def nodes(grid, params) -> int:
    if params.isAdiabaticWall or not params.has_walls:
        return 0
    ct = np.asarray(grid.CT).astype(np.int64)
    solid = (ct & fl.CT_SOLID_2D) != 0
    near = np.zeros_like(solid)
    near[1:] |= solid[:-1]
    near[:-1] |= solid[1:]
    near[:, 1:] |= solid[:, :-1]
    near[:, :-1] |= solid[:, 1:]
    return int((near & ~solid & ((ct & fl.CT_NODE_IS_SET_2D) != 0)).sum())
