"""The moving-wall sources' work at a no-slip wall gas node of a deck with
isSrcAdd: the six SrcAdd planes written by gfc and read by pass12, 24 B a
node (chip_smoke.py ``MW_BYTES``).  No node on a deck without them."""

import numpy as np

from portbench.reference.core import flags as fl

# bytes added at nodes that a class of the flow nodes counts already
ADDS = True
BYTES_PER_NODE = 24


def nodes(grid, params) -> int:
    if not params.isSrcAdd:
        return 0
    ct = np.asarray(grid.CT).astype(np.int64)
    return int((((ct & fl.CT_WALL_NO_SLIP_2D) != 0)
                & ((ct & fl.CT_SOLID_2D) == 0)).sum())
