"""The run's data from ``--seed``: a perturbation of the initial flow.

Every conservative variable of a flow node (set, not solid, with none of
its quantities held constant) is scaled by ``1 + amplitude * u``, ``u`` uniform on [-1, 1] and
drawn per node from the seed.  The scaling changes the density alone (the
velocities, temperature and mass fractions of a node stay), so every seed
gives the same sizes, the same tiles and the same work.  The program's case
and the reference's get the same perturbation."""

from __future__ import annotations

import numpy as np

from .reference.core import flags as fl


def flow_nodes(grid) -> np.ndarray:
    """(X, Y) bool map of the nodes the perturbation touches."""
    ct = np.asarray(grid.CT).astype(np.int64)
    return (((ct & fl.CT_NODE_IS_SET_2D) != 0)
            & ((ct & fl.CT_SOLID_2D) == 0)
            & ((ct & (fl.NT_FC_2D & ~fl.CT_NODE_IS_SET_2D)) == 0))


def perturb(grid, seed: int, amplitude: float) -> None:
    """Scale ``grid.S`` in place at the flow nodes (see the module)."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    u = rng.uniform(-1.0, 1.0, size=grid.S.shape[1:])
    scale = np.where(flow_nodes(grid), 1.0 + amplitude * u, 1.0)
    grid.S *= scale.astype(grid.S.dtype)[None]
