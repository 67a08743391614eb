"""The work of an iteration at a generic-interior node (every condition
flag plain, standard k-eps, all four neighbours present: the nodes whose
masks are constants), each plane read once and written once, in float32:
the 18 carry planes gfc reads (S and 9 primitives), l_min and beta read
(112 B), the 13 primitives, S and beta written (124 B); no scratch.  236 B
a node (the work bound that step_spec_kernel was measured against;
fused_step.cu's header).  On a deck with no generic-interior form (not
standard k-eps) no node."""

from portbench.reference.core.static_ctx import generic_interior_map

BYTES_PER_NODE = 236


def mask(grid, params):
    """(X, Y) bool map of the class's nodes, or None (no such node)."""
    return generic_interior_map(grid.CT, grid.TCT, grid.idXl, grid.idXr,
                                grid.idYu, grid.idYd, params)


def nodes(grid, params) -> int:
    m = mask(grid, params)
    return 0 if m is None else int(m.sum())
