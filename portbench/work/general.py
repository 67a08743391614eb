"""The work of an iteration at every other flow node of a standard k-eps
deck (set, not solid, not held constant, not generic-interior: the
boundary, wall and near-wall nodes), each plane read once and written
once, in float32: the spec node's planes (``spec.BYTES_PER_NODE``) and
what the general body decodes besides: Yc (4 planes) and p read (20 B),
the 4 int8 neighbour flags (4 B), 4 more meta planes (16 B) and the 4
ctx words (16 B): 292 B a node.  (The kernels' own byte models count
some of these once in gfc and again in pass12: 544 B a general node with
the scratch, fused_step.cu's header.)  Solid and constant nodes do no
work.  Another physics (Euler, the other closures) is not this class's:
``nodes`` gives None there, and a class of its own has to count it."""


from portbench.inputs import flow_nodes
from portbench.reference.core.static_ctx import generic_interior_map

SPEC_BYTES = 236    # spec.py's
BYTES_PER_NODE = SPEC_BYTES + 20 + 4 + 16 + 16


def nodes(grid, params):
    m = generic_interior_map(grid.CT, grid.TCT, grid.idXl, grid.idXr,
                             grid.idYu, grid.idYd, params)
    if m is None:
        return None
    return int((flow_nodes(grid) & ~m).sum())
