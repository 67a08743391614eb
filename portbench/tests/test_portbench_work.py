"""The work counted per class of node (``work/``)."""

import dataclasses

import numpy as np
import pytest

from openhyperflow2d_torch.core import flags as fl
from openhyperflow2d_torch.core.static_ctx import generic_interior_map
from openhyperflow2d_torch.examples import combustor_deck, cylinders_deck
from openhyperflow2d_torch.solver.init import build_case
from portbench import harness, registry
from portbench.inputs import flow_nodes

TILE = (8, 32)       # a CTA's tile of the port's kernels
# the kernels' byte models a node (fused_step.cu's header): the spec tiles'
# step_spec_kernel, a general tile's gfc<general> + pass12<general>
SPEC_TILE_BYTES, GENERAL_TILE_BYTES = 236, 300 + 244


def test_spec_tiles_give_the_work_bound_of_the_fused_spec_kernel():
    # PR 17's work bound of step_spec_kernel: 15,748 spec tiles of 8 x 32
    # nodes at 236 B a node over 3.35 TB/s
    spec = registry.work_classes()["spec"]
    peak = registry.load_json(registry.ROOT / "peaks.json")["hbm_bytes_per_s"]
    ms = 15748 * 256 * spec.BYTES_PER_NODE / peak * 1e3
    assert round(ms, 4) == 0.2840


@pytest.mark.parametrize("deck", [
    lambda: combustor_deck(64, 64, cfl=0.05),
    lambda: combustor_deck(64, 64, with_step=True, adiabatic=False)],
    ids=["combustor", "walls"])
def test_node_classes(deck):
    case = build_case(deck(), dtype="float32")
    g, p = case.grid, case.params
    work = registry.work_classes()
    n = {k: m.nodes(g, p) for k, m in work.items()}
    generic = generic_interior_map(g.CT, g.TCT, g.idXl, g.idXr, g.idYu,
                                   g.idYd, p)
    flow = flow_nodes(g)
    assert n["spec"] == int(generic.sum()) > 0
    # the flow nodes, each once; no solid or constant node
    assert n["spec"] + n["general"] == int(flow.sum()) < p.MaxX * p.MaxY
    assert n["wall"] == 0    # no deck here has moving-wall sources
    assert (n["heat"] == 0) == p.isAdiabaticWall
    moving = dataclasses.replace(p, isSrcAdd=True)
    no_slip = g.is_cond(fl.CT_WALL_NO_SLIP_2D) & ~g.is_cond(fl.CT_SOLID_2D)
    assert work["wall"].nodes(g, moving) == int(no_slip.sum()) > 0
    b = harness.work_bytes(case)
    assert b == {k: work[k].BYTES_PER_NODE * n[k] for k in work}
    # the work is no more than what the kernels' byte models move: a tile
    # whose nodes are all generic runs step_spec_kernel, every other tile
    # gfc<general> and pass12<general> (each over all its nodes)
    tiles = generic.reshape(p.MaxX // TILE[0], TILE[0], p.MaxY // TILE[1],
                            TILE[1]).all(axis=(1, 3))
    spec_tile_nodes = int(tiles.sum()) * TILE[0] * TILE[1]
    model = (SPEC_TILE_BYTES * spec_tile_nodes
             + GENERAL_TILE_BYTES * (p.MaxX * p.MaxY - spec_tile_nodes))
    assert sum(b.values()) <= model


def test_a_physics_no_class_counts_gives_no_work():
    # Euler: no generic-interior form, and general.py counts k-eps decks
    case = build_case(cylinders_deck(64, 48), dtype="float32")
    work = registry.work_classes()
    assert work["spec"].nodes(case.grid, case.params) == 0
    assert work["general"].nodes(case.grid, case.params) is None
    assert harness.work_bytes(case) is None
    assert np.asarray(flow_nodes(case.grid)).sum() > 0
