"""The staged general body's decomposition on the CPU.

``gfc_window_kernel`` and ``pass12_window_kernel`` (ops/csrc/fused_step.cu,
the "staged" body: chip_smoke.py's A/B candidate, which no solver path
launches) run a tile list on a persistent grid and read every operand at
+-1 from a window of the tile staged in shared memory.  The CUDA kernels
run on the card only; here the Python mirror in ops/fused_step.py, which
follows the kernel's schedule and the element each copy moves, is held to

(a) each tile of a list runs exactly once, in the kernel's order;
(b) the staged windows plus the collapse give core/step.neighbors' L/R/U/D
    values exactly (the port's and the JAX package's), at every node of the
    general tiles, for every windowed plane, and the node tiles give every
    other plane the body reads at the node: the combustor, the walls+step+
    heat deck (48 x 40, and 64 x 256 for a general tile off the grid's
    frame) and each strip of a 4-strip plan (the strip halos).

The mirror is a copy of the kernel's index math, not the kernel: it does
not model which thread issues which piece (the kernel's 3 planes at a time
and its halo-column strides).  The kernel's own copies are guarded only by
chip_smoke.py, which holds the staged body bit for bit against the general
body on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhyperflow2d_torch.core.step import neighbors
from openhyperflow2d_torch.examples import combustor_deck
from openhyperflow2d_torch.ops import fused_step as fs
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver
from openhyperflow2d_tpu.core.step import neighbors as jax_neighbors


@pytest.mark.parametrize("ctas", [1, 132, 264])
@pytest.mark.parametrize("n_tiles", [0, 1, 131, 132, 133, 636, 2000])
def test_persistent_schedule_runs_each_tile_once_in_order(n_tiles, ctas):
    sched = fs.persistent_schedule(n_tiles, ctas)
    grid = min(n_tiles, ctas)
    assert len(sched) == grid
    # the kernel's loop: CTA b runs e = b, b + G, ... while e < n_tiles
    for b, entries in enumerate(sched):
        want, e = [], b
        while e < n_tiles:
            want.append(e)
            e += grid
        assert entries == want
        assert entries     # no CTA of the grid is idle
    flat = sorted(e for entries in sched for e in entries)
    assert flat == list(range(n_tiles))


# "step_64": the step deck at a width whose general list has a tile off
# the grid's frame (T4's scatter table); at 48 x 40 every tile is on it
DECKS = {"combustor": lambda: combustor_deck(64, 256),
         "step": lambda: combustor_deck(48, 40, with_step=True,
                                        adiabatic=False),
         "step_64": lambda: combustor_deck(64, 256, with_step=True,
                                           adiabatic=False)}


@functools.lru_cache(maxsize=None)
def steps(deck, strips):
    """The FusedSteps of a deck: the single domain's, or each strip's of a
    ``strips``-strip plan (its extended buffer, halos included)."""
    case = build_case(DECKS[deck](), dtype="float32")
    if strips is None:
        return [Solver(case, device="cpu", use_kernels=True).fused]
    s = Solver(case, device="cpu", use_kernels=True,
               comm=LocalComm(strips, "cpu"))
    return list(s._chunk_fn.steps)


CASES = ([("combustor", None, 0), ("step", None, 0), ("step_64", None, 0)]
         + [("combustor", 4, k) for k in range(4)])


@pytest.mark.parametrize("vec", [True, False], ids=["16B", "4B"])
@pytest.mark.parametrize("stage", ["gfc", "pass12"])
@pytest.mark.parametrize("deck,strips,k", CASES)
def test_staged_windows_give_the_neighbors(deck, strips, k, stage, vec):
    step = steps(deck, strips)[k]
    plan = step.plan
    X, Y = plan.X, plan.Y
    ctx = step.ctx
    rng = np.random.default_rng(4)
    # the stencil stack (gfc: the carry, pass12: the scratch) and the aux
    # stack (gfc: the 5 meta planes, pass12: the carry)
    n_planes, n_aux = ((fs.N_CARRY, 5) if stage == "gfc"
                       else (fs.N_SCRATCH, fs.N_CARRY))
    planes = rng.standard_normal((n_planes, X, Y)).astype(np.float32)
    aux = rng.standard_normal((n_aux, X, Y)).astype(np.float32)
    ctxw = step.ctxw.numpy()
    idn = step.idn.numpy()
    masks = [getattr(ctx, f) for f in ("bXl", "bXr", "bYu", "bYd")]
    layout = fs.STAGE_PLANES[stage]
    ids = layout["window"]
    want = {p: [t.numpy() for t in neighbors(torch.from_numpy(planes[p]),
                                             *masks)]
            for p in ids}
    jmasks = [jnp.asarray(m.numpy()) for m in masks]
    jwant = {p: [np.asarray(t) for t in jax_neighbors(jnp.asarray(planes[p]),
                                                      *jmasks)]
             for p in ids}
    tiles = plan.general_tiles.numpy()
    sched = fs.persistent_schedule(len(tiles), 132)
    TX, TY = fs.TILE
    seen = np.zeros((X, Y), bool)
    frame = {"edge": 0, "off": 0}
    for entries in sched:
        for e in entries:
            t = int(tiles[e])
            win = fs.stage_windows(planes, stage, t, plan.nby, vec)
            # every window cell the kernel can read was copied
            used = win.reshape(len(ids), fs.WIN_X, fs.WIN_ROW)[
                :, :, fs.WIN_J0 - 1:fs.WIN_J0 + TY + 1]
            assert np.isfinite(used).all()
            words = fs.stage_nodes(ctxw, range(4), t, plan.nby)
            offs, inside = fs.window_offsets(words, t, X, Y, plan.nby)
            i0, j0 = (t // plan.nby) * TX, (t % plan.nby) * TY
            li, lj = np.nonzero(inside)
            gi, gj = i0 + li, j0 + lj
            np.testing.assert_array_equal(words[:, li, lj], ctxw[:, gi, gj])
            for stack, node_ids in ((idn, range(4)),
                                    (planes, layout["node"]),
                                    (aux, layout["aux"])):
                got = fs.stage_nodes(stack, node_ids, t, plan.nby)
                np.testing.assert_array_equal(
                    got[:, li, lj], stack[np.asarray(node_ids)][:, gi, gj])
            for s, p in enumerate(ids):
                got = win[s][offs[:, li, lj]]
                np.testing.assert_array_equal(got[0], planes[p, gi, gj])
                for d in range(4):
                    np.testing.assert_array_equal(
                        got[1 + d], want[p][d][gi, gj],
                        err_msg=f"plane {p}, neighbour {'LRUD'[d]}")
                    np.testing.assert_array_equal(got[1 + d],
                                                  jwant[p][d][gi, gj])
            seen[gi, gj] = True
            ti, tj = divmod(t, plan.nby)
            on_frame = (ti in (0, plan.nbx - 1)) or (tj in (0, plan.nby - 1))
            frame["edge" if on_frame else "off"] += 1
    # every node of the general tiles was checked, and the cases cover the
    # grid's edges, the strip halos and tiles off the frame
    np.testing.assert_array_equal(seen, plan.node_mask(
        plan.general_tiles).numpy())
    assert seen[0].any() and seen[-1].any()
    if strips is not None:
        H = fs.halo_depth(step.params)
        assert seen[:H].any() or seen[-H:].any()
    if deck == "step_64":
        assert frame["off"] > 0
