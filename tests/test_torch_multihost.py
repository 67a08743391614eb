"""The strip path over ``torch.distributed`` (parallel/comm.DistComm,
parallel/multihost) under gloo on the CPU.

Each test spawns its ranks with ``torch.multiprocessing`` (spawn); they meet
through a ``FileStore`` in ``tmp_path``, so no TCP port can collide between
test workers.  Every rank builds the same case with the port alone (the
reference re-parses the deck on every rank) and runs its strip; rank 0
gathers the state and saves it with the diags.  The parent runs the same
chunks with ``LocalComm`` and compares:

* 2 ranks: the kernel strip chunk (plain versions on the CPU), sequential
  and overlapped, and the eager strip chunk, each bit for bit equal to
  ``LocalComm(2)``: the same float64 arithmetic, and a sum over two shards
  is the same in either order.  ``gather_to_host`` returns the whole grid on
  rank 0 and None on rank 1; the per-cycle y+ update goes through
  ``all_gather``.
* 1 rank: the ring is the rank itself (a local copy), so the strip is the
  whole grid between two zeroed halos: bit for bit equal to ``LocalComm(1)``.

A rank that hangs fails its test after ``TIMEOUT`` seconds (the processes
are killed) instead of stalling the suite.
"""

import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from openhyperflow2d_torch.examples import reacting_rans_deck
from openhyperflow2d_torch.parallel.comm import LocalComm
from openhyperflow2d_torch.solver.init import build_case
from openhyperflow2d_torch.solver.runner import Solver

TIMEOUT = 120
ITERS = 7
RUNS = {"kernel": {"use_kernels": True},
        "overlap": {"use_kernels": True, "overlap": True},
        "eager": {"use_kernels": False}}


def make_case():
    return build_case(reacting_rans_deck(64, 32))


def drive(solver) -> dict:
    """ITERS iterations, the per-cycle y+ update, one more iteration; the
    gathered state and the diags (None off the primary rank)."""
    d = solver.run_iters(ITERS)
    solver.recalc_y_plus()
    d2 = solver.run_iters(1)
    st = solver.host_state()
    if st is None:
        return None
    st.update({f"diag_{k}": np.concatenate([v, d2[k]])
               for k, v in d.items()})
    return st


def rank_main(rank, world, store, out_dir):
    """One rank: join the group, run every chunk of RUNS, save rank 0's
    results (and every rank's gather result kind)."""
    torch.set_num_threads(1)
    from openhyperflow2d_torch.parallel.multihost import (init_distributed,
                                                          is_primary)
    comm = init_distributed("gloo", rank=rank, world_size=world,
                            store_path=store)
    assert comm.n == world and comm.shards == [rank]
    case = make_case()
    for name, kw in RUNS.items():
        st = drive(Solver(case, device="cpu", comm=comm, **kw))
        if is_primary():
            np.savez(os.path.join(out_dir, f"{name}.npz"), **st)
        elif st is not None:
            raise AssertionError("gather_to_host returned a state off rank 0")
    torch.distributed.destroy_process_group()


def spawn(world, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=rank_main, args=(r, world, store,
                                                 str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish in {TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world
    return {name: dict(np.load(tmp_path / f"{name}.npz")) for name in RUNS}


@pytest.mark.parametrize("world", [1, 2])
def test_dist_comm_matches_local_comm(world, tmp_path):
    got = spawn(world, tmp_path)
    case = make_case()
    for name, kw in RUNS.items():
        want = drive(Solver(case, device="cpu", comm=LocalComm(world, "cpu"),
                            **kw))
        assert set(got[name]) == set(want), name
        for k, v in want.items():
            assert got[name][k].shape == v.shape, (name, k)
            np.testing.assert_array_equal(got[name][k], v, f"{name} {k}")
        # the gathered state is the whole grid
        assert want["S"].shape == (9, case.params.MaxX, case.params.MaxY)
        assert not want["diag_unstable"].any()
