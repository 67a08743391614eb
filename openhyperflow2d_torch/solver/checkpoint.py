"""Checkpoint / resume: the swap-file analog.

Counterpart of ``openhyperflow2d_tpu/solver/checkpoint.py`` with its file
layout: a compressed npz of the dynamic SolverState, one array a field
under the field's name, plus ``__version``, ``__last_iter``,
``__global_time`` and ``__shape`` (MaxX, MaxY).  The static GridMeta is
rebuilt from the deck.  A checkpoint written by either package restores
into the other.  Restore validates the grid shape, as the reference
validates the swap file's size (obj_data.cpp:117-319).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.state import SolverState

CHECKPOINT_VERSION = 1
STATE_FIELDS = [f.name for f in dataclasses.fields(SolverState)]


def save_checkpoint(path: str, solver, st: dict = None) -> None:
    """Persist the solver's dynamic state and bookkeeping.  ``st``: a
    host state already fetched (``Solver.host_state()``, a collective on
    the strip path over several ranks: fetch on every rank, write on the
    primary only)."""
    state = st if st is not None else solver.host_state()
    np.savez_compressed(
        path,
        __version=np.asarray(CHECKPOINT_VERSION),
        __last_iter=np.asarray(solver.last_iter),
        __global_time=np.asarray(solver.global_time),
        __shape=np.asarray([solver.params.MaxX, solver.params.MaxY]),
        **{f: np.asarray(state[f]) for f in STATE_FIELDS})


def load_checkpoint(path: str, solver) -> None:
    """Restore a checkpoint into an initialized Solver (the PreloadFlag
    path: geometry and BC setup ran, the dynamic fields are overwritten),
    on the solver's device and, on the strip path, into its strips (the
    split ``Solver`` makes of its initial state)."""
    p = solver.params
    with np.load(path) as z:
        shape = z["__shape"]
        if (int(shape[0]), int(shape[1])) != (p.MaxX, p.MaxY):
            raise ValueError(
                f"checkpoint grid {tuple(shape)} != case grid "
                f"{(p.MaxX, p.MaxY)}")
        dev = "cpu" if solver.comm is not None else solver.device
        state = SolverState(**{
            f: torch.as_tensor(np.asarray(z[f]), dtype=p.torch_dtype,
                               device=dev) for f in STATE_FIELDS})
        solver.last_iter = int(z["__last_iter"])
        solver.global_time = float(z["__global_time"])
    solver.state = (state if solver.comm is None
                    else solver._chunk_fn.scatter(state))
