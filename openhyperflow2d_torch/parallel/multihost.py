"""Multi-process runtime of the strip path.

Counterpart of ``openhyperflow2d_tpu/parallel/multihost.py:24-98``.  As
there, every process parses the deck and builds the same host case (the
reference re-parses on every rank, hf2d_start.cpp:142-229); each rank then
puts only its strip on its device (parallel/shard_step), and the output is
assembled on rank 0 (the reference's rank-0 gather,
deeps2d_core.cpp:1679-1714).

Launch with ``torchrun --nproc-per-node N script.py``, where the script
calls ``init_distributed()``; or pass the rank, the world size and a
FileStore path (the tests do, so no TCP port can collide).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..core.state import SolverState
from .comm import DistComm


def init_distributed(backend: str = "nccl", rank: int = None,
                     world_size: int = None, store_path: str = None,
                     init_method: str = None) -> DistComm:
    """Join the process group and return its communicator.  Without
    arguments the rank, world size and rendezvous come from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); ``store_path``
    rendezvous through a torch.distributed.FileStore there instead.  Under
    NCCL each rank takes the CUDA device LOCAL_RANK (default: rank modulo
    the device count)."""
    if not dist.is_initialized():
        if store_path is not None:
            store = dist.FileStore(store_path, world_size)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=world_size)
        else:
            # torchrun's environment gives the rank and world size where
            # they are not passed (torch takes -1 for "from the
            # environment", and refuses None)
            dist.init_process_group(
                backend, init_method=init_method,
                rank=-1 if rank is None else rank,
                world_size=-1 if world_size is None else world_size)
    if dist.get_backend() == "nccl":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return DistComm()


def is_primary() -> bool:
    """The output-writing process (the reference's rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_state(state, comm, X: int):
    """The whole grid's SolverState from a StripState, on the primary
    process's device (None on the other ranks): each field's strips joined
    along X, the zero pad columns dropped."""
    kw = {}
    # every rank takes part in every field's gather, primary or not
    for f in dataclasses.fields(SolverState):
        parts = [getattr(st, f.name) for st in state.strips]
        if parts[0].dim() < 2:
            kw[f.name] = parts[0]
            continue
        full = comm.gather(parts)
        kw[f.name] = None if full is None else full[..., :X, :]
    return SolverState(**kw) if kw["S"] is not None else None


def gather_to_host(state, comm, X: int):
    """{field: numpy array} of the whole grid on the primary process, None
    on the other ranks."""
    full = gather_state(state, comm, X)
    if full is None:
        return None
    return {k: v.detach().cpu().contiguous().numpy()
            for k, v in full.__dict__.items()}
