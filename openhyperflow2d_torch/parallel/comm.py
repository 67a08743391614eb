"""Communicators of the X-strip decomposition (parallel/shard_step).

They take the place of the device mesh of
``openhyperflow2d_tpu/parallel/mesh.py`` and of the ``lax.ppermute`` /
``psum`` / ``pmax`` / ``pmin`` hooks of
``openhyperflow2d_tpu/parallel/shard_step.py``.  A communicator holds ``n``
shards (X strips) in a ring, ``shards`` of them in this process.  Every
call takes and returns a list with one entry per shard this process holds,
so the shard chunks have one code path for both forms:

* ``LocalComm(n, device)``: every shard in this process, on one device.
  The exchange is device copies; the reductions are
  ``torch.stack(...).amin/sum/amax`` on the device.
* ``DistComm(group)``: one shard per ``torch.distributed`` rank, NCCL for
  CUDA tensors and gloo for CPU tensors.  The exchange is
  ``batch_isend_irecv``; at world size 1 the ring is the rank itself, done
  as a local copy.

Nothing synchronizes with the host: collectives on CUDA tensors are
ordered on the current stream by ``Work.wait()``, and results stay on the
device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Pending:
    """An exchange in flight.  ``wait()`` orders the current stream (or,
    for gloo, the host) after it and returns ``(from_left, from_right)``."""

    def __init__(self, from_left, from_right, stream=None, works=(),
                 copies=()):
        self.result = (from_left, from_right)
        self.stream, self.works, self.copies = stream, works, copies

    def wait(self):
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_stream(
                self.stream)
        for w in self.works:
            w.wait()
        for dst, src in self.copies:
            dst.copy_(src)
        return self.result


def _destinations(out, like):
    return [torch.empty_like(t) for t in like] if out is None else out


class LocalComm:
    """``n`` shards, all in this process, on ``device`` (None: the GPU)."""

    def __init__(self, n: int, device=None):
        if n < 1:
            raise ValueError(f"a ring needs at least one shard, got {n}")
        self.n = n
        self.shards = list(range(n))
        self.device = torch.device("cuda" if device is None else device)
        self._side = None    # the CUDA side stream of async exchanges

    def exchange(self, left_edges, right_edges, from_left=None,
                 from_right=None, async_op=False):
        """The ring of shard_step.py:85-99 / :317-327: shard k receives its
        left neighbour's last columns (``right_edges[k-1]``) into
        ``from_left[k]`` and its right neighbour's first columns
        (``left_edges[k+1]``) into ``from_right[k]``; the destinations
        default to new tensors.  ``async_op``: the copies run on a side
        stream (CUDA) and the call returns a Pending."""
        n = self.n
        from_left = _destinations(from_left, right_edges)
        from_right = _destinations(from_right, left_edges)

        def copy():
            for k in range(n):
                from_left[k].copy_(right_edges[(k - 1) % n])
                from_right[k].copy_(left_edges[(k + 1) % n])

        if async_op and self.device.type == "cuda":
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            self._side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._side):
                copy()
            return Pending(from_left, from_right, stream=self._side)
        copy()
        return (Pending(from_left, from_right) if async_op
                else (from_left, from_right))

    def _reduce(self, xs, op):
        r = getattr(torch.stack(xs), op)(0)
        return [r] * len(xs)

    def all_min(self, xs):
        return self._reduce(xs, "amin")

    def all_sum(self, xs):
        return self._reduce(xs, "sum")

    def all_max(self, xs):
        return self._reduce(xs, "amax")

    def all_gather(self, xs):
        """Every shard's (..., X_loc, Y) block in ring order, joined along
        X, for each shard held here."""
        full = torch.cat(xs, -2)
        return [full] * len(xs)

    def gather(self, xs):
        """The blocks joined along X on the primary process (here: this
        one)."""
        return torch.cat(xs, -2)


class DistComm:
    """One shard per rank of a ``torch.distributed`` process group (None:
    the default group).  ``device``: where this rank's shard lives (None:
    the current CUDA device under NCCL, the CPU under gloo)."""

    def __init__(self, group=None, device=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.n = dist.get_world_size(group)
        self.shards = [self.rank]
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend(group) == "nccl" else "cpu")
        self.device = torch.device(device)

    def _peer(self, k: int) -> int:
        k %= self.n
        return k if self.group is None else dist.get_global_rank(
            self.group, k)

    def exchange(self, left_edges, right_edges, from_left=None,
                 from_right=None, async_op=False):
        """LocalComm.exchange between ranks: my last columns go right, my
        first columns go left.  Sends and receives are posted in the order
        that pairs them between two ranks that are each other's left and
        right neighbour (world size 2), and tagged by direction."""
        (left,), (right,) = left_edges, right_edges
        (into_l,), (into_r,) = (_destinations(from_left, right_edges),
                                _destinations(from_right, left_edges))
        if self.n == 1:
            into_l.copy_(right)
            into_r.copy_(left)
            return (Pending([into_l], [into_r]) if async_op
                    else ([into_l], [into_r]))
        recv_l = into_l if into_l.is_contiguous() else torch.empty_like(
            right, memory_format=torch.contiguous_format)
        recv_r = into_r if into_r.is_contiguous() else torch.empty_like(
            left, memory_format=torch.contiguous_format)
        g = self.group
        ops = [dist.P2POp(dist.isend, right.contiguous(),
                          self._peer(self.rank + 1), g, tag=1),
               dist.P2POp(dist.isend, left.contiguous(),
                          self._peer(self.rank - 1), g, tag=2),
               dist.P2POp(dist.irecv, recv_l, self._peer(self.rank - 1), g,
                          tag=1),
               dist.P2POp(dist.irecv, recv_r, self._peer(self.rank + 1), g,
                          tag=2)]
        copies = [(d, s) for d, s in ((into_l, recv_l), (into_r, recv_r))
                  if d is not s]
        pending = Pending([into_l], [into_r],
                          works=dist.batch_isend_irecv(ops), copies=copies)
        return pending if async_op else pending.wait()

    def _reduce(self, xs, op):
        (x,) = xs
        t = x.reshape(1).clone() if x.dim() == 0 else x.clone()
        dist.all_reduce(t, op=op, group=self.group)
        return [t.reshape(x.shape)]

    def all_min(self, xs):
        return self._reduce(xs, dist.ReduceOp.MIN)

    def all_sum(self, xs):
        return self._reduce(xs, dist.ReduceOp.SUM)

    def all_max(self, xs):
        return self._reduce(xs, dist.ReduceOp.MAX)

    def all_gather(self, xs):
        (x,) = xs
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(out, x, group=self.group)
        return [torch.cat(out, -2)]

    def gather(self, xs):
        """The blocks joined along X on rank 0 of the group; None on the
        other ranks."""
        (x,) = xs
        x = x.contiguous()
        out = ([torch.empty_like(x) for _ in range(self.n)]
               if self.rank == 0 else None)
        dist.gather(x, out, dst=self._peer(0), group=self.group)
        return torch.cat(out, -2) if self.rank == 0 else None
