"""Piecewise-linear property tables on torch tensors.

The host-side :class:`Table` (reference ``Table::GetVal`` semantics) is
imported from the JAX package, which keeps it numpy-only.  This module adds
the tensor form of ``openhyperflow2d_tpu.config.tables.table_lookup`` with
the same branch order and the same arithmetic, so float64 results are
bitwise equal to the JAX version.
"""

from __future__ import annotations

import torch

from openhyperflow2d_tpu.config.tables import Table

__all__ = ["Table", "table_lookup"]


def table_lookup(xs, ys, q, ascending: bool = False):
    """Vectorized ``Table::GetVal`` over the tensor ``q``.

    ``xs``/``ys`` are 1-D knot tensors (or tuples of 0-d tensors / floats).
    Boundary checks win over the ascending bracket scan, exactly as the
    reference does.  ``ascending`` (a claim the caller establishes on the
    host, e.g. ``SolverParams.chem_asc``) selects the telescoped
    slope-delta form

        f(q) = y0 + m1 (q - x0) + sum_s (m_s - m_{s-1}) relu(q - x_{s-1}),

    an exact identity of the masked form for strictly ascending knots.
    """
    n = len(xs)
    if n == 1:
        return torch.as_tensor(ys[0], dtype=q.dtype,
                               device=q.device).expand(q.shape)

    if ascending:
        slopes = [(ys[s] - ys[s - 1]) / (xs[s] - xs[s - 1])
                  for s in range(1, n)]
        out = ys[0] + slopes[0] * (q - xs[0])
        for s in range(2, n):
            out = out + ((slopes[s - 1] - slopes[s - 2])
                         * torch.clamp_min(q - xs[s - 1], 0.0))
        return out

    lo = q <= xs[0]                 # -> segment 1
    hi = ~lo & (q >= xs[n - 1])     # -> segment n-1
    mid = ~lo & ~hi

    # first ascending bracket (exclusive running-or), C++ scan order
    seen = torch.zeros_like(lo)
    first = []
    for s in range(1, n):
        b = (q >= xs[s - 1]) & (q < xs[s])
        first.append(b & ~seen)
        seen = seen | b
    no_bracket = ~seen

    out = torch.zeros_like(q)
    for s in range(1, n):
        sel = mid & first[s - 1]
        if s == 1:
            sel = sel | lo
        if s == n - 1:
            sel = sel | hi | (mid & no_bracket)
        seg = ys[s] + (ys[s - 1] - ys[s]) * (q - xs[s]) / (xs[s - 1] - xs[s])
        out = out + torch.where(sel, seg, 0.0)
    return out
