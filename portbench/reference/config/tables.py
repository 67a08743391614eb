"""Piecewise-linear property tables.

The host-side :class:`Table` (reference ``Table::GetVal`` semantics,
obj_data/obj_data.cpp:1822-1859) is the port's copy of the JAX package's
numpy class, and :func:`table_lookup` is the tensor form of
``openhyperflow2d_tpu.config.tables.table_lookup`` with the same branch
order and the same arithmetic, so float64 results are bitwise equal to the
JAX version.

Exact reference semantics (deliberately preserved, including quirks):

* single-row tables return ``y[0]``;
* ``x <= x[0]``  -> linear extrapolation on the first segment (i = 1);
* ``x >= x[n-1]`` -> linear extrapolation on the last segment (i = n-1);
* otherwise the first ascending bracket ``x[i-1] <= x < x[i]`` wins.  Tables
  stored in descending order (several shipped decks do this, e.g. ``lam_OX``)
  therefore always resolve through the two boundary checks;
* the "zero table" singleton always returns 0 (obj_data.cpp:1678).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Table", "table_lookup"]


@dataclass
class Table:
    """Host-side (x, y) table with reference-exact interpolation."""

    x: np.ndarray
    y: np.ndarray
    name: str = ""
    is_zero: bool = field(default=False)

    @classmethod
    def zero(cls) -> "Table":
        return cls(np.zeros(1), np.zeros(1), name="ZeroTable", is_zero=True)

    @classmethod
    def constant(cls, value: float, name: str = "") -> "Table":
        return cls(np.zeros(1), np.asarray([value], dtype=np.float64),
                   name=name)

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    def get_val(self, q: float) -> float:
        """Scalar ``Table::GetVal`` (obj_data.cpp:1822-1859)."""
        if self.is_zero:
            return 0.0
        x, y, n = self.x, self.y, self.n
        if n == 1:
            return float(y[0])
        if q <= x[0]:
            i = 1
        elif q >= x[n - 1]:
            i = n - 1
        else:
            i = n - 1
            for k in range(1, n):
                if x[k - 1] <= q < x[k]:
                    i = k
                    break
        return float(y[i] + (y[i - 1] - y[i]) * (q - x[i]) / (x[i - 1] - x[i]))

    def __call__(self, q: float) -> float:
        return self.get_val(q)


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
