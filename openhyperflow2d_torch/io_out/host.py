"""The solver's host state as the output writers read it."""

from __future__ import annotations

from types import SimpleNamespace


def host_view(fields: dict) -> SimpleNamespace:
    """``Solver.host_state()``'s {field: numpy array} read by attribute
    (``st.S``, ``st.Tg``, ...), as the writers of io_out/tecplot and
    postproc/outcfd, copies of the JAX package's, read its SolverState."""
    return SimpleNamespace(**fields)
