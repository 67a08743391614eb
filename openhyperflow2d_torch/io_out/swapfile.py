"""Reference `.hf2d` swap-file import/export.

Counterpart of ``openhyperflow2d_tpu.io_out.swapfile``, with its own copy of
the numpy layout code and a torch ``state_from_swap``.  The reference
persists its whole ``FlowNode2D<double,3>`` matrix as one raw binary
(obj_data.cpp:117-319) and resumes from it (`PreloadFlag`).  This module
reads/writes that exact byte layout, so a swap file written by either
package, or by the reference, resumes in the other; for the same state the
two packages write the same bytes.

Layout extracted from the shipped headers with a compiler probe
(g++ x86-64, FP=double, NUM_COMPONENTS=3, _UNIFORM_MESH_): 1248 bytes per
node, field offsets below; the matrix is stored row-major in X
(``Ptr[x*MaxY + y]``, umatrix2d MSO_YX — utl/umatrix2d.hpp:224-242).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.state import SolverState
from .host import host_view

NODE_SIZE = 1248

# field -> (offset, dtype, count)
LAYOUT = {
    "S": (0, "<f8", 9),
    "dSdx": (72, "<f8", 9),
    "dSdy": (144, "<f8", 9),
    "TurbType": (216, "<u8", 1),
    "l_min": (224, "<f8", 1),
    "y_plus": (232, "<f8", 1),
    "Re_local": (240, "<f8", 1),
    "mu_t": (248, "<f8", 1),
    "lam_t": (256, "<f8", 1),
    "dkdx": (264, "<f8", 1),
    "dkdy": (272, "<f8", 1),
    "depsdx": (280, "<f8", 1),
    "depsdy": (288, "<f8", 1),
    "x": (296, "<f8", 1),
    "y": (304, "<f8", 1),
    "p": (352, "<f8", 1),
    "idXl": (360, "<i4", 1),
    "idYu": (364, "<i4", 1),
    "idXr": (368, "<i4", 1),
    "idYd": (372, "<i4", 1),
    "NGX": (376, "<i4", 1),
    "NGY": (380, "<i4", 1),
    "CT": (384, "<u8", 1),
    "i_wall": (392, "<i4", 1),
    "j_wall": (396, "<i4", 1),
    "beta": (400, "<f8", 9),
    "Q_conv": (472, "<f8", 1),
    "time": (480, "<f8", 1),
    "k": (488, "<f8", 1),
    "R": (496, "<f8", 1),
    "lam": (504, "<f8", 1),
    "mu": (512, "<f8", 1),
    "CP": (520, "<f8", 1),
    "Diff": (528, "<f8", 1),
    "Tf": (536, "<f8", 1),
    "A": (544, "<f8", 9),
    "B": (616, "<f8", 9),
    "F": (688, "<f8", 9),
    "RX": (760, "<f8", 9),
    "RY": (832, "<f8", 9),
    "Src": (904, "<f8", 9),
    "SrcAdd": (976, "<f8", 9),
    "Tg": (1048, "<f8", 1),
    "U": (1056, "<f8", 1),
    "V": (1064, "<f8", 1),
    "Y": (1072, "<f8", 4),
    "Uw": (1104, "<f8", 1),
    "Vw": (1112, "<f8", 1),
    "droYdx": (1120, "<f8", 4),
    "droYdy": (1152, "<f8", 4),
    "dUdx": (1184, "<f8", 1),
    "dUdy": (1192, "<f8", 1),
    "dVdx": (1200, "<f8", 1),
    "dVdy": (1208, "<f8", 1),
    "dTdx": (1216, "<f8", 1),
    "dTdy": (1224, "<f8", 1),
    "BGX": (1232, "<f8", 1),
    "BGY": (1240, "<f8", 1),
}


def _np_dtype():
    fields = {}
    for name, (off, dt, count) in LAYOUT.items():
        fields[name] = ((dt, (count,)) if count > 1 else dt, off)
    return np.dtype({"names": list(fields),
                     "formats": [f[0] for f in fields.values()],
                     "offsets": [f[1] for f in fields.values()],
                     "itemsize": NODE_SIZE})


def read_swap_file(path: str, MaxX: int, MaxY: int) -> dict:
    """Read a reference .hf2d into a dict of (X, Y[, n]) arrays."""
    raw = np.fromfile(path, dtype=_np_dtype())
    if raw.shape[0] != MaxX * MaxY:
        raise ValueError(f"swap file has {raw.shape[0]} nodes, expected "
                         f"{MaxX * MaxY}")
    grid = raw.reshape(MaxX, MaxY)
    out = {}
    for name, (off, dt, count) in LAYOUT.items():
        a = grid[name]
        if count > 1:
            a = np.moveaxis(a, -1, 0)       # -> (count, X, Y)
        out[name] = np.ascontiguousarray(a)
    return out


def swap_size_matches(path: str, MaxX: int, MaxY: int) -> bool:
    """PreloadFlag check: the swap file exists and has exactly
    MaxX*MaxY nodes (obj_data.cpp:150-238 recreates on size mismatch —
    we simply decline to preload, which the reference's recreate-and-
    zero-fill path is equivalent to for the caller)."""
    return (os.path.exists(path)
            and os.path.getsize(path) == MaxX * MaxY * NODE_SIZE)


def grid_from_swap(grid, d: dict) -> None:
    """Populate a HostGrid from a read_swap_file dict (the PreloadFlag
    resume path: the reference maps the whole FlowNode2D matrix from the
    swap, deeps2d_core.cpp:3197-3252, so every per-node field — static
    flags included — comes from the file)."""
    grid.S[:] = d["S"]
    grid.beta[:] = d["beta"]
    grid.Src[:] = d["Src"]
    grid.Y[:] = d["Y"]
    for name in ("U", "V", "Uw", "Vw", "p", "Tg", "R", "CP", "lam", "mu",
                 "mu_t", "lam_t", "y_plus", "BGX", "BGY", "l_min", "time"):
        getattr(grid, name)[:] = d[name]
    grid.CT[:] = d["CT"].astype(np.int64)
    grid.TCT[:] = d["TurbType"].astype(np.int64)
    for name in ("idXl", "idXr", "idYu", "idYd"):
        getattr(grid, name)[:] = d[name].astype(np.uint8)
    grid.NGX[:] = d["NGX"].astype(np.int8)
    grid.NGY[:] = d["NGY"].astype(np.int8)
    grid.i_wall[:] = d["i_wall"].astype(np.int32)
    grid.j_wall[:] = d["j_wall"].astype(np.int32)
    # dynamic fields that live in SolverState but not HostGrid are staged
    # through grid.extras (consumed by core/state.state_from_grid);
    # dUdy/dVdx additionally feed the host recalc_y_plus
    grid.extras["init_A"] = np.array(d["A"])
    grid.extras["init_B"] = np.array(d["B"])
    grid.extras["init_F"] = np.array(d["F"])
    grid.extras["init_dSdx"] = np.array(d["dSdx"])
    grid.extras["init_dSdy"] = np.array(d["dSdy"])
    grid.extras["init_SrcAdd"] = np.array(d["SrcAdd"])
    grid.extras["init_droYdx"] = np.array(d["droYdx"])
    grid.extras["init_droYdy"] = np.array(d["droYdy"])
    grid.extras["init_Q_conv"] = np.array(d["Q_conv"])
    for name in ("dUdx", "dUdy", "dVdx", "dVdy", "dTdx", "dTdy",
                 "dkdx", "dkdy", "depsdx", "depsdy"):
        grid.extras[f"init_{name}"] = np.array(d[name])
        grid.extras[name] = np.array(d[name])


# SolverState field -> swap-file field of every dynamic field the file holds
STATE_FROM_SWAP = {f: f for f in (
    "S", "beta", "A", "B", "F", "dSdx", "dSdy", "Src", "SrcAdd", "U", "V",
    "p", "Tg", "R", "CP", "lam", "mu", "mu_t", "lam_t", "droYdx", "droYdy",
    "dUdx", "dUdy", "dVdx", "dVdy", "dTdx", "dTdy", "dkdx", "dkdy",
    "depsdx", "depsdy", "y_plus", "Q_conv")}
STATE_FROM_SWAP["Yc"] = "Y"


def state_from_swap(path: str, solver) -> None:
    """Load a reference .hf2d checkpoint into a Solver (PreloadFlag path):
    every dynamic field on the solver's device in its dtype and, on the
    strip path, into its strips, as ``solver/checkpoint`` restores; the
    fields the file does not hold (dt) keep the solver's values."""
    p = solver.params
    d = read_swap_file(path, p.MaxX, p.MaxY)
    strips = solver.comm is not None
    dev = "cpu" if strips else solver.device
    kw = {f: torch.as_tensor(d[name], dtype=p.torch_dtype, device=dev)
          for f, name in STATE_FROM_SWAP.items()}
    kw["dt"] = (solver.state.strips[0] if strips else solver.state).dt
    state = SolverState(**kw)
    solver.state = solver._chunk_fn.scatter(state) if strips else state
    # GlobalTime restored from node (0,0) (deeps2d_core.cpp:4618-4621)
    solver.global_time = float(d["time"][0, 0])


def write_swap_file(path: str, solver, grid, st=None) -> None:
    """Write the solver state as a reference-layout .hf2d.

    ``st``: optionally a pre-fetched host state — under a multi-process
    mesh host_state() is a collective, so the caller must fetch it on
    every process and only WRITE on the primary.  ``st`` and
    ``Solver.host_state()`` are {field: numpy array} dicts."""
    p = solver.params
    st = host_view(st if st is not None else solver.host_state())
    out = np.zeros((p.MaxX, p.MaxY), dtype=_np_dtype())

    def put(name, val, count=1):
        if count > 1:
            out[name][...] = np.moveaxis(np.asarray(val, np.float64), 0, -1)
        else:
            out[name][...] = np.asarray(val)

    put("S", st.S, 9)
    put("beta", st.beta, 9)
    put("A", st.A, 9)
    put("B", st.B, 9)
    put("F", st.F, 9)
    put("dSdx", st.dSdx, 9)
    put("dSdy", st.dSdy, 9)
    put("Src", st.Src, 9)
    put("SrcAdd", st.SrcAdd, 9)
    for n in ("U", "V", "p", "Tg", "R", "CP", "lam", "mu", "mu_t",
              "lam_t", "dUdx", "dUdy", "dVdx", "dVdy", "dTdx", "dTdy",
              "dkdx", "dkdy", "depsdx", "depsdy", "y_plus", "Q_conv"):
        put(n, getattr(st, n))
    put("Y", st.Yc, 4)
    put("droYdx", st.droYdx, 4)
    put("droYdy", st.droYdy, 4)
    put("Uw", grid.Uw)
    put("Vw", grid.Vw)
    put("CT", grid.CT.astype(np.uint64))
    put("TurbType", grid.TCT.astype(np.uint64))
    put("idXl", grid.idXl)
    put("idXr", grid.idXr)
    put("idYu", grid.idYu)
    put("idYd", grid.idYd)
    put("NGX", grid.NGX)
    put("NGY", grid.NGY)
    put("BGX", grid.BGX)
    put("BGY", grid.BGY)
    put("i_wall", grid.i_wall)
    put("j_wall", grid.j_wall)
    put("l_min", grid.l_min)
    put("Tf", grid.Tf)
    xi = (np.arange(p.MaxX)[:, None] + 0.5) * p.dx
    yj = (np.arange(p.MaxY)[None, :] + 0.5) * p.dy
    put("x", np.broadcast_to(xi, (p.MaxX, p.MaxY)))
    put("y", np.broadcast_to(yj, (p.MaxX, p.MaxY)))
    kk = np.where(np.asarray(st.CP) != np.asarray(st.R),
                  np.asarray(st.CP) / np.where(
                      np.asarray(st.CP) != np.asarray(st.R),
                      np.asarray(st.CP) - np.asarray(st.R), 1), 0.0)
    put("k", kk)
    t = np.zeros((p.MaxX, p.MaxY))
    t[0, 0] = solver.global_time
    put("time", t)
    out.tofile(path)
