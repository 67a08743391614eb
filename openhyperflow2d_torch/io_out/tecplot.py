"""Tecplot/gnuplot ASCII output, RMS and monitor files.

Byte-compatible with the reference writers so existing viewplt.sh /
view_RMS.sh tooling keeps working:

* ``SaveData2D`` field snapshot (deeps2d_core.cpp:2589-2673) —
  VARIABLES = X, R|Y, U, V, T, p, Rho, Y_fuel, Y_ox, Y_cp, Y_i, mu_t/mu|p*,
  Mach, l_min, y+, Cp; ZONE I×J POINT, values in the same formatting;
* ``SaveRMS`` residual history (2545-2587);
* ``SaveMonitors`` probe traces (2532-2569).
"""

from __future__ import annotations

import math

import numpy as np

from ..core import flags as fl


def _fmt(v: float) -> str:
    """C++ ostream default formatting: 6 significant digits."""
    return f"{v:.6g}"


def save_data_2d(path: str, grid_meta, state, params, global_time: float,
                 mode_append: bool = False, is_p_asterisk_out: bool = False,
                 cp_arr=None):
    """Write a field snapshot (Tecplot POINT zone, gnuplot-compatible rows).

    ``grid_meta`` needs CT (host int array), l_min; ``state`` needs numpy
    S, U, V, Tg, p, mu_t, mu, y_plus arrays.

    When ``is_p_asterisk_out`` the RT column (12) carries total pressure
    p* instead of mu_t/mu (deeps2d_core.cpp:2644-2647); ``cp_arr``, when
    given (the CLI passes ``calc_cp`` under ``is_Cx_calc``), fills the
    final Cp column for every node (deeps2d_core.cpp:2664-2668).
    """
    X, Y = params.MaxX, params.MaxY
    ct = np.asarray(grid_meta.CT).astype(np.int64)
    solid = (ct & fl.CT_SOLID_2D) == fl.CT_SOLID_2D
    S = np.asarray(state.S)
    U = np.asarray(state.U)
    V = np.asarray(state.V)
    Tg = np.asarray(state.Tg)
    p = np.asarray(state.p)
    mu_t = np.asarray(state.mu_t)
    mu = np.asarray(state.mu)
    y_plus = np.asarray(state.y_plus)
    l_min = np.asarray(grid_meta.l_min)

    rt = "p*" if is_p_asterisk_out else "mu_t/mu"
    yr = "R" if params.ft == fl.FT_FLAT else "Y"   # (sic: FT==1 test, 2601)
    # NOTE: the reference tests `FT == 1` against FT_FLAT==0/FT_AXI==1, so
    # flat runs print "Y" and axisymmetric print "R"... actually FT==1 is
    # axisymmetric -> "R".  Keep the reference's output exactly:
    yr = "R" if params.ft == 1 else "Y"

    dx_out = (params.dx * X) / (X - 1)
    dy_out = (params.dy * Y) / (Y - 1)

    lines = []
    lines.append(
        f"VARIABLES = X, {yr}, U, V, T, p, Rho, Y_fuel, Y_ox, Y_cp, Y_i, "
        f"{rt}, Mach, l_min, y+, Cp\n")
    lines.append(f'ZONE T="Time: {_fmt(global_time)} sec." I= {X} J= {Y} '
                 f'F=POINT\n')
    k_arr = np.where(state.CP != state.R, state.CP / np.where(
        state.CP != state.R, state.CP - state.R, 1), 0.0)
    if is_p_asterisk_out:
        from ..postproc.outcfd import p_asterisk
        p_ast = p_asterisk(state)
    for j in range(Y):
        for i in range(X):
            row = [f"{i * dx_out * 1.e3:.6g}", f"{dy_out * j * 1.e3:.6g}"]
            mach = 0.0
            if not solid[i, j]:
                a = math.sqrt(max(k_arr[i, j] * state.R[i, j] * Tg[i, j],
                                  0.0) + 1.e-30)
                w = math.sqrt(U[i, j] ** 2 + V[i, j] ** 2 + 1.e-30)
                mach = w / a
                row += [_fmt(U[i, j]), _fmt(V[i, j]), _fmt(Tg[i, j]),
                        _fmt(p[i, j]), _fmt(S[0, i, j])]
                if S[0, i, j] != 0.0:
                    yfu = S[4, i, j] / S[0, i, j]
                    yox = S[5, i, j] / S[0, i, j]
                    ycp = S[6, i, j] / S[0, i, j]
                    row += [_fmt(yfu), _fmt(yox), _fmt(ycp),
                            _fmt(abs(1 - yfu - yox - ycp))]
                    if is_p_asterisk_out:
                        row.append(_fmt(p_ast[i, j]))
                    else:
                        row.append(_fmt(mu_t[i, j] / mu[i, j]
                                        if mu[i, j] != 0 else 0.0))
                else:
                    row += ["+0.", "+0", "+0", "+0", "+0"]
            else:
                row += ["0", "0", _fmt(Tg[i, j]), "0", "0", "0", "0", "0",
                        "0", "0"]
            if not solid[i, j] and mach > 1.e-30:
                row += [_fmt(mach), _fmt(l_min[i, j]), _fmt(y_plus[i, j])]
            else:
                row += ["0", "0", "0"]
            # final Cp column: Calc_Cp per node when is_Cx_calc (the CLI
            # passes cp_arr), "0" otherwise (deeps2d_core.cpp:2664-2668)
            row.append(_fmt(cp_arr[i, j]) if cp_arr is not None else "0")
            lines.append("  ".join(row) + "\n")
        lines.append("\n")

    fmode = "a" if mode_append else "w"
    with open(path, fmode) as f:
        f.writelines(lines)


RMS_NAMES = ["Rho", "Rho*U", "Rho*V", "Rho*E", "Rho*Y_fu", "Rho*Y_ox",
             "Rho*Y_cp", "k", "eps"]


def save_rms_header(path: str):
    with open(path, "w") as f:
        f.write("#VARIABLES = N, RMS(Rho), RMS(Rho*U), RMS(Rho*V), "
                "RMS(Rho*E), RMS(Rho*Y_fu), RMS(Rho*Y_ox), RMS(RhoY*cp), "
                "RMS(k), RMS(eps)\n")


def save_rms_rows(path: str, start_iter: int, rms_history: np.ndarray,
                  every: int = 1):
    """Append RMS rows; rms_history shape (n_iters, 9)."""
    with open(path, "a") as f:
        for it in range(0, rms_history.shape[0], every):
            row = " ".join(_fmt(v) for v in rms_history[it])
            f.write(f"{start_iter + it} {row} \n")


def save_monitors_header(path: str, n_points: int):
    cols = "".join(f", Point-{i+1}.p, Point-{i+1}.T"
                   for i in range(n_points))
    with open(path, "w") as f:
        f.write(f"#VARIABLES = Time{cols}\n")


def save_monitors_row(path: str, t: float, probes):
    with open(path, "a") as f:
        f.write(_fmt(t) + " "
                + " ".join(f"{_fmt(p)} {_fmt(T)}" for (p, T) in probes)
                + " \n")


def read_tecplot_zone(path: str, X: int, Y: int, zone: int = -1):
    """Parse a reference/our Tecplot POINT file; returns dict of (X, Y)
    arrays for the standard 16 variables.  ``zone`` selects which snapshot
    (-1 = last)."""
    names = ["X", "R", "U", "V", "T", "p", "Rho", "Y_fuel", "Y_ox", "Y_cp",
             "Y_i", "mu_t_mu", "Mach", "l_min", "y_plus", "Cp"]
    zones = []
    rows = None
    with open(path) as f:
        for line in f:
            ls = line.strip()
            if ls.startswith("VARIABLES"):
                continue
            if ls.startswith("ZONE"):
                rows = []
                zones.append(rows)
                continue
            if not ls:
                continue
            if rows is None:
                continue
            vals = ls.split()
            if len(vals) >= 16:
                rows.append([float(v) for v in vals[:16]])
    data = np.asarray(zones[zone])
    assert data.shape[0] == X * Y, (data.shape, X * Y)
    out = {}
    for c, name in enumerate(names):
        out[name] = data[:, c].reshape(Y, X).T   # file is j-major
    return out
