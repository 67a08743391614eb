"""Post-processing parameters: totals, mass flow, forces, heat flux.

numpy re-implementation of libOutCFD (out_cfd_param.cpp:14-810): total
pressure/temperature, Schliren, averaged p/T probes, cross-section area and
mass-flow integrals, wall force integrals (flat / axisymmetric weights),
pressure and force coefficients Cp/Cx/Cy, nozzle discharge/thrust
coefficients Cd/Cv, and wall heat-flux / Stanton-number profiles.

Functions take host-side arrays (numpy views of the solver state + the
HostGrid metadata) and are exact ports of the reference formulas, including
the axisymmetric 2*pi*r area weights.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import flags as fl

PI = math.pi


def _k_arr(state):
    CP = np.asarray(state.CP)
    R = np.asarray(state.R)
    den = np.where(CP != R, CP - R, 1.0)
    return np.where(CP != R, CP / den, 0.0)


def p_asterisk(state):
    """Total pressure p* (out_cfd_param.cpp:23-31)."""
    k = _k_arr(state)
    Tg = np.asarray(state.Tg)
    U = np.asarray(state.U)
    V = np.asarray(state.V)
    a = np.sqrt(np.maximum(k * np.asarray(state.R) * Tg, 1e-300))
    mach = np.sqrt(U * U + V * V) / a
    return np.asarray(state.p) * (1.0 + (k - 1.0) * 0.5 * mach ** 2) ** (
        k / np.where(k != 1, k - 1.0, 1.0))


def t_asterisk(state):
    """Dynamic-temperature term (out_cfd_param.cpp:38-45)."""
    CP = np.asarray(state.CP)
    U = np.asarray(state.U)
    V = np.asarray(state.V)
    return np.where(CP > 0, (U * U + V * V) * 0.5 / np.where(CP > 0, CP, 1),
                    0.0)


def schliren(state):
    """|grad rho| from the stored dSdx/dSdy (out_cfd_param.cpp:33-35)."""
    gx = np.asarray(state.dSdx)[fl.i2d_Rho]
    gy = np.asarray(state.dSdy)[fl.i2d_Rho]
    return np.sqrt(gx * gx + gy * gy)


def _radius(grid, j):
    return (j + 0.5) * grid.dy


def calc_average_pressure(grid, state, x0, l, d):
    """CalcaveragePressure2D (47-90)."""
    solid = grid.is_cond(fl.CT_SOLID_2D)
    i_idx = np.arange(grid.MaxX)[:, None]
    j_idx = np.arange(grid.MaxY)[None, :]
    sel = (~solid & (i_idx > int(x0 / grid.dx))
           & (i_idx < int((l + x0) / grid.dx))
           & (j_idx < int(d / grid.dy)))
    p = np.asarray(state.p)
    if not sel.any():
        return 0.0
    if grid.ft == fl.FT_AXISYMMETRIC:
        v_i = 2 * PI * _radius(grid, j_idx) * grid.dy * grid.dx
        v_i = np.broadcast_to(v_i, sel.shape)
        return float((p * v_i)[sel].sum() / v_i[sel].sum())
    return float(p[sel].mean())


def calc_average_temperature(grid, state, x0, l, d, is_mid_enthalpy=False):
    """CalcaverageTemperature2D (92-140)."""
    solid = grid.is_cond(fl.CT_SOLID_2D)
    i_idx = np.arange(grid.MaxX)[:, None]
    j_idx = np.arange(grid.MaxY)[None, :]
    sel = (~solid & (i_idx > int(x0 / grid.dx))
           & (i_idx < int((l + x0) / grid.dx))
           & (j_idx < int(d / grid.dy)))
    Tg = np.asarray(state.Tg)
    if not sel.any():
        return 0.0
    if grid.ft == fl.FT_AXISYMMETRIC:
        v_i = 2 * PI * _radius(grid, j_idx) * grid.dy * grid.dx
        v_i = np.broadcast_to(v_i, sel.shape).copy()
        if is_mid_enthalpy:
            v_i = v_i * np.asarray(state.CP)
        return float((Tg * v_i)[sel].sum() / v_i[sel].sum())
    return float(Tg[sel].mean())


def calc_area_x(grid, x0, y0, dy):
    """CalcArea2D (142-168): open cross-section area at station x0."""
    i = int(x0 / grid.dx)
    j0 = int(y0 / grid.dy)
    j1 = int((y0 + dy) / grid.dy)
    solid = grid.is_cond(fl.CT_SOLID_2D)[i, j0:j1]
    if grid.ft == fl.FT_FLAT:
        return float((~solid).sum() * grid.dy)
    r = _radius(grid, np.arange(j0, j1))
    return float((2 * PI * grid.dy * r * ~solid).sum())


def calc_mass_flow_rate_x(grid, state, x0, y0, dy):
    """CalcMassFlowRateX2D (170-196)."""
    i = int(x0 / grid.dx)
    j0 = int(y0 / grid.dy)
    j1 = int((y0 + dy) / grid.dy)
    solid = grid.is_cond(fl.CT_SOLID_2D)[i, j0:j1]
    rhoU = np.asarray(state.S)[fl.i2d_RhoU][i, j0:j1]
    if grid.ft == fl.FT_FLAT:
        return float((grid.dy * rhoU * ~solid).sum())
    r = _radius(grid, np.arange(j0, j1))
    return float((2 * PI * grid.dy * r * rhoU * ~solid).sum())


def _wall_mask(grid):
    return (grid.is_cond(fl.CT_WALL_LAW_2D)
            | grid.is_cond(fl.CT_WALL_NO_SLIP_2D))


def _window(grid, x0, y0, dx, dy):
    i_idx = np.arange(grid.MaxX)[:, None]
    j_idx = np.arange(grid.MaxY)[None, :]
    return ((i_idx >= int(x0 / grid.dx)) & (i_idx <= int((x0 + dx) / grid.dx))
            & (j_idx >= int(y0 / grid.dy))
            & (j_idx <= int((y0 + dy) / grid.dy)))


def _shift(q, di, dj, fill=False):
    out = np.full_like(q, fill)
    if di == -1:
        out[1:, :] = q[:-1, :]
    elif di == 1:
        out[:-1, :] = q[1:, :]
    elif dj == -1:
        out[:, 1:] = q[:, :-1]
    elif dj == 1:
        out[:, :-1] = q[:, 1:]
    else:
        out = q.copy()
    return out


def calc_x_force(grid, state, x0, y0, dx, dy):
    """CalcXForce2D (256-318): pressure + viscous drag on wall nodes."""
    wall = _wall_mask(grid) & _window(grid, x0, y0, dx, dy)
    solid = grid.is_cond(fl.CT_SOLID_2D)
    p = np.asarray(state.p)
    mu_eff = np.asarray(state.mu) + np.asarray(state.mu_t)
    dUdy = np.abs(np.asarray(state.dUdy))
    U = np.asarray(state.U)
    j_idx = np.arange(grid.MaxY)[None, :]

    if grid.ft == fl.FT_FLAT:
        Sp = grid.dy
        Sd = grid.dx
    else:
        Sp = 2 * PI * (j_idx + 0.5) * grid.dy * grid.dy
        Sd = 2 * PI * (j_idx + 0.5) * grid.dy * grid.dx

    solid_left = _shift(solid, -1, 0)
    solid_right = _shift(solid, 1, 0)
    fp = np.where(wall & solid_left, -Sp * p,
                  np.where(wall & ~solid_left & solid_right, Sp * p, 0.0))

    gas_up = ~_shift(solid, 0, 1, fill=True)
    gas_dn = ~_shift(solid, 0, -1, fill=True)
    u_up = _shift(U, 0, 1)
    u_dn = _shift(U, 0, -1)
    drag = Sd * mu_eff * dUdy
    fd = np.where(wall & gas_up, np.where(u_up > 0, drag, -drag),
                  np.where(wall & gas_dn,
                           np.where(u_dn > 0, drag, -drag), 0.0))
    return float(fp.sum() + fd.sum())


def calc_y_force(grid, state, x0, y0, dx, dy):
    """CalcYForce2D (320-382)."""
    wall = _wall_mask(grid) & _window(grid, x0, y0, dx, dy)
    solid = grid.is_cond(fl.CT_SOLID_2D)
    p = np.asarray(state.p)
    mu_eff = np.asarray(state.mu) + np.asarray(state.mu_t)
    dVdx = np.abs(np.asarray(state.dVdx))
    V = np.asarray(state.V)
    j_idx = np.arange(grid.MaxY)[None, :]

    if grid.ft == fl.FT_FLAT:
        Sp = grid.dx
        Sd = grid.dy
    else:
        Sp = 2 * PI * _radius(grid, j_idx) * grid.dx
        Sd = 2 * PI * _radius(grid, j_idx) * grid.dy

    solid_dn = _shift(solid, 0, -1)
    solid_up = _shift(solid, 0, 1)
    fp = np.where(wall & solid_dn, -Sp * p,
                  np.where(wall & ~solid_dn & solid_up, Sp * p, 0.0))

    gas_right = ~_shift(solid, 1, 0, fill=True)
    gas_left = ~_shift(solid, -1, 0, fill=True)
    v_r = _shift(V, 1, 0)
    v_l = _shift(V, -1, 0)
    drag = -Sd * mu_eff * dVdx
    fd = np.where(wall & gas_right, np.where(v_r > 0, drag, -drag),
                  np.where(wall & gas_left,
                           np.where(v_l > 0, drag, -drag), 0.0))
    return float(fp.sum() + fd.sum())


def calc_cp(state, grid, flow2d):
    """Calc_Cp per node (384-389)."""
    wall_ns = grid.is_cond(fl.CT_WALL_NO_SLIP_2D)
    q = 0.5 * flow2d.ROG() * flow2d.Wg() ** 2
    return np.where(wall_ns, (np.asarray(state.p) - flow2d.Pg()) / q, 0.0)


def get_s(grid, x0, y0, dx, dy):
    """GetS (431-464): chord length of the wall window."""
    wall = _wall_mask(grid) & _window(grid, x0, y0, dx, dy)
    return float(wall.any(axis=1).sum() * grid.dx)


def get_fmid(grid, x0, y0, dx, dy):
    """GetFmid (391-429): frontal area of the wall window."""
    wall = _wall_mask(grid) & _window(grid, x0, y0, dx, dy)
    rows = wall.any(axis=0)
    if grid.ft == fl.FT_FLAT:
        return float(rows.sum() * grid.dy)
    j = np.arange(grid.MaxY)
    return float((2 * PI * (j + 0.5) * grid.dy * grid.dy * rows).sum())


def calc_cx(grid, state, x0, y0, dx, dy, flow2d):
    """Calc_Cx_2D (466-480)."""
    pmax = flow2d.ROG() * flow2d.Wg() ** 2 * 0.5 * get_s(grid, x0, y0, dx,
                                                         dy)
    if pmax == 0.0:
        return 0.0
    return calc_x_force(grid, state, x0, y0, dx, dy) / pmax


def calc_cy(grid, state, x0, y0, dx, dy, flow2d):
    """Calc_Cy_2D (482-497)."""
    pmax = flow2d.ROG() * flow2d.Wg() ** 2 * 0.5 * get_s(grid, x0, y0, dx,
                                                         dy)
    if pmax == 0.0:
        return 0.0
    return calc_y_force(grid, state, x0, y0, dx, dy) / pmax


def calc_cd(grid, state, x0, y0, dy, flow2d):
    """Nozzle discharge coefficient Calc_Cd (801-809)."""
    area = calc_area_x(grid, x0, y0, dy)
    if area == 0.0:
        return 0.0
    return (calc_mass_flow_rate_x(grid, state, x0, y0, dy)
            / flow2d.ROG() / flow2d.Wg() / area)


def calc_cv(grid, state, x0, y0, dy, p_amb, flow2d):
    """Nozzle thrust coefficient Calc_Cv (762-798)."""
    i = int(x0 / grid.dx)
    j0 = int(y0 / grid.dy)
    j1 = int((y0 + dy) / grid.dy)
    solid = grid.is_cond(fl.CT_SOLID_2D)[i, j0:j1]
    rhoU = np.asarray(state.S)[fl.i2d_RhoU][i, j0:j1]
    U = np.asarray(state.U)[i, j0:j1]
    p = np.asarray(state.p)[i, j0:j1]
    if grid.ft == fl.FT_FLAT:
        fv = (grid.dy * (rhoU * U + (p - p_amb)) * ~solid).sum()
    else:
        r = _radius(grid, np.arange(j0, j1))
        fv = (2 * PI * grid.dy * r * (rhoU * U + (p - p_amb)) * ~solid).sum()
    mp = calc_mass_flow_rate_x(grid, state, x0, y0, dy)
    if mp > 0.0:
        return float(fv / (flow2d.U() * mp))
    return 0.0


def smooth_x(a):
    """SmoothX (512-522) — in-place forward sweep, order-faithful.

    The reference's (j outer, i inner) sweep makes each column an
    independent recurrence along i (a[i-1] is already updated, a[i+1] is
    not), so the i loop stays sequential and all Y columns are processed
    as one vector — O(X) numpy ops instead of O(X*Y) interpreted ones.
    """
    X, Y = a.shape
    for i in range(1, X - 1):
        cond = (a[i + 1, :] > 0.0) & (a[i - 1, :] > 0.0)
        a[i, :] = np.where(cond, 0.5 * (a[i + 1, :] + a[i - 1, :]), a[i, :])
    return a


def smooth_y(a):
    """SmoothY (500-510) — sequential along j, vectorized across i (the
    reference's inner i loop only reads rows j±1, so it is parallel)."""
    X, Y = a.shape
    for j in range(1, Y - 1):
        cond = (a[:, j + 1] > 0.0) & (a[:, j - 1] > 0.0)
        a[:, j] = np.where(cond, 0.5 * (a[:, j + 1] + a[:, j - 1]), a[:, j])
    return a


def _fold_max_nonzero(heat, m, q):
    """One step of the reference heat-flux accumulator
    (out_cfd_param.cpp:648-679): where mask ``m``, ``heat`` becomes
    ``q`` if it is still exactly 0, else ``max(heat, q)``."""
    return np.where(m, np.where(heat != 0.0, np.maximum(heat, q), q), heat)


def _last_wall_value(vals, sel):
    """Per-column value at the LAST selected j (the reference overwrites
    Cp/St/Re/Pr at every wall node, so the last one wins); 0 where a
    column has no selected node."""
    X, Y = sel.shape
    any_col = sel.any(axis=1)
    # argmax on the reversed mask finds the last True per column
    j_last = (Y - 1) - np.argmax(sel[:, ::-1], axis=1)
    out = vals[np.arange(X), j_last]
    return np.where(any_col, out, 0.0)


def _lam_eff_5pt(grid, state):
    """5-point averaged effective conductivity used by the heat-flux
    profiles (out_cfd_param.cpp:587-625; the GetValue-based neighbors are
    always present, so the average is over the node + its 4 collapsed
    neighbors)."""
    lam_e = np.asarray(state.lam) + np.asarray(state.lam_t)
    X, Y = lam_e.shape
    i_idx = np.arange(X)[:, None] + np.zeros((1, Y), int)
    j_idx = np.arange(Y)[None, :] + np.zeros((X, 1), int)
    n1 = grid.idXl.astype(int)
    n2 = grid.idXr.astype(int)
    n3 = grid.idYu.astype(int)
    n4 = grid.idYd.astype(int)
    acc = (lam_e
           + lam_e[np.clip(i_idx - n1, 0, X - 1), j_idx]
           + lam_e[np.clip(i_idx + n2, 0, X - 1), j_idx]
           + lam_e[i_idx, np.clip(j_idx + n3, 0, Y - 1)]
           + lam_e[i_idx, np.clip(j_idx - n4, 0, Y - 1)])
    return acc / 5.0


def save_x_heat_flux(path, grid, state, flow2d, Ts, y_max, y_min,
                     ref_test: bool = False):
    """SaveXHeatFlux2D (524-691): per-column max wall heat flux profile,
    heat-exchange coefficient, Cp and Stanton number.

    ``ref_test`` reproduces the reference's ``_REF_TEST_`` compile-time
    mode (out_cfd_param.cpp:536-547, 633-648): per wall node the
    flat-plate correlations

        Re(x) = U_top x rho / mu,   Pr = mu Cp / lam,
        Nu = 0.332 sqrt(Re) Pr^(1/3)            (Re < 5e5, Blasius)
             0.0296 Re^0.8  Pr^(1/3)            (turbulent),
        Alpha_Ref = Nu lam / x,   Q_Ref = Alpha_Ref (Tg - Ts)

    are written next to the computed profiles — the physics oracle for
    the wall heat-flux path beyond golden fields.  Returns the extra
    (q_ref, alpha_ref, re, pr) profiles in that mode.
    """
    X, Y = grid.MaxX, grid.MaxY
    wall_ns = grid.is_cond(fl.CT_WALL_NO_SLIP_2D)
    Tg = np.asarray(state.Tg)
    lam_eff = _lam_eff_5pt(grid, state)
    trec = (1 + 0.45 * (flow2d.kg() - 1.0) * flow2d.MACH() ** 2) \
        * flow2d.Tg()
    q_all = lam_eff * (Tg - Ts) / grid.dy
    alpha_all = lam_eff / grid.dy
    cp_all = calc_cp(state, grid, flow2d)
    st_all = q_all / (flow2d.ROG() * flow2d.Wg() * flow2d.C * (trec - Ts))

    if ref_test:
        # Re uses the top-row (freestream) U of the same column and the
        # wall node's own rho/mu/lam/Cp (out_cfd_param.cpp:633-637)
        lam_l = np.asarray(state.lam)
        mu_l = np.asarray(state.mu)
        cp_l = np.asarray(state.CP)
        rho = np.asarray(state.S)[fl.i2d_Rho]
        mu_s = np.where(mu_l != 0, mu_l, 1)
        lam_s = np.where(lam_l != 0, lam_l, 1)
        x_c = (np.arange(X) + 0.5)[:, None] * grid.dx
        re_all = np.asarray(state.U)[:, -1][:, None] * x_c * rho / mu_s
        pr_all = mu_l * cp_l / lam_s
        nu_all = np.where(re_all < 5.0e5,
                          0.332 * np.sqrt(np.maximum(re_all, 0.0))
                          * np.cbrt(pr_all),
                          0.0296 * np.maximum(re_all, 0.0) ** 0.8
                          * np.cbrt(pr_all))
        alpha_ref_all = nu_all * lam_l / x_c
        q_ref_all = alpha_ref_all * (Tg - Ts)

    jlo = max(0, y_min)
    jhi = min(y_max, Y - 1)
    sel = np.zeros((X, Y), bool)
    sel[:, jlo:jhi] = wall_ns[:, jlo:jhi]

    # j-ascending fold per column, vectorized across all X columns
    # (order-faithful to the reference's per-node accumulator, see
    # _fold_max_nonzero; Cp/St/Re/Pr take the last wall node per column)
    heat = np.zeros(X)
    alpha = np.zeros(X)
    q_ref = np.zeros(X)
    a_ref = np.zeros(X)
    for j in range(jlo, jhi):
        m = sel[:, j]
        if not m.any():
            continue
        heat = _fold_max_nonzero(heat, m, q_all[:, j])
        alpha = _fold_max_nonzero(alpha, m, alpha_all[:, j])
        if ref_test:
            q_ref = _fold_max_nonzero(q_ref, m, q_ref_all[:, j])
            a_ref = _fold_max_nonzero(a_ref, m, alpha_ref_all[:, j])
    cp_prof = _last_wall_value(cp_all, sel)
    st_prof = _last_wall_value(st_all, sel)
    if ref_test:
        re_prof = _last_wall_value(re_all, sel)
        pr_prof = _last_wall_value(pr_all, sel)

    with open(path, "w") as f:
        if ref_test:
            f.write("#VARIABLES = X, HeatFlux(X), Alpha(X), "
                    "HeatFluxRef(X), AlphaRef(X), Re(X), Pr(X)\n")
            for i in range(X):
                f.write(f"{i * grid.dx:.6g} {heat[i]:.6g} {alpha[i]:.6g} "
                        f"{q_ref[i]:.6g} {a_ref[i]:.6g} "
                        f"{re_prof[i]:.6g} {pr_prof[i]:.6g}\n")
        else:
            f.write("#VARIABLES = X, HeatFlux(X),  Alpha(X), Cp(X), "
                    "St(X)\n")
            for i in range(X):
                f.write(f"{i * grid.dx:.6g} {heat[i]:.6g} {alpha[i]:.6g} "
                        f"{cp_prof[i]:.6g} {st_prof[i]:.6g}\n")
    if ref_test:
        return heat, alpha, q_ref, a_ref, re_prof, pr_prof
    return heat, alpha, cp_prof, st_prof


def save_y_heat_flux(path, grid, state, Ts):
    """SaveYHeatFlux2D (693-760)."""
    X, Y = grid.MaxX, grid.MaxY
    wall_ns = grid.is_cond(fl.CT_WALL_NO_SLIP_2D)
    Tg = np.asarray(state.Tg)
    lam_eff = _lam_eff_5pt(grid, state)
    q_all = lam_eff * (Tg - Ts) / grid.dx
    # i-ascending fold per row, vectorized across all Y rows (the
    # reference scans i inside j, out_cfd_param.cpp:705-757; note its
    # i < X-1 bound excludes the last column)
    heat = np.zeros(Y)
    for i in range(X - 1):
        m = wall_ns[i, :]
        if m.any():
            heat = _fold_max_nonzero(heat, m, q_all[i, :])
    with open(path, "w") as f:
        f.write("#VARIABLES = Y, HeatFlux(Y)\n")
        for j in range(Y):
            f.write(f"{j * grid.dy:.6g} {heat[j]:.6g}\n")
    return heat


def re_airfoil(chord, flow2d):
    """Re_Airfoil (14-16)."""
    return flow2d.Wg() * chord * flow2d.ROG() / flow2d.mu
