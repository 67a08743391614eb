"""The solver iteration: two-pass blending-factor explicit scheme.

Counterpart of ``openhyperflow2d_tpu.core.step`` on torch tensors (the hot
loops of ``DEEPS2D_Run``, deeps2d_core.cpp:853-1334):

* ``pass12`` — pass 1 (stencil flux update with the blending factor) and
  pass 2 (residual, blending-factor update, RMS, commit);
* ``gfc`` — gradients, FillNode2D, local dt and chemistry;
* ``SlimState`` with ``shrink``/``expand`` — the slim carry of the chunk's
  loop (``reference/chunk.py``).

Every read is from the previous iterate (Jacobi); neighbor access uses
edge-replicated shifts masked by the reference's neighbor flags.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config.tables import table_lookup
from . import flags as fl
from .physics import (_safe_div, band, bor, calc_chemical_reactions,
                      calc_heat_on_wall_sources, fill_node, wsel)
from .state import ChemTables, GridMeta, SolverParams, SolverState
from .static_ctx import StaticCtx, build_static_ctx


# ---------------------------------------------------------------------------
# shifts (edge-replicated; out-of-range values are masked by idX*/idY*)
# ---------------------------------------------------------------------------
def shift_xl(q):
    """Value of the left (i-1) neighbor."""
    return torch.cat([q[..., :1, :], q[..., :-1, :]], dim=-2)


def shift_xr(q):
    """Value of the right (i+1) neighbor."""
    return torch.cat([q[..., 1:, :], q[..., -1:, :]], dim=-2)


def shift_yd(q):
    """Value of the down (j-1) neighbor."""
    return torch.cat([q[..., :, :1], q[..., :, :-1]], dim=-1)


def shift_yu(q):
    """Value of the up (j+1) neighbor."""
    return torch.cat([q[..., :, 1:], q[..., :, -1:]], dim=-1)


def neighbors(q, idXl, idXr, idYu, idYd):
    """Left/Right/Up/Down neighbor values with wall collapse
    (N1 = i - idXl etc., deeps2d_core.cpp:869-888)."""
    L = wsel(idXl, shift_xl(q), q)
    Rn = wsel(idXr, shift_xr(q), q)
    Up = wsel(idYu, shift_yu(q), q)
    Dn = wsel(idYd, shift_yd(q), q)
    return L, Rn, Up, Dn


@dataclass(frozen=True)
class StepAux:
    """Per-iteration scalars (0-d tensors)."""
    beta_scen: torch.Tensor     # beta_Scenario(iter+last_iter)
    cfl_scen: torch.Tensor      # CFL_Scenario(iter+last_iter)
    is_mu_t_iter: torch.Tensor  # bool: iter+last_iter >= TurbStartIter


def pass12(state: SolverState, meta: GridMeta, params: SolverParams,
           aux: StepAux, return_fields: bool = False,
           ctx: StaticCtx = None):
    """Pass 1 (stencil/flux update) + pass 2 (DD/beta/RMS/commit).

    Returns (S_committed, beta_out, dSdx_new, dSdy_new, diag); with
    ``return_fields`` the diag holds the per-node quantities instead.
    """
    p = params
    if ctx is None:
        ctx = build_static_ctx(meta, p)
    dt_ = state.dt
    dtype = state.S.dtype
    dtdx = dt_ / p.dx
    dtdy = dt_ / p.dy
    dxx = p.dy / (p.dx + p.dy)   # neighbor-average weights (643-644)
    dyy = p.dx / (p.dx + p.dy)

    idXl, idXr, idYu, idYd = ctx.bXl, ctx.bXr, ctx.bYu, ctx.bYd
    n1, n2, n3, n4 = ctx.n1, ctx.n2, ctx.n3, ctx.n4
    rn_n, rm_m = ctx.rn_n, ctx.rm_m
    evolve = ctx.evolve

    # ---------------- PASS 1 (853-1026) -----------------------------------
    S = state.S
    S_L, S_R, S_U, S_D = neighbors(S, idXl, idXr, idYu, idYd)
    A_L, A_R, _, _ = neighbors(state.A, idXl, idXr, idYu, idYd)
    _, _, B_U, B_D = neighbors(state.B, idXl, idXr, idYu, idYd)

    dSdx_new = wsel(ctx.ev_flux_x, (A_R - A_L) * rn_n,
                    wsel(evolve, 0.0, state.dSdx))
    dSdy_new = wsel(ctx.ev_flux_y, (B_U - B_D) * rm_m,
                    wsel(evolve, 0.0, state.dSdy))

    # Neumann averaging mutates S before the blend (996-1006)
    S_eff = wsel(ctx.ev_avg_x, (S_L * n2 + S_R * n1) * rn_n, S)
    S_eff = wsel(ctx.ev_avg_y, (S_U * n3 + S_D * n4) * rm_m, S_eff)

    # 2nd-order soft-BC averaging, statically skipped when no node of the
    # case carries a d2*-NULL flag (params.has_d2x/y from build_case)
    if p.has_d2x:
        dSdx_L, dSdx_R, _, _ = neighbors(dSdx_new, idXl, idXr, idYu, idYd)
        dXX = wsel(ctx.dx2, (dSdx_L + dSdx_R) * 0.5, dSdx_new)
    else:
        dXX = dSdx_new
    if p.has_d2y:
        _, _, dSdy_U, dSdy_D = neighbors(dSdy_new, idXl, idXr, idYu, idYd)
        dYY = wsel(ctx.dy2, (dSdy_U + dSdy_D) * 0.5, dSdy_new)
    else:
        dYY = dSdy_new

    beta = state.beta
    blend = (dxx * (S_L + S_R) + dyy * (S_U + S_D)) * 0.5
    if p.ft == fl.FT_AXISYMMETRIC:
        # the radial flux over the node's j + 1 (a division, as in JAX)
        y_term = dYY + state.F / ctx.jp1[None]
    else:
        y_term = dYY
    next_s = (S_eff * beta + (1.0 - beta) * blend
              - (dtdx * dXX + dtdy * y_term)
              + state.Src * dt_ + state.SrcAdd)
    next_s = wsel(evolve, next_s, S_eff)

    # ---------------- PASS 2: DD / beta / RMS / commit (1062-1164) ---------
    tmp = S_eff
    abs_dd = next_s - tmp
    big = torch.abs(tmp) > 1.e-15
    dd_local = torch.where(big, torch.abs(abs_dd / torch.where(big, tmp, 1.0)),
                           1.0)
    if p.bff in (fl.BFF_SQR, fl.BFF_SQRR):
        sqrt_res = torch.where(big, torch.sqrt(dd_local), 0.0)

    beta_min = torch.minimum(torch.tensor(p.beta0, dtype=dtype,
                                          device=S.device), aux.beta_scen)
    if p.has_nrbc:
        # per-node override on CT_NONREFLECTED nodes; statically skipped
        # (beta_min stays a scalar) when the case marked none
        beta_min = wsel(ctx.nrbc, torch.tensor(p.nrbc_beta0, dtype=dtype,
                                               device=S.device),
                        beta_min)[None]
    if p.bff == fl.BFF_L:
        new_beta = torch.minimum(beta_min,
                                 beta_min * beta_min / (beta_min + dd_local))
    elif p.bff == fl.BFF_LR:
        new_beta = torch.minimum((beta_min + beta) * 0.5,
                                 beta_min * beta_min / (beta_min + dd_local))
    elif p.bff == fl.BFF_S:
        new_beta = torch.minimum(beta_min, beta_min * beta_min
                                 / (beta_min + dd_local * dd_local))
    elif p.bff == fl.BFF_SR:
        new_beta = torch.minimum((beta_min + beta) * 0.5,
                                 beta_min * beta_min
                                 / (beta_min + dd_local * dd_local))
    elif p.bff == fl.BFF_SQR:
        new_beta = torch.minimum(beta_min,
                                 beta_min * beta_min / (beta_min + sqrt_res))
    elif p.bff == fl.BFF_SQRR:
        new_beta = torch.minimum((beta_min + beta) * 0.5,
                                 beta_min * beta_min / (beta_min + sqrt_res))
    else:
        new_beta = beta

    dd_gate = band(ctx.ddmask, tmp != 0.0)
    beta_out = wsel(dd_gate, new_beta, beta)

    if return_fields:
        fields = {"abs_dd": abs_dd, "tmp": tmp, "dd_local": dd_local,
                  "gate": dd_gate, "dt_used": dt_}
        return next_s, beta_out, dSdx_new, dSdy_new, fields

    if p.isAlternateRMS:
        # serial build accumulates the SIGNED residual (deeps2d_core.cpp:
        # 1139-1141) and returns 0 when the sum is not positive (1541-1549);
        # the MPI build accumulates absDD^2 (1128-1130)
        acc = abs_dd if p.serial_rms_mode else abs_dd * abs_dd
        rms = torch.where(dd_gate, acc, 0.0).sum(dim=(-2, -1))
        sum_div = torch.where(dd_gate, tmp * tmp, 0.0).sum(dim=(-2, -1))
        fallback = torch.zeros_like(rms) if p.serial_rms_mode else rms
        rms_out = torch.where((rms > 0) & (sum_div > 0),
                              torch.sqrt(_safe_div(rms, sum_div)), fallback)
    else:
        rms = torch.where(dd_gate, dd_local * dd_local, 0.0).sum(dim=(-2, -1))
        irms = dd_gate.sum(dim=(-2, -1)).to(dtype)
        rms_out = torch.where(irms > 0, torch.sqrt(_safe_div(rms, irms)), rms)
    dd_max = torch.where(dd_gate, dd_local, 0.0).amax(dim=(-2, -1))

    diag = {"RMS": rms_out, "DD_max": dd_max, "dt_used": dt_}
    return next_s, beta_out, dSdx_new, dSdy_new, diag


def has_heat_stage(params) -> bool:
    """Whether gfc ends with the conjugate wall-heat stage (non-adiabatic
    walls, deeps2d_core.cpp:1402-1409)."""
    return not params.isAdiabaticWall and params.has_walls


def gfc(state: SolverState, meta: GridMeta, params: SolverParams,
        chem: ChemTables, aux: StepAux, return_fields: bool = False,
        ctx: StaticCtx = None, heat: bool = True):
    """Gradients + FillNode2D + local dt + chemistry + wall heat flux (the
    tail of pass 2, deeps2d_core.cpp:1169-1334, 1402-1409).

    Returns (out_state, dt_new, unstable); ``out_state.dt`` keeps the
    incoming value, which the heat stage uses.  With ``return_fields``
    dt_new is the per-node dt field and ``unstable`` the per-node Tg<0
    mask.  ``heat=False`` stops after chemistry (the kernel path runs the
    heat stage as a kernel of its own).
    """
    p = params
    if ctx is None:
        ctx = build_static_ctx(meta, p)
    dtype = state.S.dtype
    active = ctx.active
    idXl, idXr, idYu, idYd = ctx.bXl, ctx.bXr, ctx.bYu, ctx.bYd
    n1, n2, n3, n4 = ctx.n1, ctx.n2, ctx.n3, ctx.n4
    S_committed = state.S
    st = state

    # ---------------- gradients (1169-1237) --------------------------------
    if p.sm == fl.SM_NS:
        dx1nn = ctx.dx1nn
        dy1mm = ctx.dy1mm
        Sc_L, Sc_R, Sc_U, Sc_D = neighbors(S_committed, idXl, idXr, idYu,
                                           idYd)
        rho_c = S_committed[fl.i2d_Rho]
        rho_cs = torch.where(rho_c != 0, rho_c, 1)
        if p.fast_math:
            r_rho_c = 1.0 / rho_cs

            def div_rho_c(a):
                return a * r_rho_c
        else:
            def div_rho_c(a):
                return a / rho_cs

        dydx_ok = ctx.dydx_ok
        dydy_ok = ctx.dydy_ok
        droYdx_l = []
        droYdy_l = []
        air_R = Sc_R[fl.i2d_Rho]
        air_L = Sc_L[fl.i2d_Rho]
        air_U = Sc_U[fl.i2d_Rho]
        air_D = Sc_D[fl.i2d_Rho]
        for k in range(4, 7):
            gx = (Sc_R[k] - Sc_L[k]) * dx1nn
            gy = (Sc_U[k] - Sc_D[k]) * dy1mm
            droYdx_l.append(wsel(ctx.g_dydx, gx, st.droYdx[k - 4]))
            droYdy_l.append(wsel(ctx.g_dydy, gy, st.droYdy[k - 4]))
            air_R = air_R - wsel(dydx_ok, Sc_R[k], 0.0)
            air_L = air_L - wsel(dydx_ok, Sc_L[k], 0.0)
            air_U = air_U - wsel(dydy_ok, Sc_U[k], 0.0)
            air_D = air_D - wsel(dydy_ok, Sc_D[k], 0.0)
        droYdx_l.append(
            wsel(ctx.g_dydx, (air_R - air_L) * dx1nn,
                 wsel(active, 0.0, st.droYdx[fl.NUM_COMPONENTS])))
        droYdy_l.append(
            wsel(ctx.g_dydy, (air_U - air_D) * dy1mm,
                 wsel(active, 0.0, st.droYdy[fl.NUM_COMPONENTS])))
        droYdx = torch.stack(droYdx_l)
        droYdy = torch.stack(droYdy_l)

        wall = ctx.wall
        U_L, U_R, U_U, U_D = neighbors(st.U, idXl, idXr, idYu, idYd)
        V_L, V_R, V_U, V_D = neighbors(st.V, idXl, idXr, idYu, idYd)

        if p.has_walls:
            def grad_x(qr, ql):
                # wall nodes use the asymmetric n1*right - n2*left weights
                return wsel(wall, (qr * n1 - ql * n2) * dx1nn,
                            (qr - ql) * dx1nn)

            def grad_y(qu, qd):
                return wsel(wall, (qu * n3 - qd * n4) * dy1mm,
                            (qu - qd) * dy1mm)
        else:
            def grad_x(qr, ql):
                return (qr - ql) * dx1nn

            def grad_y(qu, qd):
                return (qu - qd) * dy1mm

        dUdx = wsel(active, grad_x(U_R, U_L), st.dUdx)
        dVdx = wsel(active, grad_x(V_R, V_L), st.dVdx)
        dUdy = wsel(active, grad_y(U_U, U_D), st.dUdy)
        dVdy = wsel(active, grad_y(V_U, V_D), st.dVdy)

        if ("keps" in p.models) or ("sa" in p.models):
            dkdx = wsel(ctx.km, div_rho_c(grad_x(Sc_R[fl.i2d_k],
                                                 Sc_L[fl.i2d_k])), st.dkdx)
            dkdy = wsel(ctx.km, div_rho_c(grad_y(Sc_U[fl.i2d_k],
                                                 Sc_D[fl.i2d_k])), st.dkdy)
        else:
            dkdx, dkdy = st.dkdx, st.dkdy
        if "keps" in p.models:
            depsdx = wsel(ctx.em, div_rho_c(grad_x(Sc_R[fl.i2d_eps],
                                                   Sc_L[fl.i2d_eps])),
                          st.depsdx)
            depsdy = wsel(ctx.em, div_rho_c(grad_y(Sc_U[fl.i2d_eps],
                                                   Sc_D[fl.i2d_eps])),
                          st.depsdy)
        else:
            depsdx, depsdy = st.depsdx, st.depsdy

        Tg_L, Tg_R, Tg_U, Tg_D = neighbors(st.Tg, idXl, idXr, idYu, idYd)
        dTdx = wsel(active, (Tg_R - Tg_L) * dx1nn, st.dTdx)
        dTdy = wsel(active, (Tg_U - Tg_D) * dy1mm, st.dTdy)
    else:
        droYdx, droYdy = st.droYdx, st.droYdy
        dUdx, dUdy, dVdx, dVdy = st.dUdx, st.dUdy, st.dVdx, st.dVdy
        dTdx, dTdy = st.dTdx, st.dTdy
        dkdx, dkdy, depsdx, depsdy = (st.dkdx, st.dkdy, st.depsdx,
                                      st.depsdy)

    mid = st.replace(droYdx=droYdx, droYdy=droYdy,
                     dUdx=dUdx, dUdy=dUdy, dVdx=dVdx, dVdy=dVdy,
                     dTdx=dTdx, dTdy=dTdy,
                     dkdx=dkdx, dkdy=dkdy, depsdx=depsdx, depsdy=depsdy)

    # ---------------- FillNode2D (1240-1244, 1330-1331) --------------------
    # NT_FC nodes are always refreshed with is_mu_t=1
    is_mu_t = bor(ctx.fc, aux.is_mu_t_iter.to(torch.bool))
    filled = fill_node(mid, meta, p, is_mu_t, is_init=False, ctx=ctx)

    unstable_field = band(active, filled.Tg < 0.0)
    unstable = unstable_field if return_fields else unstable_field.any()

    # ---------------- local dt (1317-1327) ---------------------------------
    cfl_min = torch.minimum(torch.tensor(p.CFL, dtype=dtype,
                                         device=st.S.device), aux.cfl_scen)
    k_new = _safe_div(filled.CP, filled.CP - filled.R, 2.0)
    aaa = torch.sqrt(torch.clamp_min(k_new * filled.R * filled.Tg, 0.0))
    dt_nodes = cfl_min * torch.minimum(p.dx / (aaa + torch.abs(filled.U)),
                                       p.dy / (aaa + torch.abs(filled.V)))
    dt_field = wsel(active, dt_nodes, 1.0)
    dt_new = torch.clamp_max(dt_field.amin(), 1.0)
    if p.serial_dt_mode:
        dt_new = torch.minimum(dt_new, state.dt)

    # ---------------- chemistry (1328) -------------------------------------
    out = calc_chemical_reactions(filled, meta, p, chem, active, ctx=ctx)

    # ---------------- conjugate wall heat flux (1402-1409) ------------------
    if heat and has_heat_stage(p):
        out = calc_heat_on_wall_sources(out, meta, p, ctx=ctx)

    if return_fields:
        return out, dt_field, unstable
    return out, dt_new.to(dtype), unstable


# ---------------------------------------------------------------------------
# Fast path: slim carry
# ---------------------------------------------------------------------------
@dataclass
class SlimState:
    """Minimal inner-loop carry (31 planes): everything else is recomputed
    within one rotated iteration (see the JAX SlimState)."""

    S: torch.Tensor
    beta: torch.Tensor
    U: torch.Tensor
    V: torch.Tensor
    p: torch.Tensor
    Tg: torch.Tensor
    Yc: torch.Tensor
    R: torch.Tensor
    CP: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    mu_t: torch.Tensor
    dt: torch.Tensor


_SLIM_FIELDS = [f.name for f in dataclasses.fields(SlimState)]


def shrink(state: SolverState) -> SlimState:
    return SlimState(**{f: getattr(state, f) for f in _SLIM_FIELDS})


def expand(slim: SlimState, params: SolverParams, src_ext,
           y_plus=None, lam_t=None) -> SolverState:
    """SlimState -> SolverState with the recomputable fields zeroed.

    The zero planes are read-only broadcast views of one zero plane (no
    consumer writes into a state field in place).  ``lam_t`` None
    reconstructs mu_t*CP, the invariant FillNode2D re-establishes every
    iteration under SM_NS.
    """
    X, Y = slim.S.shape[-2:]
    z1 = torch.zeros((X, Y), dtype=slim.S.dtype, device=slim.S.device)
    z9 = z1.expand(fl.NUM_EQ, X, Y)
    z4 = z1.expand(4, X, Y)
    if lam_t is None:
        lam_t = slim.mu_t * slim.CP
    if y_plus is None:
        y_plus = z1
    kw = {f: getattr(slim, f) for f in _SLIM_FIELDS}
    return SolverState(
        A=z9, B=z9, F=z9, dSdx=z9, dSdy=z9,
        Src=src_ext, SrcAdd=z9,
        droYdx=z4, droYdy=z4,
        dUdx=z1, dUdy=z1, dVdx=z1, dVdy=z1, dTdx=z1, dTdy=z1,
        dkdx=z1, dkdy=z1, depsdx=z1, depsdy=z1, Q_conv=z1,
        lam_t=lam_t, y_plus=y_plus, **kw)


def lam_t_const(state: SolverState, params):
    """The chunk-constant lam_t plane: outside SM_NS FillNode2D never
    writes lam_t, so it enters a chunk from the state (JAX step.py:569);
    None under SM_NS, where ``expand`` rebuilds it as mu_t*CP."""
    return None if params.sm == fl.SM_NS else state.lam_t


def needs_y_plus(params) -> bool:
    """True iff the case's turbulence closure reads y+ in the inner loop
    (van Driest damping or Chien's k-eps)."""
    return (("prandtl" in params.models
             and params.tem == fl.TEM_vanDriest)
            or ("keps" in params.models
                and params.tem == fl.TEM_k_eps_Chien))


def make_aux(beta_tab, cfl_tab, turb_start, it, dtype):
    """StepAux at iteration ``it`` (an int or an integer tensor, which may
    be 1-D to build the scalars of several iterations at once)."""
    dev = beta_tab[0].device
    it = torch.as_tensor(it, device=dev)
    itf = it.to(dtype)
    return StepAux(
        beta_scen=table_lookup(beta_tab[0], beta_tab[1], itf),
        cfl_scen=table_lookup(cfl_tab[0], cfl_tab[1], itf),
        is_mu_t_iter=(it >= turb_start))
