"""Per-node physics: EOS, fluxes, turbulence closures, chemistry.

Counterpart of ``openhyperflow2d_tpu.core.physics`` (``FillNode2D``,
``TurbModRANS2D`` and ``CalcChemicalReactions`` of the reference,
hyper_flow_node.hpp:374-957, deeps2d_core.cpp:4697-4780) on torch tensors.
Every per-node branch is a ``torch.where`` mask, with the operation order of
the JAX version kept so float64 results agree to rounding.

Every closure of the JAX package runs here on flat and axisymmetric
uniform meshes: the Prandtl family, the k-eps variants, Spalart-Allmaras
and Smagorinsky (``_turb_mod_rans``, with the axisymmetric add-ons of
k-eps and SA); so does the conjugate wall-heat stage of non-adiabatic
walls (``calc_heat_on_wall_sources``).  Axisymmetric flow (``p.ft``) adds
the radial flux F and the V / r terms (``fill_node``); ``isSrcAdd`` adds the
moving-wall sources at no-slip wall nodes.  The mesh is uniform.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.tables import table_lookup
from . import flags as fl
from .state import ChemTables, GridMeta, SolverParams, SolverState
from .static_ctx import (StaticCtx, _sxl, _sxr, _syd, _syu,
                         build_static_ctx, iscond)

TURB_INTENSITY = 0.005   # FlowNodeTurbulence2D::I (hyper_flow_turbulence.hpp:135)


def _safe_div(a, b, fallback=0.0):
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, 1), fallback)


# ---------------------------------------------------------------------------
# Fold-aware mask combinators: with a Python-bool mask (the specialized
# interior ctx) the select/logic folds away; with tensor masks they are
# exactly torch.where / & / | / ~.
# ---------------------------------------------------------------------------
def _shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def wsel(cond, a, b):
    """torch.where that folds Python/numpy bool conditions."""
    if isinstance(cond, (bool, np.bool_)):
        taken = a if cond else b
        ref = a if isinstance(a, torch.Tensor) else b
        shape = torch.broadcast_shapes(_shape(a), _shape(b))
        t = torch.as_tensor(taken, dtype=torch.result_type(a, b),
                            device=ref.device)
        return t.expand(shape)
    return torch.where(cond, a, b)


def band(a, b):
    """a & b with Python-bool folding (False short-circuits to False)."""
    if isinstance(a, (bool, np.bool_)):
        return b if a else False
    if isinstance(b, (bool, np.bool_)):
        return a if b else False
    return a & b


def bor(a, b):
    """a | b with Python-bool folding (True short-circuits to True)."""
    if isinstance(a, (bool, np.bool_)):
        return True if a else b
    if isinstance(b, (bool, np.bool_)):
        return True if b else a
    return a | b


def bnot(a):
    """~a that is safe on Python bools (~False == -1 in Python)."""
    if isinstance(a, (bool, np.bool_)):
        return not a
    return ~a


def node_masks(meta: GridMeta):
    """Common node classification masks."""
    ct = meta.CT
    solid = iscond(ct, fl.CT_SOLID_2D)
    is_set = iscond(ct, fl.CT_NODE_IS_SET_2D)
    fc = iscond(ct, fl.NT_FC_2D)
    active = is_set & ~solid & ~fc
    return solid, is_set, fc, active


def fill_node(state: SolverState, meta: GridMeta, params: SolverParams,
              is_mu_t, is_init: bool, ctx: StaticCtx = None) -> SolverState:
    """FillNode2D over the whole grid (hyper_flow_node.hpp:374-600).

    ``is_mu_t`` is a per-node bool mask; ``is_init`` selects the
    initialization variant.
    """
    p = params
    if ctx is None:
        ctx = build_static_ctx(meta, p)
    ne = fl.NUM_EQ
    s = list(state.S.unbind(0))
    a_l = list(state.A.unbind(0))
    b_l = list(state.B.unbind(0))
    f_l = list(state.F.unbind(0))
    src = list(state.Src.unbind(0))
    rho = s[fl.i2d_Rho]
    solid = ctx.solid

    k_cpcv = _safe_div(state.CP, state.CP - state.R, 2.0)
    guard = band(bnot(solid), (rho != 0) & (k_cpcv >= 1))
    rho_s = torch.where(rho != 0, rho, 1)
    if p.fast_math:
        r_rho = 1.0 / rho_s

        def div_rho(a):
            return a * r_rho
    else:
        def div_rho(a):
            return a / rho_s

    # --- U/V with per-equation Dirichlet enforcement (hpp:413-421) --------
    u_const = ctx.u_const
    v_const = ctx.v_const
    U = wsel(u_const, state.U, div_rho(s[fl.i2d_RhoU]))
    V = wsel(v_const, state.V, div_rho(s[fl.i2d_RhoV]))
    s[fl.i2d_RhoU] = wsel(u_const, U * rho, s[fl.i2d_RhoU])
    s[fl.i2d_RhoV] = wsel(v_const, V * rho, s[fl.i2d_RhoV])

    mu_t = state.mu_t
    lam_t = state.lam_t

    if p.sm == fl.SM_NS:
        if is_init:
            mu_t = wsel(ctx.turb_on, 5.0 * state.mu, torch.zeros_like(mu_t))
            lam_t = wsel(ctx.turb_on, lam_t, torch.zeros_like(lam_t))
        mu_t, lam_t = _turb_mod_rans(state, meta, p, s, U, V, a_l, b_l, f_l,
                                     src, mu_t, lam_t, is_mu_t, is_init, ctx)

    # --- formation enthalpy sum (hpp:438-445) -----------------------------
    Hu = list(p.Hu)
    h_form = torch.zeros_like(rho)
    rho_air = rho
    for c in range(fl.NUM_COMPONENTS):
        h_form = h_form + Hu[c] * s[4 + c]
        rho_air = rho_air - s[4 + c]
    h_form = h_form + Hu[fl.NUM_COMPONENTS] * rho_air

    # --- wall handling (hpp:447-488) --------------------------------------
    wall_law = ctx.wall_law
    wall_ns = ctx.wall_ns
    zero = torch.zeros_like(rho)
    src_add = [zero] * ne
    if p.has_walls:
        # WALL_LAW: project momentum onto the wall direction
        w_mag = torch.sqrt(U * U + V * V + 1.e-30)
        s[fl.i2d_RhoU] = wsel(wall_law, w_mag * meta.BGX, s[fl.i2d_RhoU])
        s[fl.i2d_RhoV] = wsel(wall_law, w_mag * meta.BGY, s[fl.i2d_RhoV])
        U = wsel(wall_law, div_rho(s[fl.i2d_RhoU]), U)
        V = wsel(wall_law, div_rho(s[fl.i2d_RhoV]), V)
        # WALL_NO_SLIP: optional moving-wall sources, gas moves with wall
        if p.isSrcAdd:
            # the velocity before the no-slip overwrite below
            U_pre = wsel(wall_ns, div_rho(s[fl.i2d_RhoU]), U)
            V_pre = wsel(wall_ns, div_rho(s[fl.i2d_RhoV]), V)
            sa_rho = (meta.BGX * (U_pre - meta.Uw) * rho / p.dx
                      + meta.BGY * (V_pre - meta.Vw) * rho / p.dy)
            src_add[fl.i2d_Rho] = wsel(wall_ns, sa_rho, zero)
            src_add[fl.i2d_RhoU] = wsel(
                wall_ns, meta.BGX * (U_pre - meta.Uw) * rho, zero)
            src_add[fl.i2d_RhoV] = wsel(
                wall_ns, meta.BGY * (V_pre - meta.Vw) * rho, zero)
            for c in range(fl.NUM_COMPONENTS):
                src_add[4 + c] = wsel(wall_ns, sa_rho * state.Yc[c], zero)
        U = wsel(wall_ns, meta.Uw, U)
        V = wsel(wall_ns, meta.Vw, V)
        s[fl.i2d_RhoU] = wsel(wall_ns, U * rho, s[fl.i2d_RhoU])
        s[fl.i2d_RhoV] = wsel(wall_ns, V * rho, s[fl.i2d_RhoV])

    # --- EOS (hpp:490-492) -------------------------------------------------
    p_new = (k_cpcv - 1.0) * (s[fl.i2d_RhoE]
                              - rho * (U * U + V * V) * 0.5 - h_form)
    Tg_new = _safe_div(p_new, state.R * rho_s)

    # --- effective transport & viscous/convective fluxes -------------------
    y_r = ctx.y_r                            # node radius (x,y init: 3877)

    if p.sm == fl.SM_NS:
        lam_t = mu_t * state.CP
        sig = ctx.sig
        mu_eff = wsel(is_mu_t, torch.clamp_min(state.mu + mu_t * sig, 0.0),
                      state.mu)
        lam_eff = wsel(is_mu_t,
                       torch.clamp_min(state.lam + lam_t * sig, 0.0),
                       state.lam)
        diff = lam_eff / state.CP
        L2 = (2.0 / 3.0) * mu_eff
        if p.ft == fl.FT_AXISYMMETRIC:
            dila = L2 * (state.dUdx + state.dVdy + V / y_r)
        else:
            dila = L2 * (state.dUdx + state.dVdy)

    an = list(a_l)
    bn = list(b_l)
    fn = list(f_l)
    an[0] = s[fl.i2d_RhoU]
    an[1] = p_new + s[fl.i2d_RhoU] * U
    an[2] = s[fl.i2d_RhoV] * U
    an[3] = (s[fl.i2d_RhoE] + p_new) * U
    bn[0] = s[fl.i2d_RhoV]
    bn[1] = an[2]
    bn[2] = p_new + s[fl.i2d_RhoV] * V
    bn[3] = (s[fl.i2d_RhoE] + p_new) * V
    for c in range(4, 4 + fl.NUM_COMPONENTS):
        an[c] = s[c] * U
        bn[c] = s[c] * V

    if p.ft == fl.FT_AXISYMMETRIC:
        # FT enum value is 1 for axisymmetric, so FT* factors are unity
        fn[0] = bn[0]
        fn[1] = an[2]
        fn[2] = fn[0] * V
        fn[3] = bn[3]
        for c in range(4, 4 + fl.NUM_COMPONENTS):
            fn[c] = bn[c]

    if p.sm == fl.SM_NS:
        sxx = 2.0 * mu_eff * state.dUdx - dila
        syy = 2.0 * mu_eff * state.dVdy - dila
        txy = mu_eff * (state.dUdy + state.dVdx)
        qx = lam_eff * state.dTdx
        qy = lam_eff * state.dTdy
        for c in range(fl.NUM_COMPONENTS + 1):
            qx = qx + diff * (state.CP * Tg_new + Hu[c]) * state.droYdx[c]
            qy = qy + diff * (state.CP * Tg_new + Hu[c]) * state.droYdy[c]
        RX1, RX2, RX3 = sxx, txy, U * sxx + V * txy + qx
        RY1, RY2, RY3 = txy, syy, U * txy + V * syy + qy
        an[1] = an[1] - RX1
        an[2] = an[2] - RX2
        an[3] = an[3] - RX3
        bn[1] = bn[1] - RY1
        bn[2] = bn[2] - RY2
        bn[3] = bn[3] - RY3
        for c in range(4, 4 + fl.NUM_COMPONENTS):
            an[c] = an[c] - diff * state.droYdx[c - 4]
            bn[c] = bn[c] - diff * state.droYdy[c - 4]
        if p.ft == fl.FT_AXISYMMETRIC:
            t00 = 2.0 * mu_eff * V / y_r - dila
            fn[1] = fn[1] - RY1
            fn[2] = fn[2] - (RY2 + t00)
            fn[3] = fn[3] - RY3
            for c in range(4, 4 + fl.NUM_COMPONENTS):
                fn[c] = fn[c] - diff * state.droYdy[c - 4]
        else:
            # flat NS zeroes the whole F vector, all NumEq (hpp:595-598)
            fn = [zero] * ne

    # --- assemble outputs through the guard mask ---------------------------
    def sel(new, old):
        return wsel(guard, new, old)

    def stack(new, old):
        return torch.stack([sel(new[e], old[e]) for e in range(ne)])

    return state.replace(
        S=stack(s, state.S), A=stack(an, state.A), B=stack(bn, state.B),
        F=stack(fn, state.F), Src=stack(src, state.Src),
        SrcAdd=stack(src_add, state.SrcAdd),
        U=sel(U, state.U), V=sel(V, state.V),
        p=sel(p_new, state.p), Tg=sel(Tg_new, state.Tg),
        mu_t=sel(mu_t, state.mu_t), lam_t=sel(lam_t, state.lam_t))


def _ipow(x, n: int):
    """x ** n for a positive integer n as JAX lowers it (lax.integer_pow:
    square-and-multiply, x ** 3 = x * x^2, x ** 6 = x^2 * (x^2)^2), so the
    float bits follow the JAX package's."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _turb_mod_rans(state, meta, p, s, U, V, a_l, b_l, f_l, src, mu_t, lam_t,
                   is_mu_t, is_init, ctx: StaticCtx):
    """TurbModRANS2D (hyper_flow_node.hpp:601-957) over the grid, every
    closure of the JAX package (physics.py:299-542): the Prandtl family
    (Prandtl, van Driest, Escudier, Klebanoff), k-eps (standard, Chien,
    JL, LSY, RNG), Spalart-Allmaras and Smagorinsky.

    Mutates the plane lists (s, a_l, b_l, f_l, src) for the turbulence
    equations; returns (mu_t, lam_t).  The families are selected
    statically by ``p.models`` and per node by the exclusive masks
    m_prandtl / m_keps / m_sa / m_smag; a ``tem`` no branch names takes the
    standard constants.
    """
    rho = s[fl.i2d_Rho]
    rho_s = torch.where(rho != 0, rho, 1)
    tem = p.tem
    l_base = ctx.l_base

    has_prandtl = "prandtl" in p.models
    has_keps = "keps" in p.models
    has_sa = "sa" in p.models
    has_smag = "smag" in p.models
    if has_prandtl or has_keps or has_sa or has_smag:
        grad_mag = torch.maximum(torch.abs(state.dUdy), torch.abs(state.dVdx))

    # ---------------- Prandtl zero-equation family (612-638) --------------
    if has_prandtl:
        m_prandtl = ctx.m_prandtl
        n_0 = ctx.n_0
        if tem == fl.TEM_vanDriest:
            l_p = n_0 * (1.0 - torch.exp(-state.y_plus / 26.0))
        elif tem == fl.TEM_Escudier and p.delta_bl > 0:
            l_p = torch.clamp_max(n_0, 0.09 * p.delta_bl)
        elif tem == fl.TEM_Klebanoff and p.delta_bl > 0:
            l_p = n_0 / torch.sqrt(
                1.0 + 5.5 * _ipow(meta.l_min / p.delta_bl, 6))
        else:
            l_p = n_0
        mu_t = wsel(m_prandtl, rho * l_p * l_p * grad_mag, mu_t)
        lam_t = wsel(m_prandtl, mu_t * state.CP, lam_t)

    # ---------------- k-eps family (640-820) -------------------------------
    if has_keps:
        m_keps = ctx.m_keps
        Sk = s[fl.i2d_k]
        Se = s[fl.i2d_eps]
        tmp1 = state.dUdy + state.dVdx
        tmp2 = rho * l_base
        tmp3 = state.dUdx * state.dUdx + state.dVdy * state.dVdy
        if p.ft == fl.FT_AXISYMMETRIC:
            tmp3 = tmp3 + U / ctx.y_r
        mu_t_ke = torch.where(mu_t == 0, rho * l_base * l_base * grad_mag,
                              mu_t)
        G = mu_t_ke * (tmp1 * tmp1 + 2.0 * tmp3)
        Rt = torch.where((Se != 0) & (state.mu != 0),
                         _safe_div(Sk * Sk,
                                   Se * torch.where(state.mu != 0, state.mu,
                                                    1)),
                         0.0)

        f1 = 1.0
        f2 = 1.0
        f_mu = torch.ones_like(rho)
        L_k = torch.zeros_like(rho)
        L_eps = torch.zeros_like(rho)
        Mt = torch.zeros_like(rho)
        C1eps, C2eps, C_mu = 1.44, 1.92, 0.09
        sig_k, sig_eps = 1.0, 1.3
        if tem == fl.TEM_k_eps_Chien:
            C1eps, C2eps = 1.35, 1.8
            f2 = 1.0 - 0.4 / 1.8 * torch.exp(-(Rt * Rt) / 36.0)
            f_mu = 1.0 - torch.exp(-0.0115 * state.y_plus)
            tmp2_s = torch.where(tmp2 != 0, tmp2, 1)
            L_k = -2.0 * state.mu * Sk / (tmp2_s * tmp2_s)
            L_eps = (-2.0 * state.mu * Se / (tmp2_s * tmp2_s)
                     * torch.exp(-state.y_plus / 2.0))
            k_cpcv = _safe_div(state.CP, state.CP - state.R, 2.0)
            Mt = 1.5 * _safe_div(Sk, k_cpcv * state.p)
        elif tem == fl.TEM_k_eps_JL:
            f_mu = torch.exp(-2.5 / (1.0 + Rt / 50.0))
        elif tem == fl.TEM_k_eps_LSY:
            f_mu = torch.exp(-3.4 / (1.0 + Rt / 50.0) / (1.0 + Rt / 50.0))
        elif tem == fl.TEM_k_eps_RNG:
            nu_0 = 4.38
            nu_r = torch.where(Se != 0.0,
                               torch.sqrt(torch.clamp_min(G, 0.0))
                               * _safe_div(Sk, Se), 0.0)
            C_mu = 0.0845
            C1eps = 1.42
            C2eps = (1.68 + C_mu * _ipow(nu_r, 3) * (1.0 - nu_r / nu_0)
                     / (1.0 + 0.012 * _ipow(nu_r, 3)))
            sig_k = sig_eps = 0.7194

        w_mag = torch.sqrt(U * U + V * V + 1.e-30)
        tmpI = TURB_INTENSITY * w_mag
        k_init = 1.5 * tmpI * tmpI * rho
        l_s = ctx.l_s

        def eps_of_k(sk):
            return (C_mu ** 0.75
                    * torch.clamp_min(_safe_div(sk, rho_s), 0.0) ** 1.5 / l_s)

        if is_init:
            Sk = wsel(m_keps, k_init, Sk)
            Se = wsel(m_keps, eps_of_k(Sk), Se)
            mu_t_new = torch.abs(C_mu * f_mu * _safe_div(Sk * Sk, Se))
            mu_t_ke = torch.where(Se != 0, mu_t_new, mu_t_ke)

        kconst = ctx.kconst
        econst = ctx.econst
        Sk = wsel(band(m_keps, kconst), k_init, Sk)
        Se = wsel(band(m_keps, bor(econst, ctx.ewall)), eps_of_k(Sk), Se)

        nu_t = torch.abs(C_mu * f_mu * _safe_div(Sk * Sk, Se))
        mu_t_ke = wsel(band(is_mu_t, Se != 0), torch.minimum(nu_t, mu_t_ke),
                       mu_t_ke)

        if not is_init:
            if p.fast_math:
                mt_sk = mu_t_ke * (1.0 / sig_k)
                mt_se = mu_t_ke * (1.0 / sig_eps)
            else:
                mt_sk = mu_t_ke / sig_k
                mt_se = mu_t_ke / sig_eps
            rx_k = (state.mu + mt_sk) * state.dkdx
            rx_e = (state.mu + mt_se) * state.depsdx
            ry_k = (state.mu + mt_sk) * state.dkdy
            ry_e = (state.mu + mt_se) * state.depsdy
            a_l[fl.i2d_k] = wsel(m_keps, Sk * U - rx_k, a_l[fl.i2d_k])
            a_l[fl.i2d_eps] = wsel(m_keps, Se * U - rx_e, a_l[fl.i2d_eps])
            b_l[fl.i2d_k] = wsel(m_keps, Sk * V - ry_k, b_l[fl.i2d_k])
            b_l[fl.i2d_eps] = wsel(m_keps, Se * V - ry_e, b_l[fl.i2d_eps])
            src_k = wsel(band(Sk != 0, bnot(kconst)),
                         G - Se * (1.0 + Mt) + L_k * rho, src[fl.i2d_k])
            src_e = wsel(band(Sk != 0, bnot(econst)),
                         C1eps * f1 * _safe_div(Se, Sk) * G
                         - C2eps * f2 * _safe_div(Se * Se, Sk)
                         + L_eps * rho,
                         src[fl.i2d_eps])
            src[fl.i2d_k] = wsel(m_keps, src_k, src[fl.i2d_k])
            src[fl.i2d_eps] = wsel(m_keps, src_e, src[fl.i2d_eps])
            # axisymmetric add-on (hpp:241-252)
            if p.ft == fl.FT_AXISYMMETRIC:
                f_k = (state.mu + mu_t_ke) * state.dkdy
                f_e = (state.mu + mu_t_ke / 1.3) * state.depsdy
                f_l[fl.i2d_k] = wsel(m_keps, f_k, f_l[fl.i2d_k])
                f_l[fl.i2d_eps] = wsel(m_keps, f_e, f_l[fl.i2d_eps])
        else:
            f_l[fl.i2d_k] = wsel(m_keps, 0.0, f_l[fl.i2d_k])
            f_l[fl.i2d_eps] = wsel(m_keps, 0.0, f_l[fl.i2d_eps])
            src[fl.i2d_k] = wsel(m_keps, 0.0, src[fl.i2d_k])
            src[fl.i2d_eps] = wsel(m_keps, 0.0, src[fl.i2d_eps])

        s[fl.i2d_k] = wsel(m_keps, Sk, s[fl.i2d_k])
        s[fl.i2d_eps] = wsel(m_keps, Se, s[fl.i2d_eps])
        mu_t = wsel(m_keps, mu_t_ke, mu_t)

    # ---------------- Spalart-Allmaras (822-917) ---------------------------
    if has_sa:
        m_sa = ctx.m_sa
        Snu = s[fl.i2d_nu_t]
        wall = ctx.sa_bc
        fc = ctx.fc
        nu = state.mu / rho_s
        if is_init:
            Snu_new = nu / 100.0
            full = False
        else:
            full = band(bnot(wall), bnot(fc))
            Snu_new = wsel(wall, 0.0, wsel(fc, nu * TURB_INTENSITY, Snu))
        Cb1, Cb2, sig_sa = 0.1355, 0.622, 2.0 / 3.0
        kk = 0.41
        Cw1 = Cb1 / (kk * kk) + (1 + Cb2) / sig_sa
        Cw2, Cw3, Cv1 = 0.3, 2.0, 7.1
        Ct2, Ct4, C5 = 2.0, 0.5, 3.5
        k_cpcv = _safe_div(state.CP, state.CP - state.R, 2.0)
        a_sound2 = k_cpcv * state.R * state.Tg
        ksi = _safe_div(Snu, nu)
        fv1_full = _ipow(ksi, 3) / (_ipow(ksi, 3) + Cv1 ** 3)
        fv2 = 1.0 - ksi / (1.0 + ksi * fv1_full)
        Wxy = 0.5 * (state.dVdx - state.dUdy)
        Omega = torch.sqrt(2.0 * Wxy * Wxy)
        l_min_s = ctx.l_min_s
        S_hat = Omega + Snu / (kk * kk * l_min_s * l_min_s) * fv2
        S_hat = torch.maximum(S_hat, 0.3 * Omega)
        S_hat_s = torch.where(S_hat != 0, S_hat, 1)
        r_sa = torch.clamp_max(
            Snu / (S_hat_s * kk * kk * l_min_s * l_min_s), 10.0)
        g_sa = r_sa + Cw2 * (_ipow(r_sa, 6) - r_sa)
        g_s = torch.where(g_sa != 0, g_sa, 1)
        fw = g_sa * ((1.0 + Cw3 ** 6) / (_ipow(g_s, 6) + Cw3 ** 6)) \
            ** (1.0 / 6.0)
        ft2 = Ct2 * torch.exp(-Ct4 * ksi * ksi)
        nu_hat = _safe_div(mu_t, rho_s * torch.where(fv1_full != 0,
                                                     fv1_full, 1))
        div_nu = state.dkdx + state.dkdy
        rx_nu = (nu + Snu) * state.dkdx / sig_sa
        ry_nu = (nu + Snu) * state.dkdy / sig_sa
        src_nu = (Cb1 * (1.0 - ft2) * S_hat * Snu
                  - (Cw1 * fw - Cb1 / (kk * kk) * ft2)
                  * _ipow(Snu / l_min_s, 2)
                  + (Cb2 * div_nu * div_nu) / sig_sa
                  - C5 * nu_hat * nu_hat
                  * _safe_div(state.dUdy * state.dVdx, a_sound2))
        if not is_init:
            on = band(m_sa, full)
            a_l[fl.i2d_nu_t] = wsel(on, Snu * U - rx_nu, a_l[fl.i2d_nu_t])
            b_l[fl.i2d_nu_t] = wsel(on, Snu * V - ry_nu, b_l[fl.i2d_nu_t])
            src[fl.i2d_nu_t] = wsel(on, src_nu, src[fl.i2d_nu_t])
            # axisymmetric add-on for SA (hpp:246-247)
            if p.ft == fl.FT_AXISYMMETRIC:
                f_nu = (nu + Snu) * state.dkdy
                f_l[fl.i2d_nu_t] = wsel(m_sa, f_nu, f_l[fl.i2d_nu_t])
        else:
            f_l[fl.i2d_nu_t] = wsel(m_sa, 0.0, f_l[fl.i2d_nu_t])
            src[fl.i2d_nu_t] = wsel(m_sa, 0.0, src[fl.i2d_nu_t])
        s[fl.i2d_nu_t] = wsel(m_sa, Snu_new, s[fl.i2d_nu_t])
        fv1_eff = wsel(full, fv1_full, 1.0)
        mu_t_sa = torch.clamp_min(rho * s[fl.i2d_nu_t] * fv1_eff, 0.0)
        mu_t = wsel(band(m_sa, is_mu_t), mu_t_sa, mu_t)
        lam_t = wsel(band(m_sa, is_mu_t), mu_t * state.CP, lam_t)

    # ---------------- Smagorinsky LES (927-956) ----------------------------
    if has_smag:
        m_smag = ctx.m_smag
        Cs = 0.1
        delta_les = (p.dx * p.dy) ** 0.5
        Wxy_s = 0.5 * (state.dVdx - state.dUdy)
        Omega_s = torch.sqrt(2.0 * Wxy_s * Wxy_s)
        mu_t_sm = torch.clamp_min(rho * (Cs * delta_les) ** 2 * Omega_s, 0.0)
        mu_t = wsel(band(m_smag, is_mu_t), mu_t_sm, mu_t)
        lam_t = wsel(band(m_smag, is_mu_t), mu_t * state.CP, lam_t)

    return mu_t, lam_t


def calc_chemical_reactions(state: SolverState, meta: GridMeta,
                            params: SolverParams, chem: ChemTables,
                            active, ctx: StaticCtx = None) -> SolverState:
    """CalcChemicalReactions, Zeldovich infinitely-fast model
    (deeps2d_core.cpp:4697-4780), applied to ``active`` nodes; order of
    operations kept (renormalize -> burn -> mixture props -> clip ->
    renormalize -> store)."""
    p = params
    S = state.S
    rho = S[fl.i2d_Rho]
    rho_s = torch.where(rho != 0, rho, 1)
    Tg = state.Tg

    if p.fast_math:
        r_rho = 1.0 / rho_s
        Yfu = S[fl.i2d_Yfu] * r_rho
        Yox = S[fl.i2d_Yox] * r_rho
        Ycp = S[fl.i2d_Ycp] * r_rho
    else:
        Yfu = S[fl.i2d_Yfu] / rho_s
        Yox = S[fl.i2d_Yox] / rho_s
        Ycp = S[fl.i2d_Ycp] / rho_s
    Yair = 1.0 - (Yfu + Yox + Ycp)

    if ctx is not None:
        react = ctx.react
    else:
        react = active & ~iscond(meta.CT, fl.CT_Y_CONST_2D)

    if p.chemistry == fl.CRM_ZELDOVICH:
        ssum = Yfu + Yox + Ycp + Yair
        Y0 = _safe_div(torch.ones_like(ssum), ssum, 1.0)
        Yfu_n = Yfu * Y0
        Yox_n = Yox * Y0
        Ycp_n = Ycp * Y0
        burn = band(react, Tg > p.Tf)
        lean = Yox_n > Yfu_n * p.K0         # oxidizer excess
        Yox_b = torch.where(lean, Yox_n - Yfu_n * p.K0, 0.0)
        Yfu_b = torch.where(lean, 0.0, Yfu_n - Yox_n / max(p.K0, 1e-30))
        Ycp_b = torch.where(lean, 1.0 - Yox_b - Yair, 1.0 - Yfu_b - Yair)
        Yfu = torch.where(burn, Yfu_b, wsel(react, Yfu_n, Yfu))
        Yox = torch.where(burn, Yox_b, wsel(react, Yox_n, Yox))
        Ycp = torch.where(burn, Ycp_b, wsel(react, Ycp_n, Ycp))

    # mixture properties at Tg (pre-clip mass fractions)
    def tl(prefix):
        def one(sp, w):
            return table_lookup(
                getattr(chem, f"{prefix}_{sp}_x"),
                getattr(chem, f"{prefix}_{sp}_y"), Tg,
                ascending=(f"{prefix}_{sp}" in p.chem_asc)) * w
        return (one("Fuel", Yfu) + one("OX", Yox) + one("cp", Ycp)
                + one("air", Yair))

    R_new = (chem.R_Fuel * Yfu + chem.R_OX * Yox + chem.R_cp * Ycp
             + chem.R_air * Yair)
    CP_new = tl("Cp")
    if p.sm == fl.SM_NS:
        lam_new = tl("lam")
        mu_new = tl("mu")
    else:
        lam_new = state.lam
        mu_new = state.mu

    Yair = torch.where(Yair < 1.e-5, 0.0, Yair)
    Ycp = torch.where(Ycp < 1.e-8, 0.0, Ycp)
    Yox = torch.where(Yox < 1.e-8, 0.0, Yox)
    Yfu = torch.where(Yfu < 1.e-8, 0.0, Yfu)
    ssum = Yfu + Yox + Ycp + Yair
    Y0 = _safe_div(torch.ones_like(ssum), ssum, 1.0)
    Yfu = Yfu * Y0
    Yox = Yox * Y0
    Ycp = Ycp * Y0
    Yair = Yair * Y0

    Yc_new = torch.stack([
        wsel(active, val, state.Yc[c])
        for c, val in zip(range(4), (Yfu, Yox, Ycp, Yair))])

    store = react
    S_new = torch.stack([
        S[0], S[1], S[2], S[3],
        wsel(store, torch.abs(Yfu * rho), S[fl.i2d_Yfu]),
        wsel(store, torch.abs(Yox * rho), S[fl.i2d_Yox]),
        wsel(store, torch.abs(Ycp * rho), S[fl.i2d_Ycp]),
        S[7], S[8]])

    return state.replace(
        S=S_new, Yc=Yc_new,
        R=wsel(active, R_new, state.R), CP=wsel(active, CP_new, state.CP),
        lam=wsel(active, lam_new, state.lam),
        mu=wsel(active, mu_new, state.mu))


def calc_heat_on_wall_sources(state: SolverState, meta: GridMeta,
                              params: SolverParams,
                              ctx: StaticCtx = None) -> SolverState:
    """CalcHeatOnWallSources (deeps2d_core.cpp:2679-2833): conjugate wall
    heat flux for non-adiabatic walls.

    Every wall (no-slip / wall-law) gas node with a solid neighbor deposits
    a convective flux Q = -lam_eff (T_solid - T_gas)/d on the solid node and
    receives SrcAdd[rhoE] = -dt Q / d.  The C++ visits gas nodes in (i,j)
    scan order and averages when a solid node is hit twice (Q>0 test); the
    fold below reproduces that exact visit order per solid node
    [(I-1,J) right-facing, (I,J-1) up, (I,J+1) down, (I+1,J) left].
    lam_eff is the wall node's own lam + lam_t (the reference's extra
    neighbor term is dead code).  Without a ctx the visit masks are
    computed here from CT with the same shifts.
    """
    p = params
    dt_ = state.dt
    if ctx is not None:
        solid = ctx.solid
        wall = band(bnot(solid), ctx.wall)
    else:
        ct = meta.CT
        solid = iscond(ct, fl.CT_SOLID_2D)
        wall = (~solid & (iscond(ct, fl.CT_WALL_LAW_2D)
                          | iscond(ct, fl.CT_WALL_NO_SLIP_2D)))
    lam_eff = state.lam + state.lam_t
    Tg = state.Tg

    if ctx is not None:
        pres = (ctx.hv_xl, ctx.hv_yd, ctx.hv_yu, ctx.hv_xr)
    else:
        pres = (solid & _sxl(wall), solid & _syd(wall),
                solid & _syu(wall), solid & _sxr(wall))
    visitors = []
    for shift_in, d, present in ((_sxl, p.dx, pres[0]),   # gas at I-1
                                 (_syd, p.dy, pres[1]),   # gas at J-1
                                 (_syu, p.dy, pres[2]),   # gas at J+1
                                 (_sxr, p.dx, pres[3])):  # gas at I+1
        c = -shift_in(lam_eff) * (Tg - shift_in(Tg)) / d
        visitors.append((present, c))

    q = torch.zeros_like(Tg)
    q_after = []
    for present, c in visitors:
        q = wsel(present, torch.where(q > 0.0, (q + c) * 0.5, c), q)
        q_after.append(q)

    # SrcAdd[rhoE] per gas node: directions processed D, U, L, R — the last
    # solid direction wins; each reads the solid's Q right after this gas
    # node's own visit (the q_after rank of that (solid, visitor) pair)
    src_e = state.SrcAdd[fl.i2d_RhoE]
    if ctx is not None:
        down_solid, up_solid = ctx.hw_down, ctx.hw_up
        left_solid, right_solid = ctx.hw_left, ctx.hw_right
    else:
        down_solid, up_solid = wall & _syd(solid), wall & _syu(solid)
        left_solid, right_solid = wall & _sxl(solid), wall & _sxr(solid)
    src_e = wsel(down_solid, -dt_ * _syd(q_after[2]) / p.dy, src_e)
    src_e = wsel(up_solid, -dt_ * _syu(q_after[1]) / p.dy, src_e)
    src_e = wsel(left_solid, -dt_ * _sxl(q_after[3]) / p.dx, src_e)
    src_e = wsel(right_solid, -dt_ * _sxr(q_after[0]) / p.dx, src_e)

    src_add = torch.stack([state.SrcAdd[e] if e != fl.i2d_RhoE else src_e
                           for e in range(fl.NUM_EQ)])
    return state.replace(SrcAdd=src_add, Q_conv=q)
