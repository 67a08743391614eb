"""Precomputed per-node static context: masks, stencil weights, geometry.

Counterpart of ``openhyperflow2d_tpu.core.static_ctx``: every per-iteration
branch of the reference decodes the CT/TCT bit flags; all of those decodes
are pure functions of the static GridMeta + SolverParams and are computed
once here.

Condition words are int32 bit-views (see core/state.py), so flags above bit
30 are compared as their signed int32 values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import flags as fl


def _i32(flag: int) -> int:
    """The signed int32 value with the bit pattern of ``flag``'s low word."""
    f = flag & 0xFFFFFFFF
    return f - (1 << 32) if f >= (1 << 31) else f


def iscond(ct, flag):
    f = _i32(flag)
    return (ct & f) == f


# edge-replicated shifts of the integer CT plane (the heat visit masks test
# bits of the shifted word, as the JAX package does)
def _sxl(q):
    return torch.cat([q[:1, :], q[:-1, :]], dim=0)


def _sxr(q):
    return torch.cat([q[1:, :], q[-1:, :]], dim=0)


def _syd(q):
    return torch.cat([q[:, :1], q[:, :-1]], dim=1)


def _syu(q):
    return torch.cat([q[:, 1:], q[:, -1:]], dim=1)


def _heat_visit_masks(ct, solid, wall):
    """The 8 conjugate-heat visit masks (deeps2d_core.cpp:2679-2833):
    hv_* = solid node whose (xl/yd/yu/xr) neighbor is a wall GAS node;
    hw_* = wall gas node whose (down/up/left/right) neighbor is solid."""
    def wall_gas_of(c):
        w = iscond(c, fl.CT_WALL_LAW_2D) | iscond(c, fl.CT_WALL_NO_SLIP_2D)
        return w & ~iscond(c, fl.CT_SOLID_2D)

    def solid_of(c):
        return iscond(c, fl.CT_SOLID_2D)

    ct_xl, ct_xr, ct_yd, ct_yu = _sxl(ct), _sxr(ct), _syd(ct), _syu(ct)
    wall_gas = wall & ~solid
    return {
        "hv_xl": solid & wall_gas_of(ct_xl),
        "hv_yd": solid & wall_gas_of(ct_yd),
        "hv_yu": solid & wall_gas_of(ct_yu),
        "hv_xr": solid & wall_gas_of(ct_xr),
        "hw_down": wall_gas & solid_of(ct_yd),
        "hw_up": wall_gas & solid_of(ct_yu),
        "hw_left": wall_gas & solid_of(ct_xl),
        "hw_right": wall_gas & solid_of(ct_xr),
    }


@dataclass
class StaticCtx:
    """Static per-node planes consumed by the solver stages (field meanings
    as in the JAX StaticCtx)."""

    # per-equation BC masks, (9, X, Y) bool
    evolve: torch.Tensor
    dxn: torch.Tensor
    dyn: torch.Tensor
    dx2: torch.Tensor
    dy2: torch.Tensor
    ddmask: torch.Tensor
    ev_flux_x: torch.Tensor
    ev_avg_x: torch.Tensor
    ev_flux_y: torch.Tensor
    ev_avg_y: torch.Tensor
    # node classification, (X, Y) bool
    solid: torch.Tensor
    fc: torch.Tensor
    active: torch.Tensor
    nrbc: torch.Tensor
    # neighbor structure
    bXl: torch.Tensor
    bXr: torch.Tensor
    bYu: torch.Tensor
    bYd: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    n3: torch.Tensor
    n4: torch.Tensor
    rn_n: torch.Tensor
    rm_m: torch.Tensor
    dx1nn: torch.Tensor
    dy1mm: torch.Tensor
    # FillNode2D masks
    u_const: torch.Tensor
    v_const: torch.Tensor
    wall_law: torch.Tensor
    wall_ns: torch.Tensor
    wall: torch.Tensor
    turb_on: torch.Tensor
    sig: torch.Tensor
    y_r: torch.Tensor
    jp1: torch.Tensor
    # turbulence model masks
    m_prandtl: torch.Tensor
    m_keps: torch.Tensor
    m_sa: torch.Tensor
    m_smag: torch.Tensor
    kconst: torch.Tensor
    econst: torch.Tensor
    ewall: torch.Tensor
    sa_bc: torch.Tensor
    l_base: torch.Tensor
    n_0: torch.Tensor
    l_s: torch.Tensor
    l_min_s: torch.Tensor
    # gradient-stage masks
    dydx_ok: torch.Tensor
    dydy_ok: torch.Tensor
    g_dydx: torch.Tensor
    g_dydy: torch.Tensor
    km: torch.Tensor
    em: torch.Tensor
    # chemistry
    react: torch.Tensor
    # conjugate-heat visit masks
    hv_xl: torch.Tensor
    hv_yd: torch.Tensor
    hv_yu: torch.Tensor
    hv_xr: torch.Tensor
    hw_down: torch.Tensor
    hw_up: torch.Tensor
    hw_left: torch.Tensor
    hw_right: torch.Tensor


def _eq_flag_masks(ct, tct, params, active):
    """Per-equation (c, dxn, dyn, dx2, dy2, act, ddc) mask lists (the
    reference's per-equation flag decode, deeps2d_core.cpp:893-991)."""
    p = params
    ones = torch.ones_like(active)
    zeros = torch.zeros_like(active)
    keps = iscond(tct, fl.TCT_k_eps_Model_2D)
    sa = iscond(tct, fl.TCT_Spalart_Allmaras_Model_2D)
    turb2 = (keps | sa) if p.sm == fl.SM_NS else zeros
    out = []
    for k in range(9):
        if k < 4:
            c = iscond(ct, fl.CT_Rho_CONST_2D << k)
            dxn = iscond(ct, fl.CT_dRhodx_NULL_2D << k)
            dyn = iscond(ct, fl.CT_dRhody_NULL_2D << k)
            dx2 = iscond(ct, fl.CT_d2Rhodx2_NULL_2D << k)
            dy2 = iscond(ct, fl.CT_d2Rhody2_NULL_2D << k)
            act, ddc = ones, c
        elif k < 7:
            c = iscond(ct, fl.CT_Y_CONST_2D)
            dxn = iscond(ct, fl.CT_dYdx_NULL_2D)
            dyn = iscond(ct, fl.CT_dYdy_NULL_2D)
            dx2 = iscond(ct, fl.CT_d2Ydx2_NULL_2D)
            dy2 = iscond(ct, fl.CT_d2Ydy2_NULL_2D)
            act, ddc = ones, c
        else:
            s = k - 7
            c = iscond(tct, fl.TCT_k_CONST_2D << s)
            dxn = iscond(tct, fl.TCT_dkdx_NULL_2D << s)
            dyn = iscond(tct, fl.TCT_dkdy_NULL_2D << s)
            dx2 = iscond(tct, fl.TCT_d2kdx2_NULL_2D << s)
            dy2 = iscond(tct, fl.TCT_d2kdy2_NULL_2D << s)
            act = (turb2 if k == 7 else
                   (keps if p.sm == fl.SM_NS else zeros))
            # reference pass-2 gate tests CT (not TCT) for these equations
            ddc = iscond(ct, fl.TCT_k_CONST_2D << s)
        out.append((c, dxn, dyn, dx2, dy2, act, ddc))
    return out


def _node_planes(meta, params, active, solid, fc):
    """The (X, Y) bool planes of StaticCtx, by field name."""
    ct, tct = meta.CT, meta.TCT
    keps = iscond(tct, fl.TCT_k_eps_Model_2D)
    sa = iscond(tct, fl.TCT_Spalart_Allmaras_Model_2D)
    wall_lawm = iscond(ct, fl.CT_WALL_LAW_2D)
    wall_nsm = iscond(ct, fl.CT_WALL_NO_SLIP_2D) & ~wall_lawm
    m_prandtl = iscond(tct, fl.TCT_Prandtl_Model_2D)
    m_keps = keps & ~m_prandtl
    m_sa = sa & ~m_prandtl & ~m_keps
    dydx_ok = ~iscond(ct, fl.CT_dYdx_NULL_2D)
    dydy_ok = ~iscond(ct, fl.CT_dYdy_NULL_2D)
    planes = {
        "solid": solid, "fc": fc, "active": active,
        "nrbc": iscond(ct, fl.CT_NONREFLECTED_2D),
        "bXl": meta.idXl != 0, "bXr": meta.idXr != 0,
        "bYu": meta.idYu != 0, "bYd": meta.idYd != 0,
        "u_const": iscond(ct, fl.CT_U_CONST_2D),
        "v_const": iscond(ct, fl.CT_V_CONST_2D),
        "wall_law": wall_lawm, "wall_ns": wall_nsm,
        "wall": wall_nsm | wall_lawm, "turb_on": tct != 0,
        "m_prandtl": m_prandtl, "m_keps": m_keps, "m_sa": m_sa,
        "m_smag": (iscond(tct, fl.TCT_Smagorinsky_Model_2D)
                   & ~m_prandtl & ~m_keps & ~m_sa),
        "kconst": iscond(tct, fl.TCT_k_CONST_2D),
        "econst": iscond(tct, fl.TCT_eps_CONST_2D),
        "ewall": iscond(tct, fl.TCT_eps_Cmk2kXn_WALL_2D),
        "sa_bc": (iscond(ct, fl.CT_WALL_NO_SLIP_2D) | wall_lawm
                  | iscond(tct, fl.TCT_nu_t_CONST_2D)),
        "dydx_ok": dydx_ok, "dydy_ok": dydy_ok,
        "g_dydx": active & dydx_ok, "g_dydy": active & dydy_ok,
        "km": active & (keps | sa), "em": active & keps,
        "react": active & ~iscond(ct, fl.CT_Y_CONST_2D),
    }
    planes.update(_heat_visit_masks(ct, solid, wall_nsm | wall_lawm))
    return planes


def _node_class(ct):
    solid = iscond(ct, fl.CT_SOLID_2D)
    is_set = iscond(ct, fl.CT_NODE_IS_SET_2D)
    fc = iscond(ct, fl.NT_FC_2D)
    return solid, fc, is_set & ~solid & ~fc


def _float_planes(meta, params, dtype, wall):
    """Weights and length scales rebuilt from the meta planes with exactly
    build_static_ctx's expressions."""
    p = params
    n1 = meta.idXl.to(dtype)
    n2 = meta.idXr.to(dtype)
    n3 = meta.idYu.to(dtype)
    n4 = meta.idYd.to(dtype)
    n_n = torch.clamp_min(n1 + n2, 1.0)
    m_m = torch.clamp_min(n3 + n4, 1.0)
    rn_n = 1.0 / n_n
    rm_m = 1.0 / m_m
    l_base = torch.clamp_min(meta.l_min, min(p.dx, p.dy)) * 0.41
    return dict(
        n1=n1, n2=n2, n3=n3, n4=n4, rn_n=rn_n, rm_m=rm_m,
        dx1nn=rn_n / p.dx, dy1mm=rm_m / p.dy,
        sig=torch.where(wall, torch.tensor(p.SigW, dtype=dtype,
                                           device=wall.device),
                        torch.tensor(p.SigF, dtype=dtype,
                                     device=wall.device)),
        l_base=l_base, n_0=meta.l_min * 0.41,
        l_s=torch.where(l_base != 0, l_base, 1.0),
        l_min_s=torch.where(meta.l_min != 0, meta.l_min, 1.0))


def _row_geometry(shape, params, dtype, device):
    jj = torch.arange(shape[1], dtype=torch.int32,
                      device=device).to(dtype).expand(shape)
    return (jj + 0.5) * params.dy, jj + 1.0


def spec_supported(params) -> bool:
    """Whether the interior-specialized kernel body exists for this case
    family (NS + k-eps: all 9 equations evolve on a generic node)."""
    return params.sm == fl.SM_NS and "keps" in params.models


def generic_interior_map(CT, TCT, idXl, idXr, idYu, idYd, params):
    """(X, Y) bool numpy map of 'generic interior' nodes: exactly the
    IS_SET flag, exactly the k-eps model bit, all four neighbors present.
    Their full StaticCtx decode is constant.  None when the case family has no specialized body."""
    if not spec_supported(params):
        return None

    def u32(a):
        a = np.asarray(a)
        return a.view(np.uint32) if a.dtype == np.int32 else \
            a.astype(np.int64).astype(np.uint32)

    return ((u32(CT) == np.uint32(fl.CT_NODE_IS_SET_2D))
            & (u32(TCT) == np.uint32(fl.TCT_k_eps_Model_2D))
            & (np.asarray(idXl) == 1) & (np.asarray(idXr) == 1)
            & (np.asarray(idYu) == 1) & (np.asarray(idYd) == 1))


def build_static_ctx(meta, params) -> StaticCtx:
    """Decode GridMeta + SolverParams into a StaticCtx."""
    p = params
    ct, tct = meta.CT, meta.TCT
    dtype = p.torch_dtype
    solid, fc, active = _node_class(ct)
    cols = list(zip(*_eq_flag_masks(ct, tct, p, active)))
    cmask, dxn_s, dyn_s, dx2_s, dy2_s, eact, ddc_s = (torch.stack(c)
                                                      for c in cols)
    evolve = active[None] & eact & ~cmask
    vals = dict(
        evolve=evolve, dxn=dxn_s, dyn=dyn_s, dx2=dx2_s, dy2=dy2_s,
        ddmask=active[None] & eact & ~ddc_s,
        ev_flux_x=evolve & ~dxn_s, ev_avg_x=evolve & dxn_s,
        ev_flux_y=evolve & ~dyn_s, ev_avg_y=evolve & dyn_s)
    vals.update(_node_planes(meta, p, active, solid, fc))
    vals.update(_float_planes(meta, p, dtype, vals["wall"]))
    vals["y_r"], vals["jp1"] = _row_geometry(ct.shape, p, dtype, ct.device)
    return StaticCtx(**vals)
