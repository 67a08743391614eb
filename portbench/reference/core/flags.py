"""Boundary-condition and node-type bit flags.

TPU-native re-implementation of the reference solver's per-node condition
bit-mask scheme (reference: libOpenHyperFLOW2D/hyper_flow_node.hpp:63-128 and
libOpenHyperFLOW2D/hyper_flow_turbulence.hpp:22-99).  Every node carries a
condition word ``CT`` and a turbulence condition word ``TCT``; the solver kernel
is branch-free — BC behaviour is selected per node per equation by testing
bits, which maps directly onto vectorized ``jnp.where`` masks on TPU.

Bit values are kept identical to the reference so that deck files
(``<data/...Cond=NT_FC_2D, CT_V_CONST_2D>``) and any persisted grids remain
semantically compatible.

The reference stores CT in a 64-bit word with two flags above bit 31
(CT_LIQUID, CT_TIME_DEPEND).  On device we keep CT as uint32 (bits 0..31) and
track the two high flags in a separate small field host-side; neither is used
by any shipped test case.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Species / equation indexing (hyper_flow_node.hpp:33-60,
# hyper_flow_turbulence.hpp:14-20)
# ---------------------------------------------------------------------------
NUM_COMPONENTS = 3          # additional components (fuel, ox, cp); air is base
NUM_EQ = 6 + NUM_COMPONENTS  # rho, rhoU, rhoV, rhoE, 3 species, k/nu_t, eps

h_fu, h_ox, h_cp, h_air = 0, 1, 2, 3

i2d_Rho = 0
i2d_RhoU = 1
i2d_RhoV = 2
i2d_RhoE = 3
i2d_Yfu = 4
i2d_Yox = 5
i2d_Ycp = 6
i2d_k = 7        # k (k-eps) / nu_t (SA)
i2d_nu_t = 7
i2d_eps = 8      # eps (k-eps) / omega
i2d_omega = 8

# ---------------------------------------------------------------------------
# Solver / flow modes (hyper_flow_node.hpp:41-49)
# ---------------------------------------------------------------------------
SM_EULER = 0
SM_NS = 1

FT_FLAT = 0
FT_AXISYMMETRIC = 1

# ---------------------------------------------------------------------------
# CondType2D bit flags (hyper_flow_node.hpp:63-99)
# ---------------------------------------------------------------------------
CT_NO_COND_2D = 0x0
CT_Rho_CONST_2D = 0x01
CT_U_CONST_2D = 0x02
CT_V_CONST_2D = 0x04
CT_T_CONST_2D = 0x08
CT_Y_CONST_2D = 0x010
CT_dRhodx_NULL_2D = 0x020
CT_dUdx_NULL_2D = 0x040
CT_dVdx_NULL_2D = 0x080
CT_dTdx_NULL_2D = 0x0100
CT_dYdx_NULL_2D = 0x0200
CT_dRhody_NULL_2D = 0x0400
CT_dUdy_NULL_2D = 0x0800
CT_dVdy_NULL_2D = 0x01000
CT_dTdy_NULL_2D = 0x02000
CT_dYdy_NULL_2D = 0x04000
CT_d2Rhodx2_NULL_2D = 0x08000
CT_d2Udx2_NULL_2D = 0x010000
CT_d2Vdx2_NULL_2D = 0x020000
CT_d2Tdx2_NULL_2D = 0x040000
CT_d2Ydx2_NULL_2D = 0x080000
CT_d2Rhody2_NULL_2D = 0x0100000
CT_d2Udy2_NULL_2D = 0x0200000
CT_d2Vdy2_NULL_2D = 0x0400000
CT_d2Tdy2_NULL_2D = 0x0800000
CT_d2Ydy2_NULL_2D = 0x01000000
CT_NONREFLECTED_2D = 0x02000000
CT_WALL_NO_SLIP_2D = 0x04000000
CT_WALL_LAW_2D = 0x08000000
CT_GAS_2D = 0x010000000
CT_BL_REFINEMENT_2D = 0x020000000
CT_SOLID_2D = 0x040000000
CT_NODE_IS_SET_2D = 0x080000000
CT_LIQUID_2D = 0x0100000000       # bit 32 — host-side only
CT_TIME_DEPEND_2D = 0x0200000000  # bit 33 — host-side only

# ---------------------------------------------------------------------------
# NodeType2D macro combinations (hyper_flow_node.hpp:103-128)
# ---------------------------------------------------------------------------
NT_UNDEF_2D = 0
NT_FC_2D = (CT_Rho_CONST_2D | CT_U_CONST_2D | CT_V_CONST_2D | CT_Y_CONST_2D
            | CT_T_CONST_2D | CT_NODE_IS_SET_2D)
NT_D0X_2D = (CT_NODE_IS_SET_2D | CT_dRhodx_NULL_2D | CT_dUdx_NULL_2D
             | CT_dVdx_NULL_2D | CT_dTdx_NULL_2D | CT_dYdx_NULL_2D)
NT_D2X_2D = (CT_NODE_IS_SET_2D | CT_d2Rhodx2_NULL_2D | CT_d2Udx2_NULL_2D
             | CT_d2Vdx2_NULL_2D | CT_d2Tdx2_NULL_2D | CT_d2Ydx2_NULL_2D)
NT_D0Y_2D = (CT_NODE_IS_SET_2D | CT_dRhody_NULL_2D | CT_dUdy_NULL_2D
             | CT_dVdy_NULL_2D | CT_dTdy_NULL_2D | CT_dYdy_NULL_2D)
NT_D2Y_2D = (CT_NODE_IS_SET_2D | CT_d2Rhody2_NULL_2D | CT_d2Udy2_NULL_2D
             | CT_d2Vdy2_NULL_2D | CT_d2Tdy2_NULL_2D | CT_d2Ydy2_NULL_2D)
NT_AY_2D = CT_NODE_IS_SET_2D | NT_D0X_2D | CT_U_CONST_2D
NT_AX_2D = CT_NODE_IS_SET_2D | NT_D0Y_2D | CT_V_CONST_2D
NT_WALL_LAW_2D = CT_NODE_IS_SET_2D | CT_WALL_LAW_2D
NT_WNS_2D = (CT_NODE_IS_SET_2D | CT_WALL_NO_SLIP_2D | CT_U_CONST_2D
             | CT_V_CONST_2D)
NT_S_2D = CT_SOLID_2D | CT_NODE_IS_SET_2D
# NT_F_2D in the reference is `!CT_SOLID_2D | CT_NODE_IS_SET_2D` which
# evaluates to `0 | CT_NODE_IS_SET_2D` (logical-not of a nonzero constant).
NT_F_2D = CT_NODE_IS_SET_2D
NT_FC_TIME_DEPEND_2D = (CT_Rho_CONST_2D | CT_U_CONST_2D | CT_V_CONST_2D
                        | CT_Y_CONST_2D | CT_T_CONST_2D | CT_TIME_DEPEND_2D
                        | CT_NODE_IS_SET_2D)
NT_FARFIELD_2D = NT_FC_2D | CT_NONREFLECTED_2D

# ---------------------------------------------------------------------------
# TurbulenceCondType2D bit flags (hyper_flow_turbulence.hpp:22-61)
# ---------------------------------------------------------------------------
TCT_No_Turbulence_2D = 0x0
TCT_k_CONST_2D = 0x01
TCT_eps_CONST_2D = 0x02
TCT_dkdx_NULL_2D = 0x04
TCT_depsdx_NULL_2D = 0x08
TCT_dkdy_NULL_2D = 0x010
TCT_depsdy_NULL_2D = 0x020
TCT_d2kdx2_NULL_2D = 0x040
TCT_d2epsdx2_NULL_2D = 0x080
TCT_d2kdy2_NULL_2D = 0x0100
TCT_d2epsdy2_NULL_2D = 0x0200
TCT_k_eps_Model_2D = 0x0400
TCT_Prandtl_Model_2D = 0x0800
TCT_Integral_Model_2D = 0x01000
TCT_eps_mud2kdx2_WALL_2D = 0x02000
TCT_eps_mud2kdy2_WALL_2D = 0x04000
TCT_eps_Cmk2kXn_WALL_2D = 0x08000
TCT_Spalart_Allmaras_Model_2D = 0x010000
TCT_k_omega_Model_2D = 0x020000
TCT_k_omega_SST_Model_2D = 0x040000
TCT_Baldwin_Lomax_Model_2D = 0x080000
TCT_nut_92_Model_2D = 0x0100000
TCT_Smagorinsky_Model_2D = 0x0200000

# omega / nu_t aliases (hyper_flow_turbulence.hpp:83-91)
TCT_omega_CONST_2D = TCT_eps_CONST_2D
TCT_nu_t_CONST_2D = TCT_k_CONST_2D
TCT_dnu_t_dx_NULL_2D = TCT_dkdx_NULL_2D
TCT_dnu_t_dy_NULL_2D = TCT_dkdy_NULL_2D

TNT_UNDEF_2D = 0
TNT_FC_2D = TCT_k_CONST_2D | TCT_eps_CONST_2D
TNT_D0X_2D = TCT_dkdx_NULL_2D | TCT_depsdx_NULL_2D
TNT_D0Y_2D = TCT_dkdy_NULL_2D | TCT_depsdy_NULL_2D

# ---------------------------------------------------------------------------
# Extended turbulence models (hyper_flow_turbulence.hpp:63-80)
# ---------------------------------------------------------------------------
TEM_Prandtl = 0
TEM_vanDriest = 1
TEM_Escudier = 2
TEM_Klebanoff = 3
TEM_k_eps_Std = 4
TEM_k_eps_Chien = 5
TEM_k_eps_JL = 6
TEM_k_eps_LSY = 7
TEM_k_eps_RNG = 8
TEM_k_eps_Realisable = 9
TEM_Spalart_Allmaras = 10
TEM_Baldwin_Lomax = 11
TEM_nut_92_Sekundov = 12
TEM_k_omega_Wilcox = 13
TEM_k_omega_SST = 14
TEM_Smagorinsky = 15

# Blending factor function ids (libDEEPS2D/deeps2d_core.hpp:66-79 / deck key BFF)
BFF_L = 0     # linear
BFF_LR = 1    # linear with relaxation
BFF_S = 2     # square
BFF_SR = 3    # square with relaxation
BFF_SQR = 4   # sqrt (most accurate & stable per reference)
BFF_SQRR = 5  # sqrt with relaxation

# Chemistry models
CRM_NO_REACTIONS = 0
CRM_ZELDOVICH = 1

# Deck-level turbulence model id -> TCT model bit
# (deeps2d_core.cpp:2166-2177 & 3297-3308)
TURB_MODEL_ID_TO_TCT = {
    0: TCT_No_Turbulence_2D,
    1: TCT_Integral_Model_2D,
    2: TCT_Prandtl_Model_2D,
    3: TCT_Spalart_Allmaras_Model_2D,
    4: TCT_k_eps_Model_2D,
    5: TCT_Smagorinsky_Model_2D,
}

# Names accepted in deck "Cond" strings, applied via substring match in the
# reference (deeps2d_core.cpp:3311-3439).  Order matters only for the
# else-if chains, reproduced in geometry/bounds.py.
CT_NAME_TO_FLAG = {
    "CT_Rho_CONST_2D": CT_Rho_CONST_2D,
    "CT_U_CONST_2D": CT_U_CONST_2D,
    "CT_V_CONST_2D": CT_V_CONST_2D,
    "CT_T_CONST_2D": CT_T_CONST_2D,
    "CT_Y_CONST_2D": CT_Y_CONST_2D,
    "CT_WALL_LAW_2D": CT_WALL_LAW_2D,
    "CT_WALL_NO_SLIP_2D": CT_WALL_NO_SLIP_2D,
    "CT_dRhodx_NULL_2D": CT_dRhodx_NULL_2D,
    "CT_dUdx_NULL_2D": CT_dUdx_NULL_2D,
    "CT_dVdx_NULL_2D": CT_dVdx_NULL_2D,
    "CT_dTdx_NULL_2D": CT_dTdx_NULL_2D,
    "CT_dYdx_NULL_2D": CT_dYdx_NULL_2D,
    "CT_dRhody_NULL_2D": CT_dRhody_NULL_2D,
    "CT_dUdy_NULL_2D": CT_dUdy_NULL_2D,
    "CT_dVdy_NULL_2D": CT_dVdy_NULL_2D,
    "CT_dTdy_NULL_2D": CT_dTdy_NULL_2D,
    # The reference tests the literal string "CT_dYdy_NULL_2D_2D"
    # (deeps2d_core.cpp:3343) — kept for compatibility.
    "CT_dYdy_NULL_2D_2D": CT_dYdy_NULL_2D,
    "CT_d2Rhodx2_NULL_2D": CT_d2Rhodx2_NULL_2D,
    "CT_d2Udx2_NULL_2D": CT_d2Udx2_NULL_2D,
    "CT_d2Vdx2_NULL_2D": CT_d2Vdx2_NULL_2D,
    "CT_d2Tdx2_NULL_2D": CT_d2Tdx2_NULL_2D,
    "CT_d2Ydx2_NULL_2D": CT_d2Ydx2_NULL_2D,
    "CT_d2Rhody2_NULL_2D": CT_d2Rhody2_NULL_2D,
    "CT_d2Udy2_NULL_2D": CT_d2Udy2_NULL_2D,
    "CT_d2Vdy2_NULL_2D": CT_d2Vdy2_NULL_2D,
    "CT_d2Tdy2_NULL_2D": CT_d2Tdy2_NULL_2D,
    "CT_d2Ydy2_NULL_2D": CT_d2Ydy2_NULL_2D,
    "CT_SOLID_2D": CT_SOLID_2D,
    "CT_BL_REFINEMENT_2D": CT_BL_REFINEMENT_2D,
    "CT_NONREFLECTED_2D": CT_NONREFLECTED_2D,
}

NT_NAME_TO_FLAG = {
    "NT_AX_2D": NT_AX_2D,
    "NT_AY_2D": NT_AY_2D,
    "NT_D0X_2D": NT_D0X_2D,
    "NT_D0Y_2D": NT_D0Y_2D,
    "NT_D2X_2D": NT_D2X_2D,
    "NT_D2Y_2D": NT_D2Y_2D,
    "NT_WALL_LAW_2D": NT_WALL_LAW_2D,
    "NT_WNS_2D": NT_WNS_2D,
    "NT_FC_2D": NT_FC_2D,
    "NT_FARFIELD_2D": NT_FARFIELD_2D,
    "NT_S_2D": NT_S_2D,
}

TCT_NAME_TO_FLAG = {
    "TCT_k_CONST_2D": TCT_k_CONST_2D,
    "TCT_eps_CONST_2D": TCT_eps_CONST_2D,
    "TCT_dkdx_NULL_2D": TCT_dkdx_NULL_2D,
    "TCT_depsdx_NULL_2D": TCT_depsdx_NULL_2D,
    "TCT_dkdy_NULL_2D": TCT_dkdy_NULL_2D,
    "TCT_depsdy_NULL_2D": TCT_depsdy_NULL_2D,
    "TCT_d2kdx2_NULL_2D": TCT_d2kdx2_NULL_2D,
    "TCT_d2epsdx2_NULL_2D": TCT_d2epsdx2_NULL_2D,
    "TCT_d2kdy2_NULL_2D": TCT_d2kdy2_NULL_2D,
    "TCT_d2epsdy2_NULL_2D": TCT_d2epsdy2_NULL_2D,
    "TCT_eps_mud2kdx2_WALL_2D": TCT_eps_mud2kdx2_WALL_2D,
    "TCT_eps_mud2kdy2_WALL_2D": TCT_eps_mud2kdy2_WALL_2D,
    "TCT_eps_Cmk2kXn_WALL_2D": TCT_eps_Cmk2kXn_WALL_2D,
}


def is_cond(ct, flag):
    """Vectorized ``FlowNode2D::isCond2D``: all bits of ``flag`` set in ``ct``.

    Works on Python ints, numpy arrays and jnp arrays.
    """
    return (ct & flag) == flag


def ct_to_uint32(ct: np.ndarray) -> np.ndarray:
    """Project a 64-bit host CT array onto the device uint32 representation."""
    return (np.asarray(ct, dtype=np.uint64) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)
