// Bit indices of the packed static context and plane layouts shared by the
// fused-iteration kernels (fused_step.cu) and ops/fused_step.py.
//
// The packed ctx holds every bool field of StaticCtx in 4 int32 words per
// node (core/static_ctx.py build_packed_ctx): bit b lives in word b / 32 at
// position b % 32.  The order is _CTX_BOOL_STACKS (9 bits each, equation k
// at BASE + k) followed by _CTX_BOOL_PLANES — the same order as the JAX
// package's openhyperflow2d_tpu/core/static_ctx.py, checked by
// tests/test_torch_static_ctx.py.
#pragma once

namespace hf2d {

// ---- per-equation stacks: bit = BASE + equation -------------------------
constexpr int CTX_EVOLVE = 0;
constexpr int CTX_DXN = 9;
constexpr int CTX_DYN = 18;
constexpr int CTX_DX2 = 27;
constexpr int CTX_DY2 = 36;
constexpr int CTX_DDMASK = 45;
constexpr int CTX_EV_FLUX_X = 54;
constexpr int CTX_EV_AVG_X = 63;
constexpr int CTX_EV_FLUX_Y = 72;
constexpr int CTX_EV_AVG_Y = 81;
// ---- per-node planes ------------------------------------------------------
constexpr int CTX_SOLID = 90;
constexpr int CTX_FC = 91;
constexpr int CTX_ACTIVE = 92;
constexpr int CTX_NRBC = 93;
constexpr int CTX_BXL = 94;
constexpr int CTX_BXR = 95;
constexpr int CTX_BYU = 96;
constexpr int CTX_BYD = 97;
constexpr int CTX_U_CONST = 98;
constexpr int CTX_V_CONST = 99;
constexpr int CTX_WALL_LAW = 100;
constexpr int CTX_WALL_NS = 101;
constexpr int CTX_WALL = 102;
constexpr int CTX_TURB_ON = 103;
constexpr int CTX_M_PRANDTL = 104;
constexpr int CTX_M_KEPS = 105;
constexpr int CTX_M_SA = 106;
constexpr int CTX_M_SMAG = 107;
constexpr int CTX_KCONST = 108;
constexpr int CTX_ECONST = 109;
constexpr int CTX_EWALL = 110;
constexpr int CTX_SA_BC = 111;
constexpr int CTX_DYDX_OK = 112;
constexpr int CTX_DYDY_OK = 113;
constexpr int CTX_G_DYDX = 114;
constexpr int CTX_G_DYDY = 115;
constexpr int CTX_KM = 116;
constexpr int CTX_EM = 117;
constexpr int CTX_REACT = 118;
constexpr int CTX_HV_XL = 119;
constexpr int CTX_HV_YD = 120;
constexpr int CTX_HV_YU = 121;
constexpr int CTX_HV_XR = 122;
constexpr int CTX_HW_DOWN = 123;
constexpr int CTX_HW_UP = 124;
constexpr int CTX_HW_LEFT = 125;
constexpr int CTX_HW_RIGHT = 126;
constexpr int CTX_N_BITS = 127;
constexpr int CTX_N_WORDS = 4;
// the word that holds every conjugate-heat bit (all heat_kernel reads)
constexpr int CTX_HEAT_WORD = CTX_HV_XL / 32;
static_assert(CTX_HW_RIGHT / 32 == CTX_HEAT_WORD,
              "the hv_*/hw_* bits must share one ctx word");

// ---- slim carry: (31, X, Y), SlimState field order ------------------------
constexpr int CARRY_S = 0;      // 9 planes
constexpr int CARRY_BETA = 9;   // 9 planes
constexpr int CARRY_U = 18;
constexpr int CARRY_V = 19;
constexpr int CARRY_P = 20;
constexpr int CARRY_TG = 21;
constexpr int CARRY_YC = 22;    // 4 planes
constexpr int CARRY_R = 26;
constexpr int CARRY_CP = 27;
constexpr int CARRY_LAM = 28;
constexpr int CARRY_MU = 29;
constexpr int CARRY_MU_T = 30;
constexpr int N_CARRY = 31;

// ---- gfc -> heat -> pass12 scratch: (31, X, Y) ----------------------------
constexpr int SCR_S = 0;        // 9 planes: post-fill, post-chemistry S
constexpr int SCR_A = 9;        // 9 planes: x-flux
constexpr int SCR_B = 18;       // 9 planes: y-flux
constexpr int SCR_SRC_K = 27;   // turbulence sources (the only nonzero Src)
constexpr int SCR_SRC_EPS = 28;
constexpr int SCR_LAM_EFF = 29;   // lam + lam_t after chemistry (gfc<general>)
constexpr int SCR_SRCADD_E = 30;  // SrcAdd of rhoE (heat_kernel only)
constexpr int N_SCRATCH = 31;
// axisymmetric decks: the 9 radial fluxes F after those (gfc's extended
// form writes them, pass12's reads them at the node)
constexpr int SCR_F = 31;
constexpr int N_SCRATCH_AXI = SCR_F + 9;
// decks with moving-wall sources (isSrcAdd): their SrcAdd of equations 0,
// 1, 2, 4, 5, 6 after the F planes (the XF_MW forms write them at no-slip
// wall nodes, pass12 reads them there)
constexpr int SCR_MW = N_SCRATCH_AXI;
constexpr int N_SCRATCH_MW = SCR_MW + 6;

// ---- meta planes ----------------------------------------------------------
constexpr int META_IDXL = 0;    // int8 (4, X, Y): idXl, idXr, idYu, idYd
constexpr int META_BGX = 0;     // float (5, X, Y): BGX, BGY, Uw, Vw, l_min
                                // (6 on Euler decks: + lam_t; 7 where the
                                // closure reads y+: + lam_t, y+)
constexpr int META_BGY = 1;
constexpr int META_UW = 2;
constexpr int META_VW = 3;
constexpr int META_LMIN = 4;
constexpr int META_LAM_T = 5;   // Euler decks only: the chunk-constant lam_t
constexpr int META_Y_PLUS = 6;  // closures that read y+ (van Driest, Chien):
                                // the chunk-constant y+ (after a lam_t plane)

// ---- CTA tile: TX rows (i) x TY columns (j), one thread per node ----------
constexpr int TILE_X = 8;
constexpr int TILE_Y = 32;

}  // namespace hf2d
