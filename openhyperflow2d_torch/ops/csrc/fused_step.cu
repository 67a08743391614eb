// Fused solver iteration for Hopper (sm_90a), float32:
//
//   gfc_kernel<BODY>     gradients -> FillNode2D (k-eps) -> dt field ->
//                        Zeldovich chemistry, one thread per node
//   heat_kernel          conjugate wall heat (CalcHeatOnWallSources) of
//                        non-adiabatic walls, one thread per node of the
//                        heat tiles
//   pass12_kernel<BODY>  pass 1 (blending update) + pass 2 (residual,
//                        blending factor, commit), one thread per node
//
// Replaces the TPU kernel openhyperflow2d_tpu/ops/pallas_step.py
// _machinery.make_fused: its "general" body (lines 456-722, the packed-ctx
// decode, including the wall-heat stage of gfc) is BODY_GENERAL, its
// "spec" body (line 719-720, every mask a constant of
// specialized_interior_ctx) is BODY_SPEC, its "dual" body (lines 702-718,
// both bodies switched per tile by a flag) is BODY_DUAL, and its scatter
// form (scatter_n, lines 506-510: a 1-D grid over a tile table) is the
// BODY_GENERAL launch over an arbitrary device tile list.  The TPU kernel
// ran gfc and pass12 of one tile window in VMEM; here the stages are
// launches over the whole grid, because every mask on this path is read at
// the node being computed and the only neighbor reads are the +-1 stencils
// of the gradients (S, U, V, Tg) and of pass 1 (S, A, B), and the +-2
// reach of the heat stage.
//
// What bounds it on an H100: memory traffic.  Per node and iteration, in
// float32, with each plane read from memory once (neighbor reads hit the
// cache): gfc_kernel<spec> reads 18 carry planes and l_min and writes the
// 29-plane scratch and 13 carry planes (about 244 bytes); pass12_kernel
// <spec> reads the scratch and beta (38 planes) and writes S and beta (18),
// about 224 bytes.  The general body adds Yc, p, the 4 int8 neighbor
// flags, 4 more meta planes and the 4 ctx words (about 545 bytes for
// both).  At 2048^2, where 96% of the nodes run the spec body, that is
// about 2 GB per iteration, so about 0.59 ms at 3.35 TB/s is the floor of
// this two-launch form.  The design keeps the neighbor reads in L1/L2 (a CTA is
// an 8 x 32 tile, warps run along the contiguous j axis), keeps the
// per-equation state in registers, and writes partial reductions per tile
// (no atomics, so the diagnostics are deterministic).  The scratch round
// trip is what a single fused launch per iteration would remove.
//
// heat_kernel reads the one ctx word that holds the heat bits (4 bytes) at
// every node of the heat tiles, and Tg, lam_eff and the SrcAdd write only
// at the wall gas nodes and their solid neighbors (+-2 around the wall): at
// 2048^2 that is a few dozen tiles, so its time is the launch.  The dual
// form trades the second launch of each stage for one kernel holding both
// bodies, whose register budget is the larger body's; CTA b runs tile b.
//
// The same launches are the counterpart of the multi-chip kernel
// (openhyperflow2d_tpu/parallel/shard_step.py make_pallas_shard_chunk,
// lines 256-381, with sharded_inner_overlap, 383-568): each X strip of the
// multi-device path (openhyperflow2d_torch/parallel/shard_step.py) runs
// them over its own rows plus H = 2 halo rows on each side, read straight
// from the strip's compact carry with clamped indices, and the window
// Consts::x0/x1 keeps the halo rows out of the partials.  What bounds one
// iteration of a strip: the byte model above times the strip's nodes,
// halo rows included ((X_loc + 2H) * Y: the 2H rows are recomputed, a
// 2H / X_loc overhead), plus the halo exchange, 2 * 31 * H * Y * 4 bytes a
// strip (the 31 carry planes, H rows each way): device copies over HBM
// when the strips share a card, or NCCL over NVLink at 450 GB/s each way
// between cards.  At 2048^2 in 4 strips that is 1.0 MB a strip against
// ~0.5 GB of kernel traffic, so the exchange is latency, not bytes.
//
// Jacobi semantics: gfc_kernel reads the carry `cin` at +-1 and writes new
// primitives into the other carry buffer `cout`; pass12_kernel reads the
// scratch at +-1 and writes S and beta into `cout`.  The caller swaps the
// buffers after each iteration.
//
// Operation order follows core/step.py and core/physics.py expression by
// expression.  nvcc contracts a*b+c into FMAs (no --use_fast_math: division
// and sqrt stay IEEE), so results differ from the plain torch version at
// the ulp level; chip_smoke.py states the tolerances.
#include <cuda_runtime.h>

#include <cstdint>

#include "hf2d_ctx_bits.cuh"

using namespace hf2d;

// Float constant written the way the reference code writes it: a Python
// float (double) rounded to the working type.
#define F(x) (static_cast<float>(x))

// Host-side scalars of the case, passed by value (ops/fused_step.py
// KernelConsts mirrors this layout).
struct Consts {
    float dx, dy;          // float(dx), float(dy)
    float dxx, dyy;        // float(dy/(dx+dy)), float(dx/(dx+dy))
    float min_dxdy;        // float(min(dx, dy))
    float cfl, beta0, sig_w, sig_f;
    float k0, k0_div, tf;  // K0, max(K0, 1e-30), ignition temperature
    float c_mu075;         // 0.09 ** 0.75
    float hu[4];           // heats of formation (fuel, ox, cp, air)
    int X, Y, nby;         // grid extent, tiles along j
    int has_walls, fast_math, bff, alt_rms, serial_rms, zeldovich;
    int heat;              // the heat stage runs: gfc writes lam_eff,
                           // pass12 adds SrcAdd of rhoE
    int x0, x1;            // window: only rows x0 <= i < x1 count in the
                           // per-tile partials (a strip's own rows)
};

// kernel bodies (ops/fused_step.py _BODY_CODE)
constexpr int BODY_GENERAL = 0;
constexpr int BODY_SPEC = 1;
constexpr int BODY_DUAL = 2;

__device__ __forceinline__ bool ctx_bit(const uint32_t* w, int b) {
    return (w[b >> 5] >> (b & 31)) & 1u;
}

// A mask: the constant of the specialized interior ctx, or the node's bit.
#define MASK(name, spec_value) \
    (SPEC ? (spec_value) : ctx_bit(w, CTX_##name))
#define MASK_EQ(name, e, spec_value) \
    (SPEC ? (spec_value) : ctx_bit(w, CTX_##name + (e)))

// Neighbor indices with the reference's wall collapse: an absent neighbor
// reads the node itself (core/step.neighbors over edge-replicated shifts).
struct Stencil {
    size_t n, nL, nR, nU, nD;
    float n1, n2, n3, n4, rn_n, rm_m;
};

template <bool SPEC>
__device__ __forceinline__ Stencil make_stencil(
        const Consts& c, const uint32_t* w, const int8_t* __restrict__ idn,
        size_t P, int i, int j) {
    Stencil st;
    st.n = static_cast<size_t>(i) * c.Y + j;
    const bool bXl = MASK(BXL, true), bXr = MASK(BXR, true);
    const bool bYu = MASK(BYU, true), bYd = MASK(BYD, true);
    st.nL = (bXl && i > 0) ? st.n - c.Y : st.n;
    st.nR = (bXr && i < c.X - 1) ? st.n + c.Y : st.n;
    st.nU = (bYu && j < c.Y - 1) ? st.n + 1 : st.n;
    st.nD = (bYd && j > 0) ? st.n - 1 : st.n;
    if (SPEC) {
        st.n1 = st.n2 = st.n3 = st.n4 = 1.f;
        st.rn_n = st.rm_m = 0.5f;
    } else {
        st.n1 = idn[st.n];
        st.n2 = idn[P + st.n];
        st.n3 = idn[2 * P + st.n];
        st.n4 = idn[3 * P + st.n];
        st.rn_n = 1.f / fmaxf(st.n1 + st.n2, 1.f);
        st.rm_m = 1.f / fmaxf(st.n3 + st.n4, 1.f);
    }
    return st;
}

template <bool SPEC>
__device__ __forceinline__ void load_ctx(uint32_t* w,
                                         const int32_t* __restrict__ ctxw,
                                         size_t P, size_t n) {
#pragma unroll
    for (int k = 0; k < CTX_N_WORDS; ++k)
        w[k] = SPEC ? 0u : static_cast<uint32_t>(ctxw[k * P + n]);
}

// Table::GetVal (config/tables.table_lookup): telescoped slope form for
// strictly ascending knots, else the first-bracket segment with the
// reference's boundary checks.  Knots of table t: xs at chemf[off],
// ys right after; chemi[3t..3t+2] = (off, n, ascending).
__device__ float table_lookup(const float* __restrict__ chemf,
                              const int32_t* __restrict__ chemi, int t,
                              float q) {
    const int off = chemi[3 * t], n = chemi[3 * t + 1];
    const bool asc = chemi[3 * t + 2] != 0;
    const float* xs = chemf + off;
    const float* ys = xs + n;
    if (n == 1) return ys[0];
    if (asc) {
        float m_prev = (ys[1] - ys[0]) / (xs[1] - xs[0]);
        float out = ys[0] + m_prev * (q - xs[0]);
        for (int s = 2; s < n; ++s) {
            const float m = (ys[s] - ys[s - 1]) / (xs[s] - xs[s - 1]);
            out = out + (m - m_prev) * fmaxf(q - xs[s - 1], 0.f);
            m_prev = m;
        }
        return out;
    }
    int sel = n - 1;
    if (q <= xs[0]) {
        sel = 1;
    } else if (!(q >= xs[n - 1])) {
        for (int s = 1; s < n; ++s) {
            if (q >= xs[s - 1] && q < xs[s]) {
                sel = s;
                break;
            }
        }
    }
    return ys[sel] + (ys[sel - 1] - ys[sel]) * (q - xs[sel])
                     / (xs[sel - 1] - xs[sel]);
}

// Mixture property: sum over species of table(prop, species)(Tg) * Y.
__device__ __forceinline__ float mixture(const float* __restrict__ chemf,
                                         const int32_t* __restrict__ chemi,
                                         int prop, float Tg, float Yfu,
                                         float Yox, float Ycp, float Yair) {
    return table_lookup(chemf, chemi, 4 * prop + 0, Tg) * Yfu
           + table_lookup(chemf, chemi, 4 * prop + 1, Tg) * Yox
           + table_lookup(chemf, chemi, 4 * prop + 2, Tg) * Ycp
           + table_lookup(chemf, chemi, 4 * prop + 3, Tg) * Yair;
}

// ---------------------------------------------------------------------------
// gfc: core/step.gfc for one node (gradients, fill_node with standard
// k-eps, the per-node dt limit, chemistry).  Returns the Tg<0 and
// frozen-dt-overrun flags of the node.
// ---------------------------------------------------------------------------
template <bool SPEC>
__device__ __forceinline__ void gfc_node(
        const Consts& c, const float* __restrict__ cin,
        float* __restrict__ cout, float* __restrict__ scr,
        const int8_t* __restrict__ idn, const float* __restrict__ mf,
        const int32_t* __restrict__ ctxw, const float* __restrict__ chemf,
        const int32_t* __restrict__ chemi, float dt, float cfl_scen,
        bool mu_t_iter, int i, int j, bool& uns, bool& ovr) {
    const size_t P = static_cast<size_t>(c.X) * c.Y;
    uint32_t w[CTX_N_WORDS];
    load_ctx<SPEC>(w, ctxw, P, static_cast<size_t>(i) * c.Y + j);
    const Stencil st = make_stencil<SPEC>(c, w, idn, P, i, j);
    const size_t n = st.n;
    auto ld = [&](int plane, size_t idx) { return cin[plane * P + idx]; };

    const bool active = MASK(ACTIVE, true);
    const bool solid = MASK(SOLID, false);
    const bool fc = MASK(FC, false);
    const bool wall = MASK(WALL, false);
    const bool wall_law = MASK(WALL_LAW, false);
    const bool wall_ns = MASK(WALL_NS, false);
    const bool u_const = MASK(U_CONST, false);
    const bool v_const = MASK(V_CONST, false);
    const bool m_keps = MASK(M_KEPS, true);
    const bool kconst = MASK(KCONST, false);
    const bool econst = MASK(ECONST, false);
    const bool ewall = MASK(EWALL, false);
    const bool km = MASK(KM, true);
    const bool em = MASK(EM, true);
    const bool g_dydx = MASK(G_DYDX, true);
    const bool g_dydy = MASK(G_DYDY, true);
    const bool dydx_ok = MASK(DYDX_OK, true);
    const bool dydy_ok = MASK(DYDY_OK, true);
    const bool react = MASK(REACT, true);

    const float dx1nn = st.rn_n / c.dx;
    const float dy1mm = st.rm_m / c.dy;
    auto grad_x = [&](float qr, float ql) {
        return wall ? (qr * st.n1 - ql * st.n2) * dx1nn : (qr - ql) * dx1nn;
    };
    auto grad_y = [&](float qu, float qd) {
        return wall ? (qu * st.n3 - qd * st.n4) * dy1mm : (qu - qd) * dy1mm;
    };

    // ---------------- gradients (deeps2d_core.cpp:1169-1237) --------------
    const float rho_c = ld(CARRY_S, n);
    const float rho_cs = rho_c != 0.f ? rho_c : 1.f;
    const float r_rho_c = 1.f / rho_cs;
    auto div_rho_c = [&](float a) {
        return c.fast_math ? a * r_rho_c : a / rho_cs;
    };
    float dro_x[4], dro_y[4];
    float air_R = ld(CARRY_S, st.nR), air_L = ld(CARRY_S, st.nL);
    float air_U = ld(CARRY_S, st.nU), air_D = ld(CARRY_S, st.nD);
#pragma unroll
    for (int k = 4; k < 7; ++k) {
        const float sR = ld(CARRY_S + k, st.nR), sL = ld(CARRY_S + k, st.nL);
        const float sU = ld(CARRY_S + k, st.nU), sD = ld(CARRY_S + k, st.nD);
        dro_x[k - 4] = g_dydx ? (sR - sL) * dx1nn : 0.f;
        dro_y[k - 4] = g_dydy ? (sU - sD) * dy1mm : 0.f;
        air_R = air_R - (dydx_ok ? sR : 0.f);
        air_L = air_L - (dydx_ok ? sL : 0.f);
        air_U = air_U - (dydy_ok ? sU : 0.f);
        air_D = air_D - (dydy_ok ? sD : 0.f);
    }
    dro_x[3] = g_dydx ? (air_R - air_L) * dx1nn : 0.f;
    dro_y[3] = g_dydy ? (air_U - air_D) * dy1mm : 0.f;

    const float dUdx = active ? grad_x(ld(CARRY_U, st.nR), ld(CARRY_U, st.nL))
                              : 0.f;
    const float dVdx = active ? grad_x(ld(CARRY_V, st.nR), ld(CARRY_V, st.nL))
                              : 0.f;
    const float dUdy = active ? grad_y(ld(CARRY_U, st.nU), ld(CARRY_U, st.nD))
                              : 0.f;
    const float dVdy = active ? grad_y(ld(CARRY_V, st.nU), ld(CARRY_V, st.nD))
                              : 0.f;
    const float dkdx = km ? div_rho_c(grad_x(ld(CARRY_S + 7, st.nR),
                                             ld(CARRY_S + 7, st.nL)))
                          : 0.f;
    const float dkdy = km ? div_rho_c(grad_y(ld(CARRY_S + 7, st.nU),
                                             ld(CARRY_S + 7, st.nD)))
                          : 0.f;
    const float depsdx = em ? div_rho_c(grad_x(ld(CARRY_S + 8, st.nR),
                                               ld(CARRY_S + 8, st.nL)))
                            : 0.f;
    const float depsdy = em ? div_rho_c(grad_y(ld(CARRY_S + 8, st.nU),
                                               ld(CARRY_S + 8, st.nD)))
                            : 0.f;
    const float dTdx = active
        ? (ld(CARRY_TG, st.nR) - ld(CARRY_TG, st.nL)) * dx1nn : 0.f;
    const float dTdy = active
        ? (ld(CARRY_TG, st.nU) - ld(CARRY_TG, st.nD)) * dy1mm : 0.f;

    // ---------------- FillNode2D (hyper_flow_node.hpp:374-600) ------------
    float s[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) s[e] = ld(CARRY_S + e, n);
    const float rho = s[0];
    const float CP = ld(CARRY_CP, n), R = ld(CARRY_R, n);
    const float cpr = CP - R;
    const float k_cpcv = cpr != 0.f ? CP / cpr : 2.f;
    const bool guard = !solid && rho != 0.f && k_cpcv >= 1.f;
    const float rho_s = rho != 0.f ? rho : 1.f;
    const float r_rho = 1.f / rho_s;
    auto div_rho = [&](float a) { return c.fast_math ? a * r_rho : a / rho_s; };

    const float U0 = ld(CARRY_U, n), V0 = ld(CARRY_V, n);
    float U = u_const ? U0 : div_rho(s[1]);
    float V = v_const ? V0 : div_rho(s[2]);
    if (u_const) s[1] = U * rho;
    if (v_const) s[2] = V * rho;
    const float mu = ld(CARRY_MU, n), lam = ld(CARRY_LAM, n);
    const float mu_t0 = ld(CARRY_MU_T, n);
    float mu_t = mu_t0;
    const bool is_mu_t = fc || mu_t_iter;

    // standard k-eps (hpp:640-820): f1 = f2 = f_mu = 1, no low-Re terms
    const float grad_mag = fmaxf(fabsf(dUdy), fabsf(dVdx));
    float Sk = s[7], Se = s[8];
    const float tmp1 = dUdy + dVdx;
    const float tmp3 = dUdx * dUdx + dVdy * dVdy;
    const float l_base = fmaxf(mf[META_LMIN * P + n], c.min_dxdy) * F(0.41);
    const float l_s = l_base != 0.f ? l_base : 1.f;
    float mu_t_ke = mu_t == 0.f ? rho * l_base * l_base * grad_mag : mu_t;
    const float G = mu_t_ke * (tmp1 * tmp1 + F(2.0) * tmp3);
    const float w_mag = sqrtf(U * U + V * V + F(1.e-30));
    const float tmpI = F(0.005) * w_mag;
    const float k_init = F(1.5) * tmpI * tmpI * rho;
    if (m_keps && kconst) Sk = k_init;
    if (m_keps && (econst || ewall))
        Se = c.c_mu075 * powf(fmaxf(Sk / rho_s, 0.f), F(1.5)) / l_s;
    const float nu_t = fabsf(F(0.09) * (Se != 0.f ? Sk * Sk / Se : 0.f));
    if (is_mu_t && Se != 0.f) mu_t_ke = fminf(nu_t, mu_t_ke);
    const float mt_sk = mu_t_ke;  // mu_t_ke / sig_k with sig_k = 1
    const float mt_se = c.fast_math ? mu_t_ke * F(1.0 / 1.3)
                                    : mu_t_ke / F(1.3);
    float a7 = 0.f, a8 = 0.f, b7 = 0.f, b8 = 0.f, src7 = 0.f, src8 = 0.f;
    if (m_keps) {
        a7 = Sk * U - (mu + mt_sk) * dkdx;
        a8 = Se * U - (mu + mt_se) * depsdx;
        b7 = Sk * V - (mu + mt_sk) * dkdy;
        b8 = Se * V - (mu + mt_se) * depsdy;
        if (Sk != 0.f && !kconst) src7 = (G - Se) + F(0.0) * rho;
        if (Sk != 0.f && !econst)
            src8 = (F(1.44) * (Se / Sk) * G - F(1.92) * (Se * Se / Sk))
                   + F(0.0) * rho;
        s[7] = Sk;
        s[8] = Se;
        mu_t = mu_t_ke;
    }

    // formation enthalpy sum (hpp:438-445)
    float h_form = 0.f, rho_air = rho;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        h_form = h_form + c.hu[k] * s[4 + k];
        rho_air = rho_air - s[4 + k];
    }
    h_form = h_form + c.hu[3] * rho_air;

    // wall handling (hpp:447-488)
    if (c.has_walls) {
        if (wall_law) {
            const float wm = sqrtf(U * U + V * V + F(1.e-30));
            s[1] = wm * mf[META_BGX * P + n];
            s[2] = wm * mf[META_BGY * P + n];
            U = div_rho(s[1]);
            V = div_rho(s[2]);
        }
        if (wall_ns) {
            U = mf[META_UW * P + n];
            V = mf[META_VW * P + n];
            s[1] = U * rho;
            s[2] = V * rho;
        }
    }

    // EOS (hpp:490-492)
    const float p_new = (k_cpcv - F(1.0))
                        * (s[3] - rho * (U * U + V * V) * F(0.5) - h_form);
    const float RR = R * rho_s;
    const float Tg_new = RR != 0.f ? p_new / RR : 0.f;

    // effective transport and viscous/convective fluxes (hpp:494-598)
    // rounded on its own (no contraction): lam_eff below is lam + lam_t
    const float lam_t = __fmul_rn(mu_t, CP);
    const float sig = wall ? c.sig_w : c.sig_f;
    const float mu_eff = is_mu_t ? fmaxf(0.f, mu + mu_t * sig) : mu;
    const float lam_eff = is_mu_t ? fmaxf(0.f, lam + lam_t * sig) : lam;
    const float diff = lam_eff / CP;
    const float dila = F(2.0 / 3.0) * mu_eff * (dUdx + dVdy);
    const float sxx = F(2.0) * mu_eff * dUdx - dila;
    const float syy = F(2.0) * mu_eff * dVdy - dila;
    const float txy = mu_eff * (dUdy + dVdx);
    float qx = lam_eff * dTdx, qy = lam_eff * dTdy;
    const float cpt = CP * Tg_new;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        qx = qx + diff * (cpt + c.hu[k]) * dro_x[k];
        qy = qy + diff * (cpt + c.hu[k]) * dro_y[k];
    }
    const float RX3 = U * sxx + V * txy + qx;
    const float RY3 = U * txy + V * syy + qy;

    float an[9], bn[9];
    an[0] = s[1];
    an[1] = (p_new + s[1] * U) - sxx;
    an[2] = s[2] * U - txy;
    an[3] = (s[3] + p_new) * U - RX3;
    bn[0] = s[2];
    bn[1] = s[2] * U - txy;
    bn[2] = (p_new + s[2] * V) - syy;
    bn[3] = (s[3] + p_new) * V - RY3;
#pragma unroll
    for (int k = 4; k < 7; ++k) {
        an[k] = s[k] * U - diff * dro_x[k - 4];
        bn[k] = s[k] * V - diff * dro_y[k - 4];
    }
    an[7] = a7;
    an[8] = a8;
    bn[7] = b7;
    bn[8] = b8;

    // outputs through the guard (failing nodes keep the expanded zeros /
    // the carried values)
#pragma unroll
    for (int e = 0; e < 9; ++e) {
        scr[(SCR_A + e) * P + n] = guard ? an[e] : 0.f;
        scr[(SCR_B + e) * P + n] = guard ? bn[e] : 0.f;
        if (!guard) s[e] = ld(CARRY_S + e, n);
    }
    scr[SCR_SRC_K * P + n] = guard ? src7 : 0.f;
    scr[SCR_SRC_EPS * P + n] = guard ? src8 : 0.f;
    const float U_f = guard ? U : U0;
    const float V_f = guard ? V : V0;
    const float p_f = guard ? p_new : ld(CARRY_P, n);
    const float Tg_f = guard ? Tg_new : ld(CARRY_TG, n);

    // ---------------- instability and the local dt (1246-1327) ------------
    uns = active && Tg_f < 0.f;
    const float cfl_min = fminf(c.cfl, cfl_scen);
    const float aaa = sqrtf(fmaxf(k_cpcv * R * Tg_f, 0.f));
    const float dt_nodes = cfl_min * fminf(c.dx / (aaa + fabsf(U_f)),
                                           c.dy / (aaa + fabsf(V_f)));
    ovr = dt > (active ? dt_nodes : 1.f);

    // ---------------- chemistry (deeps2d_core.cpp:4697-4780) --------------
    const float rho2 = s[0];
    const float rho2_s = rho2 != 0.f ? rho2 : 1.f;
    const float r_rho2 = 1.f / rho2_s;
    float Yfu = c.fast_math ? s[4] * r_rho2 : s[4] / rho2_s;
    float Yox = c.fast_math ? s[5] * r_rho2 : s[5] / rho2_s;
    float Ycp = c.fast_math ? s[6] * r_rho2 : s[6] / rho2_s;
    float Yair = F(1.0) - (Yfu + Yox + Ycp);
    if (c.zeldovich) {
        const float ssum = Yfu + Yox + Ycp + Yair;
        const float Y0 = ssum != 0.f ? F(1.0) / ssum : F(1.0);
        const float Yfu_n = Yfu * Y0, Yox_n = Yox * Y0, Ycp_n = Ycp * Y0;
        const bool burn = react && Tg_f > c.tf;
        const bool lean = Yox_n > Yfu_n * c.k0;
        const float Yox_b = lean ? Yox_n - Yfu_n * c.k0 : 0.f;
        const float Yfu_b = lean ? 0.f : Yfu_n - Yox_n / c.k0_div;
        const float Ycp_b = lean ? F(1.0) - Yox_b - Yair
                                 : F(1.0) - Yfu_b - Yair;
        Yfu = burn ? Yfu_b : (react ? Yfu_n : Yfu);
        Yox = burn ? Yox_b : (react ? Yox_n : Yox);
        Ycp = burn ? Ycp_b : (react ? Ycp_n : Ycp);
    }
    // mixture properties at Tg (pre-clip mass fractions)
    const float R_new = chemf[0] * Yfu + chemf[1] * Yox + chemf[2] * Ycp
                        + chemf[3] * Yair;
    const float CP_new = mixture(chemf, chemi, 0, Tg_f, Yfu, Yox, Ycp, Yair);
    const float lam_new = mixture(chemf, chemi, 1, Tg_f, Yfu, Yox, Ycp, Yair);
    const float mu_new = mixture(chemf, chemi, 2, Tg_f, Yfu, Yox, Ycp, Yair);
    Yair = Yair < F(1.e-5) ? 0.f : Yair;
    Ycp = Ycp < F(1.e-8) ? 0.f : Ycp;
    Yox = Yox < F(1.e-8) ? 0.f : Yox;
    Yfu = Yfu < F(1.e-8) ? 0.f : Yfu;
    const float ssum2 = Yfu + Yox + Ycp + Yair;
    const float Y02 = ssum2 != 0.f ? F(1.0) / ssum2 : F(1.0);
    Yfu = Yfu * Y02;
    Yox = Yox * Y02;
    Ycp = Ycp * Y02;
    Yair = Yair * Y02;
    if (react) {
        s[4] = fabsf(Yfu * rho2);
        s[5] = fabsf(Yox * rho2);
        s[6] = fabsf(Ycp * rho2);
    }

    // ---------------- stores ----------------------------------------------
#pragma unroll
    for (int e = 0; e < 9; ++e) scr[(SCR_S + e) * P + n] = s[e];
    cout[CARRY_U * P + n] = U_f;
    cout[CARRY_V * P + n] = V_f;
    cout[CARRY_P * P + n] = p_f;
    cout[CARRY_TG * P + n] = Tg_f;
    const float Yc[4] = {Yfu, Yox, Ycp, Yair};
#pragma unroll
    for (int k = 0; k < 4; ++k)
        cout[(CARRY_YC + k) * P + n] = active ? Yc[k] : ld(CARRY_YC + k, n);
    cout[CARRY_R * P + n] = active ? R_new : R;
    cout[CARRY_CP * P + n] = active ? CP_new : CP;
    cout[CARRY_LAM * P + n] = active ? lam_new : lam;
    cout[CARRY_MU * P + n] = active ? mu_new : mu;
    cout[CARRY_MU_T * P + n] = guard ? mu_t : mu_t0;
    // what the heat stage reads: lam after chemistry + lam_t (with the CP
    // before chemistry, physics.py fill_node), as core/step.gfc leaves them
    if (!SPEC && c.heat)
        scr[SCR_LAM_EFF * P + n] =
            __fadd_rn(active ? lam_new : lam,
                      guard ? lam_t : __fmul_rn(mu_t0, CP));
}

// ---------------------------------------------------------------------------
// pass12: core/step.pass12 for one node.  Accumulates the gated RMS
// numerator/denominator and DD max per equation into acc[0..26].
// ---------------------------------------------------------------------------
template <bool SPEC>
__device__ __forceinline__ void pass12_node(
        const Consts& c, const float* __restrict__ cin,
        float* __restrict__ cout, const float* __restrict__ scr,
        const int8_t* __restrict__ idn, const int32_t* __restrict__ ctxw,
        float dt, float beta_scen, int i, int j, bool own, float* acc) {
    const size_t P = static_cast<size_t>(c.X) * c.Y;
    uint32_t w[CTX_N_WORDS];
    load_ctx<SPEC>(w, ctxw, P, static_cast<size_t>(i) * c.Y + j);
    const Stencil st = make_stencil<SPEC>(c, w, idn, P, i, j);
    const size_t n = st.n;
    const float dtdx = dt / c.dx;
    const float dtdy = dt / c.dy;
    const float bm = fminf(c.beta0, beta_scen);
#pragma unroll
    for (int e = 0; e < 9; ++e) {
        const float* Se = scr + (SCR_S + e) * P;
        const float* Ae = scr + (SCR_A + e) * P;
        const float* Be = scr + (SCR_B + e) * P;
        const bool evolve = MASK_EQ(EVOLVE, e, true);
        const bool efx = MASK_EQ(EV_FLUX_X, e, true);
        const bool eax = MASK_EQ(EV_AVG_X, e, false);
        const bool efy = MASK_EQ(EV_FLUX_Y, e, true);
        const bool eay = MASK_EQ(EV_AVG_Y, e, false);
        const bool ddmask = MASK_EQ(DDMASK, e, true);
        const float S = Se[n], SL = Se[st.nL], SR = Se[st.nR];
        const float SU = Se[st.nU], SD = Se[st.nD];
        const float dSdx = efx ? (Ae[st.nR] - Ae[st.nL]) * st.rn_n : 0.f;
        const float dSdy = efy ? (Be[st.nU] - Be[st.nD]) * st.rm_m : 0.f;
        float S_eff = eax ? (SL * st.n2 + SR * st.n1) * st.rn_n : S;
        S_eff = eay ? (SU * st.n3 + SD * st.n4) * st.rm_m : S_eff;
        const float blend = (c.dxx * (SL + SR) + c.dyy * (SU + SD)) * F(0.5);
        const float beta = cin[(CARRY_BETA + e) * P + n];
        const float src = e == 7 ? scr[SCR_SRC_K * P + n]
                        : e == 8 ? scr[SCR_SRC_EPS * P + n] : 0.f;
        float next = S_eff * beta + (F(1.0) - beta) * blend
                     - (dtdx * dSdx + dtdy * dSdy) + src * dt;
        if (!SPEC && c.heat && e == 3)
            next = next + scr[SCR_SRCADD_E * P + n];   // + SrcAdd
        if (!evolve) next = S_eff;

        // pass 2: residual and blending factor (1062-1121)
        const float abs_dd = next - S_eff;
        const bool big = fabsf(S_eff) > F(1.e-15);
        const float dd = big ? fabsf(abs_dd / S_eff) : F(1.0);
        const float sqrt_res = big ? sqrtf(dd) : 0.f;
        float nb;
        switch (c.bff) {
            case 0: nb = fminf(bm, bm * bm / (bm + dd)); break;
            case 1: nb = fminf((bm + beta) * F(0.5), bm * bm / (bm + dd));
                    break;
            case 2: nb = fminf(bm, bm * bm / (bm + dd * dd)); break;
            case 3: nb = fminf((bm + beta) * F(0.5), bm * bm / (bm + dd * dd));
                    break;
            case 4: nb = fminf(bm, bm * bm / (bm + sqrt_res)); break;
            case 5: nb = fminf((bm + beta) * F(0.5),
                               bm * bm / (bm + sqrt_res));
                    break;
            default: nb = beta;
        }
        const bool gate = ddmask && S_eff != 0.f;
        cout[(CARRY_S + e) * P + n] = next;
        cout[(CARRY_BETA + e) * P + n] = gate ? nb : beta;
        if (gate && own) {
            acc[e] = c.alt_rms ? (c.serial_rms ? abs_dd : abs_dd * abs_dd)
                               : dd * dd;
            acc[9 + e] = c.alt_rms ? S_eff * S_eff : 1.f;
            acc[18 + e] = dd;
        }
    }
}

// ---------------------------------------------------------------------------
// heat: core/physics.calc_heat_on_wall_sources for one node.  Solid node s
// folds the fluxes of its wall gas neighbors in the reference's visit
// order [(I-1,J), (I,J-1), (I,J+1), (I+1,J)], averaging when it is hit
// again (q > 0); `upto` stops the fold after that visit (q_after[upto]).
// Neighbors are clamped to the grid, as the edge-replicated shifts are.
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool heat_bit(uint32_t w, int b) {
    return (w >> (b - 32 * CTX_HEAT_WORD)) & 1u;
}

__device__ __forceinline__ uint32_t heat_word(const int32_t* __restrict__ ctxw,
                                              size_t P, size_t n) {
    return static_cast<uint32_t>(ctxw[CTX_HEAT_WORD * P + n]);
}

__device__ __forceinline__ float heat_q(const Consts& c,
                                        const float* __restrict__ cout,
                                        const float* __restrict__ scr,
                                        const int32_t* __restrict__ ctxw,
                                        size_t P, int i, int j, int upto) {
    const size_t s = static_cast<size_t>(i) * c.Y + j;
    const uint32_t w = heat_word(ctxw, P, s);
    const float Ts = cout[CARRY_TG * P + s];
    const int vi[4] = {max(i - 1, 0), i, i, min(i + 1, c.X - 1)};
    const int vj[4] = {j, max(j - 1, 0), min(j + 1, c.Y - 1), j};
    const float vd[4] = {c.dx, c.dy, c.dy, c.dx};
    const int vbit[4] = {CTX_HV_XL, CTX_HV_YD, CTX_HV_YU, CTX_HV_XR};
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (k > upto) break;
        if (!heat_bit(w, vbit[k])) continue;
        const size_t g = static_cast<size_t>(vi[k]) * c.Y + vj[k];
        const float cq = (-scr[SCR_LAM_EFF * P + g]
                          * (Ts - cout[CARRY_TG * P + g])) / vd[k];
        q = q > 0.f ? (q + cq) * F(0.5) : cq;
    }
    return q;
}

__global__ void __launch_bounds__(TILE_X * TILE_Y)
heat_kernel(const Consts c, const float* __restrict__ cout,
            float* __restrict__ scr, const int32_t* __restrict__ ctxw,
            const float* __restrict__ dtp,
            const int32_t* __restrict__ tiles) {
    const int tile = tiles[blockIdx.x];
    const int i = (tile / c.nby) * TILE_X + threadIdx.y;
    const int j = (tile % c.nby) * TILE_Y + threadIdx.x;
    if (i >= c.X || j >= c.Y) return;
    const size_t P = static_cast<size_t>(c.X) * c.Y;
    const size_t n = static_cast<size_t>(i) * c.Y + j;
    const uint32_t w = heat_word(ctxw, P, n);
    // directions D, U, L, R, the last solid one wins; each reads the
    // solid's q right after this gas node's own visit of it
    const float ndt = -*dtp;
    float src;
    if (heat_bit(w, CTX_HW_RIGHT))
        src = ndt * heat_q(c, cout, scr, ctxw, P, min(i + 1, c.X - 1), j, 0)
              / c.dx;
    else if (heat_bit(w, CTX_HW_LEFT))
        src = ndt * heat_q(c, cout, scr, ctxw, P, max(i - 1, 0), j, 3) / c.dx;
    else if (heat_bit(w, CTX_HW_UP))
        src = ndt * heat_q(c, cout, scr, ctxw, P, i, min(j + 1, c.Y - 1), 1)
              / c.dy;
    else if (heat_bit(w, CTX_HW_DOWN))
        src = ndt * heat_q(c, cout, scr, ctxw, P, i, max(j - 1, 0), 2) / c.dy;
    else
        return;   // the plane keeps the chunk's zero
    scr[SCR_SRCADD_E * P + n] = src;
}

// The dual body runs every tile (CTA b on tile b) and reads its tile's flag
// once per CTA (uniform branch); the other bodies run their tile list.
template <int BODY>
__device__ __forceinline__ int cta_tile(const int32_t* __restrict__ tiles) {
    return BODY == BODY_DUAL ? static_cast<int>(blockIdx.x)
                             : tiles[blockIdx.x];
}

template <int BODY>
__device__ __forceinline__ bool spec_tile(const int32_t* __restrict__ flags,
                                          int tile) {
    return BODY == BODY_DUAL ? flags[tile] != 0 : BODY == BODY_SPEC;
}

template <int BODY>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
gfc_kernel(const Consts c, const float* __restrict__ cin,
           float* __restrict__ cout, float* __restrict__ scr,
           const int8_t* __restrict__ idn, const float* __restrict__ mf,
           const int32_t* __restrict__ ctxw, const float* __restrict__ chemf,
           const int32_t* __restrict__ chemi, const float* __restrict__ dtp,
           const float* __restrict__ aux, const int32_t* __restrict__ tiles,
           const int32_t* __restrict__ flags, int32_t* __restrict__ part_i) {
    const int tile = cta_tile<BODY>(tiles);
    const int i = (tile / c.nby) * TILE_X + threadIdx.y;
    const int j = (tile % c.nby) * TILE_Y + threadIdx.x;
    bool uns = false, ovr = false;
    if (i < c.X && j < c.Y) {
        if (spec_tile<BODY>(flags, tile))
            gfc_node<true>(c, cin, cout, scr, idn, mf, ctxw, chemf, chemi,
                           *dtp, aux[1], aux[2] > F(0.5), i, j, uns, ovr);
        else
            gfc_node<false>(c, cin, cout, scr, idn, mf, ctxw, chemf, chemi,
                            *dtp, aux[1], aux[2] > F(0.5), i, j, uns, ovr);
    }
    // the node is computed at every row; only the window's rows count
    const bool own = i >= c.x0 && i < c.x1;
    const int n_uns = __syncthreads_count(uns && own);
    const int n_ovr = __syncthreads_count(ovr && own);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        part_i[2 * tile] = n_uns;
        part_i[2 * tile + 1] = n_ovr;
    }
}

template <int BODY>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
pass12_kernel(const Consts c, const float* __restrict__ cin,
              float* __restrict__ cout, const float* __restrict__ scr,
              const int8_t* __restrict__ idn,
              const int32_t* __restrict__ ctxw,
              const float* __restrict__ dtp, const float* __restrict__ aux,
              const int32_t* __restrict__ tiles,
              const int32_t* __restrict__ flags, float* __restrict__ part_f) {
    constexpr int NQ = 27;   // RMS numerator, denominator, DD max x 9
    __shared__ float red[TILE_X][NQ];
    const int tile = cta_tile<BODY>(tiles);
    const int i = (tile / c.nby) * TILE_X + threadIdx.y;
    const int j = (tile % c.nby) * TILE_Y + threadIdx.x;
    float acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
    if (i < c.X && j < c.Y) {
        const bool own = i >= c.x0 && i < c.x1;
        if (spec_tile<BODY>(flags, tile))
            pass12_node<true>(c, cin, cout, scr, idn, ctxw, *dtp, aux[0], i,
                              j, own, acc);
        else
            pass12_node<false>(c, cin, cout, scr, idn, ctxw, *dtp, aux[0], i,
                               j, own, acc);
    }
    // tile partials in a fixed order: lanes of a warp (one row of the
    // tile), then the TILE_X warps in row order
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        float v = acc[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float o = __shfl_down_sync(0xffffffffu, v, off);
            v = q < 18 ? v + o : fmaxf(v, o);
        }
        if (threadIdx.x == 0) red[threadIdx.y][q] = v;
    }
    __syncthreads();
    if (threadIdx.y == 0 && threadIdx.x < NQ) {
        const int q = threadIdx.x;
        float v = red[0][q];
        for (int r = 1; r < TILE_X; ++r)
            v = q < 18 ? v + red[r][q] : fmaxf(v, red[r][q]);
        part_f[NQ * tile + q] = v;
    }
}

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes by ops/build.py).  Each launches one
// instantiation over `n_tiles` tiles of the device tile list `tiles` on
// `stream` and returns cudaGetLastError().  `body` is BODY_*; the dual
// body reads no tile list (`tiles` may be null, `n_tiles` is every tile)
// and reads `flags` (int32 per tile id, 1 = spec), which the others
// ignore.
// ---------------------------------------------------------------------------
extern "C" {

int hf2d_gfc(int body, const void* consts, const void* cin, void* cout,
             void* scr, const void* idn, const void* mf, const void* ctxw,
             const void* chemf, const void* chemi, const void* dt,
             const void* aux, const void* tiles, int n_tiles,
             const void* flags, void* part_i, void* stream) {
    const Consts c = *static_cast<const Consts*>(consts);
    const dim3 block(TILE_Y, TILE_X);
    auto s = static_cast<cudaStream_t>(stream);
#define HF2D_GFC_ARGS                                                        \
    c, static_cast<const float*>(cin), static_cast<float*>(cout),           \
        static_cast<float*>(scr), static_cast<const int8_t*>(idn),          \
        static_cast<const float*>(mf), static_cast<const int32_t*>(ctxw),   \
        static_cast<const float*>(chemf),                                   \
        static_cast<const int32_t*>(chemi), static_cast<const float*>(dt), \
        static_cast<const float*>(aux), static_cast<const int32_t*>(tiles), \
        static_cast<const int32_t*>(flags), static_cast<int32_t*>(part_i)
    if (body == BODY_SPEC)
        gfc_kernel<BODY_SPEC><<<n_tiles, block, 0, s>>>(HF2D_GFC_ARGS);
    else if (body == BODY_DUAL)
        gfc_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(HF2D_GFC_ARGS);
    else
        gfc_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(HF2D_GFC_ARGS);
#undef HF2D_GFC_ARGS
    return static_cast<int>(cudaGetLastError());
}

int hf2d_pass12(int body, const void* consts, const void* cin, void* cout,
                const void* scr, const void* idn, const void* ctxw,
                const void* dt, const void* aux, const void* tiles,
                int n_tiles, const void* flags, void* part_f, void* stream) {
    const Consts c = *static_cast<const Consts*>(consts);
    const dim3 block(TILE_Y, TILE_X);
    auto s = static_cast<cudaStream_t>(stream);
#define HF2D_PASS12_ARGS                                                     \
    c, static_cast<const float*>(cin), static_cast<float*>(cout),           \
        static_cast<const float*>(scr), static_cast<const int8_t*>(idn),    \
        static_cast<const int32_t*>(ctxw), static_cast<const float*>(dt),   \
        static_cast<const float*>(aux), static_cast<const int32_t*>(tiles), \
        static_cast<const int32_t*>(flags), static_cast<float*>(part_f)
    if (body == BODY_SPEC)
        pass12_kernel<BODY_SPEC><<<n_tiles, block, 0, s>>>(HF2D_PASS12_ARGS);
    else if (body == BODY_DUAL)
        pass12_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(HF2D_PASS12_ARGS);
    else
        pass12_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_ARGS);
#undef HF2D_PASS12_ARGS
    return static_cast<int>(cudaGetLastError());
}

int hf2d_heat(const void* consts, const void* cout, void* scr,
              const void* ctxw, const void* dt, const void* tiles,
              int n_tiles, void* stream) {
    const Consts c = *static_cast<const Consts*>(consts);
    const dim3 block(TILE_Y, TILE_X);
    heat_kernel<<<n_tiles, block, 0, static_cast<cudaStream_t>(stream)>>>(
        c, static_cast<const float*>(cout), static_cast<float*>(scr),
        static_cast<const int32_t*>(ctxw), static_cast<const float*>(dt),
        static_cast<const int32_t*>(tiles));
    return static_cast<int>(cudaGetLastError());
}

const char* hf2d_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
