// Device code shared by the fused-iteration kernels of fused_step.cu (the
// flat forms), fused_step_closure.cu (the closures' flat forms),
// fused_step_ext.cu (the extended forms) and fused_step_mw.cu (the
// moving-wall forms): the constants,
// the loaders, the node bodies gfc_node / pass12_node and the tile bodies
// gfc_tile / pass12_tile.  What the kernels compute, replace and are
// bounded by is in fused_step.cu's header.
#pragma once

#include <cuda_pipeline.h>
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
    float c_mu075;         // C_mu ** 0.75 of the k-eps form (0.09, or
                           // 0.0845 for RNG; ClosureConsts::keps_form)
    float hu[4];           // heats of formation (fuel, ox, cp, air)
    int X, Y, nby;         // grid extent, tiles along j
    int has_walls, fast_math, bff, alt_rms, serial_rms, zeldovich;
    int heat;              // the heat stage runs: gfc writes lam_eff,
                           // pass12 adds SrcAdd of rhoE
    int x0, x1;            // window: only rows x0 <= i < x1 count in the
                           // per-tile partials (a strip's own rows)
    int heat_fold;         // with heat: pass12's general body computes its
                           // node's SrcAdd itself (else it reads the plane
                           // heat_kernel wrote; the staged body always does)
    int euler;             // an Euler deck: hf2d_gfc launches
                           // gfc_euler_kernel (pass12 has no Euler form)
};

// The closures' constants: the host passes every entry one struct, Consts
// followed by these fields (ops/fused_step.py KernelConsts); only the
// closures' gfc forms (fused_step_closure.cu) take them, so the other
// kernels keep their Consts, code and registers.
struct ClosureConsts : Consts {
    int closure;           // an NS deck whose closure is not standard
                           // k-eps: hf2d_gfc launches a closures' form
                           // (hf2d_gfc_closure)
    int models;            // MODEL_* bits of the families of p.models (a
                           // lone family picks its own form)
    int prandtl_form;      // the Prandtl family's length (TEM_*: Prandtl,
                           // van Driest, or Escudier/Klebanoff with
                           // delta_bl > 0)
    int keps_form;         // the k-eps variant (TEM_*; else standard)
    float delta_bl;        // float(delta_bl)
    float esc_l;           // float(0.09 * delta_bl): Escudier's length cap
    float smag_cs2;        // float((0.1 * sqrt(dx * dy)) ** 2)
};
static_assert(sizeof(ClosureConsts) == sizeof(Consts) + 7 * 4,
              "ClosureConsts is Consts and its fields, unpadded");

// The extended forms' constants (fused_step_ext.cu), after the closures'
// in the one struct the host passes; only the *_ext_kernel kernels take
// them.
struct ExtConsts : ClosureConsts {
    int axi;               // axisymmetric flow: gfc writes F (SCR_F..),
                           // pass12 adds F / (j + 1)
    int src;               // external sources: the source field is read
    int d2x, d2y;          // d2*-NULL soft BCs in x, in y (pass12's general
                           // and dual bodies)
    int nrbc;              // non-reflected BCs: beta_min = nrbc_beta0 on
                           // CT_NONREFLECTED nodes (the same bodies)
    float nrbc_beta0;      // float(nrbc_beta0)
    int wall_src;          // moving-wall sources (isSrcAdd): the entries
                           // launch the moving-wall forms (XF_MW, and
                           // pass12's XF_MW_FLAT where mw_flat;
                           // fused_step_mw.cu)
};
static_assert(sizeof(ExtConsts) == sizeof(ClosureConsts) + 7 * 4,
              "ExtConsts is ClosureConsts and its fields, unpadded");

// What the extended forms read besides their stage's planes: the external
// source field (9 planes of the grid), and for d2 the scratch, ctx words
// and neighbour flags of the node's neighbours; the node (i, j); gfc's
// chemistry-table coefficients, staged in shared memory (chem_coef).  The
// flat forms read none of it, but the closures' forms the coefficients.
struct ExtIn {
    const float* __restrict__ src;
    const float* __restrict__ scr;
    const int32_t* __restrict__ ctxw;
    const int8_t* __restrict__ idn;
    int i, j;
    const float* coef = nullptr;
};

// The feature forms of the node code, fixed at compile time: the flat
// forms (none), the axisymmetric-only form (axisymmetry and nothing else:
// no source, d2 or NRBC code; pass12 also takes no collapse of the node's
// own), the all-features form, which tests each of c.axi, c.src, c.d2x,
// c.d2y and c.nrbc at run time, and the two moving-wall forms (isSrcAdd;
// gfc writes their six planes SCR_MW.. at no-slip wall nodes, pass12 adds
// them there), which only a deck with c.wall_src launches: the
// all-features form with the moving-wall sources (XF_MW), and pass12's
// flat form with them (XF_MW_FLAT: the flat node code, no axisymmetric,
// source, d2 or NRBC code, for a deck whose one extended feature is
// c.wall_src, mw_flat).
constexpr int XF_FLAT = 0;
constexpr int XF_AXI = 1;
constexpr int XF_ALL = 2;
constexpr int XF_MW = 3;
constexpr int XF_MW_FLAT = 4;

// The feature forms that carry the axisymmetric code (y_r, the V / r and
// U / r terms, F), the run-time feature tests of the all-features form,
// and the moving-wall sources.
template <int XF>
__host__ __device__ constexpr bool has_axi_code() {
    return XF == XF_AXI || XF == XF_ALL || XF == XF_MW;
}
template <int XF>
__host__ __device__ constexpr bool has_all_features() {
    return XF == XF_ALL || XF == XF_MW;
}
template <int XF>
__host__ __device__ constexpr bool has_mw() {
    return XF == XF_MW || XF == XF_MW_FLAT;
}

// A moving-wall deck whose one extended feature is the moving-wall
// sources: its pass12 general and dual launches run the XF_MW_FLAT form
// (gfc and the spec launches keep the XF_MW and the all-features forms);
// ops/fused_step.py mw_flat mirrors it.
template <class C>
__host__ __device__ inline bool mw_flat(const C& c) {
    return c.wall_src && !c.axi && !c.src && !c.d2x && !c.d2y && !c.nrbc;
}

// c.axi / c.src of a feature form: read in the forms that carry their
// code, false in the others (the flat forms' constants have no such
// fields); c.src is false in the axisymmetric-only form.  gfc's
// axisymmetric-only form still reads c.axi (one uniform predicate): with
// the axisymmetric terms compiled in unconditionally, nvcc contracted the
// dilatation's and the hoop stress's terms otherwise (A[1], A[3], B[2] and
// F[2] moved by up to 2e-6 at a few thousand nodes of the combustor) and
// ran no faster on an H100.
template <int XF, class C>
__device__ __forceinline__ bool ext_axi(const C& c) {
    if constexpr (has_axi_code<XF>()) return c.axi != 0; else return false;
}
template <int XF, class C>
__device__ __forceinline__ bool ext_src(const C& c) {
    if constexpr (has_all_features<XF>()) return c.src != 0;
    else return false;
}

// kernel bodies (ops/fused_step.py _BODY_CODE): GENERAL is the general
// body on direct global loads, STAGED the same body on staged windows,
// STATE gfc's general body over a tile table that also keeps what the
// chunk's epilogue returns (gfc_tile, StateOut)
constexpr int BODY_GENERAL = 0;
constexpr int BODY_SPEC = 1;
constexpr int BODY_DUAL = 2;
constexpr int BODY_STAGED = 3;
constexpr int BODY_STATE = 4;

constexpr int CTA_THREADS = TILE_X * TILE_Y;

__device__ __forceinline__ bool ctx_bit(const uint32_t* w, int b) {
    return (w[b >> 5] >> (b & 31)) & 1u;
}

// A mask: the constant of the specialized interior ctx, or the node's bit.
#define MASK(name, spec_value) \
    (SPEC ? (spec_value) : ctx_bit(w, CTX_##name))
#define MASK_EQ(name, e, spec_value) \
    (SPEC ? (spec_value) : ctx_bit(w, CTX_##name + (e)))

// The neighbours an operand is read at.
enum Nb { NB_C = 0, NB_L, NB_R, NB_U, NB_D };

// The reference's wall collapse: an absent neighbour reads the node itself
// (core/step.neighbors over edge-replicated shifts).  l/r/u/d: the
// neighbour exists.
struct Collapse {
    bool l, r, u, d;
};

template <bool SPEC>
__device__ __forceinline__ Collapse collapse(const Consts& c,
                                             const uint32_t* w, int i,
                                             int j) {
    Collapse k;
    k.l = MASK(BXL, true) && i > 0;
    k.r = MASK(BXR, true) && i < c.X - 1;
    k.u = MASK(BYU, true) && j < c.Y - 1;
    k.d = MASK(BYD, true) && j > 0;
    return k;
}

// The node's neighbour flags (idXl, idXr, idYu, idYd) and the weights of
// the one-sided differences they give.
struct Stencil {
    float n1, n2, n3, n4, rn_n, rm_m;
};

template <bool SPEC>
__device__ __forceinline__ Stencil make_stencil(const int8_t* id4) {
    Stencil st;
    if (SPEC) {
        st.n1 = st.n2 = st.n3 = st.n4 = 1.f;
        st.rn_n = st.rm_m = 0.5f;
    } else {
        st.n1 = id4[0];
        st.n2 = id4[1];
        st.n3 = id4[2];
        st.n4 = id4[3];
        st.rn_n = 1.f / fmaxf(st.n1 + st.n2, 1.f);
        st.rm_m = 1.f / fmaxf(st.n3 + st.n4, 1.f);
    }
    return st;
}

// Loader policies: the node bodies read every operand of a plane stack
// (the carry for gfc, the scratch for pass12) through `at(plane, nb)`, so
// the expressions, and nvcc's FMA contraction of them, are one code for
// every body.
//
// Besides its stencil stack (`at`), a body reads a second stack at the
// node only (`aux`): gfc the meta planes mf, pass12 the carry's beta.
//
// DirectSrc reads global memory at the collapsed neighbour indices (the
// spec, dual and general bodies).
struct DirectSrc {
    const float* __restrict__ base;
    const float* __restrict__ aux_base;
    size_t P, n;
    size_t nb[5];   // by Nb
    __device__ __forceinline__ float at(int plane, int d) const {
        return base[plane * P + nb[d]];
    }
    __device__ __forceinline__ float aux(int plane) const {
        return aux_base[plane * P + n];
    }
};

template <bool SPEC>
__device__ __forceinline__ DirectSrc direct_src(const Consts& c,
                                                const float* base,
                                                const float* aux_base,
                                                const uint32_t* w, size_t P,
                                                int i, int j) {
    const size_t n = static_cast<size_t>(i) * c.Y + j;
    const Collapse k = collapse<SPEC>(c, w, i, j);
    return DirectSrc{base, aux_base, P, n,
                     {n, k.l ? n - c.Y : n, k.r ? n + c.Y : n,
                      k.u ? n + 1 : n, k.d ? n - 1 : n}};
}

template <bool SPEC>
__device__ __forceinline__ void load_ctx(uint32_t* w,
                                         const int32_t* __restrict__ ctxw,
                                         size_t P, size_t n) {
#pragma unroll
    for (int k = 0; k < CTX_N_WORDS; ++k)
        w[k] = SPEC ? 0u : static_cast<uint32_t>(ctxw[k * P + n]);
}

template <bool SPEC>
__device__ __forceinline__ void load_idn(int8_t* id4,
                                         const int8_t* __restrict__ idn,
                                         size_t P, size_t n) {
#pragma unroll
    for (int k = 0; k < 4; ++k) id4[k] = SPEC ? 1 : idn[k * P + n];
}

// ---------------------------------------------------------------------------
// The stencil window of a tile in shared memory (the general body).
//
// For each plane read at +-1 a window of (TILE_X + 2) rows x (TILE_Y + 2)
// columns: the tile and one halo row and column on each side, copied from
// clamped indices (a halo outside the grid, or outside a strip's extended
// buffer, is never selected by the collapse: i > 0, i < X - 1, j > 0,
// j < Y - 1).  A window row is WIN_ROW floats with the tile's first column
// at WIN_J0, so the 32 interior columns start 16-byte aligned; the halo
// columns sit at WIN_J0 - 1 and WIN_J0 + TILE_Y.  After the windows, at
// the tile's own nodes ([plane][row][column]): each plane of the stencil
// stack read at the node only, each plane of the aux stack, the 4 ctx
// words (uint32) and the 4 neighbour flags (int8).  So every operand of
// the tile is in shared memory after one wait.
// ---------------------------------------------------------------------------
constexpr int WIN_X = TILE_X + 2;
constexpr int WIN_ROW = 40;
constexpr int WIN_J0 = 4;
constexpr int WIN_PLANE = WIN_X * WIN_ROW;
static_assert(WIN_J0 + TILE_Y < WIN_ROW && WIN_J0 % 4 == 0
              && WIN_ROW % 4 == 0, "window row layout");
// floats of a stage after its windows: ctx words, then the int8 flags
constexpr int WIN_META = CTX_N_WORDS * CTA_THREADS + CTA_THREADS;

// The planes a body reads, by stage slot.  gfc: the carry planes S0
// (rho), S4..S8 (the species and the turbulence), U, V and Tg at +-1
// (window s holds plane(s)); S1..S3, p, Yc, R, CP, lam, mu and mu_t at the
// node (centre tile k holds cplane(k)); of the meta planes (aux) l_min,
// which every node reads (BGX, BGY, Uw and Vw only wall nodes read, from
// global memory).
struct GfcPlanes {
    static constexpr int N = 9, NC = 13, NA = 1;
    __host__ __device__ static constexpr int plane(int s) {
        return s == 0 ? CARRY_S : s < 6 ? CARRY_S + 3 + s
             : s == 6 ? CARRY_U : s == 7 ? CARRY_V : CARRY_TG;
    }
    __host__ __device__ static constexpr int slot(int p) {
        return p == CARRY_S ? 0
             : (p >= CARRY_S + 4 && p <= CARRY_S + 8) ? p - CARRY_S - 3
             : p == CARRY_U ? 6 : p == CARRY_V ? 7 : p == CARRY_TG ? 8 : -1;
    }
    __host__ __device__ static constexpr int cplane(int k) {
        return k < 3 ? CARRY_S + 1 + k : k == 3 ? CARRY_P
             : k < 8 ? CARRY_YC + k - 4 : CARRY_R + k - 8;
    }
    __host__ __device__ static constexpr int cslot(int p) {
        return (p >= CARRY_S + 1 && p <= CARRY_S + 3) ? p - CARRY_S - 1
             : p == CARRY_P ? 3
             : (p >= CARRY_YC && p <= CARRY_MU_T) ? p - CARRY_YC + 4 : -1;
    }
    __host__ __device__ static constexpr int aplane(int) { return META_LMIN; }
    __host__ __device__ static constexpr int aslot(int p) {
        return p == META_LMIN ? 0 : -1;
    }
};

// pass12: the scratch's S, A and B of the 9 equations at +-1; its k and
// eps sources and SrcAdd at the node; the carry's 9 beta planes (aux).
struct Pass12Planes {
    static constexpr int N = 27, NC = 3, NA = 9;
    __host__ __device__ static constexpr int plane(int s) { return s; }
    __host__ __device__ static constexpr int slot(int p) {
        return p < SCR_S + 27 ? p : -1;
    }
    __host__ __device__ static constexpr int cplane(int k) {
        return k == 0 ? SCR_SRC_K : k == 1 ? SCR_SRC_EPS : SCR_SRCADD_E;
    }
    __host__ __device__ static constexpr int cslot(int p) {
        return p == SCR_SRC_K ? 0 : p == SCR_SRC_EPS ? 1
             : p == SCR_SRCADD_E ? 2 : -1;
    }
    __host__ __device__ static constexpr int aplane(int k) {
        return CARRY_BETA + k;
    }
    __host__ __device__ static constexpr int aslot(int p) {
        return p - CARRY_BETA;
    }
};

// floats of a stage: the windows, the node tiles, the ctx words and flags
template <class Planes>
__host__ __device__ constexpr int stage_floats() {
    return Planes::N * WIN_PLANE + (Planes::NC + Planes::NA) * CTA_THREADS
           + WIN_META;
}

// WindowSrc reads every operand from the stage: a windowed plane at the
// collapsed window offsets, a plane read at the node from its node tile;
// an aux plane without a node tile from global memory.
template <class Planes>
struct WindowSrc {
    const float* win;                  // the stage
    const float* __restrict__ aux_base;
    size_t P, n;                       // the node in the grid
    int t;                             // the node in its tile
    int nb[5];                         // window offsets by Nb
    __device__ __forceinline__ float at(int plane, int d) const {
        const int s = Planes::slot(plane);
        return s >= 0 ? win[s * WIN_PLANE + nb[d]]
                      : node(Planes::cslot(plane));
    }
    __device__ __forceinline__ float aux(int plane) const {
        const int s = Planes::aslot(plane);
        return s >= 0 ? node(Planes::NC + s) : aux_base[plane * P + n];
    }
    __device__ __forceinline__ float node(int k) const {
        return win[Planes::N * WIN_PLANE + k * CTA_THREADS + t];
    }
};

// 16-byte copies need a 16-byte-aligned source: aligned stacks and ctx
// words with Y % 4 == 0, aligned int8 flags with Y % 16 == 0.
__device__ __forceinline__ bool vec_ok(const Consts& c, const void* base,
                                       const void* aux, const void* ctxw) {
    return ((reinterpret_cast<uintptr_t>(base)
             | reinterpret_cast<uintptr_t>(aux)
             | reinterpret_cast<uintptr_t>(ctxw)) & 15u) == 0
           && c.Y % 4 == 0;
}

__device__ __forceinline__ bool vec_idn_ok(const Consts& c,
                                           const void* idn) {
    return (reinterpret_cast<uintptr_t>(idn) & 15u) == 0 && c.Y % 16 == 0;
}

// Issue the asynchronous copies of tile `tile`'s stage into `buf` (every
// thread of the CTA takes part): the windows and node tiles of the stencil
// stack `base`, the node tiles of the aux stack, the ctx words and the
// neighbour flags, in 16-byte pieces where vec_ok/vec_idn_ok allow and the
// tile is whole (a tile cut by the grid's last column copies 4-byte
// pieces).  Each thread keeps one position in a plane (its row and
// piece, so its source and destination offsets) and walks the planes, so
// a copy costs a pointer step, not the index arithmetic.
template <class Planes>
__device__ __forceinline__ void stage_tile(
        const Consts& c, float* buf, const float* __restrict__ base,
        const float* __restrict__ aux, const int32_t* __restrict__ ctxw,
        const int8_t* __restrict__ idn, int tile) {
    constexpr int N = Planes::N, NODE = Planes::NC + Planes::NA;
    const bool vec = vec_ok(c, base, aux, ctxw), vec_idn = vec_idn_ok(c, idn);
    const size_t P = static_cast<size_t>(c.X) * c.Y;
    const int i0 = (tile / c.nby) * TILE_X, j0 = (tile % c.nby) * TILE_Y;
    const int t = threadIdx.y * TILE_Y + threadIdx.x;
    const bool whole = j0 + TILE_Y <= c.Y;
    auto row = [&](int r) {
        return static_cast<size_t>(min(max(i0 + r, 0), c.X - 1)) * c.Y;
    };
    auto col = [&](int q) { return min(max(j0 + q, 0), c.Y - 1); };
    auto node_plane = [&](int m) {
        return m < Planes::NC ? base + Planes::cplane(m) * P
                              : aux + Planes::aplane(m - Planes::NC) * P;
    };
    float* nt = buf + N * WIN_PLANE;          // the node tiles
    uint32_t* cw = reinterpret_cast<uint32_t*>(nt + NODE * CTA_THREADS);
    int8_t* id = reinterpret_cast<int8_t*>(cw + CTX_N_WORDS * CTA_THREADS);
    if (vec && whole) {
        // windows, interior columns: WIN_X rows x 8 pieces of 16 bytes a
        // plane; 3 planes at a time
        constexpr int PW = WIN_X * (TILE_Y / 4);
        if (t < 3 * PW) {
            const int r = (t % PW) / (TILE_Y / 4), k = t % (TILE_Y / 4);
            const size_t src = row(r - 1) + j0 + 4 * k;
            float* dst = buf + r * WIN_ROW + WIN_J0 + 4 * k;
            for (int s = t / PW; s < N; s += 3)
                __pipeline_memcpy_async(dst + s * WIN_PLANE,
                                        base + Planes::plane(s) * P + src,
                                        16);
        }
        // windows, the two halo columns: WIN_X rows x 2 a plane, 4 bytes
        constexpr int PH = WIN_X * 2, GH = CTA_THREADS / PH;
        if (t < GH * PH) {
            const int r = (t % PH) / 2, side = t % 2;
            const size_t src = row(r - 1) + col(side ? TILE_Y : -1);
            float* dst = buf + r * WIN_ROW
                         + (side ? WIN_J0 + TILE_Y : WIN_J0 - 1);
            for (int s = t / PH; s < N; s += GH)
                __pipeline_memcpy_async(dst + s * WIN_PLANE,
                                        base + Planes::plane(s) * P + src,
                                        4);
        }
        // node tiles and ctx words: TILE_X rows x 8 pieces of 16 bytes a
        // plane; 4 planes at a time
        constexpr int PN = TILE_X * (TILE_Y / 4);
        const int r = (t % PN) / (TILE_Y / 4), k = t % (TILE_Y / 4);
        const size_t src = row(r) + j0 + 4 * k;
        const int dst = r * TILE_Y + 4 * k;
        for (int m = t / PN; m < NODE; m += CTA_THREADS / PN)
            __pipeline_memcpy_async(nt + m * CTA_THREADS + dst,
                                    node_plane(m) + src, 16);
        static_assert(CTA_THREADS / PN == CTX_N_WORDS, "a ctx word each");
        __pipeline_memcpy_async(cw + (t / PN) * CTA_THREADS + dst,
                                ctxw + (t / PN) * P + src, 16);
    } else {
        // 4-byte pieces: a thread holds one or two positions of a window
        // and one of a node tile
        constexpr int WE = WIN_X * (TILE_Y + 2);
        for (int q = t; q < WE; q += CTA_THREADS) {
            const int r = q / (TILE_Y + 2), k = q % (TILE_Y + 2);
            const size_t src = row(r - 1) + col(k - 1);
            float* dst = buf + r * WIN_ROW + WIN_J0 - 1 + k;
            for (int s = 0; s < N; ++s)
                __pipeline_memcpy_async(dst + s * WIN_PLANE,
                                        base + Planes::plane(s) * P + src,
                                        4);
        }
        const size_t src = row(t / TILE_Y) + col(t % TILE_Y);
        for (int m = 0; m < NODE; ++m)
            __pipeline_memcpy_async(nt + m * CTA_THREADS + t,
                                    node_plane(m) + src, 4);
        for (int w = 0; w < CTX_N_WORDS; ++w)
            __pipeline_memcpy_async(cw + w * CTA_THREADS + t,
                                    ctxw + w * P + src, 4);
    }
    if (vec_idn && whole) {
        // 4 flags x TILE_X rows x 2 pieces of 16 bytes
        constexpr int PI = TILE_X * (TILE_Y / 16);
        if (t < 4 * PI) {
            const int f = t / PI, r = (t % PI) / (TILE_Y / 16);
            const int k = t % (TILE_Y / 16);
            __pipeline_memcpy_async(id + f * CTA_THREADS + r * TILE_Y + 16 * k,
                                    idn + f * P + row(r) + j0 + 16 * k, 16);
        }
    } else {
        // no copy narrower than 4 bytes: plain loads, visible after the
        // barrier that precedes the tile's compute
        const size_t src = row(t / TILE_Y) + col(t % TILE_Y);
        for (int f = 0; f < 4; ++f)
            id[f * CTA_THREADS + t] = idn[f * P + src];
    }
}

// The staged operands of this thread's node (li, lj) = (threadIdx.y,
// threadIdx.x) of the tile in stage `buf`.
template <bool SPEC, class Planes>
__device__ __forceinline__ WindowSrc<Planes> window_src(
        const Consts& c, const float* buf, const float* aux_base,
        const uint32_t* w, size_t P, int i, int j) {
    const int o = (threadIdx.y + 1) * WIN_ROW + WIN_J0 + threadIdx.x;
    const Collapse k = collapse<SPEC>(c, w, i, j);
    return WindowSrc<Planes>{buf, aux_base, P,
                             static_cast<size_t>(i) * c.Y + j,
                             static_cast<int>(threadIdx.y * TILE_Y
                                              + threadIdx.x),
                             {o, k.l ? o - WIN_ROW : o,
                              k.r ? o + WIN_ROW : o, k.u ? o + 1 : o,
                              k.d ? o - 1 : o}};
}

template <class Planes>
__device__ __forceinline__ void window_ctx(uint32_t* w, int8_t* id4,
                                           const float* buf) {
    const int t = threadIdx.y * TILE_Y + threadIdx.x;
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(
        buf + Planes::N * WIN_PLANE
        + (Planes::NC + Planes::NA) * CTA_THREADS);
    const int8_t* id =
        reinterpret_cast<const int8_t*>(cw + CTX_N_WORDS * CTA_THREADS);
#pragma unroll
    for (int k = 0; k < CTX_N_WORDS; ++k) w[k] = cw[k * CTA_THREADS + t];
#pragma unroll
    for (int k = 0; k < 4; ++k) id4[k] = id[k * CTA_THREADS + t];
}

// Table::GetVal (config/tables.table_lookup): telescoped slope form for
// strictly ascending knots, else the first-bracket segment with the
// reference's boundary checks.  Knots of table t: xs at chemf[off],
// ys right after; chemi[3t..3t+2] = (off, n, ascending).
// (static: this header is in two translation units)
static __device__ float table_lookup(const float* __restrict__ chemf,
                                     const int32_t* __restrict__ chemi,
                                     int t, float q) {
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

// The extended forms' table lookups: each table's slopes computed once on
// the host (ops/fused_step.pack_chem), not at every node.  After what
// table_lookup reads, chemf holds a coefficient block of chemi[CHEM_COEF]
// floats at chemi[CHEM_COEF + 1] (chemi[CHEM_COEF] <= CHEM_COEF_MAX): a
// head of 4 floats a table (x0, y0, m1, code), m1 = (y1 - y0) / (x1 - x0)
// rounded as the division above rounds it; code 0: two ascending knots;
// > 0: more, at block offset code a pair (segments k, 0) and k pairs
// (x_{s-1}, m_s - m_{s-1}); -1: one knot or not ascending (table_lookup).
// An extended CTA stages the block in shared memory (stage_chem_coef), so
// a lookup is loads from shared memory and, for two knots, one FMA: the
// same expressions and bits as table_lookup, with no chemi indirection and
// no division.
constexpr int N_CHEM_TABLES = 12;
constexpr int CHEM_COEF = 3 * N_CHEM_TABLES;
constexpr int CHEM_COEF_MAX = 1024;

// the table coefficients a CTA stages (stage_chem_coef): the kernel's
// static shared memory and the pointer gfc_tile takes
#define HF2D_COEF __shared__ float4 coef4[CHEM_COEF_MAX / 4];
#define HF2D_COEF_PTR reinterpret_cast<float*>(coef4)

__device__ __forceinline__ void stage_chem_coef(
        float* coef, const float* __restrict__ chemf,
        const int32_t* __restrict__ chemi) {
    const int len = chemi[CHEM_COEF], off = chemi[CHEM_COEF + 1];
    for (int k = threadIdx.y * TILE_Y + threadIdx.x; k < len;
         k += CTA_THREADS)
        coef[k] = chemf[off + k];
    __syncthreads();
}

__device__ __forceinline__ float coef_lookup(const float* coef,
                                    const float* __restrict__ chemf,
                                    const int32_t* __restrict__ chemi, int t,
                                    float q) {
    const float4 h = reinterpret_cast<const float4*>(coef)[t];
    float out = h.y + h.z * (q - h.x);
    if (h.w == 0.f) return out;
    if (h.w < 0.f) return table_lookup(chemf, chemi, t, q);
    const float2* seg =
        reinterpret_cast<const float2*>(coef + static_cast<int>(h.w));
    const int k = static_cast<int>(seg[0].x);
    for (int s = 1; s <= k; ++s)
        out = out + seg[s].y * fmaxf(q - seg[s].x, 0.f);
    return out;
}

__device__ __forceinline__ float mixture_coef(
        const float* coef, const float* __restrict__ chemf,
        const int32_t* __restrict__ chemi, int prop, float Tg, float Yfu,
        float Yox, float Ycp, float Yair) {
    return coef_lookup(coef, chemf, chemi, 4 * prop + 0, Tg) * Yfu
           + coef_lookup(coef, chemf, chemi, 4 * prop + 1, Tg) * Yox
           + coef_lookup(coef, chemf, chemi, 4 * prop + 2, Tg) * Ycp
           + coef_lookup(coef, chemf, chemi, 4 * prop + 3, Tg) * Yair;
}

// ---------------------------------------------------------------------------
// The turbulence closures of the closures' gfc (fused_step_closure.cu):
// core/physics._turb_mod_rans for one node (TurbModRANS2D,
// hyper_flow_node.hpp:601-957; the JAX package's physics.py:299-542), on
// an NS deck whose closure is not standard k-eps (ops/fused_step.py
// is_closure).  The families run where the case has them (FAM, else
// ClosureConsts::models, p.models) and each writes only at its own nodes
// (the exclusive masks m_prandtl, m_keps, m_sa, m_smag), in JAX's order:
// Prandtl, k-eps, SA, Smagorinsky.  Every expression keeps
// JAX's operation order, its Python constants folded in double and rounded
// once (F), and its integer powers in lax.integer_pow's form (x^3 = x x^2,
// x^6 = x^2 (x^2)^2).
// ---------------------------------------------------------------------------
constexpr int TEM_VAN_DRIEST = 1, TEM_ESCUDIER = 2, TEM_KLEBANOFF = 3;
constexpr int TEM_CHIEN = 5, TEM_JL = 6, TEM_LSY = 7, TEM_RNG = 8;
constexpr int MODEL_PRANDTL = 1, MODEL_KEPS = 2, MODEL_SA = 4,
              MODEL_SMAG = 8;   // ops/fused_step.py MODEL_BITS

// The closure families a form compiles (FAM), fixed at compile time: the
// MODEL_* bit of a deck's one family (its form carries no other family's
// code, so fewer registers live), or FAM_ALL, which tests each family of
// c.models at run time (a deck with more than one; the extended and
// moving-wall forms)
constexpr int FAM_ALL = 0;

template <int FAM, class C>
__device__ __forceinline__ bool has_family(const C& c, int model) {
    if constexpr (FAM == FAM_ALL) return (c.models & model) != 0;
    else return (FAM & model) != 0;
}

// What the closures read at the node: its state after the Dirichlet
// enforcement of U and V, the carry's p and Tg (the state before this
// fill, as Chien's Mt and SA's sound speed read them), its gradients, and
// the meta planes l_min and y+.
struct NodeFlow {
    float rho, rho_s, U, V, mu, CP, R, k_cpcv, p, Tg;
    float dUdx, dUdy, dVdx, dVdy, dkdx, dkdy, depsdx, depsdy;
    float l_min, y_plus;
    bool is_mu_t, fc;
};

// The fluxes and sources of equations 7 and 8 (0 where no closure writes
// them, as the expanded state's zeros; the sources the source field's in
// an extended form); f7, f8: their radial fluxes (the axisymmetric
// add-ons of the extended forms).
struct TurbFlux {
    float a7, a8, b7, b8, src7, src8, f7, f8;
};

__device__ __forceinline__ float safe_div(float a, float b) {
    return b != 0.f ? a / b : 0.f;
}

// Updates s[7], s[8] and mu_t; fills `t`.  EXT, on an axisymmetric deck
// (`axi`, the node radius `y_r`): k-eps's production reads U / y_r and
// k-eps and SA write their radial fluxes (physics.py:350, 446-450,
// 514-518).  FAM: the families compiled (has_family).
template <bool SPEC, bool EXT = false, int FAM = FAM_ALL>
__device__ __forceinline__ void closures(const ClosureConsts& c,
                                         const uint32_t* w,
                                         const NodeFlow& f, float* s,
                                         float& mu_t, TurbFlux& t,
                                         bool axi = false, float y_r = 0.f) {
    const bool m_prandtl = MASK(M_PRANDTL, false);
    const bool m_keps = MASK(M_KEPS, true);
    const bool m_sa = MASK(M_SA, false);
    const bool m_smag = MASK(M_SMAG, false);
    const bool kconst = MASK(KCONST, false);
    const bool econst = MASK(ECONST, false);
    const bool ewall = MASK(EWALL, false);
    const bool sa_bc = MASK(SA_BC, false);
    const float rho = f.rho, U = f.U, V = f.V, mu = f.mu;
    const float grad_mag = fmaxf(fabsf(f.dUdy), fabsf(f.dVdx));

    // ---------------- Prandtl zero-equation family (612-638) --------------
    if (has_family<FAM>(c, MODEL_PRANDTL) && m_prandtl) {
        const float n_0 = f.l_min * F(0.41);
        float l_p = n_0;
        if (c.prandtl_form == TEM_VAN_DRIEST) {
            l_p = n_0 * (F(1.0) - expf(-f.y_plus / F(26.0)));
        } else if (c.prandtl_form == TEM_ESCUDIER) {
            l_p = fminf(n_0, c.esc_l);
        } else if (c.prandtl_form == TEM_KLEBANOFF) {
            const float q = f.l_min / c.delta_bl;
            const float q2 = q * q;
            l_p = n_0 / sqrtf(F(1.0) + F(5.5) * (q2 * (q2 * q2)));
        }
        mu_t = rho * l_p * l_p * grad_mag;
    }

    // ---------------- k-eps family (640-820) -------------------------------
    if (has_family<FAM>(c, MODEL_KEPS) && m_keps) {
        float Sk = s[7], Se = s[8];
        const float l_base = fmaxf(f.l_min, c.min_dxdy) * F(0.41);
        const float l_s = l_base != 0.f ? l_base : 1.f;
        const float tmp1 = f.dUdy + f.dVdx;
        const float tmp2 = rho * l_base;
        float tmp3 = f.dUdx * f.dUdx + f.dVdy * f.dVdy;
        if constexpr (EXT) {
            if (axi) tmp3 = tmp3 + U / y_r;
        }
        float mu_t_ke = mu_t == 0.f ? rho * l_base * l_base * grad_mag : mu_t;
        const float G = mu_t_ke * (tmp1 * tmp1 + F(2.0) * tmp3);
        const float Rt = (Se != 0.f && mu != 0.f) ? safe_div(Sk * Sk, Se * mu)
                                                  : 0.f;
        float f2 = F(1.0), f_mu = F(1.0), L_k = 0.f, L_eps = 0.f, Mt = 0.f;
        float C1eps = F(1.44), C2eps = F(1.92), C_mu = F(0.09);
        float sig_k = F(1.0), sig_eps = F(1.3);
        float r_sig_k = F(1.0 / 1.0), r_sig_eps = F(1.0 / 1.3);
        if (c.keps_form == TEM_CHIEN) {
            C1eps = F(1.35);
            C2eps = F(1.8);
            f2 = F(1.0) - F(0.4 / 1.8) * expf(-(Rt * Rt) / F(36.0));
            f_mu = F(1.0) - expf(F(-0.0115) * f.y_plus);
            const float tmp2_s = tmp2 != 0.f ? tmp2 : 1.f;
            L_k = F(-2.0) * mu * Sk / (tmp2_s * tmp2_s);
            L_eps = F(-2.0) * mu * Se / (tmp2_s * tmp2_s)
                    * expf(-f.y_plus / F(2.0));
            Mt = F(1.5) * safe_div(Sk, f.k_cpcv * f.p);
        } else if (c.keps_form == TEM_JL) {
            f_mu = expf(F(-2.5) / (F(1.0) + Rt / F(50.0)));
        } else if (c.keps_form == TEM_LSY) {
            f_mu = expf(F(-3.4) / (F(1.0) + Rt / F(50.0))
                        / (F(1.0) + Rt / F(50.0)));
        } else if (c.keps_form == TEM_RNG) {
            const float nu_r = Se != 0.f
                ? sqrtf(fmaxf(G, 0.f)) * safe_div(Sk, Se) : 0.f;
            const float nu_r3 = nu_r * (nu_r * nu_r);
            C_mu = F(0.0845);
            C1eps = F(1.42);
            C2eps = F(1.68) + C_mu * nu_r3 * (F(1.0) - nu_r / F(4.38))
                              / (F(1.0) + F(0.012) * nu_r3);
            sig_k = sig_eps = F(0.7194);
            r_sig_k = r_sig_eps = F(1.0 / 0.7194);
        }
        const float w_mag = sqrtf(U * U + V * V + F(1.e-30));
        const float tmpI = F(0.005) * w_mag;
        const float k_init = F(1.5) * tmpI * tmpI * rho;
        if (kconst) Sk = k_init;
        if (econst || ewall)   // c_mu075: C_mu ** 0.75 of the variant
            Se = c.c_mu075 * powf(fmaxf(Sk / f.rho_s, 0.f), F(1.5)) / l_s;
        const float nu_t = fabsf(C_mu * f_mu * safe_div(Sk * Sk, Se));
        if (f.is_mu_t && Se != 0.f) mu_t_ke = fminf(nu_t, mu_t_ke);
        const float mt_sk = c.fast_math ? mu_t_ke * r_sig_k : mu_t_ke / sig_k;
        const float mt_se = c.fast_math ? mu_t_ke * r_sig_eps
                                        : mu_t_ke / sig_eps;
        t.a7 = Sk * U - (mu + mt_sk) * f.dkdx;
        t.a8 = Se * U - (mu + mt_se) * f.depsdx;
        t.b7 = Sk * V - (mu + mt_sk) * f.dkdy;
        t.b8 = Se * V - (mu + mt_se) * f.depsdy;
        if (Sk != 0.f && !kconst) t.src7 = G - Se * (F(1.0) + Mt) + L_k * rho;
        if (Sk != 0.f && !econst)
            t.src8 = C1eps * (Se / Sk) * G - C2eps * f2 * (Se * Se / Sk)
                     + L_eps * rho;
        if constexpr (EXT) {
            if (axi) {   // the axisymmetric add-on (hpp:241-252)
                t.f7 = (mu + mu_t_ke) * f.dkdy;
                t.f8 = (mu + mu_t_ke / F(1.3)) * f.depsdy;
            }
        }
        s[7] = Sk;
        s[8] = Se;
        mu_t = mu_t_ke;
    }

    // ---------------- Spalart-Allmaras (822-917) ---------------------------
    if (has_family<FAM>(c, MODEL_SA) && m_sa) {
        const float Snu = s[7];
        const bool full = !sa_bc && !f.fc;
        const float nu = mu / f.rho_s;
        const float Snu_new = sa_bc ? 0.f : f.fc ? nu * F(0.005) : Snu;
        const float a_sound2 = f.k_cpcv * f.R * f.Tg;
        const float ksi = safe_div(Snu, nu);
        const float ksi3 = ksi * (ksi * ksi);
        const float fv1_full = ksi3 / (ksi3 + F(7.1 * 7.1 * 7.1));
        const float fv2 = F(1.0) - ksi / (F(1.0) + ksi * fv1_full);
        const float Wxy = F(0.5) * (f.dVdx - f.dUdy);
        const float Omega = sqrtf(F(2.0) * Wxy * Wxy);
        const float lms = f.l_min != 0.f ? f.l_min : 1.f;
        float S_hat = Omega + Snu / (F(0.41 * 0.41) * lms * lms) * fv2;
        S_hat = fmaxf(S_hat, F(0.3) * Omega);
        const float S_hat_s = S_hat != 0.f ? S_hat : 1.f;
        const float r_sa = fminf(Snu / (S_hat_s * F(0.41) * F(0.41) * lms
                                        * lms),
                                 F(10.0));
        const float r2 = r_sa * r_sa;
        const float g_sa = r_sa + F(0.3) * (r2 * (r2 * r2) - r_sa);
        const float g_s = g_sa != 0.f ? g_sa : 1.f;
        const float g2 = g_s * g_s;
        const float fw = g_sa * powf(F(65.0) / (g2 * (g2 * g2) + F(64.0)),
                                     F(1.0 / 6.0));
        const float ft2 = F(2.0) * expf(F(-0.5) * ksi * ksi);
        const float nu_hat = safe_div(
            mu_t, f.rho_s * (fv1_full != 0.f ? fv1_full : 1.f));
        const float div_nu = f.dkdx + f.dkdy;
        const float q = Snu / lms;
        // Cb1 = 0.1355, Cb2 = 0.622, sig = 2/3, kappa = 0.41,
        // Cw1 = Cb1 / kappa^2 + (1 + Cb2) / sig, C5 = 3.5
        const float src_nu =
            F(0.1355) * (F(1.0) - ft2) * S_hat * Snu
            - (F(0.1355 / (0.41 * 0.41) + (1 + 0.622) / (2.0 / 3.0)) * fw
               - F(0.1355 / (0.41 * 0.41)) * ft2) * (q * q)
            + (F(0.622) * div_nu * div_nu) / F(2.0 / 3.0)
            - F(3.5) * nu_hat * nu_hat * safe_div(f.dUdy * f.dVdx, a_sound2);
        if (full) {
            t.a7 = Snu * U - (nu + Snu) * f.dkdx / F(2.0 / 3.0);
            t.b7 = Snu * V - (nu + Snu) * f.dkdy / F(2.0 / 3.0);
            t.src7 = src_nu;
        }
        if constexpr (EXT) {
            if (axi) t.f7 = (nu + Snu) * f.dkdy;   // SA's add-on (hpp:246-247)
        }
        s[7] = Snu_new;
        if (f.is_mu_t) mu_t = fmaxf(0.f, rho * s[7] * (full ? fv1_full : 1.f));
    }

    // ---------------- Smagorinsky LES (927-956), uniform mesh --------------
    if (has_family<FAM>(c, MODEL_SMAG) && m_smag && f.is_mu_t) {
        const float Wxy = F(0.5) * (f.dVdx - f.dUdy);
        const float Omega = sqrtf(F(2.0) * Wxy * Wxy);
        mu_t = fmaxf(0.f, rho * c.smag_cs2 * Omega);   // (Cs delta)^2
    }
}

// ---------------------------------------------------------------------------
// gfc: core/step.gfc for one node (gradients, fill_node with standard
// k-eps, the per-node dt limit, chemistry).  Returns the Tg<0 and
// frozen-dt-overrun flags of the node.
//
// CLOSURE is the form of the NS decks whose closure is not standard
// k-eps: fill_node's turbulence is `closures` above (the families FAM),
// which reads l_min and, where the closure reads it, y+ (META_Y_PLUS) from
// the meta planes, and the table values come from the staged coefficients
// (mixture_coef), as in the extended forms.  A compile-time flag as EULER
// is: the standard k-eps bodies keep their code, registers and 3-CTA
// budget.
//
// EULER is the form of the Euler decks (ProblemType=0, p.sm != SM_NS;
// the TPU kernel's non-NS staging, pallas_step.py:405-414): no gradients
// (the expanded state's zeros stand), no turbulence, no viscous stress or
// heat flux in the fluxes, lam and mu carried (no table lookups), and
// lam_t read from the chunk-constant meta plane META_LAM_T, which
// FillNode2D never rewrites outside SM_NS.  A compile-time flag: the NS
// bodies' code and registers stay as they were.
// ---------------------------------------------------------------------------
// Where gfc_node puts the node's outputs: `carry(plane, v)` a plane of
// the new carry, `scratch(plane, v)` a plane of the gfc -> pass12 scratch.
// GlobalOut stores both in global memory at the node (cout and scr), as
// every kernel but step_spec_kernel does (its sink, SpecOut, keeps the
// scratch of its tile in shared memory: fused_step_spec.cu).
//
// What only the chunk's epilogue keeps (StateOut): `grad(plane, v)` a
// gradient plane of the SolverState (ST_*), `lam_t(v)` its lam_t, `dt(v)`
// the node's dt limit (1 off the active nodes, as core/step.gfc's dt
// field).  Every other sink drops them (HF2D_NO_STATE), so its kernels
// keep their code; a sink's STATE also writes the moving-wall planes at
// every node (0 off the no-slip wall nodes, as the state's SrcAdd).  The
// Euler forms call neither grad nor lam_t: outside SM_NS the state keeps
// the expanded zeros and its own lam_t (META_LAM_T).
#define HF2D_NO_STATE                                                        \
    static constexpr bool STATE = false;                                    \
    __device__ __forceinline__ void grad(int, float) const {}               \
    __device__ __forceinline__ void lam_t(float) const {}                   \
    __device__ __forceinline__ void dt(float) const {}

struct GlobalOut {
    float* __restrict__ cout;
    float* __restrict__ scr;
    size_t P, n;
    HF2D_NO_STATE
    __device__ __forceinline__ void carry(int plane, float v) const {
        cout[plane * P + n] = v;
    }
    __device__ __forceinline__ void scratch(int plane, float v) const {
        scr[plane * P + n] = v;
    }
};

// GlobalOut's stores, and the state planes `st` (N_STATE planes) at the
// node, those whose bit is set in `keep` (ops/fused_step.py state_keep: a
// deck with no k-eps or SA closure leaves dkdx..depsdy to the host's
// zeros); the node's dt into `*dtn`.
struct StateOut {
    float* __restrict__ cout;
    float* __restrict__ scr;
    float* __restrict__ st;
    size_t P, n;
    float* dtn;
    int keep;
    static constexpr bool STATE = true;
    __device__ __forceinline__ void carry(int plane, float v) const {
        cout[plane * P + n] = v;
    }
    __device__ __forceinline__ void scratch(int plane, float v) const {
        scr[plane * P + n] = v;
    }
    __device__ __forceinline__ void grad(int plane, float v) const {
        if ((keep >> plane) & 1) st[plane * P + n] = v;
    }
    __device__ __forceinline__ void lam_t(float v) const {
        if ((keep >> ST_LAM_T) & 1) st[ST_LAM_T * P + n] = v;
    }
    __device__ __forceinline__ void dt(float v) const { *dtn = v; }
};

// `src` reads the carry `cin` (through the node's collapse) and the meta
// planes mf (aux), `w` holds the node's ctx words, `st` its neighbour
// flags; `out` takes the outputs.  COEF: the table values come from the
// staged coefficients (ext.coef) as in the extended and the closures'
// forms, in a flat standard k-eps form (step_spec_kernel).
template <bool SPEC, bool EULER, bool CLOSURE, int XF = XF_FLAT,
          int FAM = FAM_ALL, bool COEF = false, class C, class Src,
          class Out>
__device__ __forceinline__ void gfc_node(
        const C& c, const Src& src, const uint32_t* w,
        const Stencil& st, const Out& out, const float* __restrict__ chemf,
        const int32_t* __restrict__ chemi,
        float dt, float cfl_scen, bool mu_t_iter, bool& uns, bool& ovr,
        const ExtIn& ext = ExtIn{}) {
    static_assert(XF != XF_MW_FLAT, "a feature form of gfc");
    const size_t P = src.P;
    const size_t n = src.n;
    auto ld = [&](int plane, int d) { return src.at(plane, d); };

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
    const float rho_c = ld(CARRY_S, NB_C);
    const float rho_cs = rho_c != 0.f ? rho_c : 1.f;
    const float r_rho_c = 1.f / rho_cs;
    auto div_rho_c = [&](float a) {
        return c.fast_math ? a * r_rho_c : a / rho_cs;
    };
    // outside SM_NS the gradients keep the expanded state's zeros and
    // nothing reads them (EULER: the loads go with the uses)
    float dro_x[4] = {0.f, 0.f, 0.f, 0.f}, dro_y[4] = {0.f, 0.f, 0.f, 0.f};
    float air_R = ld(CARRY_S, NB_R), air_L = ld(CARRY_S, NB_L);
    float air_U = ld(CARRY_S, NB_U), air_D = ld(CARRY_S, NB_D);
#pragma unroll
    for (int k = 4; k < 7 && !EULER; ++k) {
        const float sR = ld(CARRY_S + k, NB_R), sL = ld(CARRY_S + k, NB_L);
        const float sU = ld(CARRY_S + k, NB_U), sD = ld(CARRY_S + k, NB_D);
        dro_x[k - 4] = g_dydx ? (sR - sL) * dx1nn : 0.f;
        dro_y[k - 4] = g_dydy ? (sU - sD) * dy1mm : 0.f;
        air_R = air_R - (dydx_ok ? sR : 0.f);
        air_L = air_L - (dydx_ok ? sL : 0.f);
        air_U = air_U - (dydy_ok ? sU : 0.f);
        air_D = air_D - (dydy_ok ? sD : 0.f);
    }
    if (!EULER) {
        dro_x[3] = g_dydx ? (air_R - air_L) * dx1nn : 0.f;
        dro_y[3] = g_dydy ? (air_U - air_D) * dy1mm : 0.f;
    }

    const bool grad = active && !EULER;
    const float dUdx = grad ? grad_x(ld(CARRY_U, NB_R), ld(CARRY_U, NB_L))
                            : 0.f;
    const float dVdx = grad ? grad_x(ld(CARRY_V, NB_R), ld(CARRY_V, NB_L))
                            : 0.f;
    const float dUdy = grad ? grad_y(ld(CARRY_U, NB_U), ld(CARRY_U, NB_D))
                            : 0.f;
    const float dVdy = grad ? grad_y(ld(CARRY_V, NB_U), ld(CARRY_V, NB_D))
                            : 0.f;
    const float dkdx = km && !EULER
        ? div_rho_c(grad_x(ld(CARRY_S + 7, NB_R), ld(CARRY_S + 7, NB_L)))
        : 0.f;
    const float dkdy = km && !EULER
        ? div_rho_c(grad_y(ld(CARRY_S + 7, NB_U), ld(CARRY_S + 7, NB_D)))
        : 0.f;
    const float depsdx = em && !EULER
        ? div_rho_c(grad_x(ld(CARRY_S + 8, NB_R), ld(CARRY_S + 8, NB_L)))
        : 0.f;
    const float depsdy = em && !EULER
        ? div_rho_c(grad_y(ld(CARRY_S + 8, NB_U), ld(CARRY_S + 8, NB_D)))
        : 0.f;
    const float dTdx = grad
        ? (ld(CARRY_TG, NB_R) - ld(CARRY_TG, NB_L)) * dx1nn : 0.f;
    const float dTdy = grad
        ? (ld(CARRY_TG, NB_U) - ld(CARRY_TG, NB_D)) * dy1mm : 0.f;
    // the state's gradients: core/step.gfc's masks over the expanded
    // state's zeros (EULER: none, the host keeps the zeros)
    if constexpr (!EULER) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            out.grad(ST_DROYDX + k, dro_x[k]);
            out.grad(ST_DROYDY + k, dro_y[k]);
        }
        out.grad(ST_DUDX, dUdx);
        out.grad(ST_DUDY, dUdy);
        out.grad(ST_DVDX, dVdx);
        out.grad(ST_DVDY, dVdy);
        out.grad(ST_DTDX, dTdx);
        out.grad(ST_DTDY, dTdy);
        out.grad(ST_DKDX, dkdx);
        out.grad(ST_DKDY, dkdy);
        out.grad(ST_DEPSDX, depsdx);
        out.grad(ST_DEPSDY, depsdy);
    }

    // ---------------- FillNode2D (hyper_flow_node.hpp:374-600) ------------
    float s[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) s[e] = ld(CARRY_S + e, NB_C);
    const float rho = s[0];
    const float CP = ld(CARRY_CP, NB_C), R = ld(CARRY_R, NB_C);
    const float cpr = CP - R;
    const float k_cpcv = cpr != 0.f ? CP / cpr : 2.f;
    const bool guard = !solid && rho != 0.f && k_cpcv >= 1.f;
    const float rho_s = rho != 0.f ? rho : 1.f;
    const float r_rho = 1.f / rho_s;
    auto div_rho = [&](float a) { return c.fast_math ? a * r_rho : a / rho_s; };

    const float U0 = ld(CARRY_U, NB_C), V0 = ld(CARRY_V, NB_C);
    float U = u_const ? U0 : div_rho(s[1]);
    float V = v_const ? V0 : div_rho(s[2]);
    if (u_const) s[1] = U * rho;
    if (v_const) s[2] = V * rho;
    const float mu = ld(CARRY_MU, NB_C), lam = ld(CARRY_LAM, NB_C);
    const float mu_t0 = ld(CARRY_MU_T, NB_C);
    float mu_t = mu_t0;
    const bool is_mu_t = fc || mu_t_iter;

    // EXT: the node radius (j + 0.5) dy of an axisymmetric deck
    // (static_ctx.py:369-370), and the source field's turbulence sources,
    // which stand where no closure writes them (fill_node's src list)
    constexpr bool EXT = XF != XF_FLAT;
    const bool axi = ext_axi<XF>(c);
    const float y_r = EXT ? (static_cast<float>(ext.j) + F(0.5)) * c.dy
                          : 0.f;
    float srcd7 = 0.f, srcd8 = 0.f;
    if (ext_src<XF>(c)) {
        srcd7 = ext.src[7 * P + n];
        srcd8 = ext.src[8 * P + n];
    }
    float a7 = 0.f, a8 = 0.f, b7 = 0.f, b8 = 0.f, src7 = srcd7, src8 = srcd8;
    float f7 = 0.f, f8 = 0.f;   // EXT: the turbulence add-ons of F
    if constexpr (CLOSURE) {
        const bool y_plus_read =
            (has_family<FAM>(c, MODEL_PRANDTL)
             && c.prandtl_form == TEM_VAN_DRIEST)
            || (has_family<FAM>(c, MODEL_KEPS) && c.keps_form == TEM_CHIEN);
        const NodeFlow f{rho, rho_s, U, V, mu, CP, R, k_cpcv,
                         ld(CARRY_P, NB_C), ld(CARRY_TG, NB_C), dUdx, dUdy,
                         dVdx, dVdy, dkdx, dkdy, depsdx, depsdy,
                         src.aux(META_LMIN),
                         y_plus_read ? src.aux(META_Y_PLUS) : 0.f,
                         is_mu_t, fc};
        TurbFlux t{0.f, 0.f, 0.f, 0.f, srcd7, srcd8, 0.f, 0.f};
        closures<SPEC, EXT, FAM>(c, w, f, s, mu_t, t, axi, y_r);
        a7 = t.a7;
        a8 = t.a8;
        b7 = t.b7;
        b8 = t.b8;
        src7 = t.src7;
        src8 = t.src8;
        f7 = t.f7;
        f8 = t.f8;
    } else {
    // standard k-eps (hpp:640-820): f1 = f2 = f_mu = 1, no low-Re terms
    const float grad_mag = fmaxf(fabsf(dUdy), fabsf(dVdx));
    float Sk = s[7], Se = s[8];
    const float tmp1 = dUdy + dVdx;
    float tmp3 = dUdx * dUdx + dVdy * dVdy;
    if constexpr (EXT) {
        if (axi) tmp3 = tmp3 + U / y_r;   // physics.py:350
    }
    const float l_base = EULER ? 0.f
        : fmaxf(src.aux(META_LMIN), c.min_dxdy) * F(0.41);
    const float l_s = l_base != 0.f ? l_base : 1.f;
    float mu_t_ke = mu_t == 0.f ? rho * l_base * l_base * grad_mag : mu_t;
    const float G = mu_t_ke * (tmp1 * tmp1 + F(2.0) * tmp3);
    const float w_mag = sqrtf(U * U + V * V + F(1.e-30));
    const float tmpI = F(0.005) * w_mag;
    const float k_init = F(1.5) * tmpI * tmpI * rho;
    if (!EULER && m_keps && kconst) Sk = k_init;
    if (!EULER && m_keps && (econst || ewall))
        Se = c.c_mu075 * powf(fmaxf(Sk / rho_s, 0.f), F(1.5)) / l_s;
    const float nu_t = fabsf(F(0.09) * (Se != 0.f ? Sk * Sk / Se : 0.f));
    if (is_mu_t && Se != 0.f) mu_t_ke = fminf(nu_t, mu_t_ke);
    const float mt_sk = mu_t_ke;  // mu_t_ke / sig_k with sig_k = 1
    const float mt_se = c.fast_math ? mu_t_ke * F(1.0 / 1.3)
                                    : mu_t_ke / F(1.3);
    if (!EULER && m_keps) {
        a7 = Sk * U - (mu + mt_sk) * dkdx;
        a8 = Se * U - (mu + mt_se) * depsdx;
        b7 = Sk * V - (mu + mt_sk) * dkdy;
        b8 = Se * V - (mu + mt_se) * depsdy;
        if (Sk != 0.f && !kconst) src7 = (G - Se) + F(0.0) * rho;
        if (Sk != 0.f && !econst)
            src8 = (F(1.44) * (Se / Sk) * G - F(1.92) * (Se * Se / Sk))
                   + F(0.0) * rho;
        if constexpr (EXT) {
            if (axi) {   // the axisymmetric add-on (hpp:241-252)
                f7 = (mu + mu_t_ke) * dkdy;
                f8 = (mu + mu_t_ke / F(1.3)) * depsdy;
            }
        }
        s[7] = Sk;
        s[8] = Se;
        mu_t = mu_t_ke;
    }
    }

    // formation enthalpy sum (hpp:438-445)
    float h_form = 0.f, rho_air = rho;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        h_form = h_form + c.hu[k] * s[4 + k];
        rho_air = rho_air - s[4 + k];
    }
    h_form = h_form + c.hu[3] * rho_air;

    // wall handling (hpp:447-488); XF_MW: the moving-wall sources of
    // equations 0, 1, 2, 4, 5, 6 (mw_slot)
    float mw[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (c.has_walls) {
        if (wall_law) {
            const float wm = sqrtf(U * U + V * V + F(1.e-30));
            s[1] = wm * src.aux(META_BGX);
            s[2] = wm * src.aux(META_BGY);
            U = div_rho(s[1]);
            V = div_rho(s[2]);
        }
        if (wall_ns) {
            if constexpr (XF == XF_MW) {
                // the moving-wall sources from the velocity before the
                // no-slip overwrite (physics.py fill_node, isSrcAdd; the
                // kernel path's mesh is uniform: the node's dx, dy are
                // the deck's)
                const float rx = src.aux(META_BGX)
                                 * (div_rho(s[1]) - src.aux(META_UW)) * rho;
                const float ry = src.aux(META_BGY)
                                 * (div_rho(s[2]) - src.aux(META_VW)) * rho;
                const float sa = rx / c.dx + ry / c.dy;
                mw[0] = sa;
                mw[1] = rx;
                mw[2] = ry;
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    mw[3 + k] = sa * ld(CARRY_YC + k, NB_C);
            }
            U = src.aux(META_UW);
            V = src.aux(META_VW);
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
    const float lam_t = EULER ? src.aux(META_LAM_T) : __fmul_rn(mu_t, CP);
    float an[9], bn[9];
    // EXT, axisymmetric: F of the momentum V equation (the others are
    // among the fluxes below: physics.py:238-245, 267-272)
    float fn2 = EXT ? s[2] * V : 0.f;
    an[0] = s[1];
    bn[0] = s[2];
    if (EULER) {
        // the convective fluxes alone (physics.py fill_node outside SM_NS)
        an[1] = p_new + s[1] * U;
        an[2] = s[2] * U;
        an[3] = (s[3] + p_new) * U;
        bn[1] = s[2] * U;
        bn[2] = p_new + s[2] * V;
        bn[3] = (s[3] + p_new) * V;
#pragma unroll
        for (int k = 4; k < 7; ++k) {
            an[k] = s[k] * U;
            bn[k] = s[k] * V;
        }
    } else {
        const float sig = wall ? c.sig_w : c.sig_f;
        const float mu_eff = is_mu_t ? fmaxf(0.f, mu + mu_t * sig) : mu;
        const float lam_eff = is_mu_t ? fmaxf(0.f, lam + lam_t * sig) : lam;
        const float diff = lam_eff / CP;
        float div_uv = dUdx + dVdy;
        if constexpr (EXT) {
            if (axi) div_uv = div_uv + V / y_r;   // physics.py:216
        }
        const float dila = F(2.0 / 3.0) * mu_eff * div_uv;
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

        an[1] = (p_new + s[1] * U) - sxx;
        an[2] = s[2] * U - txy;
        an[3] = (s[3] + p_new) * U - RX3;
        bn[1] = s[2] * U - txy;
        bn[2] = (p_new + s[2] * V) - syy;
        bn[3] = (s[3] + p_new) * V - RY3;
#pragma unroll
        for (int k = 4; k < 7; ++k) {
            an[k] = s[k] * U - diff * dro_x[k - 4];
            bn[k] = s[k] * V - diff * dro_y[k - 4];
        }
        if constexpr (EXT) {
            // the radial stress's hoop term (physics.py:267-272)
            if (axi) fn2 = s[2] * V - (syy + (F(2.0) * mu_eff * V / y_r
                                              - dila));
        }
    }
    an[7] = a7;
    an[8] = a8;
    bn[7] = b7;
    bn[8] = b8;

    // outputs through the guard (failing nodes keep the expanded zeros /
    // the carried values)
#pragma unroll
    for (int e = 0; e < 9; ++e) {
        out.scratch(SCR_A + e, guard ? an[e] : 0.f);
        out.scratch(SCR_B + e, guard ? bn[e] : 0.f);
        if (!guard) s[e] = ld(CARRY_S + e, NB_C);
    }
    out.scratch(SCR_SRC_K, guard ? src7 : srcd7);
    out.scratch(SCR_SRC_EPS, guard ? src8 : srcd8);
    if constexpr (EXT) {
        if (axi) {
            // F = (rhoV, rhoV U, rhoV V, (rhoE + p) V, rhoY V) less the
            // viscous terms: bn but for the momentum equations, where it
            // is an[2] (the U one) and fn2; then the turbulence add-ons.
            // F[0], F[1] and F[3..6] are the floats of B[0], A[2] and
            // B[3..6] under the same guard, which pass12 reads as such
            // (radial_flux): only the other three are written, and their
            // six planes are never written or read
            out.scratch(SCR_F + 2, guard ? fn2 : 0.f);
            out.scratch(SCR_F + 7, guard ? f7 : 0.f);
            out.scratch(SCR_F + 8, guard ? f8 : 0.f);
        }
    }
    if constexpr (XF == XF_MW) {
        // written at the no-slip wall nodes alone, where pass12 reads them
        // (0 where the guard fails: the expanded state's SrcAdd); by a
        // STATE sink at every node (mw's zeros elsewhere)
        if (wall_ns || Out::STATE) {
#pragma unroll
            for (int k = 0; k < 6; ++k)
                out.scratch(SCR_MW + k, guard ? mw[k] : 0.f);
        }
    }
    const float U_f = guard ? U : U0;
    const float V_f = guard ? V : V0;
    const float p_f = guard ? p_new : ld(CARRY_P, NB_C);
    const float Tg_f = guard ? Tg_new : ld(CARRY_TG, NB_C);

    // ---------------- instability and the local dt (1246-1327) ------------
    uns = active && Tg_f < 0.f;
    const float cfl_min = fminf(c.cfl, cfl_scen);
    const float aaa = sqrtf(fmaxf(k_cpcv * R * Tg_f, 0.f));
    const float dt_nodes = cfl_min * fminf(c.dx / (aaa + fabsf(U_f)),
                                           c.dy / (aaa + fabsf(V_f)));
    ovr = dt > (active ? dt_nodes : 1.f);
    out.dt(active ? dt_nodes : 1.f);

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
    // (the extended forms but the Euler one, the closures' forms and
    // step_spec_kernel, from the staged coefficients: mixture_coef,
    // gfc_tile)
    float CP_new, lam_new, mu_new;
    if constexpr ((EXT || CLOSURE || COEF) && !EULER) {
        CP_new = mixture_coef(ext.coef, chemf, chemi, 0, Tg_f, Yfu, Yox, Ycp,
                              Yair);
        lam_new = mixture_coef(ext.coef, chemf, chemi, 1, Tg_f, Yfu, Yox, Ycp,
                               Yair);
        mu_new = mixture_coef(ext.coef, chemf, chemi, 2, Tg_f, Yfu, Yox, Ycp,
                              Yair);
    } else {
    CP_new = mixture(chemf, chemi, 0, Tg_f, Yfu, Yox, Ycp, Yair);
    // outside SM_NS lam and mu are carried (physics.py calc_chemical_
    // reactions)
    lam_new = EULER ? lam
        : mixture(chemf, chemi, 1, Tg_f, Yfu, Yox, Ycp, Yair);
    mu_new = EULER ? mu
        : mixture(chemf, chemi, 2, Tg_f, Yfu, Yox, Ycp, Yair);
    }
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
    for (int e = 0; e < 9; ++e) out.scratch(SCR_S + e, s[e]);
    out.carry(CARRY_U, U_f);
    out.carry(CARRY_V, V_f);
    out.carry(CARRY_P, p_f);
    out.carry(CARRY_TG, Tg_f);
    const float Yc[4] = {Yfu, Yox, Ycp, Yair};
#pragma unroll
    for (int k = 0; k < 4; ++k)
        out.carry(CARRY_YC + k, active ? Yc[k] : ld(CARRY_YC + k, NB_C));
    out.carry(CARRY_R, active ? R_new : R);
    out.carry(CARRY_CP, active ? CP_new : CP);
    out.carry(CARRY_LAM, active ? lam_new : lam);
    out.carry(CARRY_MU, active ? mu_new : mu);
    out.carry(CARRY_MU_T, guard ? mu_t : mu_t0);
    // what the heat stage reads: lam after chemistry + lam_t (with the CP
    // before chemistry, physics.py fill_node; EULER: the constant plane),
    // as core/step.gfc leaves them
    if (!SPEC && c.heat)
        out.scratch(SCR_LAM_EFF,
                    __fadd_rn(active ? lam_new : lam,
                              guard || EULER ? lam_t
                                             : __fmul_rn(mu_t0, CP)));
    // the state's lam_t (fill_node's, through the guard; EULER: the
    // state's own, which the host keeps)
    if constexpr (!EULER) out.lam_t(guard ? lam_t : __fmul_rn(mu_t0, CP));
}

// ---------------------------------------------------------------------------
// pass12: core/step.pass12 for one node.  Hands the gated RMS numerator,
// denominator and DD max of each equation to `acc` (below).
// ---------------------------------------------------------------------------
constexpr int NQ = 27;   // RMS numerator, denominator, DD max x 9

// The warp's share of tile partial q (sum for q < 18, else max) into
// red[warp][q], lanes reduced by shuffles in a fixed order.  Every lane of
// the warp takes part.
__device__ __forceinline__ void warp_partial(float v, int q,
                                             float (*red)[NQ]) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_down_sync(0xffffffffu, v, off);
        v = q < 18 ? v + o : fmaxf(v, o);
    }
    if (threadIdx.x == 0) red[threadIdx.y][q] = v;
}

// The tile's partials from red, the TILE_X warps in row order, into
// part_f (after a barrier that follows the warps' writes).
__device__ __forceinline__ void tile_partials(float (*red)[NQ], int tile,
                                              float* __restrict__ part_f) {
    if (threadIdx.y == 0 && threadIdx.x < NQ) {
        const int q = threadIdx.x;
        float v = red[0][q];
        for (int r = 1; r < TILE_X; ++r)
            v = q < 18 ? v + red[r][q] : fmaxf(v, red[r][q]);
        part_f[NQ * tile + q] = v;
    }
}

// Where pass12_node puts an equation's three terms: ArrayAcc keeps all 27
// for pass12_partials at the end of the tile; WarpAcc reduces each over
// the warp at once (the same shuffles, so the same bits), so the 27 never
// live in registers together.
struct ArrayAcc {
    float v[NQ];
    __device__ __forceinline__ void put(int e, float num, float den,
                                        float ddm) {
        v[e] = num;
        v[9 + e] = den;
        v[18 + e] = ddm;
    }
};

struct WarpAcc {
    float (*red)[NQ];
    __device__ __forceinline__ void put(int e, float num, float den,
                                        float ddm) const {
        warp_partial(num, e, red);
        warp_partial(den, 9 + e, red);
        warp_partial(ddm, 18 + e, red);
    }
};

// `src` reads the scratch (through the node's collapse) and the carry's
// beta (aux), `w` holds the node's ctx words, `st` its neighbour flags;
// `own`: the node counts in the partials; `store`: it is a node of the
// grid (a WarpAcc body runs every lane of a tile, and a lane past the
// grid's edge stores nothing); `heat()`: the node's SrcAdd of rhoE,
// taken where c.heat (the general body only) at the energy equation.
// d2*-NULL soft BCs (the extended forms' general and dual bodies): the new
// x flux difference of equation e at node (i, j), a neighbour of the node
// being computed, as that neighbour's own pass 1 computes it
// (core/step.pass12's dSdx_new: its ev_flux_x bit, its collapse and
// flags, the scratch's A at its neighbours; 0 where the bit is unset, as
// the expanded state's dSdx).  nb_flux_y: the same in y, from B.
template <class C>
__device__ __forceinline__ float nb_flux_x(const C& c, const ExtIn& x,
                                           size_t P, int i, int j, int e) {
    const size_t n = static_cast<size_t>(i) * c.Y + j;
    uint32_t w[CTX_N_WORDS];
    load_ctx<false>(w, x.ctxw, P, n);
    if (!ctx_bit(w, CTX_EV_FLUX_X + e)) return 0.f;
    const Collapse k = collapse<false>(c, w, i, j);
    const float rn_n = 1.f / fmaxf(static_cast<float>(x.idn[n])
                                   + static_cast<float>(x.idn[P + n]), 1.f);
    const float* A = x.scr + (SCR_A + e) * P;
    return (A[k.r ? n + c.Y : n] - A[k.l ? n - c.Y : n]) * rn_n;
}

template <class C>
__device__ __forceinline__ float nb_flux_y(const C& c, const ExtIn& x,
                                           size_t P, int i, int j, int e) {
    const size_t n = static_cast<size_t>(i) * c.Y + j;
    uint32_t w[CTX_N_WORDS];
    load_ctx<false>(w, x.ctxw, P, n);
    if (!ctx_bit(w, CTX_EV_FLUX_Y + e)) return 0.f;
    const Collapse k = collapse<false>(c, w, i, j);
    const float rm_m = 1.f / fmaxf(static_cast<float>(x.idn[2 * P + n])
                                   + static_cast<float>(x.idn[3 * P + n]),
                                   1.f);
    const float* B = x.scr + (SCR_B + e) * P;
    return (B[k.u ? n + 1 : n] - B[k.d ? n - 1 : n]) * rm_m;
}

// a / jp1, correctly rounded (bit for bit __fdiv_rn), for jp1 = j + 1 of
// a node and rj = __frcp_rn(jp1), its one reciprocal: q = a rj, then one
// Markstein correction q + (a - q jp1) rj, two FMAs and no branch to a slow
// path.  It holds for every float a with 2^-90 <= |a| < 2^126 and every
// integer jp1 <= DIV_JP1_MAX: the steps scale exactly with a's exponent in
// that range and the remainder stays a normal float, so every significand
// of a against every jp1 covers it, which chip_smoke.py checks on the card
// against __fdiv_rn (hf2d_div_jp1_check, at each exponent F takes);
// elsewhere (0, subnormal, huge, inf, NaN, or a wider grid) it is
// __fdiv_rn itself.
constexpr int DIV_JP1_MAX = 4096;

__device__ __forceinline__ float div_jp1(float a, float jp1, float rj) {
    const float m = fabsf(a);
    if (m >= 0x1p-90f && m < 0x1p126f && jp1 <= F(DIV_JP1_MAX)) {
        const float q = __fmul_rn(a, rj);
        return __fmaf_rn(__fmaf_rn(-q, jp1, a), rj, q);
    }
    return __fdiv_rn(a, jp1);
}

// Radial flux F of equation e at the node.  gfc writes F under the guard
// of A and B and as their own floats but for F[2] (fn2) and the turbulence
// add-ons F[7], F[8] (gfc_node: fn = {bn[0], an[2], fn2, bn[3..6], f7,
// f8}), so F[0] = B[0], F[1] = A[2], F[3..6] = B[3..6] bit for bit at every
// node, and only the other three planes are read.
template <class Src>
__device__ __forceinline__ float radial_flux(const Src& src, int e) {
    return e == 0 ? src.at(SCR_B, NB_C)
         : e == 1 ? src.at(SCR_A + 2, NB_C)
         : (e == 2 || e >= 7) ? src.at(SCR_F + e, NB_C)
                              : src.at(SCR_B + e, NB_C);
}

// The moving-wall source plane of equation e (0, 1, 2, 4, 5, 6): SCR_MW +
// mw_slot(e).
__device__ __forceinline__ constexpr int mw_slot(int e) {
    return e < 3 ? e : e - 1;
}

// XF: the extended forms (ExtConsts) of XF_AXI, XF_ALL, XF_MW (XF_ALL
// and the moving-wall sources at no-slip wall nodes) or XF_MW_FLAT (the
// flat form and the moving-wall sources).  XF_ALL: d2
// averaging of the flux differences where dx2/dy2 is set and the per-node
// NRBC beta_min (general and dual bodies only: no spec tile holds such a
// node), F / (j + 1) of an axisymmetric deck and Src dt of a deck with
// sources (every body), as core/step.pass12 (JAX step.py:136-176); XF_AXI:
// F / (j + 1) alone.
template <bool SPEC, int XF = XF_FLAT, class C, class Src, class Heat,
          class Acc>
__device__ __forceinline__ void pass12_node(
        const C& c, const Src& src, const uint32_t* w,
        const Stencil& st, float* __restrict__ cout, float dt,
        float beta_scen, bool own, bool store, const Heat& heat, Acc& acc,
        const ExtIn& ext = ExtIn{}) {
    static_assert(XF == XF_FLAT || XF == XF_AXI || XF == XF_ALL
                  || XF == XF_MW || XF == XF_MW_FLAT,
                  "a feature form of pass12");
    const size_t P = src.P;
    const size_t n = src.n;
    const float dtdx = dt / c.dx;
    const float dtdy = dt / c.dy;
    float bm = fminf(c.beta0, beta_scen);
    Collapse kc{false, false, false, false};   // XF_ALL: the node's collapse
    if constexpr (has_all_features<XF>() && !SPEC) {
        if (c.nrbc && ctx_bit(w, CTX_NRBC)) bm = c.nrbc_beta0;
        kc = collapse<false>(c, w, ext.i, ext.j);
    }
    // j + 1 and its one reciprocal (div_jp1)
    const float jp1 = has_axi_code<XF>()
        ? static_cast<float>(ext.j) + F(1.0) : 0.f;
    const float rj = has_axi_code<XF>() ? __frcp_rn(jp1) : 0.f;
    // the general body takes the energy equation first, so that the heat
    // source's live values end before any partial is held (the equations
    // are independent: the order moves no bit)
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const int e = SPEC ? k : k == 0 ? 3 : k <= 3 ? k - 1 : k;
        auto Se = [&](int d) { return src.at(SCR_S + e, d); };
        auto Ae = [&](int d) { return src.at(SCR_A + e, d); };
        auto Be = [&](int d) { return src.at(SCR_B + e, d); };
        const bool evolve = MASK_EQ(EVOLVE, e, true);
        const bool efx = MASK_EQ(EV_FLUX_X, e, true);
        const bool eax = MASK_EQ(EV_AVG_X, e, false);
        const bool efy = MASK_EQ(EV_FLUX_Y, e, true);
        const bool eay = MASK_EQ(EV_AVG_Y, e, false);
        const bool ddmask = MASK_EQ(DDMASK, e, true);
        const float S = Se(NB_C), SL = Se(NB_L), SR = Se(NB_R);
        const float SU = Se(NB_U), SD = Se(NB_D);
        const float dSdx = efx ? (Ae(NB_R) - Ae(NB_L)) * st.rn_n : 0.f;
        const float dSdy = efy ? (Be(NB_U) - Be(NB_D)) * st.rm_m : 0.f;
        float S_eff = eax ? (SL * st.n2 + SR * st.n1) * st.rn_n : S;
        S_eff = eay ? (SU * st.n3 + SD * st.n4) * st.rm_m : S_eff;
        const float blend = (c.dxx * (SL + SR) + c.dyy * (SU + SD)) * F(0.5);
        const float beta = src.aux(CARRY_BETA + e);
        float sk = e == 7 ? src.at(SCR_SRC_K, NB_C)
                 : e == 8 ? src.at(SCR_SRC_EPS, NB_C) : 0.f;
        float dXX = dSdx, y_term = dSdy;
        if constexpr (XF == XF_AXI)
            y_term = y_term + div_jp1(radial_flux(src, e), jp1, rj);
        if constexpr (has_all_features<XF>()) {
            if constexpr (!SPEC) {
                if (c.d2x && ctx_bit(w, CTX_DX2 + e)) {
                    const float l = kc.l ? nb_flux_x(c, ext, P, ext.i - 1,
                                                     ext.j, e) : dSdx;
                    const float r = kc.r ? nb_flux_x(c, ext, P, ext.i + 1,
                                                     ext.j, e) : dSdx;
                    dXX = (l + r) * F(0.5);
                }
                if (c.d2y && ctx_bit(w, CTX_DY2 + e)) {
                    const float u = kc.u ? nb_flux_y(c, ext, P, ext.i,
                                                     ext.j + 1, e) : dSdy;
                    const float d = kc.d ? nb_flux_y(c, ext, P, ext.i,
                                                     ext.j - 1, e) : dSdy;
                    y_term = (u + d) * F(0.5);
                }
            }
            if (c.axi)
                y_term = y_term + div_jp1(radial_flux(src, e), jp1, rj);
            if (c.src && e < 7) sk = ext.src[e * P + n];
        }
        float next = S_eff * beta + (F(1.0) - beta) * blend
                     - (dtdx * dXX + dtdy * y_term) + sk * dt;
        if (!SPEC && c.heat && e == 3) next = next + heat();   // + SrcAdd
        if constexpr (has_mw<XF>() && !SPEC) {
            // + SrcAdd of the moving wall (no spec tile holds a wall node)
            if (e != 3 && e < 7 && MASK(WALL_NS, false))
                next = next + src.at(SCR_MW + mw_slot(e), NB_C);
        }
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
        if (store) {
            cout[(CARRY_S + e) * P + n] = next;
            cout[(CARRY_BETA + e) * P + n] = gate ? nb : beta;
        }
        const bool count = gate && own;
        acc.put(e,
                count ? (c.alt_rms ? (c.serial_rms ? abs_dd : abs_dd * abs_dd)
                                   : dd * dd)
                      : 0.f,
                count ? (c.alt_rms ? S_eff * S_eff : 1.f) : 0.f,
                count ? dd : 0.f);
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

// SrcAdd[rhoE] of node (i, j) with heat word `w` into `src`; false (and
// `src` untouched) where the node has no hw_* bit.  The directions D, U,
// L, R, the last solid one wins; each reads the solid's q right after this
// gas node's own visit of it.  Reads only what gfc wrote: Tg of `cout` and
// lam_eff of `scr` at +-2 around the node, and the solids' heat words.
__device__ __forceinline__ bool heat_source(const Consts& c,
                                            const float* __restrict__ cout,
                                            const float* __restrict__ scr,
                                            const int32_t* __restrict__ ctxw,
                                            size_t P, int i, int j,
                                            uint32_t w, float dt,
                                            float& src) {
    const float ndt = -dt;
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
        return false;
    return true;
}

// The dual body runs every tile (CTA b on tile b) and reads its tile's flag
// once per CTA (uniform branch); the spec and general bodies run their
// tile list, CTA b on entry b.
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

// One node of gfc on direct global loads; XF: the feature form (the
// extended and the closures' forms read the staged table coefficients
// `coef`, and the all-features form the source field `srcp`); FAM: the
// closure families compiled; STATE: the state form's sink (StateOut: the
// state planes `st` of `keep`, the node's dt into `*dtn`).
template <bool SPEC, bool EULER, bool CLOSURE, int XF = XF_FLAT,
          int FAM = FAM_ALL, bool STATE = false, class C>
__device__ __forceinline__ void gfc_direct(
        const C& c, const float* __restrict__ cin,
        float* __restrict__ cout, float* __restrict__ scr,
        const int8_t* __restrict__ idn, const float* __restrict__ mf,
        const int32_t* __restrict__ ctxw, const float* __restrict__ chemf,
        const int32_t* __restrict__ chemi, float dt, float cfl_scen,
        bool mu_t_iter, int i, int j, bool& uns, bool& ovr,
        const float* __restrict__ srcp = nullptr,
        const float* coef = nullptr, float* __restrict__ st = nullptr,
        float* dtn = nullptr, int keep = 0) {
    const size_t P = static_cast<size_t>(c.X) * c.Y;
    const size_t n = static_cast<size_t>(i) * c.Y + j;
    uint32_t w[CTX_N_WORDS];
    int8_t id4[4];
    load_ctx<SPEC>(w, ctxw, P, n);
    load_idn<SPEC>(id4, idn, P, n);
    const DirectSrc src = direct_src<SPEC>(c, cin, mf, w, P, i, j);
    const ExtIn ext{srcp, nullptr, nullptr, nullptr, i, j, coef};
    if constexpr (STATE)
        gfc_node<SPEC, EULER, CLOSURE, XF, FAM>(
            c, src, w, make_stencil<SPEC>(id4),
            StateOut{cout, scr, st, P, n, dtn, keep}, chemf, chemi, dt,
            cfl_scen,
            mu_t_iter, uns, ovr, ext);
    else
        gfc_node<SPEC, EULER, CLOSURE, XF, FAM>(
            c, src, w, make_stencil<SPEC>(id4), GlobalOut{cout, scr, P, n},
            chemf, chemi, dt, cfl_scen, mu_t_iter, uns, ovr, ext);
}

// One node of pass12 on direct global loads.  With the heat stage, the
// general body takes the node's SrcAdd at the energy equation: folded
// (c.heat_fold), it computes it from gfc's Tg and lam_eff (heat_source;
// nothing pass12 writes is read there), else it reads the plane
// heat_kernel wrote.  XF: the feature form (XF_ALL reads the source field
// `srcp`, and for d2 the neighbours' scratch, ctx words and flags).
template <bool SPEC, int XF = XF_FLAT, class C, class Acc>
__device__ __forceinline__ void pass12_direct(
        const C& c, const float* __restrict__ cin,
        float* __restrict__ cout, const float* __restrict__ scr,
        const int8_t* __restrict__ idn, const int32_t* __restrict__ ctxw,
        float dt, float beta_scen, int i, int j, bool own, bool store,
        Acc& acc, const float* __restrict__ srcp = nullptr) {
    const size_t P = static_cast<size_t>(c.X) * c.Y;
    const size_t n = static_cast<size_t>(i) * c.Y + j;
    uint32_t w[CTX_N_WORDS];
    int8_t id4[4];
    load_ctx<SPEC>(w, ctxw, P, n);
    load_idn<SPEC>(id4, idn, P, n);
    auto heat = [&]() {
        float h = 0.f;
        if (c.heat_fold)
            heat_source(c, cout, scr, ctxw, P, i, j, w[CTX_HEAT_WORD], dt, h);
        else
            h = scr[SCR_SRCADD_E * P + n];
        return h;
    };
    pass12_node<SPEC, XF>(c, direct_src<SPEC>(c, scr, cin, w, P, i, j), w,
                          make_stencil<SPEC>(id4), cout, dt, beta_scen, own,
                          store, heat, acc,
                          ExtIn{srcp, scr, ctxw, idn, i, j});
}

// The Tg<0 and dt-overrun counts of a tile over the window's rows (the
// node is computed at every row; only the window's rows count).  A CTA
// barrier.
__device__ __forceinline__ void gfc_partials(const Consts& c, int i,
                                             bool uns, bool ovr, int tile,
                                             int32_t* __restrict__ part_i) {
    const bool own = i >= c.x0 && i < c.x1;
    const int n_uns = __syncthreads_count(uns && own);
    const int n_ovr = __syncthreads_count(ovr && own);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        part_i[2 * tile] = n_uns;
        part_i[2 * tile + 1] = n_ovr;
    }
}

// min(a, b) that keeps a NaN of either (torch.amin's, where fminf drops
// it).
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}

// The state form's per-tile dt partial: the least node dt `v` of the tile
// over the window's rows (1 at a node outside them or past the grid's
// edge), lanes of a warp by shuffles, then the TILE_X warps, into
// part_dt[tile].  Every thread of the CTA takes part; a CTA barrier.
__device__ __forceinline__ void tile_dt_min(const Consts& c, int i, int j,
                                            float v, int tile,
                                            float* __restrict__ part_dt) {
    __shared__ float red[TILE_X];
    float m = i < c.X && j < c.Y && i >= c.x0 && i < c.x1 ? v : 1.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        m = nan_min(m, __shfl_down_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) red[threadIdx.y] = m;
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        for (int r = 1; r < TILE_X; ++r) m = nan_min(m, red[r]);
        part_dt[tile] = m;
    }
}

// The tile partials of pass12 in a fixed order: lanes of a warp (one row
// of the tile), then the TILE_X warps in row order.  Ends with the thread
// that writes them; `red` is free again after the caller's next barrier.
__device__ __forceinline__ void pass12_partials(const ArrayAcc& acc,
                                                float (*red)[NQ], int tile,
                                                float* __restrict__ part_f) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) warp_partial(acc.v[q], q, red);
    __syncthreads();
    tile_partials(red, tile, part_f);
}

// A CTA of gfc over its tile; EULER: every tile runs the Euler form of the
// general body (an Euler deck has no spec tiles, spec_supported);
// CLOSURE: every body runs the closures' form, its families FAM; XF: the
// feature form.  An extended form but the Euler one, and every closures'
// form, stages the table coefficients into `coef` first (CHEM_COEF_MAX
// floats of shared memory, HF2D_COEF): the Euler form looks up only CP, 4
// tables, and ran 1.003-1.006x as long with the staged block as without
// it on an H100.
//
// BODY_STATE is the chunk's epilogue: the general body over the tile table
// `tiles` (every tile of the grid: T4's launch), its sink StateOut, which
// also writes the gradients and lam_t into the state planes `st` (those
// of `keep`), the moving-wall planes at every node, and each tile's least
// node dt into part_dt (tile_dt_min).
template <int BODY, bool EULER, bool CLOSURE, int XF = XF_FLAT,
          int FAM = FAM_ALL, class C>
__device__ __forceinline__ void gfc_tile(
        const C& c, const float* __restrict__ cin,
        float* __restrict__ cout, float* __restrict__ scr,
        const int8_t* __restrict__ idn, const float* __restrict__ mf,
        const int32_t* __restrict__ ctxw, const float* __restrict__ chemf,
        const int32_t* __restrict__ chemi, const float* __restrict__ dtp,
        const float* __restrict__ aux, const int32_t* __restrict__ tiles,
        const int32_t* __restrict__ flags, int32_t* __restrict__ part_i,
        const float* __restrict__ srcp = nullptr, float* coef = nullptr,
        float* __restrict__ st = nullptr,
        float* __restrict__ part_dt = nullptr, int keep = 0) {
    constexpr bool STATE = BODY == BODY_STATE;
    const int tile = cta_tile<BODY>(tiles);
    const int i = (tile / c.nby) * TILE_X + threadIdx.y;
    const int j = (tile % c.nby) * TILE_Y + threadIdx.x;
    bool uns = false, ovr = false;
    float dtn = 1.f;
    if constexpr ((XF != XF_FLAT || CLOSURE) && !EULER)
        stage_chem_coef(coef, chemf, chemi);
    if (i < c.X && j < c.Y) {
        if (!EULER && !STATE && spec_tile<BODY>(flags, tile))
            gfc_direct<true, false, CLOSURE, XF, FAM>(
                c, cin, cout, scr, idn, mf, ctxw, chemf, chemi, *dtp, aux[1],
                aux[2] > F(0.5), i, j, uns, ovr, srcp, coef);
        else
            gfc_direct<false, EULER, CLOSURE, XF, FAM, STATE>(
                c, cin, cout, scr, idn, mf, ctxw, chemf, chemi, *dtp, aux[1],
                aux[2] > F(0.5), i, j, uns, ovr, srcp, coef, st, &dtn,
                keep);
    }
    gfc_partials(c, i, uns, ovr, tile, part_i);
    if constexpr (STATE) tile_dt_min(c, i, j, dtn, tile, part_dt);
}

// A CTA of pass12 over its tile, the partials through the CTA's `red`
// (pass12_kernel's body; XF: the extended kernels' feature form).  The
// dual body holds both bodies in one function, and reduces each
// equation's partials over the warp at once (WarpAcc: the same shuffles
// in the same order, so the same bits), so that the 27 are never live
// together; so does every body of the extended forms (measured on an
// H100: the general body's 72-byte spill gone and 15-17% faster, the spec
// body at 64 registers and 4 CTAs an SM and 15% faster).  WarpAcc needs
// every lane of the warp in each shuffle, so there a lane past the grid's
// edge runs the body at the grid's last row and column, stores nothing
// and counts nothing.  The flat spec and general bodies, and the flat
// moving-wall general body, keep all 27 partials of a node to the end of
// the tile (ArrayAcc); in the last, WarpAcc ran 1.06x as long on an H100
// (PERF.md).
template <int BODY, int XF = XF_FLAT, class C>
__device__ __forceinline__ void pass12_tile(
        const C& c, const float* __restrict__ cin, float* __restrict__ cout,
        const float* __restrict__ scr, const int8_t* __restrict__ idn,
        const int32_t* __restrict__ ctxw, const float* __restrict__ dtp,
        const float* __restrict__ aux, const int32_t* __restrict__ tiles,
        const int32_t* __restrict__ flags, float* __restrict__ part_f,
        float (*red)[NQ], const float* __restrict__ srcp = nullptr) {
    const int tile = cta_tile<BODY>(tiles);
    const int i = (tile / c.nby) * TILE_X + threadIdx.y;
    const int j = (tile % c.nby) * TILE_Y + threadIdx.x;
    const bool inside = i < c.X && j < c.Y;
    const bool own = inside && i >= c.x0 && i < c.x1;
    if constexpr (BODY == BODY_DUAL
                  || (XF != XF_FLAT && XF != XF_MW_FLAT)) {
        WarpAcc acc{red};
        const int ic = min(i, c.X - 1), jc = min(j, c.Y - 1);
        if (spec_tile<BODY>(flags, tile))
            pass12_direct<true, XF>(c, cin, cout, scr, idn, ctxw, *dtp,
                                    aux[0], ic, jc, own, inside, acc, srcp);
        else
            pass12_direct<false, XF>(c, cin, cout, scr, idn, ctxw, *dtp,
                                     aux[0], ic, jc, own, inside, acc,
                                     srcp);
        __syncthreads();
        tile_partials(red, tile, part_f);
    } else {
        ArrayAcc acc;
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc.v[q] = 0.f;
        if (inside)
            pass12_direct<BODY == BODY_SPEC, XF>(c, cin, cout, scr, idn,
                                                 ctxw, *dtp, aux[0], i, j,
                                                 own, true, acc, srcp);
        pass12_partials(acc, red, tile, part_f);
    }
}

// A gfc kernel's parameters: the stage's, then the state form's outputs
// `st` and `part_dt` (null but in BODY_STATE) and the bits `keep` of the
// state planes it stores (StateOut; the kernel hands the three to gfc_tile
// after its source field and table coefficients).
#define HF2D_GFC_PARAMS(CONSTS)                                              \
    const CONSTS c, const float* __restrict__ cin, float* __restrict__ cout, \
        float* __restrict__ scr, const int8_t* __restrict__ idn,            \
        const float* __restrict__ mf, const int32_t* __restrict__ ctxw,     \
        const float* __restrict__ chemf, const int32_t* __restrict__ chemi, \
        const float* __restrict__ dtp, const float* __restrict__ aux,       \
        const int32_t* __restrict__ tiles,                                  \
        const int32_t* __restrict__ flags, int32_t* __restrict__ part_i,    \
        float* __restrict__ st, float* __restrict__ part_dt, const int keep
#define HF2D_GFC_FORWARD                                                     \
    c, cin, cout, scr, idn, mf, ctxw, chemf, chemi, dtp, aux, tiles, flags, \
        part_i
// the host-side arguments of a gfc launch in that order (the C entries),
// from void pointers of the same names and the int `keep`
#define HF2D_GFC_LAUNCH_ARGS(CONSTS)                                         \
    CONSTS, static_cast<const float*>(cin), static_cast<float*>(cout),      \
        static_cast<float*>(scr), static_cast<const int8_t*>(idn),          \
        static_cast<const float*>(mf), static_cast<const int32_t*>(ctxw),   \
        static_cast<const float*>(chemf),                                   \
        static_cast<const int32_t*>(chemi), static_cast<const float*>(dt), \
        static_cast<const float*>(aux), static_cast<const int32_t*>(tiles), \
        static_cast<const int32_t*>(flags), static_cast<int32_t*>(part_i),  \
        static_cast<float*>(st), static_cast<float*>(part_dt), keep

