// The moving-wall forms of the fused solver iteration for Hopper (sm_90a),
// float32: the extended forms of fused_step_ext.cu with the moving-wall
// sources (SolverParams.isSrcAdd) compiled in (XF_MW of fused_step.cuh),
// and pass12's flat form of fused_step.cu with them (XF_MW_FLAT):
//
//   gfc_mw_kernel<BODY>          gfc of gfc_ext_kernel /
//   gfc_closure_mw_kernel<BODY>  gfc_closure_ext_kernel /
//   gfc_euler_mw_kernel<BODY>    gfc_euler_ext_kernel on a deck with
//                                moving-wall sources
//   pass12_mw_kernel<BODY>       pass12 of pass12_ext_kernel on such a deck
//   pass12_mw_flat_kernel<BODY>  pass12 of pass12_kernel on a deck whose
//                                one extended feature is the moving-wall
//                                sources (mw_flat)
//
// BODY is the general or the dual body: no spec tile holds a wall node,
// and in a spec body the moving-wall code compiles away, so a moving-wall
// deck's spec tiles run the all-features forms' spec bodies
// (fused_step_ext.cu, whose entries route them there).  Every gfc runs
// its moving-wall form on every moving-wall deck of its family, whatever
// its other features.
//
// They replace the same TPU kernel as the other forms
// (openhyperflow2d_tpu/ops/pallas_step.py _machinery.make_fused, general
// body :456-722, spec body :719-720, dual body :702-718), whose body runs
// core/physics.fill_node with the wall planes BGX, BGY, Uw and Vw staged
// (:392-400) and so the moving-wall branch of fill_node (physics.py
// :176-192) wherever isSrcAdd is set.  At a no-slip wall node gfc takes
// the velocity before the no-slip overwrite and writes
//
//   SrcAdd[rhoU] = BGX (U - Uw) rho,  SrcAdd[rhoV] = BGY (V - Vw) rho,
//   SrcAdd[rho] = SrcAdd[rhoU] / dx + SrcAdd[rhoV] / dy,
//   SrcAdd[rhoY_c] = SrcAdd[rho] Y_c  (c = fuel, ox, cp)
//
// into six scratch planes of their own (SCR_MW..), at the wall nodes
// alone; pass12 adds them to pass 1 at the node, beside the folded heat
// source of the energy equation.  The terms are node-local: no new halo.
// The kernel path runs uniform meshes only (the node's dx and dy are the
// deck's).  Every other feature is the all-features form's, tested at run
// time (axisymmetry, sources, d2*-NULL, NRBC) in the XF_MW forms.
// pass12's XF_MW_FLAT form carries none of that: no axisymmetric, source,
// d2 or NRBC code, no collapse of its own node, no j + 1 or its
// reciprocal, no reads of the neighbours' ctx words or scratch; it takes
// the flat kernels' Consts.  pass12_mw pays for those features on the
// decks that use none of them (the combustor, the cylinders, a free-wall
// channel): its general launch over one wave of tiles took about 2.5x the
// flat pass12 chain's time on an H100 (PERF.md).  gfc keeps its
// all-features moving-wall form there: a flat one ran no faster (PERF.md).
// A translation unit of its own: the forms the other decks launch keep
// their code, and nvcc builds it beside the others.
//
// What bounds them on an H100: their forms' traffic (the all-features
// forms', or the flat pass12's for XF_MW_FLAT) plus 24 bytes a no-slip
// wall node for gfc's write and 24 for pass12's read.  PERF.md keeps their
// times.
#include "fused_step.cuh"

// each at 3 CTAs an SM, as its all-features form
template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
gfc_mw_kernel(HF2D_GFC_PARAMS(ExtConsts), const float* __restrict__ srcp) {
    HF2D_COEF
    gfc_tile<BODY, false, false, XF_MW>(HF2D_GFC_FORWARD, srcp,
                                        HF2D_COEF_PTR);
}

template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
gfc_closure_mw_kernel(HF2D_GFC_PARAMS(ExtConsts),
                      const float* __restrict__ srcp) {
    HF2D_COEF
    gfc_tile<BODY, false, true, XF_MW>(HF2D_GFC_FORWARD, srcp,
                                       HF2D_COEF_PTR);
}

template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
gfc_euler_mw_kernel(HF2D_GFC_PARAMS(ExtConsts),
                    const float* __restrict__ srcp) {
    gfc_tile<BODY, true, false, XF_MW>(HF2D_GFC_FORWARD, srcp);
}
#undef HF2D_GFC_PARAMS
#undef HF2D_GFC_FORWARD

template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
pass12_mw_kernel(const ExtConsts c, const float* __restrict__ cin,
                 float* __restrict__ cout, const float* __restrict__ scr,
                 const int8_t* __restrict__ idn,
                 const int32_t* __restrict__ ctxw,
                 const float* __restrict__ dtp,
                 const float* __restrict__ aux,
                 const int32_t* __restrict__ tiles,
                 const int32_t* __restrict__ flags,
                 float* __restrict__ part_f, const float* __restrict__ srcp) {
    __shared__ float red[TILE_X][NQ];
    pass12_tile<BODY, XF_MW>(c, cin, cout, scr, idn, ctxw, dtp, aux, tiles,
                             flags, part_f, red, srcp);
}

// The general body keeps all 27 partials of a node to the end of the tile
// (ArrayAcc, pass12_tile), as the flat general body: with WarpAcc (no
// spill, against 16 B spilled) it ran 1.06x as long on an H100 (PERF.md).
template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
pass12_mw_flat_kernel(const Consts c, const float* __restrict__ cin,
                      float* __restrict__ cout,
                      const float* __restrict__ scr,
                      const int8_t* __restrict__ idn,
                      const int32_t* __restrict__ ctxw,
                      const float* __restrict__ dtp,
                      const float* __restrict__ aux,
                      const int32_t* __restrict__ tiles,
                      const int32_t* __restrict__ flags,
                      float* __restrict__ part_f) {
    __shared__ float red[TILE_X][NQ];
    pass12_tile<BODY, XF_MW_FLAT>(
        c, cin, cout, scr, idn, ctxw, dtp, aux, tiles, flags, part_f, red);
}

// ---------------------------------------------------------------------------
// Entries: hf2d_gfc_ext / hf2d_pass12_ext (fused_step_ext.cu) hand the
// general and dual launches of a deck with ExtConsts::wall_src to these,
// with their own arguments; pass12's launches the flat form where mw_flat
// takes the deck, else the all-features one.
// ---------------------------------------------------------------------------
extern "C" {

int hf2d_gfc_mw(int body, const void* consts, const void* cin, void* cout,
                void* scr, const void* idn, const void* mf,
                const void* ctxw, const void* chemf, const void* chemi,
                const void* dt, const void* aux, const void* tiles,
                int n_tiles, const void* flags, void* part_i,
                const void* src, void* stream) {
    const ExtConsts c = *static_cast<const ExtConsts*>(consts);
    const dim3 block(TILE_Y, TILE_X);
    auto s = static_cast<cudaStream_t>(stream);
#define HF2D_GFC_MW_ARGS                                                     \
    c, static_cast<const float*>(cin), static_cast<float*>(cout),           \
        static_cast<float*>(scr), static_cast<const int8_t*>(idn),          \
        static_cast<const float*>(mf), static_cast<const int32_t*>(ctxw),   \
        static_cast<const float*>(chemf),                                   \
        static_cast<const int32_t*>(chemi), static_cast<const float*>(dt), \
        static_cast<const float*>(aux), static_cast<const int32_t*>(tiles), \
        static_cast<const int32_t*>(flags), static_cast<int32_t*>(part_i),  \
        static_cast<const float*>(src)
    if (!c.wall_src || (c.euler && c.closure))
        return static_cast<int>(cudaErrorInvalidValue);
    else if (c.closure && body == BODY_GENERAL)
        gfc_closure_mw_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_MW_ARGS);
    else if (c.closure && body == BODY_DUAL)
        gfc_closure_mw_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_MW_ARGS);
    else if (c.closure)
        return static_cast<int>(cudaErrorInvalidValue);
    else if (c.euler && body == BODY_GENERAL)
        gfc_euler_mw_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_MW_ARGS);
    else if (c.euler && body == BODY_DUAL)
        gfc_euler_mw_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_MW_ARGS);
    else if (c.euler)
        return static_cast<int>(cudaErrorInvalidValue);
    else if (body == BODY_GENERAL)
        gfc_mw_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_MW_ARGS);
    else if (body == BODY_DUAL)
        gfc_mw_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_MW_ARGS);
    else
        return static_cast<int>(cudaErrorInvalidValue);
#undef HF2D_GFC_MW_ARGS
    return static_cast<int>(cudaGetLastError());
}

int hf2d_pass12_mw(int body, const void* consts, const void* cin,
                   void* cout, const void* scr, const void* idn,
                   const void* ctxw, const void* dt, const void* aux,
                   const void* tiles, int n_tiles, const void* flags,
                   void* part_f, const void* src, void* stream) {
    const ExtConsts c = *static_cast<const ExtConsts*>(consts);
    const dim3 block(TILE_Y, TILE_X);
    auto s = static_cast<cudaStream_t>(stream);
#define HF2D_PASS12_MW_ARGS                                                  \
    c, static_cast<const float*>(cin), static_cast<float*>(cout),           \
        static_cast<const float*>(scr), static_cast<const int8_t*>(idn),    \
        static_cast<const int32_t*>(ctxw), static_cast<const float*>(dt),   \
        static_cast<const float*>(aux), static_cast<const int32_t*>(tiles), \
        static_cast<const int32_t*>(flags), static_cast<float*>(part_f),    \
        static_cast<const float*>(src)
#define HF2D_PASS12_MW_FLAT_ARGS                                             \
    static_cast<const Consts&>(c), static_cast<const float*>(cin),          \
        static_cast<float*>(cout), static_cast<const float*>(scr),          \
        static_cast<const int8_t*>(idn), static_cast<const int32_t*>(ctxw), \
        static_cast<const float*>(dt), static_cast<const float*>(aux),      \
        static_cast<const int32_t*>(tiles),                                 \
        static_cast<const int32_t*>(flags), static_cast<float*>(part_f)
    if (!c.wall_src)
        return static_cast<int>(cudaErrorInvalidValue);
    else if (mw_flat(c) && body == BODY_GENERAL)
        pass12_mw_flat_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_MW_FLAT_ARGS);
    else if (mw_flat(c) && body == BODY_DUAL)
        pass12_mw_flat_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_MW_FLAT_ARGS);
    else if (mw_flat(c))
        return static_cast<int>(cudaErrorInvalidValue);
    else if (body == BODY_GENERAL)
        pass12_mw_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_MW_ARGS);
    else if (body == BODY_DUAL)
        pass12_mw_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_MW_ARGS);
    else
        return static_cast<int>(cudaErrorInvalidValue);
#undef HF2D_PASS12_MW_ARGS
#undef HF2D_PASS12_MW_FLAT_ARGS
    return static_cast<int>(cudaGetLastError());
}

// The kernel of stage 11 (gfc_mw), 12 (gfc_closure_mw), 13 (gfc_euler_mw),
// 14 (pass12_mw) or 19 (pass12_mw_flat) and body (BODY_GENERAL or
// BODY_DUAL), for fused_step.cu's hf2d_kernel_info; null for any other.
const void* hf2d_mw_kernel_fn(int stage, int body) {
    if (body != BODY_GENERAL && body != BODY_DUAL) return nullptr;
    const bool dual = body == BODY_DUAL;
    switch (stage) {
        case 11:
            return dual ? (const void*)gfc_mw_kernel<BODY_DUAL>
                        : (const void*)gfc_mw_kernel<BODY_GENERAL>;
        case 12:
            return dual ? (const void*)gfc_closure_mw_kernel<BODY_DUAL>
                        : (const void*)gfc_closure_mw_kernel<BODY_GENERAL>;
        case 13:
            return dual ? (const void*)gfc_euler_mw_kernel<BODY_DUAL>
                        : (const void*)gfc_euler_mw_kernel<BODY_GENERAL>;
        case 14:
            return dual ? (const void*)pass12_mw_kernel<BODY_DUAL>
                        : (const void*)pass12_mw_kernel<BODY_GENERAL>;
        case 19:
            return dual ? (const void*)pass12_mw_flat_kernel<BODY_DUAL>
                        : (const void*)pass12_mw_flat_kernel<BODY_GENERAL>;
        default:
            return nullptr;
    }
}

}  // extern "C"
