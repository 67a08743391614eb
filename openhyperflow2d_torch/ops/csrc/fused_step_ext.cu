// The extended forms of the fused solver iteration for Hopper (sm_90a),
// float32: the same stages as fused_step.cu on the decks that need more of
// core/step and core/physics than its flat forms carry:
//
//   gfc_axi_kernel<BODY>          gfc of gfc_kernel on a deck whose one
//                                 extended feature of gfc is axisymmetry
//   gfc_ext_kernel<BODY>          gfc of gfc_kernel / gfc_closure_kernel /
//   gfc_closure_ext_kernel<BODY>  gfc_euler_kernel, on an axisymmetric
//   gfc_euler_ext_kernel<BODY>    deck (ExtConsts::axi) or one with
//                                 external sources (::src)
//   pass12_axi_kernel<BODY>       pass12 of pass12_kernel on a deck whose
//                                 one extended feature is axisymmetry
//   pass12_ext_kernel<BODY>       pass12 of pass12_kernel on a deck with
//                                 sources, d2*-NULL soft BCs or NRBC
//
// (A deck with moving-wall sources runs fused_step_mw.cu's forms of these
// on its general and dual launches, through the same entries, and the
// all-features forms' spec bodies on its spec tiles.)
//
// They replace the same TPU kernel as the flat forms
// (openhyperflow2d_tpu/ops/pallas_step.py _machinery.make_fused, general
// body :456-722, spec body :719-720, dual body :702-718, scatter form
// :506-510), whose body calls core/step.gfc and pass12 with the branches
// these forms add: the d2 halo of 3 (:79-99), the source plane as a kernel
// input (:445, 497, 561), and y_r / jp1 rebuilt in the kernel from the
// window's rows (:431).  What they add (gfc_node's and pass12_node's EXT
// flag, fused_step.cuh):
//
// * axisymmetric flow: gfc computes the node radius y_r = (j + 0.5) dy
//   from its column (the strips are X strips, so j is the global column on
//   every path), adds V / y_r to the dilatation and U / y_r to k-eps's
//   production, and writes the radial fluxes F that are not copies of its
//   fluxes (the hoop stress in the V equation, the k, eps and SA add-ons)
//   to 3 of 9 more scratch planes (SCR_F + 2, 7, 8); pass12 adds dt / dy
//   F / (j + 1), correctly rounded as JAX's division, from one reciprocal
//   of j + 1 a node (div_jp1).  It reads F at the node from those three
//   planes: F[0], F[3..6] are B[0], B[3..6] and F[1] is A[2], the same
//   floats (radial_flux), so their six planes stay unwritten;
// * external sources: pass12 reads the 9-plane source field at the node
//   (Src dt of pass 1, every body), and gfc reads its planes 7 and 8, which
//   stand as the turbulence sources where no closure writes them;
// * d2*-NULL soft BCs (pass12's general and dual bodies): where dx2 (dy2)
//   is set, the flux difference is the mean of the two neighbours' own,
//   which the node computes from their ctx words, flags and the scratch's
//   A (B) at +-2 (nb_flux_x, nb_flux_y); the strips' halo is 3 a K;
// * NRBC (the same bodies): beta_min = nrbc_beta0 on CT_NONREFLECTED
//   nodes.
//
// No spec tile holds a d2 or NRBC node (generic_interior_map excludes any
// node with an extra CT bit), so the spec bodies carry only F and Src.
// gfc and pass12 come in two feature forms fixed at compile time (XF_AXI,
// XF_ALL in fused_step.cuh), which hf2d_gfc_ext and hf2d_pass12_ext pick
// from the flags: the axisymmetric-only forms carry no source code (and
// pass12's no d2 or NRBC code; the timed axisymmetric decks), the
// all-features forms test each flag at run time.  d2 and NRBC are
// pass12's alone, so gfc's axisymmetric-only form runs the d2/NRBC deck
// too; the closures' and the Euler gfc keep one (all-features) form each.
// Every extended gfc but the Euler one (4 lookups a node) reads the
// chemistry tables' slopes, computed once per table on the host, from
// shared memory (stage_chem_coef, coef_lookup), where table_lookup's
// twelve lookups a node are a chain of dependent loads and IEEE
// divisions.
// The flat forms keep their symbols and code: a deck without these
// features launches fused_step.cu's kernels (ops/fused_step.py gfc_ext,
// pass12_ext).
//
// What bounds them on an H100: memory traffic, as the flat forms, plus
// 12 bytes a node for gfc's F write and 12 for pass12's F read (F[2],
// F[7], F[8]; the other six are A and B floats) on an axisymmetric deck,
// and 36 for pass12's Src read and 8 for gfc's on a deck with sources; d2
// and NRBC read a few more words at their (boundary) nodes.  PERF.md keeps
// their times.
#include "fused_step.cuh"

// Every extended gfc at 3 CTAs an SM, as gfc_closure_ext_kernel: without
// the bound ptxas gave the spec body 64 registers and 4 CTAs an SM with a
// spill, and the general bodies larger spills, and on an H100
// gfc_axi_kernel ran 1.005-1.05x and gfc_euler_ext_kernel 1.04-1.06x as
// long as with it (PERF.md).

template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
gfc_axi_kernel(HF2D_GFC_PARAMS(ExtConsts), const float* __restrict__ srcp) {
    HF2D_COEF
    gfc_tile<BODY, false, false, XF_AXI>(HF2D_GFC_FORWARD, srcp,
                                         HF2D_COEF_PTR);
}

template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
gfc_ext_kernel(HF2D_GFC_PARAMS(ExtConsts), const float* __restrict__ srcp) {
    HF2D_COEF
    gfc_tile<BODY, false, false, XF_ALL>(HF2D_GFC_FORWARD, srcp,
                                         HF2D_COEF_PTR);
}

// 3 CTAs an SM, as gfc_closure_kernel: at 80 registers the general and
// dual bodies spill 48 and 72 bytes, and ran 1.51x and 1.04x as fast on
// an H100 as at 2 CTAs (99-100 registers, no spill); the spec body takes
// 80 registers and spills 24 bytes with or without the bound, and at 2
// CTAs (85 registers) ran 1.18x slower
template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
gfc_closure_ext_kernel(HF2D_GFC_PARAMS(ExtConsts),
                       const float* __restrict__ srcp) {
    HF2D_COEF
    gfc_tile<BODY, false, true, XF_ALL>(HF2D_GFC_FORWARD, srcp,
                                        HF2D_COEF_PTR);
}

template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
gfc_euler_ext_kernel(HF2D_GFC_PARAMS(ExtConsts),
                     const float* __restrict__ srcp) {
    gfc_tile<BODY, true, false, XF_ALL>(HF2D_GFC_FORWARD, srcp);
}
#undef HF2D_GFC_PARAMS
#undef HF2D_GFC_FORWARD

// pass12's extended forms, each with the budget of pass12_kernel (3 CTAs
// an SM): pass12_axi_kernel is the axisymmetric-only form (XF_AXI: F /
// (j + 1) and no other feature's code), pass12_ext_kernel the
// all-features form (XF_ALL, each feature tested at run time).
#define HF2D_PASS12_EXT_PARAMS                                               \
    const ExtConsts c, const float* __restrict__ cin,                       \
        float* __restrict__ cout, const float* __restrict__ scr,            \
        const int8_t* __restrict__ idn, const int32_t* __restrict__ ctxw,   \
        const float* __restrict__ dtp, const float* __restrict__ aux,       \
        const int32_t* __restrict__ tiles,                                  \
        const int32_t* __restrict__ flags, float* __restrict__ part_f,      \
        const float* __restrict__ srcp
template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
pass12_axi_kernel(HF2D_PASS12_EXT_PARAMS) {
    __shared__ float red[TILE_X][NQ];
    pass12_tile<BODY, XF_AXI>(c, cin, cout, scr, idn, ctxw, dtp, aux, tiles,
                              flags, part_f, red, srcp);
}

template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
pass12_ext_kernel(HF2D_PASS12_EXT_PARAMS) {
    __shared__ float red[TILE_X][NQ];
    pass12_tile<BODY, XF_ALL>(c, cin, cout, scr, idn, ctxw, dtp, aux, tiles,
                              flags, part_f, red, srcp);
}
#undef HF2D_PASS12_EXT_PARAMS

// The feature form of pass12 a deck's flags call for (ops/fused_step.py
// pass12_form mirrors it): the axisymmetric-only form where axisymmetry is
// the one feature, the all-features form where the deck has sources, d2
// or NRBC, and on a moving-wall deck's spec tiles (its other launches run
// fused_step_mw.cu's form); -1 (no form: such a deck runs pass12_kernel)
// without any.
static int pass12_form(const ExtConsts& c) {
    if (c.src || c.d2x || c.d2y || c.nrbc || c.wall_src) return XF_ALL;
    return c.axi ? XF_AXI : -1;
}

// The same of gfc_ext_kernel's feature forms (ops/fused_step.py gfc_form):
// the all-features form with sources or on a moving-wall deck's spec
// tiles, else the axisymmetric-only form on an axisymmetric deck (d2 and
// NRBC are pass12's alone); -1 without either (such a deck runs
// gfc_kernel).
static int gfc_form(const ExtConsts& c) {
    if (c.src || c.wall_src) return XF_ALL;
    return c.axi ? XF_AXI : -1;
}

// The division check of div_jp1 (chip_smoke.py): for each a of as[0, n)
// and each jp1 in [jp1_lo, jp1_hi], div_jp1 against __fdiv_rn bit for bit;
// the count of differences is added to bad[0] and the last difference
// found is left in bad[1] (a's bits << 32 | jp1).  With `out`, the
// quotient of a[i] by jp1 is also written to out[(jp1 - jp1_lo) n + i].
__global__ void __launch_bounds__(CTA_THREADS)
div_jp1_check_kernel(const float* __restrict__ as, int n, int jp1_lo,
                     int jp1_hi, float* __restrict__ out,
                     unsigned long long* __restrict__ bad) {
    const int i = blockIdx.x * CTA_THREADS + threadIdx.x;
    unsigned long long count = 0, last = 0;
    if (i < n) {
        const float a = as[i];
        for (int b = jp1_lo; b <= jp1_hi; ++b) {
            const float jp1 = static_cast<float>(b);
            const float q = div_jp1(a, jp1, __frcp_rn(jp1));
            if (__float_as_uint(q) != __float_as_uint(__fdiv_rn(a, jp1))) {
                ++count;
                last = (static_cast<unsigned long long>(__float_as_uint(a))
                        << 32) | static_cast<unsigned>(b);
            }
            if (out != nullptr)
                out[static_cast<size_t>(b - jp1_lo) * n + i] = q;
        }
    }
    if (count) {
        atomicAdd(bad, count);
        atomicExch(bad + 1, last);
    }
}

// ---------------------------------------------------------------------------
// C entry points: hf2d_gfc / hf2d_pass12 of fused_step.cu with the source
// field `src` (9 planes of the grid; read only where ExtConsts::src) last
// but the stream; `consts` points to an ExtConsts.  No staged body.  A deck
// with moving-wall sources (ExtConsts::wall_src) runs the moving-wall forms
// of fused_step_mw.cu on its general and dual launches, whatever its other
// features, and the all-features spec body on its spec tiles (pass12_form,
// gfc_form).
// ---------------------------------------------------------------------------
extern "C" {

int hf2d_gfc_mw(int body, const void* consts, const void* cin, void* cout,
                void* scr, const void* idn, const void* mf,
                const void* ctxw, const void* chemf, const void* chemi,
                const void* dt, const void* aux, const void* tiles,
                int n_tiles, const void* flags, void* part_i,
                const void* src, void* stream);
int hf2d_pass12_mw(int body, const void* consts, const void* cin,
                   void* cout, const void* scr, const void* idn,
                   const void* ctxw, const void* dt, const void* aux,
                   const void* tiles, int n_tiles, const void* flags,
                   void* part_f, const void* src, void* stream);

int hf2d_gfc_ext(int body, const void* consts, const void* cin, void* cout,
                 void* scr, const void* idn, const void* mf,
                 const void* ctxw, const void* chemf, const void* chemi,
                 const void* dt, const void* aux, const void* tiles,
                 int n_tiles, const void* flags, void* part_i,
                 const void* src, void* stream) {
    if (n_tiles == 0) return 0;
    const ExtConsts c = *static_cast<const ExtConsts*>(consts);
    if (c.wall_src && body != BODY_SPEC)
        return hf2d_gfc_mw(body, consts, cin, cout, scr, idn, mf, ctxw,
                           chemf, chemi, dt, aux, tiles, n_tiles, flags,
                           part_i, src, stream);
    const dim3 block(TILE_Y, TILE_X);
    auto s = static_cast<cudaStream_t>(stream);
#define HF2D_GFC_EXT_ARGS                                                    \
    c, static_cast<const float*>(cin), static_cast<float*>(cout),           \
        static_cast<float*>(scr), static_cast<const int8_t*>(idn),          \
        static_cast<const float*>(mf), static_cast<const int32_t*>(ctxw),   \
        static_cast<const float*>(chemf),                                   \
        static_cast<const int32_t*>(chemi), static_cast<const float*>(dt), \
        static_cast<const float*>(aux), static_cast<const int32_t*>(tiles), \
        static_cast<const int32_t*>(flags), static_cast<int32_t*>(part_i),  \
        static_cast<const float*>(src)
    const int form = gfc_form(c);
    if ((c.euler && c.closure) || form < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    else if (c.closure && body == BODY_GENERAL)
        gfc_closure_ext_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (c.closure && body == BODY_SPEC)
        gfc_closure_ext_kernel<BODY_SPEC><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (c.closure && body == BODY_DUAL)
        gfc_closure_ext_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (c.closure)
        return static_cast<int>(cudaErrorInvalidValue);
    else if (c.euler && body == BODY_GENERAL)
        gfc_euler_ext_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (c.euler && body == BODY_DUAL)
        gfc_euler_ext_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (c.euler)
        return static_cast<int>(cudaErrorInvalidValue);
    else if (form == XF_AXI && body == BODY_GENERAL)
        gfc_axi_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (form == XF_AXI && body == BODY_SPEC)
        gfc_axi_kernel<BODY_SPEC><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (form == XF_AXI && body == BODY_DUAL)
        gfc_axi_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (form == XF_ALL && body == BODY_GENERAL)
        gfc_ext_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (form == XF_ALL && body == BODY_SPEC)
        gfc_ext_kernel<BODY_SPEC><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else if (form == XF_ALL && body == BODY_DUAL)
        gfc_ext_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_EXT_ARGS);
    else
        return static_cast<int>(cudaErrorInvalidValue);
#undef HF2D_GFC_EXT_ARGS
    return static_cast<int>(cudaGetLastError());
}

int hf2d_pass12_ext(int body, const void* consts, const void* cin,
                    void* cout, const void* scr, const void* idn,
                    const void* ctxw, const void* dt, const void* aux,
                    const void* tiles, int n_tiles, const void* flags,
                    void* part_f, const void* src, void* stream) {
    if (n_tiles == 0) return 0;
    const ExtConsts c = *static_cast<const ExtConsts*>(consts);
    if (c.wall_src && body != BODY_SPEC)
        return hf2d_pass12_mw(body, consts, cin, cout, scr, idn, ctxw, dt,
                              aux, tiles, n_tiles, flags, part_f, src,
                              stream);
    const dim3 block(TILE_Y, TILE_X);
    auto s = static_cast<cudaStream_t>(stream);
#define HF2D_PASS12_EXT_ARGS                                                 \
    c, static_cast<const float*>(cin), static_cast<float*>(cout),           \
        static_cast<const float*>(scr), static_cast<const int8_t*>(idn),    \
        static_cast<const int32_t*>(ctxw), static_cast<const float*>(dt),   \
        static_cast<const float*>(aux), static_cast<const int32_t*>(tiles), \
        static_cast<const int32_t*>(flags), static_cast<float*>(part_f),    \
        static_cast<const float*>(src)
    const int form = pass12_form(c);
    if (form == XF_AXI && body == BODY_GENERAL)
        pass12_axi_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_EXT_ARGS);
    else if (form == XF_AXI && body == BODY_SPEC)
        pass12_axi_kernel<BODY_SPEC><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_EXT_ARGS);
    else if (form == XF_AXI && body == BODY_DUAL)
        pass12_axi_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_EXT_ARGS);
    else if (form == XF_ALL && body == BODY_GENERAL)
        pass12_ext_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_EXT_ARGS);
    else if (form == XF_ALL && body == BODY_SPEC)
        pass12_ext_kernel<BODY_SPEC><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_EXT_ARGS);
    else if (form == XF_ALL && body == BODY_DUAL)
        pass12_ext_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_EXT_ARGS);
    else
        return static_cast<int>(cudaErrorInvalidValue);
#undef HF2D_PASS12_EXT_ARGS
    return static_cast<int>(cudaGetLastError());
}

// div_jp1_check_kernel over as[0, n) and jp1 in [jp1_lo, jp1_hi] (out:
// null, or (jp1_hi - jp1_lo + 1) x n floats; bad: two zeroed uint64).
int hf2d_div_jp1_check(const void* as, int n, int jp1_lo, int jp1_hi,
                       void* out, void* bad, void* stream) {
    if (n <= 0 || jp1_lo < 1 || jp1_hi < jp1_lo)
        return static_cast<int>(cudaErrorInvalidValue);
    div_jp1_check_kernel<<<(n + CTA_THREADS - 1) / CTA_THREADS, CTA_THREADS,
                           0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(as), n, jp1_lo, jp1_hi,
        static_cast<float*>(out), static_cast<unsigned long long*>(bad));
    return static_cast<int>(cudaGetLastError());
}

// The kernel of stage 5 (gfc_ext, the all-features form), 6
// (gfc_closure_ext), 7 (gfc_euler_ext), 8 (pass12_ext, the all-features
// form), 9 (pass12_axi) or 10 (gfc_axi) and body
// (BODY_GENERAL, BODY_SPEC or BODY_DUAL; the Euler form has no spec body),
// for fused_step.cu's hf2d_kernel_info; null for any other.
const void* hf2d_ext_kernel_fn(int stage, int body) {
    if (body != BODY_GENERAL && body != BODY_SPEC && body != BODY_DUAL)
        return nullptr;
    const bool spec = body == BODY_SPEC, dual = body == BODY_DUAL;
    switch (stage) {
        case 5:
            return spec ? (const void*)gfc_ext_kernel<BODY_SPEC>
                 : dual ? (const void*)gfc_ext_kernel<BODY_DUAL>
                        : (const void*)gfc_ext_kernel<BODY_GENERAL>;
        case 6:
            return spec ? (const void*)gfc_closure_ext_kernel<BODY_SPEC>
                 : dual ? (const void*)gfc_closure_ext_kernel<BODY_DUAL>
                        : (const void*)gfc_closure_ext_kernel<BODY_GENERAL>;
        case 7:
            return spec ? nullptr
                 : dual ? (const void*)gfc_euler_ext_kernel<BODY_DUAL>
                        : (const void*)gfc_euler_ext_kernel<BODY_GENERAL>;
        case 8:
            return spec ? (const void*)pass12_ext_kernel<BODY_SPEC>
                 : dual ? (const void*)pass12_ext_kernel<BODY_DUAL>
                        : (const void*)pass12_ext_kernel<BODY_GENERAL>;
        case 9:
            return spec ? (const void*)pass12_axi_kernel<BODY_SPEC>
                 : dual ? (const void*)pass12_axi_kernel<BODY_DUAL>
                        : (const void*)pass12_axi_kernel<BODY_GENERAL>;
        case 10:
            return spec ? (const void*)gfc_axi_kernel<BODY_SPEC>
                 : dual ? (const void*)gfc_axi_kernel<BODY_DUAL>
                        : (const void*)gfc_axi_kernel<BODY_GENERAL>;
        default:
            return nullptr;
    }
}

}  // extern "C"
