// The closures' forms of gfc for Hopper (sm_90a), float32: gfc of
// gfc_kernel on the flat NS decks whose turbulence closure is not standard
// k-eps (ops/fused_step.py is_closure), in forms fixed at compile time by
// the closure families they carry (FAM of fused_step.cuh):
//
//   gfc_closure_kernel<BODY>   every family, each tested at run time
//                              (FAM_ALL): a deck whose p.models holds more
//                              than one family
//   gfc_keps_var_kernel<BODY>  the k-eps variants (Chien, JL, LSY, RNG)
//   gfc_sa_kernel<BODY>        Spalart-Allmaras
//   gfc_smag_kernel<BODY>      Smagorinsky
//   gfc_prandtl_kernel<BODY>   the Prandtl family (Prandtl, van Driest,
//                              Escudier, Klebanoff)
//
// BODY is the general, spec or dual body, or the general body's state form
// of the chunk's epilogue (BODY_STATE, fused_step.cuh gfc_tile); only k-eps
// nodes make spec tiles (static_ctx spec_supported), so the SA,
// Smagorinsky and Prandtl forms have no spec body.
//
// They replace the TPU kernel of the flat forms
// (openhyperflow2d_tpu/ops/pallas_step.py _machinery.make_fused: general
// body :456-722, spec body :719-720, dual body :702-718), whose body runs
// core/physics.fill_node with _turb_mod_rans (physics.py:299-542) on such
// a deck.  What bounds them on an H100: memory traffic, as the standard
// k-eps bodies (244 bytes a node spec, 300 general, + 4 for the y+ plane
// where van Driest or Chien reads it).  What held them under half of it
// is one thread's chain, as in the other general bodies (fused_step.cu's
// header): every family's code compiled into one body (a 56-byte spill a
// thread at 3 CTAs an SM) and twelve table lookups a node, each a chain
// of dependent loads and IEEE divisions.  So a deck whose p.models holds
// one family runs that family's form, and every form stages the tables'
// coefficient block in shared memory once a CTA (HF2D_COEF,
// stage_chem_coef) and looks its table values up there (mixture_coef: the
// same bits as table_lookup), as the extended forms do.  Every form at 3
// CTAs an SM.  PERF.md keeps their registers, spills and times.
#include "fused_step.cuh"

#define HF2D_CLOSURE_FORM(NAME, FAM)                                         \
    template <int BODY>                                                      \
    __global__ void __launch_bounds__(CTA_THREADS, 3)                        \
    NAME(HF2D_GFC_PARAMS(ClosureConsts)) {                                   \
        HF2D_COEF                                                            \
        gfc_tile<BODY, false, true, XF_FLAT, FAM>(                           \
            HF2D_GFC_FORWARD, nullptr, HF2D_COEF_PTR, st, part_dt, keep);          \
    }
HF2D_CLOSURE_FORM(gfc_closure_kernel, FAM_ALL)
HF2D_CLOSURE_FORM(gfc_keps_var_kernel, MODEL_KEPS)
HF2D_CLOSURE_FORM(gfc_sa_kernel, MODEL_SA)
HF2D_CLOSURE_FORM(gfc_smag_kernel, MODEL_SMAG)
HF2D_CLOSURE_FORM(gfc_prandtl_kernel, MODEL_PRANDTL)
#undef HF2D_CLOSURE_FORM
#undef HF2D_GFC_PARAMS
#undef HF2D_GFC_FORWARD

// The form a deck's constants call for (ops/fused_step.py closure_form
// mirrors it): its one family's, else every family's.
static int closure_family(const ClosureConsts& c) {
    switch (c.models) {
        case MODEL_PRANDTL:
        case MODEL_KEPS:
        case MODEL_SA:
        case MODEL_SMAG:
            return c.models;
        default:
            return FAM_ALL;
    }
}

// Each form: its family, its stage of hf2d_kernel_info, and its bodies'
// kernels (general, dual, the chunk epilogue's state form, spec; no spec
// body but in the forms that carry k-eps).
struct ClosureForm {
    int fam, stage;
    const void *general, *dual, *state, *spec;
};
#define HF2D_FORM(NAME, FAM, STAGE, SPEC)                                    \
    {FAM, STAGE, reinterpret_cast<const void*>(NAME<BODY_GENERAL>),          \
     reinterpret_cast<const void*>(NAME<BODY_DUAL>),                         \
     reinterpret_cast<const void*>(NAME<BODY_STATE>), SPEC}
static const ClosureForm CLOSURE_FORMS[] = {
    HF2D_FORM(gfc_closure_kernel, FAM_ALL, 4,
              reinterpret_cast<const void*>(gfc_closure_kernel<BODY_SPEC>)),
    HF2D_FORM(gfc_keps_var_kernel, MODEL_KEPS, 15,
              reinterpret_cast<const void*>(gfc_keps_var_kernel<BODY_SPEC>)),
    HF2D_FORM(gfc_sa_kernel, MODEL_SA, 16, nullptr),
    HF2D_FORM(gfc_smag_kernel, MODEL_SMAG, 17, nullptr),
    HF2D_FORM(gfc_prandtl_kernel, MODEL_PRANDTL, 18, nullptr)};
#undef HF2D_FORM

// The kernel of `body` in form `f`; null where there is none (a staged
// body, or a spec body the form lacks).
static const void* body_kernel(const ClosureForm& f, int body) {
    return body == BODY_GENERAL ? f.general
         : body == BODY_DUAL    ? f.dual
         : body == BODY_STATE   ? f.state
         : body == BODY_SPEC    ? f.spec
                                : nullptr;
}

extern "C" {

// hf2d_gfc of fused_step.cu on a closure deck (ClosureConsts::closure):
// the arguments of hf2d_gfc and the state form's outputs and plane bits
// (null and 0 but in BODY_STATE); launches the deck's family form (closure_family) over
// `n_tiles` tiles on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a body the form lacks.
int hf2d_gfc_closure(int body, const void* consts, const void* cin,
                     void* cout, void* scr, const void* idn, const void* mf,
                     const void* ctxw, const void* chemf, const void* chemi,
                     const void* dt, const void* aux, const void* tiles,
                     int n_tiles, const void* flags, void* part_i, void* st,
                     void* part_dt, int keep, void* stream) {
    if (n_tiles == 0) return 0;
    ClosureConsts c = *static_cast<const ClosureConsts*>(consts);
    const int fam = closure_family(c);
    const void* fn = nullptr;
    for (const ClosureForm& f : CLOSURE_FORMS)
        if (f.fam == fam) fn = body_kernel(f, body);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&c,    &cin,   &cout,  &scr, &idn,   &mf,
                    &ctxw, &chemf, &chemi, &dt,  &aux,   &tiles,
                    &flags, &part_i, &st,  &part_dt, &keep};
    const cudaError_t err = cudaLaunchKernel(
        fn, dim3(n_tiles), dim3(TILE_Y, TILE_X), args, 0,
        static_cast<cudaStream_t>(stream));
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The kernel of stage 4 (gfc_closure, every family), 15 (gfc_keps_var),
// 16 (gfc_sa), 17 (gfc_smag) or 18 (gfc_prandtl) and body, for
// fused_step.cu's hf2d_kernel_info; null for any other.
const void* hf2d_closure_kernel_fn(int stage, int body) {
    for (const ClosureForm& f : CLOSURE_FORMS)
        if (f.stage == stage) return body_kernel(f, body);
    return nullptr;
}

}  // extern "C"
