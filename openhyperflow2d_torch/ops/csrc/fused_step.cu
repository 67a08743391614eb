// Fused solver iteration for Hopper (sm_90a), float32:
//
//   gfc_kernel<BODY>     gradients -> FillNode2D (k-eps) -> dt field ->
//                        Zeldovich chemistry, one thread per node
//   gfc_euler_kernel     the same stage on Euler decks (ProblemType=0):
//     <BODY>             the general body's Euler form on every tile
//   pass12_kernel<BODY>  pass 1 (blending update) + pass 2 (residual,
//                        blending factor, commit), one thread per node;
//                        on decks with non-adiabatic walls the general
//                        body computes its node's conjugate wall heat
//                        source itself (CalcHeatOnWallSources, "folded")
//   heat_kernel          the same heat stage as a launch of its own (the
//                        separate form), one thread per node of the heat
//                        tiles; no solver path launches it
//   gfc_window_kernel,   the general body of both stages in a second form
//   pass12_window_kernel (BODY_STAGED): persistent CTAs, each tile's
//                        operands staged in shared memory (below); no
//                        solver path launches it
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
// both); with the heat stage gfc also writes lam_eff (4 bytes), and the
// folded pass12 reads Tg at the wall gas nodes and their solid
// neighbours and lam_eff at the gas nodes (a few KB at 2048^2; the
// solids' heat words are among the ctx words it reads anyway).  At
// 2048^2, where 96% of the nodes run the spec body, that is
// about 2 GB per iteration, so about 0.59 ms at 3.35 TB/s is the floor of
// this two-launch form.  The design keeps the neighbor reads in L1/L2 (a CTA is
// an 8 x 32 tile, warps run along the contiguous j axis), keeps the
// per-equation state in registers, and writes partial reductions per tile
// (no atomics, so the diagnostics are deterministic).  The scratch is not
// an input or an output of an iteration: the work of a spec node reads 18
// carry planes, l_min and beta (112 bytes) and writes the 13 primitives, S
// and beta (124), 236 bytes, 0.2840 ms over the 2048^2 combustor's 15,748
// spec tiles.  step_spec_kernel (fused_step_spec.cu) runs both stages of
// the spec tiles in one launch with the scratch of a tile and its ring in
// shared memory, against that bound; on the main path it takes the place
// of gfc_kernel<spec> + pass12_kernel<spec>, which stay for the dual
// body's comparisons and chip_smoke.py's A/B (ops/fused_step.py
// spec_fusable).
//
// The heat stage reads only what gfc wrote (Tg of `cout`, lam_eff of the
// scratch, +-2 around a wall) and writes SrcAdd[rhoE] at the wall gas
// node itself, which only pass12's general body reads, at the node; pass12
// writes S and beta alone.  So a pass12 thread can compute its own node's
// source with no grid-wide sync, where pass 1 of the energy equation adds
// it: the fold keeps it in a register, and the SrcAdd plane's write, its
// read and heat_kernel's launch go (the TPU kernel ran heat inside the
// tile as well).  As its own
// launch, heat_kernel reads the heat ctx word (4 bytes) at every node of
// the heat tiles, and Tg, lam_eff and the SrcAdd write only at the wall
// gas nodes and their solid neighbors: at 2048^2 a few dozen tiles, so its
// time is the launch.  The dual form trades the second launch of each
// stage for one kernel holding both bodies; CTA b runs tile b.  pass12's
// dual body runs at the others' budget, 3 CTAs an SM, with its partials
// reduced over the warp an equation at a time (pass12_kernel below).
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
// The general body replaces the general body of the TPU kernel
// (pallas_step.py:456-722, called at :843) and its scatter form over a
// tile table (:506-510): the general tiles of the single domain's frame,
// of the step deck's remainder off the frame, and of each strip (its
// whole list, or its "edge" and "inner" parts).  Its bound is bytes as
// above: 300 bytes a node for gfc (+4 with the heat stage), 244 for pass12
// (folded, plus heat's reads at the wall nodes; +4 for the SrcAdd plane in
// the separate form).  It has two forms.  BODY_GENERAL, which the solver's paths
// launch, is one thread per node on direct global loads, a CTA per tile.
// It runs at about half its bound on a full frame, and a lone tile takes
// 7-8 us on an H100, 396 tiles (one wave at 3 CTAs an SM) only 2.1x as
// long (PERF.md).  BODY_STAGED tests the reading that the time is a chain
// of dependent loads (the ctx words, then the collapsed neighbour indices,
// then ~40 neighbour loads).  The TPU kernel assembled each tile's window
// in VMEM before computing (pallas_step.py:524-540); BODY_STAGED assembles
// it in shared memory by cp.async, all of a tile's copies issued at once
// and waited for once, on persistent CTAs that each run every G-th tile of
// the list (gfc with the next tile's copies in flight while it computes).
// The node arithmetic is one code (gfc_node/pass12_node read their
// operands through a loader policy), so both forms give the same bits.
// Measured, a lone tile takes as long staged as direct, so the time is
// one thread's instruction chain, and past one wave the staged form's
// extra copies and shared-memory loads make it the slower one.  It stays
// compiled as the A/B candidate of chip_smoke.py, not on a path.
//
// The Euler decks (p.sm != SM_NS) run the general body on every tile: the
// spec body exists for NS + k-eps only (static_ctx.spec_supported), as on
// the TPU.  Their gfc is the general body's Euler form, gfc_euler_kernel
// (T1's non-NS staging, pallas_step.py:405-414): no gradients, no k-eps,
// no viscous stress or heat flux in the fluxes, lam and mu carried (4 of
// the 12 table lookups), and lam_t, which FillNode2D never writes outside
// SM_NS, read from a chunk-constant meta plane (META_LAM_T) where the NS
// body computes mu_t * CP.  It is a kernel of its own (gfc_node's EULER
// flag at compile time), so the NS bodies keep their code, registers and
// 3-CTA budget.  Its bytes a node: the general body's 300 less l_min and
// the 4 int8 flags, which nothing reads without gradients, plus lam_t: 296.
// pass12 has no Euler form: its pass 1 and pass 2 read the fluxes gfc
// wrote, which carry or omit the viscous terms, and nothing else differs
// (core/step.pass12 has no SM_NS branch), so pass12_kernel<general> (and
// <dual>) run Euler decks as they are.
//
// The other turbulence closures (ops/fused_step.py is_closure) run gfc in
// the closures' forms of fused_step_closure.cu (gfc_node's CLOSURE flag
// at compile time swaps the standard k-eps code for `closures`, one form
// a closure family), which hf2d_gfc's closure branch launches
// (hf2d_gfc_closure); they alone take ClosureConsts.  pass12 runs these
// decks as it runs the standard ones: the closures change only what gfc
// writes.
//
// Axisymmetric flow, external sources, d2*-NULL soft BCs and NRBC run the
// extended forms of these kernels (fused_step_ext.cu, a translation unit
// of its own); this file keeps the flat forms' symbols and code.  The
// device code both share (the constants, the loaders, gfc_node,
// pass12_node, the tile bodies) is fused_step.cuh.
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
#include "fused_step.cuh"

// The heat stage as a launch of its own (the separate form): the SrcAdd
// plane at the wall gas nodes of the heat tiles; every other node keeps
// the chunk's zero.
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
    float src;
    if (heat_source(c, cout, scr, ctxw, P, i, j, heat_word(ctxw, P, n), *dtp,
                    src))
        scr[SCR_SRCADD_E * P + n] = src;
}


template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS)
gfc_kernel(HF2D_GFC_PARAMS(Consts)) {
    gfc_tile<BODY, false, false>(HF2D_GFC_FORWARD);
}

// The Euler decks' gfc (BODY_GENERAL or BODY_DUAL): the general body's
// Euler form on every tile.  A kernel of its own, so the NS kernels keep
// their symbols, code and budgets.
template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS)
gfc_euler_kernel(HF2D_GFC_PARAMS(Consts)) {
    gfc_tile<BODY, true, false>(HF2D_GFC_FORWARD);
}
#undef HF2D_GFC_PARAMS
#undef HF2D_GFC_FORWARD

// 3 CTAs an SM (at most 85 registers, so 80) for every body: unbounded,
// ptxas gives the general body 88 registers and so 2 CTAs an SM, which ran
// a full general frame 28% slower on an H100 (PERF.md).  The bodies and
// their partials: pass12_tile (fused_step.cuh).
template <int BODY>
__global__ void __launch_bounds__(CTA_THREADS, 3)
pass12_kernel(const Consts c, const float* __restrict__ cin,
              float* __restrict__ cout, const float* __restrict__ scr,
              const int8_t* __restrict__ idn,
              const int32_t* __restrict__ ctxw,
              const float* __restrict__ dtp, const float* __restrict__ aux,
              const int32_t* __restrict__ tiles,
              const int32_t* __restrict__ flags, float* __restrict__ part_f) {
    __shared__ float red[TILE_X][NQ];
    pass12_tile<BODY>(c, cin, cout, scr, idn, ctxw, dtp, aux, tiles, flags,
                      part_f, red);
}

// ---------------------------------------------------------------------------
// The staged general body (BODY_STAGED): persistent CTAs over the tile
// list, each tile's operands staged in shared memory by cp.async
// (stage_tile).  CTA b runs
// entries b, b + G, b + 2G, ... of `tiles` (G = gridDim.x).  With NBUF = 2
// stages it issues the copies of its next tile before it computes the
// current one, so the next tile's round trip to memory overlaps this
// tile's arithmetic; with NBUF = 1 it issues them after, and the other
// CTAs of its SM (MINB or more) overlap it.  The node arithmetic is
// gfc_node/pass12_node<false>, as in the general body; only where the
// operands come from differs.
// ---------------------------------------------------------------------------
// Wait for the current tile's stage (the next tile's copies, when NBUF is
// 2, stay in flight).
template <int NBUF>
__device__ __forceinline__ void wait_stage() {
    if (NBUF > 1)
        __pipeline_wait_prior(1);
    else
        __pipeline_wait_prior(0);
    __syncthreads();
}

template <int NBUF, int MINB>
__global__ void __launch_bounds__(CTA_THREADS, MINB)
gfc_window_kernel(const Consts c, const float* __restrict__ cin,
                  float* __restrict__ cout, float* __restrict__ scr,
                  const int8_t* __restrict__ idn,
                  const float* __restrict__ mf,
                  const int32_t* __restrict__ ctxw,
                  const float* __restrict__ chemf,
                  const int32_t* __restrict__ chemi,
                  const float* __restrict__ dtp,
                  const float* __restrict__ aux,
                  const int32_t* __restrict__ tiles, int n_tiles,
                  int32_t* __restrict__ part_i) {
    extern __shared__ __align__(16) float smem[];
    constexpr int STAGE = stage_floats<GfcPlanes>();
    const size_t P = static_cast<size_t>(c.X) * c.Y;
    const float dt = *dtp, cfl_scen = aux[1];
    const bool mu_t_iter = aux[2] > F(0.5);
    int e = blockIdx.x;
    stage_tile<GfcPlanes>(c, smem, cin, mf, ctxw, idn, tiles[e]);
    __pipeline_commit();
    for (int k = 0; e < n_tiles; e += gridDim.x, ++k) {
        const int next = e + static_cast<int>(gridDim.x);
        const float* buf = smem + (k % NBUF) * STAGE;
        if (NBUF > 1) {
            if (next < n_tiles)
                stage_tile<GfcPlanes>(c, smem + ((k + 1) % NBUF) * STAGE,
                                      cin, mf, ctxw, idn, tiles[next]);
            __pipeline_commit();
        }
        wait_stage<NBUF>();
        const int tile = tiles[e];
        const int i = (tile / c.nby) * TILE_X + threadIdx.y;
        const int j = (tile % c.nby) * TILE_Y + threadIdx.x;
        bool uns = false, ovr = false;
        if (i < c.X && j < c.Y) {
            uint32_t w[CTX_N_WORDS];
            int8_t id4[4];
            window_ctx<GfcPlanes>(w, id4, buf);
            const WindowSrc<GfcPlanes> src =
                window_src<false, GfcPlanes>(c, buf, mf, w, P, i, j);
            gfc_node<false, false, false>(
                c, src, w, make_stencil<false>(id4),
                GlobalOut{cout, scr, P, src.n}, chemf, chemi, dt, cfl_scen,
                mu_t_iter, uns, ovr);
        }
        // its barrier also frees `buf` for the next copies into it
        gfc_partials(c, i, uns, ovr, tile, part_i);
        if (NBUF == 1 && next < n_tiles) {
            stage_tile<GfcPlanes>(c, smem, cin, mf, ctxw, idn, tiles[next]);
            __pipeline_commit();
        }
    }
}

template <int NBUF, int MINB>
__global__ void __launch_bounds__(CTA_THREADS, MINB)
pass12_window_kernel(const Consts c, const float* __restrict__ cin,
                     float* __restrict__ cout,
                     const float* __restrict__ scr,
                     const int8_t* __restrict__ idn,
                     const int32_t* __restrict__ ctxw,
                     const float* __restrict__ dtp,
                     const float* __restrict__ aux,
                     const int32_t* __restrict__ tiles, int n_tiles,
                     float* __restrict__ part_f) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float red[TILE_X][NQ];
    const WarpAcc acc{red};
    constexpr int STAGE = stage_floats<Pass12Planes>();
    const size_t P = static_cast<size_t>(c.X) * c.Y;
    const float dt = *dtp, beta_scen = aux[0];
    int e = blockIdx.x;
    stage_tile<Pass12Planes>(c, smem, scr, cin, ctxw, idn, tiles[e]);
    __pipeline_commit();
    for (int k = 0; e < n_tiles; e += gridDim.x, ++k) {
        const int next = e + static_cast<int>(gridDim.x);
        const float* buf = smem + (k % NBUF) * STAGE;
        if (NBUF > 1) {
            if (next < n_tiles)
                stage_tile<Pass12Planes>(c, smem + ((k + 1) % NBUF) * STAGE,
                                         scr, cin, ctxw, idn, tiles[next]);
            __pipeline_commit();
        }
        wait_stage<NBUF>();
        const int tile = tiles[e];
        const int i = (tile / c.nby) * TILE_X + threadIdx.y;
        const int j = (tile % c.nby) * TILE_Y + threadIdx.x;
        // every lane runs the node (the warp reduces each equation's
        // partials at once); a lane past the grid's edge reads its tile's
        // clamped copies, stores nothing and counts nothing
        const bool inside = i < c.X && j < c.Y;
        uint32_t w[CTX_N_WORDS];
        int8_t id4[4];
        window_ctx<Pass12Planes>(w, id4, buf);
        const WindowSrc<Pass12Planes> src =
            window_src<false, Pass12Planes>(c, buf, cin, w, P, i, j);
        // the separate form's SrcAdd plane, whatever c.heat_fold says
        pass12_node<false>(c, src, w, make_stencil<false>(id4), cout, dt,
                           beta_scen, inside && i >= c.x0 && i < c.x1, inside,
                           [&]() { return src.at(SCR_SRCADD_E, NB_C); }, acc);
        __syncthreads();
        tile_partials(red, tile, part_f);
        __syncthreads();   // `buf` and `red` are free again
        if (NBUF == 1 && next < n_tiles) {
            stage_tile<Pass12Planes>(c, smem, scr, cin, ctxw, idn,
                                     tiles[next]);
            __pipeline_commit();
        }
    }
}

// The stages a CTA holds and the CTAs an SM must hold, by kernel, chosen
// by measurement on an H100 (PERF.md): gfc double-buffers (68 KB, 2 CTAs
// an SM at 124 registers; at 3 it spills, and ran no faster); pass12 holds
// one 61 KB stage at 3 CTAs an SM (80 registers without spills, since
// WarpAcc keeps its partials out of registers; double-buffered, its 121 KB
// would leave 1 CTA an SM).
constexpr int GFC_NBUF = 2, GFC_MINB = 2;
constexpr int PASS12_NBUF = 1, PASS12_MINB = 3;

template <class Planes, int NBUF>
constexpr size_t window_smem() {
    return NBUF * sizeof(float) * stage_floats<Planes>();
}

// The persistent grid of a window kernel on the current device: the CTAs
// an SM holds at its dynamic shared memory (cudaOccupancyMaxActiveBlocks
// PerMultiprocessor) times the SM count, computed once per device and
// kernel into `cache` (no call here synchronizes the device).  Returns
// the CUDA error.
constexpr int MAX_DEVICES = 64;

static int window_grid(const void* fn, size_t smem, int* cache, int* ctas,
                       int* per_sm) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (cache[2 * dev] == 0) {
        int n = 0, sms = 0;
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, fn, CTA_THREADS, smem);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        cache[2 * dev] = n * sms;
        cache[2 * dev + 1] = n;
    }
    *ctas = cache[2 * dev];
    if (per_sm) *per_sm = cache[2 * dev + 1];
    return 0;
}

// A window kernel with its dynamic shared memory and its grid cache.
struct WindowKernel {
    const void* fn;
    size_t smem;
    int* cache;
    int grid(int* ctas, int* per_sm) const {
        return window_grid(fn, smem, cache, ctas, per_sm);
    }
};

static int g_gfc_grid[2 * MAX_DEVICES], g_pass12_grid[2 * MAX_DEVICES];

static const WindowKernel GFC_WINDOW{
    reinterpret_cast<const void*>(gfc_window_kernel<GFC_NBUF, GFC_MINB>),
    window_smem<GfcPlanes, GFC_NBUF>(), g_gfc_grid};
static const WindowKernel PASS12_WINDOW{
    reinterpret_cast<const void*>(
        pass12_window_kernel<PASS12_NBUF, PASS12_MINB>),
    window_smem<Pass12Planes, PASS12_NBUF>(), g_pass12_grid};

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes by ops/build.py).  Each launches one
// kernel over `n_tiles` tiles of the device tile list `tiles` on `stream`
// and returns cudaGetLastError() (0 without a launch when n_tiles is 0).
// `body` is BODY_*: the staged body launches the window kernel on the
// persistent grid, the others a CTA per tile; the dual body reads no tile
// list (`tiles` may be null, `n_tiles` is every tile) and reads `flags`
// (int32 per tile id, 1 = spec), which the others ignore.  `consts` points
// to a ClosureConsts; every entry but hf2d_gfc reads its Consts part.
// ---------------------------------------------------------------------------
extern "C" {

int hf2d_gfc_closure(int body, const void* consts, const void* cin,
                     void* cout, void* scr, const void* idn, const void* mf,
                     const void* ctxw, const void* chemf, const void* chemi,
                     const void* dt, const void* aux, const void* tiles,
                     int n_tiles, const void* flags, void* part_i,
                     void* stream);   // fused_step_closure.cu

int hf2d_gfc(int body, const void* consts, const void* cin, void* cout,
             void* scr, const void* idn, const void* mf, const void* ctxw,
             const void* chemf, const void* chemi, const void* dt,
             const void* aux, const void* tiles, int n_tiles,
             const void* flags, void* part_i, void* stream) {
    if (n_tiles == 0) return 0;
    const Consts c = *static_cast<const Consts*>(consts);
    const ClosureConsts cc = *static_cast<const ClosureConsts*>(consts);
    const dim3 block(TILE_Y, TILE_X);
    auto s = static_cast<cudaStream_t>(stream);
    if (body == BODY_STAGED && !c.euler && !cc.closure) {
        int ctas = 0;
        const int err = GFC_WINDOW.grid(&ctas, nullptr);
        if (err) return err;
        gfc_window_kernel<GFC_NBUF, GFC_MINB>
            <<<n_tiles < ctas ? n_tiles : ctas, block, GFC_WINDOW.smem, s>>>(
            c, static_cast<const float*>(cin), static_cast<float*>(cout),
            static_cast<float*>(scr), static_cast<const int8_t*>(idn),
            static_cast<const float*>(mf), static_cast<const int32_t*>(ctxw),
            static_cast<const float*>(chemf),
            static_cast<const int32_t*>(chemi), static_cast<const float*>(dt),
            static_cast<const float*>(aux),
            static_cast<const int32_t*>(tiles), n_tiles,
            static_cast<int32_t*>(part_i));
        return static_cast<int>(cudaGetLastError());
    }
#define HF2D_GFC_ARGS(CONSTS)                                                \
    CONSTS, static_cast<const float*>(cin), static_cast<float*>(cout),      \
        static_cast<float*>(scr), static_cast<const int8_t*>(idn),          \
        static_cast<const float*>(mf), static_cast<const int32_t*>(ctxw),   \
        static_cast<const float*>(chemf),                                   \
        static_cast<const int32_t*>(chemi), static_cast<const float*>(dt), \
        static_cast<const float*>(aux), static_cast<const int32_t*>(tiles), \
        static_cast<const int32_t*>(flags), static_cast<int32_t*>(part_i)
    if (c.euler && cc.closure)
        return static_cast<int>(cudaErrorInvalidValue);
    else if (cc.closure)   // the deck's closures' form (no staged body)
        return hf2d_gfc_closure(body, consts, cin, cout, scr, idn, mf, ctxw,
                                chemf, chemi, dt, aux, tiles, n_tiles, flags,
                                part_i, stream);
    else if (c.euler && body == BODY_GENERAL)
        gfc_euler_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_ARGS(c));
    else if (c.euler && body == BODY_DUAL)
        gfc_euler_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_ARGS(c));
    else if (c.euler)   // no spec or staged body on an Euler deck
        return static_cast<int>(cudaErrorInvalidValue);
    else if (body == BODY_GENERAL)
        gfc_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_GFC_ARGS(c));
    else if (body == BODY_SPEC)
        gfc_kernel<BODY_SPEC><<<n_tiles, block, 0, s>>>(HF2D_GFC_ARGS(c));
    else if (body == BODY_DUAL)
        gfc_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(HF2D_GFC_ARGS(c));
    else
        return static_cast<int>(cudaErrorInvalidValue);
#undef HF2D_GFC_ARGS
    return static_cast<int>(cudaGetLastError());
}

int hf2d_pass12(int body, const void* consts, const void* cin, void* cout,
                const void* scr, const void* idn, const void* ctxw,
                const void* dt, const void* aux, const void* tiles,
                int n_tiles, const void* flags, void* part_f, void* stream) {
    if (n_tiles == 0) return 0;
    const Consts c = *static_cast<const Consts*>(consts);
    const dim3 block(TILE_Y, TILE_X);
    auto s = static_cast<cudaStream_t>(stream);
    if (body == BODY_STAGED) {
        int ctas = 0;
        const int err = PASS12_WINDOW.grid(&ctas, nullptr);
        if (err) return err;
        pass12_window_kernel<PASS12_NBUF, PASS12_MINB>
            <<<n_tiles < ctas ? n_tiles : ctas, block, PASS12_WINDOW.smem,
               s>>>(
            c, static_cast<const float*>(cin), static_cast<float*>(cout),
            static_cast<const float*>(scr), static_cast<const int8_t*>(idn),
            static_cast<const int32_t*>(ctxw), static_cast<const float*>(dt),
            static_cast<const float*>(aux),
            static_cast<const int32_t*>(tiles), n_tiles,
            static_cast<float*>(part_f));
        return static_cast<int>(cudaGetLastError());
    }
#define HF2D_PASS12_ARGS                                                     \
    c, static_cast<const float*>(cin), static_cast<float*>(cout),           \
        static_cast<const float*>(scr), static_cast<const int8_t*>(idn),    \
        static_cast<const int32_t*>(ctxw), static_cast<const float*>(dt),   \
        static_cast<const float*>(aux), static_cast<const int32_t*>(tiles), \
        static_cast<const int32_t*>(flags), static_cast<float*>(part_f)
    if (body == BODY_GENERAL)
        pass12_kernel<BODY_GENERAL><<<n_tiles, block, 0, s>>>(
            HF2D_PASS12_ARGS);
    else if (body == BODY_SPEC)
        pass12_kernel<BODY_SPEC><<<n_tiles, block, 0, s>>>(HF2D_PASS12_ARGS);
    else if (body == BODY_DUAL)
        pass12_kernel<BODY_DUAL><<<n_tiles, block, 0, s>>>(HF2D_PASS12_ARGS);
    else
        return static_cast<int>(cudaErrorInvalidValue);
#undef HF2D_PASS12_ARGS
    return static_cast<int>(cudaGetLastError());
}

int hf2d_heat(const void* consts, const void* cout, void* scr,
              const void* ctxw, const void* dt, const void* tiles,
              int n_tiles, void* stream) {
    if (n_tiles == 0) return 0;
    const Consts c = *static_cast<const Consts*>(consts);
    const dim3 block(TILE_Y, TILE_X);
    heat_kernel<<<n_tiles, block, 0, static_cast<cudaStream_t>(stream)>>>(
        c, static_cast<const float*>(cout), static_cast<float*>(scr),
        static_cast<const int32_t*>(ctxw), static_cast<const float*>(dt),
        static_cast<const int32_t*>(tiles));
    return static_cast<int>(cudaGetLastError());
}

const void* hf2d_ext_kernel_fn(int stage, int body);   // fused_step_ext.cu
const void* hf2d_mw_kernel_fn(int stage, int body);    // fused_step_mw.cu
// fused_step_closure.cu
const void* hf2d_closure_kernel_fn(int stage, int body);
const void* hf2d_spec_kernel_fn();   // fused_step_spec.cu

// Launch facts of one kernel, for the measurements of chip_smoke.py:
// out[0] registers a thread, out[1] local memory bytes a thread (spills and
// stack), out[2] static shared memory, out[3] the dynamic shared memory of
// a launch, out[4] the CTAs of CTA_THREADS threads an SM holds at that
// shared memory, out[5] the device's SM count.  `kernel` is 8 * stage +
// body: stage 0 gfc, 1 pass12 (body BODY_*), 2 heat (body ignored), 3
// gfc_euler (BODY_GENERAL or BODY_DUAL); the closures' forms 4 gfc_closure
// (every family), 15 gfc_keps_var, 16 gfc_sa, 17 gfc_smag, 18 gfc_prandtl
// (BODY_GENERAL, BODY_DUAL and, in the forms 4 and 15, BODY_SPEC;
// hf2d_closure_kernel_fn); the extended forms 5 gfc_ext, 6
// gfc_closure_ext, 7 gfc_euler_ext, 8 pass12_ext (the all-features form),
// 9 pass12_axi (the axisymmetric-only form), 10 gfc_axi (gfc's
// axisymmetric-only form) (hf2d_ext_kernel_fn); the moving-wall forms 11
// gfc_mw, 12 gfc_closure_mw, 13 gfc_euler_mw, 14 pass12_mw, 19
// pass12_mw_flat (hf2d_mw_kernel_fn); 20 step_spec_kernel (body ignored;
// hf2d_spec_kernel_fn).
int hf2d_kernel_info(int kernel, int* out) {
    const void* fn = nullptr;
    const int stage = kernel / 8, body = kernel % 8;
    size_t dyn = 0;
    int ctas = 0, per_sm = 0, err = 0;
    if (stage > 20 || (stage < 2 && body > BODY_STAGED)
        || (stage == 3 && body != BODY_GENERAL && body != BODY_DUAL))
        return static_cast<int>(cudaErrorInvalidValue);
    if (stage == 20) {
        fn = hf2d_spec_kernel_fn();
    } else if (stage >= 4) {
        fn = stage == 4 || (stage >= 15 && stage <= 18)
                 ? hf2d_closure_kernel_fn(stage, body)
           : stage >= 11 ? hf2d_mw_kernel_fn(stage, body)
                         : hf2d_ext_kernel_fn(stage, body);
        if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    } else if (stage < 2 && body == BODY_STAGED) {
        const WindowKernel& k = stage == 0 ? GFC_WINDOW : PASS12_WINDOW;
        fn = k.fn;
        dyn = k.smem;
        err = k.grid(&ctas, &per_sm);
        if (err) return err;
    } else if (stage == 0) {
        fn = body == BODY_SPEC ? (const void*)gfc_kernel<BODY_SPEC>
           : body == BODY_DUAL ? (const void*)gfc_kernel<BODY_DUAL>
                               : (const void*)gfc_kernel<BODY_GENERAL>;
    } else if (stage == 1) {
        fn = body == BODY_SPEC ? (const void*)pass12_kernel<BODY_SPEC>
           : body == BODY_DUAL ? (const void*)pass12_kernel<BODY_DUAL>
                               : (const void*)pass12_kernel<BODY_GENERAL>;
    } else if (stage == 3) {
        fn = body == BODY_DUAL ? (const void*)gfc_euler_kernel<BODY_DUAL>
                               : (const void*)gfc_euler_kernel<BODY_GENERAL>;
    } else {
        fn = (const void*)heat_kernel;
    }
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, fn);
    int dev = 0, sms = 0;
    if (e == cudaSuccess && dyn == 0)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                          CTA_THREADS, 0);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = static_cast<int>(attr.sharedSizeBytes);
    out[3] = static_cast<int>(dyn);
    out[4] = per_sm;
    out[5] = sms;
    return 0;
}

const char* hf2d_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
