// step_spec_kernel: one iteration of the spec tiles in one launch, for
// Hopper (sm_90a), float32.  A CTA of 8 x 32 threads runs one spec tile:
//
//   1. gfc (gfc_node<spec>) at the tile's 256 nodes and at its 80-node
//      cross ring (rows i0 - 1 and i0 + 8, columns j0 - 1 and j0 + 32),
//      the scratch values into shared memory;
//   2. a barrier;
//   3. pass12 (pass12_node<spec>) at the tile's nodes from shared memory.
//
// Replaces the TPU kernel openhyperflow2d_tpu/ops/pallas_step.py
// make_fused(body="spec") (line 719-720), whose iteration body (:600-625)
// runs gfc (:613) and then pass12 (:618) on a tile window in VMEM and
// writes back the centre: nothing crosses HBM between the two stages.  The
// port ran that as two launches, gfc_kernel<spec> writing the 29-plane
// scratch and pass12_kernel<spec> reading it back (fused_step.cu); this
// kernel takes the scratch round trip out, as the TPU kernel had it.
//
// What the ring needs: pass12 reads gfc's S at the node and its four
// neighbours, A at i +- 1, B at j +- 1, and the k and eps sources at the
// node (fused_step.cuh pass12_node).  A ring node's tile decides where its
// values come from (the tile plan's edge mask, ops/fused_step.py
// make_tile_plan: bit k set where the neighbour tile across side k is a
// general tile).  In a spec tile it is recomputed here with the spec body,
// from the carry `cin` at distance 2, which no launch of the iteration
// writes.  In a general tile it is read from the scratch gfc<general>
// wrote, which runs before this launch; pass12<general> runs after it.  So
// an iteration is 3 launches (gfc<general>, step_spec_kernel,
// pass12<general>; FusedStep.iteration_launches), and this kernel writes
// to the scratch only what pass12<general> reads of a spec tile: S and A
// at its nodes on an i-edge facing a general tile, S and B on a j-edge
// (the sources are read at the node alone).  Ring nodes are computed,
// never stored.  To `cout` go the tile's 13 primitives, then S and beta;
// the Tg<0 and dt-overrun counts of its nodes go to part_i in gfc's
// layout, the 27 partials to part_f in pass12's, reduced over the warp
// (WarpAcc).  The table values come from the slopes staged once a CTA
// (mixture_coef), as in the extended and the closures' forms.
//
// What bounds it on an H100: memory traffic.  Per node it reads 18 carry
// planes, l_min and beta's 9 planes (112 B) and writes the 13 primitives,
// S and beta (124 B): 236 B a node, 0.2840 ms over the 15,748 spec tiles
// of the 2048^2 combustor at 3.35 TB/s, against 468 B a node for the pair
// (244 + 224).  The border writes add 72 B at the edge nodes of the tiles
// that face a general tile; the ring reads of cin hit the cache.  The
// ring costs 80 more gfc nodes a tile (31%): the arithmetic is about 15x
// below the byte bound, so recomputing it costs less than writing and
// reading back the scratch.  Work mapping: the CTA's 256 threads run the
// tile's nodes, then its threads 0-79 the ring (warps 0 and 1 the two ring
// rows, along j; warp 2 the two ring columns) through a sink that keeps S
// and A or B alone (RingOut), so the ring's gfc drops the table lookups,
// the dt field and the counts.
// Shared memory: S of the tile and the ring (10 x 34 a plane), A of the
// tile and the ring rows (10 x 32), B of the tile and the ring columns (8 x
// 34), the two sources, the 27 x 8 warp partials and the table block:
// 40,560 B, static; 3 CTAs an SM at 80 registers (__launch_bounds__).
//
// Semantics and bits: the same device code as the pair, gfc_node<spec> and
// pass12_node<spec>, through a sink (SpecOut) and a loader (SpecSrc) of
// shared memory, so every expression and its contraction are the pair's;
// mixture_coef gives table_lookup's bits (fused_step.cuh).
#include "fused_step.cuh"

// The edge mask (ops/fused_step.py EDGE_BITS): the neighbour tile across
// the side is a general tile (i - 1, i + 1, j - 1, j + 1).
constexpr int EDGE_XL = 1, EDGE_XR = 2, EDGE_YD = 4, EDGE_YU = 8;

constexpr int SPEC_SX = TILE_X + 2;   // rows of S and A: i0 - 1 .. i0 + 8
constexpr int SPEC_SW = TILE_Y + 2;   // columns of S and B: j0 - 1 .. j0 + 32
constexpr int RING = 2 * (TILE_X + TILE_Y);

struct SpecTile {
    float4 coef4[CHEM_COEF_MAX / 4];     // the table block (stage_chem_coef)
    float s[9][SPEC_SX * SPEC_SW];       // S at (li + 1, lj + 1)
    float a[9][SPEC_SX * TILE_Y];        // A at (li + 1, lj)
    float b[9][TILE_X * SPEC_SW];        // B at (li, lj + 1)
    float src[2][CTA_THREADS];           // the k and eps sources at the tile
    float red[TILE_X][NQ];               // the warps' partials (WarpAcc)
};
static_assert(sizeof(SpecTile) <= 48 * 1024, "static shared memory");

// gfc's outputs at a node of the tile: the primitives into `cout`; the
// scratch planes pass12 reads into shared memory, and S and A (ga) or S
// and B (gb) also into the global scratch at a node on an edge facing a
// general tile.
struct SpecOut {
    SpecTile* m;
    float* __restrict__ cout;
    float* __restrict__ scr;
    size_t P, n;
    int os, oa, ob, t;
    bool ga, gb;
    HF2D_NO_STATE
    __device__ __forceinline__ void carry(int plane, float v) const {
        cout[plane * P + n] = v;
    }
    __device__ __forceinline__ void scratch(int plane, float v) const {
        if (plane < SCR_A) {
            m->s[plane - SCR_S][os] = v;
            if (ga || gb) scr[plane * P + n] = v;
        } else if (plane < SCR_B) {
            m->a[plane - SCR_A][oa] = v;
            if (ga) scr[plane * P + n] = v;
        } else if (plane < SCR_SRC_K) {
            m->b[plane - SCR_B][ob] = v;
            if (gb) scr[plane * P + n] = v;
        } else if (plane <= SCR_SRC_EPS) {
            m->src[plane - SCR_SRC_K][t] = v;
        }
    }
};

// gfc's outputs at a ring node: S, and A (a ring row, oa >= 0) or B (a
// ring column), into shared memory.  Nothing else is kept, so nvcc drops
// what only the rest needs (the table lookups of CP, lam and mu, the dt
// field and the counts).
struct RingOut {
    SpecTile* m;
    int os, oa, ob;
    HF2D_NO_STATE
    __device__ __forceinline__ void carry(int, float) const {}
    __device__ __forceinline__ void scratch(int plane, float v) const {
        if (plane < SCR_A) {
            m->s[plane - SCR_S][os] = v;
        } else if (plane < SCR_B) {
            if (oa >= 0) m->a[plane - SCR_A][oa] = v;
        } else if (plane < SCR_SRC_K) {
            if (oa < 0) m->b[plane - SCR_B][ob] = v;
        }
    }
};

// pass12's operands of an own node: the scratch planes from shared memory
// at the collapsed offsets (by Nb), beta from the carry at the node.
struct SpecSrc {
    const SpecTile* m;
    const float* __restrict__ cin;
    size_t P, n;
    int t;
    int os[5], oa[5], ob[5];
    __device__ __forceinline__ float at(int plane, int d) const {
        return plane < SCR_A ? m->s[plane - SCR_S][os[d]]
             : plane < SCR_B ? m->a[plane - SCR_A][oa[d]]
             : plane < SCR_SRC_K ? m->b[plane - SCR_B][ob[d]]
                                 : m->src[plane - SCR_SRC_K][t];
    }
    __device__ __forceinline__ float aux(int plane) const {
        return cin[plane * P + n];
    }
};

// Ring node r (0 .. RING - 1) relative to the tile, and the side it lies
// across (the bit of the edge mask): the row above, the row below, the
// column left, the column right.
__device__ __forceinline__ void ring_node(int r, int& li, int& lj,
                                          int& side) {
    if (r < TILE_Y) {
        li = -1, lj = r, side = 0;
    } else if (r < 2 * TILE_Y) {
        li = TILE_X, lj = r - TILE_Y, side = 1;
    } else if (r < 2 * TILE_Y + TILE_X) {
        li = r - 2 * TILE_Y, lj = -1, side = 2;
    } else {
        li = r - 2 * TILE_Y - TILE_X, lj = TILE_Y, side = 3;
    }
}

// `aux`: the (beta, cfl, is_mu_t) row of gfc's iteration, `aux_next` the
// row pass12 reads (its beta_scen); `edges`: the edge mask by tile id.
__global__ void __launch_bounds__(CTA_THREADS, 3)
step_spec_kernel(const Consts c, const float* __restrict__ cin,
                 float* __restrict__ cout, float* __restrict__ scr,
                 const float* __restrict__ mf,
                 const float* __restrict__ chemf,
                 const int32_t* __restrict__ chemi,
                 const float* __restrict__ dtp,
                 const float* __restrict__ aux,
                 const float* __restrict__ aux_next,
                 const int32_t* __restrict__ tiles,
                 const int32_t* __restrict__ edges,
                 int32_t* __restrict__ part_i, float* __restrict__ part_f) {
    __shared__ SpecTile m;
    const int tile = tiles[blockIdx.x];
    const int i0 = (tile / c.nby) * TILE_X, j0 = (tile % c.nby) * TILE_Y;
    const int edge = edges[tile];
    const int t = threadIdx.y * TILE_Y + threadIdx.x;
    const size_t P = static_cast<size_t>(c.X) * c.Y;
    const float dt = *dtp, cfl_scen = aux[1];
    const bool mu_t_iter = aux[2] > F(0.5);
    float* coef = reinterpret_cast<float*>(m.coef4);
    stage_chem_coef(coef, chemf, chemi);
    const uint32_t w[CTX_N_WORDS] = {0u, 0u, 0u, 0u};   // the spec constants
    const Stencil st = make_stencil<true>(nullptr);

    // 1. gfc at the tile's nodes (a spec tile is whole: every lane has its
    // node)
    const int li = threadIdx.y, lj = threadIdx.x;
    const int i = i0 + li, j = j0 + lj;
    const int os = (li + 1) * SPEC_SW + lj + 1;
    const int oa = (li + 1) * TILE_Y + lj;
    const int ob = li * SPEC_SW + lj + 1;
    bool uns = false, ovr = false;
    {
        const bool ga = (li == 0 && (edge & EDGE_XL))
                        || (li == TILE_X - 1 && (edge & EDGE_XR));
        const bool gb = (lj == 0 && (edge & EDGE_YD))
                        || (lj == TILE_Y - 1 && (edge & EDGE_YU));
        const size_t n = static_cast<size_t>(i) * c.Y + j;
        gfc_node<true, false, false, XF_FLAT, FAM_ALL, true>(
            c, direct_src<true>(c, cin, mf, w, P, i, j), w, st,
            SpecOut{&m, cout, scr, P, n, os, oa, ob, t, ga, gb}, chemf,
            chemi, dt, cfl_scen, mu_t_iter, uns, ovr,
            ExtIn{nullptr, nullptr, nullptr, nullptr, i, j, coef});
    }
    // ... and at the ring, by threads 0 .. RING - 1
    if (t < RING) {
        int ri, rj, side;
        ring_node(t, ri, rj, side);
        const int gi = i0 + ri, gj = j0 + rj;
        // a ring node outside the grid: no node reads it (the collapse)
        if (gi >= 0 && gi < c.X && gj >= 0 && gj < c.Y) {
            const size_t n = static_cast<size_t>(gi) * c.Y + gj;
            const int ros = (ri + 1) * SPEC_SW + rj + 1;
            const int roa = side < 2 ? (ri + 1) * TILE_Y + rj : -1;
            const int rob = ri * SPEC_SW + rj + 1;
            if ((edge >> side) & 1) {
                // a general tile's node: gfc<general>'s scratch
#pragma unroll
                for (int e = 0; e < 9; ++e) {
                    m.s[e][ros] = scr[(SCR_S + e) * P + n];
                    if (roa >= 0)
                        m.a[e][roa] = scr[(SCR_A + e) * P + n];
                    else
                        m.b[e][rob] = scr[(SCR_B + e) * P + n];
                }
            } else {
                bool u = false, o = false;
                gfc_node<true, false, false, XF_FLAT, FAM_ALL, true>(
                    c, direct_src<true>(c, cin, mf, w, P, gi, gj), w, st,
                    RingOut{&m, ros, roa, rob}, chemf, chemi, dt, cfl_scen,
                    mu_t_iter, u, o,
                    ExtIn{nullptr, nullptr, nullptr, nullptr, gi, gj, coef});
            }
        }
    }
    // 2. the counts of the tile's nodes; its barrier completes the window
    gfc_partials(c, i, uns, ovr, tile, part_i);

    // 3. pass12 at the tile's nodes
    const Collapse k = collapse<true>(c, w, i, j);
    const SpecSrc src{&m, cin, P, static_cast<size_t>(i) * c.Y + j, t,
                      {os, k.l ? os - SPEC_SW : os, k.r ? os + SPEC_SW : os,
                       k.u ? os + 1 : os, k.d ? os - 1 : os},
                      {oa, k.l ? oa - TILE_Y : oa, k.r ? oa + TILE_Y : oa,
                       oa, oa},
                      {ob, ob, ob, k.u ? ob + 1 : ob, k.d ? ob - 1 : ob}};
    WarpAcc acc{m.red};
    pass12_node<true>(c, src, w, st, cout, dt, aux_next[0],
                      i >= c.x0 && i < c.x1, true, [] { return 0.f; }, acc);
    __syncthreads();
    tile_partials(m.red, tile, part_f);
}

extern "C" {

// The spec tiles of an iteration (or of one part of a strip plan's) in one
// launch, a CTA a tile of the device list `tiles`; returns
// cudaGetLastError() (0 without a launch when n_tiles is 0).  Flat
// standard k-eps decks only (ops/fused_step.spec_fusable): `consts` points
// to the KernelConsts whose Consts part it reads.
int hf2d_step_spec(const void* consts, const void* cin, void* cout,
                   void* scr, const void* mf, const void* chemf,
                   const void* chemi, const void* dt, const void* aux,
                   const void* aux_next, const void* tiles, int n_tiles,
                   const void* edges, void* part_i, void* part_f,
                   void* stream) {
    if (n_tiles == 0) return 0;
    const Consts c = *static_cast<const Consts*>(consts);
    if (c.euler) return static_cast<int>(cudaErrorInvalidValue);
    step_spec_kernel<<<n_tiles, dim3(TILE_Y, TILE_X), 0,
                       static_cast<cudaStream_t>(stream)>>>(
        c, static_cast<const float*>(cin), static_cast<float*>(cout),
        static_cast<float*>(scr), static_cast<const float*>(mf),
        static_cast<const float*>(chemf), static_cast<const int32_t*>(chemi),
        static_cast<const float*>(dt), static_cast<const float*>(aux),
        static_cast<const float*>(aux_next),
        static_cast<const int32_t*>(tiles),
        static_cast<const int32_t*>(edges), static_cast<int32_t*>(part_i),
        static_cast<float*>(part_f));
    return static_cast<int>(cudaGetLastError());
}

// The kernel of hf2d_kernel_info's stage 20.
const void* hf2d_spec_kernel_fn() {
    return reinterpret_cast<const void*>(step_spec_kernel);
}

}  // extern "C"
