// The class-sum boundary of the sequence-parallel (four-step) digit-matmul
// polymul, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of qtesla_tpu/parallel/sharded_mxu.py:
//   qt_sp_seg1_classes <- _make_seg1_classes (l.972)   B17
//   qt_sp_seg2_classes <- _make_seg2_classes (l.1001)  B18
//
// What they compute.  The path of sharded_mxu.cu (B11, B12, B16) with the
// first exchange moved before segment 1's recombination.  Shard d holds
// nloc = n1 * n2/k values a row in A tiles of TW lanes
// (parallel/sharded_mxu_tables.py).  Per row of a shard:
//   B17: the Lr wide stages of the n1-point forward along j1, then per tile
//        the digit split of p1 and the products against K1[d, t], and no
//        recombination: class m's int32 sum c_m is stored as the uint32
//        c_m + cls_b[m] (cls_b p1's inclusive class bounds) at column
//        m * nloc + t * TW + o of a row of Dout * nloc values;
//   B18: per tile and operand (x and y, each Dout class planes after the
//        exchange), class plane j split into din_j planes of its own base,
//        centred at cls_b[j], at K offset sum_{i<j} din_i * TW; one product
//        over all of them against the one shared table of the 2^{8j}-scaled
//        K2f (class_boundary_plan), one recombination with the row
//        c2c[d, t] (seg1's centring term carried through K2f); then the
//        Barrett pointwise product of x's and y's results and K2i[d, t]
//        under p2i, as B12.  The output is canonical.
// The wide stages, the split, the MMA core and the recombination are
// mxu_block.cuh's; B17 gives the MMA core an epilogue that stores the raw
// sums, B18 runs the split once per class plane into one K dimension.
// Exact while every class bound of B18 is below 2^24 (the recombination's
// bias): true for every set with Dout <= 3, n = 8192 included; the
// four-class sets are refused by the planner, as JAX's entry point refuses
// them.
//
// Design of B17.  One launch covers the k_local stacked shards, grid (row
// groups, shard), as in sharded_mxu.cu.  B17 holds `rows` input rows (at
// most 32) in shared memory and writes its Dout-times wider output straight
// from the MMA registers to device memory, so its shared memory is the
// dense segment kernels' and four 128-thread blocks fit an SM at
// qtesla-iii-speed, k = 4.  It multiplies whole tiles of the dense K1
// streamed from L2 (mxu_block.cuh), phases barrier-separated.
//
// Design of B18 (seg2_classes_compact_kernel).  The class tables and K2i
// are block-diagonal over the n2-blocks of a tile (1/4 of a dense tile at
// qtesla-iii-speed, k = 4), and every diagonal block of the class tables
// is the same one (K2f = kron(I, R2)): the planner hands over that one
// block and K2i's blocks alone (compact_tables; mxu_compact.cuh).  Nothing
// couples two n2-blocks of a row, or two batch rows, anywhere in B18, so
//   - the grid is (walkers, n2-blocks of a shard's row, shard), persistent:
//     a block loads its n2-block's tables once into shared memory with
//     cp.async (class block Dout*n2 x 288 = 27 KiB, K2i block Dout*n2 x 96
//     = 9 KiB at qtesla-iii-speed) and after that one barrier its warps
//     never meet again;
//   - each warp walks over units of 8 batch rows of x and the same 8 of y
//     and takes a unit through every phase on its own, with __syncwarp
//     between them: the split straight from device memory (16-byte loads,
//     four in flight, byte permutes at base 256) into its own planes, one
//     product 288 deep where the dense kernel ran 1152, then, since the MMA
//     tile's rows 0-7 are x's and 8-15 y's, a thread holds x's and y's
//     sums of the same row and lanes: recombination, the Barrett product
//     and the split under p2i happen in registers, the second product
//     (96 deep where the dense one ran 384; its rows 8-15 are zero) reads
//     8 rows of planes, and its recombined tile goes straight to device
//     memory.  No row is staged in shared memory and no table load goes to
//     L2 inside the MMA loops;
//   - shared memory at qtesla-iii-speed: per warp 16 x 352 B + 8 x 160 B of
//     planes (6.75 KiB), 16 warps (512 threads, one block an SM, 128
//     registers): 108 KiB, 36 KiB of tables, 256 B of const rows.  The
//     launcher gives a block as many warps as its shared memory holds, at
//     most 16.
// Where n2 = TW (n = 8192: one block a tile, nothing to skip) the tables do
// not fit (432 + 144 KiB) and the same kernel reads them through L2
// (kSmemTables false) with 10 warps a block; parallel/sharded_classes.py
// plan_for picks the route.  A block narrower than 8 lanes would be widened
// to 8 positions (no registered set has n2 < 8).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, utils/phase_ablation.py,
// utils/ab_timing.py): the dense B18 took 3.77 ms, 1.66 of it products,
// 1.13 their table stream, 0.43 the split and 0.32 the recombination.  The
// same phases behind four block barriers a unit took 2.02 ms over the
// nonzero blocks, 1.45 with four digits packed a word; a warp to a unit
// 1.12; the byte permutes 1.08; the unrolled depth 0.89; the depth loops
// free of run-time conditions (kFull) 0.74.
//
// What bounds them on the H100 (qtesla-iii-speed, B = 32768, k = 4, all
// shards on one card, bytes / 3.35 TB/s against the tables' nonzero int8
// MACs * 2 / 1979 TOP/s):
//   B17 (per operand) 134 MB in, 403 MB out: 0.160 ms, device memory;
//   B18               805 MB in, 134 MB out: 0.280 ms, device memory.
//
// Each launcher is extern "C", takes raw pointers (sharded_mxu.cu's
// signature), the batch B (rows per shard), k_local, a pointer to an
// SpClassPlan and a stream, launches without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "mxu_block.cuh"
#include "mxu_compact.cuh"

namespace {

using qt::CompactDims;
using qt::cp_async16;
using qt::cp_async_wait_all;
using qt::kMaxClasses;
using qt::kMaxRows;
using qt::kPad;
using qt::Mod;
using qt::mma_classes;
using qt::mma_s8;
using qt::mulmod_barrett;
using qt::split_block;
using qt::tile_lane;
using qt::tile_row;
using qt::warp_uniform;
using qt::zero_depth_pad;

constexpr int kMaxClassSlots = 3;   // JAX's class boundary: Dout <= 3

// Field for field the SpClassPlan ctypes.Structure of
// parallel/sharded_classes.py: sharded_mxu.cu's SpPlan, then per class j the
// split of B18 (cdin, clb, cadd) and the bias B17 stores (cls_b).  Digit
// plan 1 is B17's p1, or B18's class split (din1 = sum_j cdin[j], kp1 its
// depth, kb1 its recombination constant); digit plan 2 is B18's p2i.  Last
// B18's compact layouts (c1 the class tables, c2 K2i) and whether its
// tables are held in shared memory; B17 leaves them 0.
struct SpClassPlan {
    int32_t nloc, lnloc, tw, a, lr, logm, llanes, d, rows;
    uint32_t q, r32, r32_sh, one_sh;
    uint32_t pw[4], pw_sh[4];
    int32_t din1, lb1, kp1;
    uint32_t add1, kb1;
    int32_t din2, lb2, kp2;
    uint32_t add2, kb2;
    int32_t cdin[3], clb[3];
    uint32_t cadd[3], cls_b[3];
    CompactDims c1, c2;
    int32_t smem_tables;
};

// the threads an SM runs: 16 warps, in blocks of 128, 256 or 512
constexpr int kSmThreads = 512;
// shared memory of one SM, and what the runtime reserves for each block
constexpr int kSmShared = 233472, kBlockReserve = 1024;

// classes_kernel's SEG; kSeg2Classes keeps its number: B18 runs
// seg2_classes_compact_kernel below
enum Seg { kSeg1Classes, kSeg2Classes };

// B17.
template <int SEG, int THREADS>
__global__ void __launch_bounds__(THREADS, kSmThreads / THREADS)
    classes_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ z,
                   const int8_t* __restrict__ w1,
                   const uint32_t* __restrict__ tw, long long batch,
                   const __grid_constant__ SpClassPlan p) {
    static_assert(SEG == kSeg1Classes, "B18 has a kernel of its own");
    extern __shared__ __align__(16) uint32_t smem[];
    const int nloc = p.nloc, d = p.d, tws = p.tw;
    const uint32_t q = p.q;
    const int wide = d * nloc;                  // a row of class planes
    const int tb = p.rows;                      // batch rows a block
    const int ks = p.kp1 + kPad;
    uint32_t* data = smem;
    int8_t* planes = reinterpret_cast<int8_t*>(smem + p.rows * nloc);
    const int shard = blockIdx.y;
    const long long row0 = static_cast<long long>(blockIdx.x) * tb;
    const int live = batch - row0 < tb ? static_cast<int>(batch - row0) : tb;
    const size_t row_base = static_cast<size_t>(shard) * batch + row0;
    const size_t in_base = row_base * static_cast<size_t>(nloc);

    // rows past the batch are zero-filled
    for (int c = threadIdx.x * 4; c < tb * nloc; c += blockDim.x * 4) {
        const bool ok = c / nloc < live;
        cp_async16(data + c, ok ? x + in_base + c : x, ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    // one shard's K1 tiles of (d * tw, kp1) int8
    const size_t tile1 = static_cast<size_t>(d) * tws * p.kp1;
    const int8_t* w1_shard = w1 + shard * p.a * tile1;
    uint32_t* zrow = z + row_base * static_cast<size_t>(wide);
    const uint32_t cls_b[kMaxClassSlots] = {p.cls_b[0], p.cls_b[1],
                                            p.cls_b[2]};
    qt::fwd_wide(data, tb, p.logm, p.llanes, p.lr, tw, q);
    zero_depth_pad(planes, tb, ks, p.din1 * tws, p.kp1);
    for (int t = 0; t < p.a; ++t) {
        split_block(data, tb, nloc, tws, t, planes, ks, p.din1, p.lb1,
                    p.add1);
        __syncthreads();
        // the raw class sums, biased, straight to device memory
        mma_classes(
            planes, tb, ks, w1_shard + t * tile1, p.kp1, tws, d,
            [&](int lt, const int (&acc)[2][kMaxClasses][4]) {
                const int du = warp_uniform(d);
#pragma unroll
                for (int mm = 0; mm < 2; ++mm)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = tile_row(mm, e);
                        if (r >= live) continue;
                        uint32_t* zr = zrow + static_cast<size_t>(r) * wide +
                                       t * tws + tile_lane(lt, e);
#pragma unroll
                        for (int j = 0; j < kMaxClassSlots; ++j)
                            if (j < du)
                                zr[j * nloc] =
                                    static_cast<uint32_t>(acc[mm][j][e]) +
                                    cls_b[j];
                    }
            });
        __syncthreads();
    }
}

// B18 over the nonzero blocks (header note: design of B18).
constexpr int kWarpRows = 8;      // batch rows of x and of y a warp works on
constexpr int kMaxWarps = 16;     // warps a block runs at most
constexpr int kPassTiles = 4;     // 8-lane output tiles a warp sums at once

// Shared memory one warp of seg2_classes_compact_kernel takes: the class
// planes of its 8 + 8 rows and the p2i planes of its 8 product rows.
size_t seg2_warp_smem(const SpClassPlan& p) {
    return 2 * kWarpRows * qt::compact_row_stride(1, p.c1.kp) +
           kWarpRows * qt::compact_row_stride(1, p.c2.kp);
}

// What the block's warps share: the two const rows of its n2-block and,
// where they fit, its tables.
size_t seg2_shared_smem(const SpClassPlan& p) {
    const size_t s = static_cast<size_t>(1) << p.c1.ls;
    return 2 * s * sizeof(uint32_t) +
           (p.smem_tables ? p.d * s * (p.c1.kp + p.c2.kp) : 0);
}

// kFull: kMaxClassSlots classes and a multiple of kPassTiles output tiles
// a block (every registered set of three classes but smallprime), so that
// no MMA of the depth loops hangs on a run-time condition.
template <bool kSmemTables, bool kFull>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    seg2_classes_compact_kernel(const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ y,
                                uint32_t* __restrict__ z,
                                const int8_t* __restrict__ w2cc,
                                const uint32_t* __restrict__ c2c,
                                const int8_t* __restrict__ w2ic,
                                const uint32_t* __restrict__ c2i,
                                long long batch,
                                const __grid_constant__ SpClassPlan p) {
    extern __shared__ __align__(16) uint32_t smem[];
    const CompactDims& ca = p.c1;        // the class tables' layout
    const CompactDims& cb = p.c2;        // K2i's
    const int d = kFull ? kMaxClassSlots : warp_uniform(p.d);
    const int ls = ca.ls, s = 1 << ls, nloc = p.nloc;
    const int wide = d * nloc;           // an input row of class planes
    const int ks1 = qt::compact_row_stride(1, ca.kp);
    const int ks2 = qt::compact_row_stride(1, cb.kp);
    const int col = blockIdx.y, shard = blockIdx.z;
    const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    // shared memory: the const rows, each warp's planes, the tables
    uint32_t* cst = smem;
    int8_t* planes1 = reinterpret_cast<int8_t*>(cst + 2 * s) +
                      warp * (2 * kWarpRows * ks1 + kWarpRows * ks2);
    int8_t* planes2 = planes1 + 2 * kWarpRows * ks1;
    // this n2-block's tables: the class block is one for all, K2i's is
    // block col of the shard's (a * nblk, d * s, kp)
    const size_t bytes_a = static_cast<size_t>(d << ls) * ca.kp;
    const size_t bytes_b = static_cast<size_t>(d << ls) * cb.kp;
    const int8_t* wa = w2cc;
    const int8_t* wb =
        w2ic + (static_cast<size_t>(shard) * (nloc >> ls) + col) * bytes_b;
    const size_t lanes0 = static_cast<size_t>(shard) * nloc + (col << ls);

    // once a block: the const rows and the tables, then no block barrier
    qt::cp_async_bytes(cst, c2c + lanes0, s * sizeof(uint32_t));
    qt::cp_async_bytes(cst + s, c2i + lanes0, s * sizeof(uint32_t));
    if (kSmemTables) {
        int8_t* wsm = reinterpret_cast<int8_t*>(cst + 2 * s) +
                      nwarps * (2 * kWarpRows * ks1 + kWarpRows * ks2);
        qt::cp_async_bytes(wsm, wa, bytes_a);
        qt::cp_async_bytes(wsm + bytes_a, wb, bytes_b);
        wa = wsm;
        wb = wsm + bytes_a;
    }
    cp_async_wait_all();
    __syncthreads();

    // Depth steps unrolled together, so that the next steps' fragment loads
    // are under way while this step's MMAs issue: 0.83x the kernel's time
    // on an H100 (utils/ab_timing.py, PERF.md).  Through L2 the 12 table
    // fragments a step are kept to one step: three spill.
    constexpr int kDepthUnroll = kSmemTables ? 3 : 1;
    const Mod m{p.q, p.r32, p.r32_sh, p.one_sh};
    const int ntiles = s >> 3;
    const int words = (2 * kWarpRows * d) << (ls - 2);
    const long long units = (batch + kWarpRows - 1) / kWarpRows;
    for (long long u = static_cast<long long>(blockIdx.x) * nwarps + warp;
         u < units; u += static_cast<long long>(gridDim.x) * nwarps) {
        const long long row0 = u * kWarpRows;
        const int live = batch - row0 < kWarpRows
                             ? static_cast<int>(batch - row0)
                             : kWarpRows;
        const size_t base =
            (static_cast<size_t>(shard) * batch + row0) * wide + (col << ls);

        // The split, straight from device memory: word idx is 4 lanes of
        // row R (0-7 x's rows, 8-15 y's, zero past the batch) of class j,
        // j the same in all lanes of the warp; four loads in flight.
        for (int idx0 = lane; idx0 < words; idx0 += 4 * 32) {
            uint4 v[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int idx = idx0 + 32 * t, seg = idx >> (ls - 2);
                const int R = seg & (2 * kWarpRows - 1), j = seg >> 4;
                const int r = R & (kWarpRows - 1);
                v[t] = make_uint4(0, 0, 0, 0);
                if (idx < words && r < live)
                    v[t] = __ldg(reinterpret_cast<const uint4*>(
                        (R < kWarpRows ? x : y) + base +
                        static_cast<size_t>(r) * wide + j * nloc +
                        4 * (idx & ((s >> 2) - 1))));
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int idx = idx0 + 32 * t, seg = idx >> (ls - 2);
                if (idx >= words) break;
                const int R = seg & (2 * kWarpRows - 1), j = seg >> 4;
                const int i0 = j == 0 ? 0 : j == 1 ? p.cdin[0]
                                                   : p.cdin[0] + p.cdin[1];
                const uint32_t add = p.cadd[j];
                const int32_t a[4] = {static_cast<int32_t>(v[t].x + add),
                                      static_cast<int32_t>(v[t].y + add),
                                      static_cast<int32_t>(v[t].z + add),
                                      static_cast<int32_t>(v[t].w + add)};
                qt::store_planes(
                    reinterpret_cast<uint32_t*>(planes1 + R * ks1 +
                                                (i0 << ls)) +
                        (idx & ((s >> 2) - 1)),
                    ls - 2, a, p.cdin[j], p.clb[j]);
            }
        }
        __syncwarp();

        // One product of all class planes against the class block, at most
        // kPassTiles output tiles a pass.  Accumulators 0, 1 are x's row g
        // and 2, 3 y's row g at the same two lanes: both are recombined,
        // multiplied and split under p2i in registers.
        for (int nt0 = 0; nt0 < ntiles; nt0 += kPassTiles) {
            int acc[kPassTiles][kMaxClassSlots][4];
#pragma unroll
            for (int t = 0; t < kPassTiles; ++t)
#pragma unroll
                for (int j = 0; j < kMaxClassSlots; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[t][j][e] = 0;
            const int8_t* pa = planes1 + g * ks1 + tig * 8;
            const int8_t* pb = wa + (nt0 * 8 + g) * ca.kp + tig * 8;
#pragma unroll(kDepthUnroll)
            for (int k0 = 0; k0 < ca.kp; k0 += 32) {
                const uint2 a_lo = *reinterpret_cast<const uint2*>(pa + k0);
                const uint2 a_hi = *reinterpret_cast<const uint2*>(
                    pa + kWarpRows * ks1 + k0);
#pragma unroll
                for (int t = 0; t < kPassTiles; ++t)
#pragma unroll
                    for (int j = 0; j < kMaxClassSlots; ++j)
                        if (kFull || (nt0 + t < ntiles && j < d))
                            mma_s8(acc[t][j], a_lo, a_hi,
                                   qt::table_fragment<kSmemTables>(
                                       pb + ((j << ls) + t * 8) * ca.kp + k0));
            }
#pragma unroll
            for (int t = 0; t < kPassTiles; ++t) {
                if (!kFull && nt0 + t >= ntiles) break;
                const int l0 = (nt0 + t) * 8 + tig * 2;
                int32_t zz[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const uint32_t start = cst[l0 + c] + p.kb1;
                    const uint32_t vx = qt::recombine_value(
                        start, d, p, [&](int j) { return acc[t][j][c]; });
                    const uint32_t vy = qt::recombine_value(
                        start, d, p, [&](int j) { return acc[t][j][2 + c]; });
                    zz[c] = static_cast<int32_t>(mulmod_barrett(vx, vy, m) +
                                                 p.add2);
                }
                // the two lanes' digits of a plane in one 16-bit store
                uint16_t* pr =
                    reinterpret_cast<uint16_t*>(planes2 + g * ks2 + l0);
                for (int i = 0; i < p.din2; ++i) {
                    pr[i << (ls - 1)] = qt::pack_pair(zz[0], zz[1], i, p.lb2,
                                                      i == p.din2 - 1);
                }
            }
        }
        __syncwarp();

        // The n2-block's inverse rows on the 8 product rows (the MMA's rows
        // 8-15 are zero), straight to device memory.
        uint32_t* zrow = z + (static_cast<size_t>(shard) * batch + row0) *
                                 static_cast<size_t>(nloc) +
                         (col << ls);
        for (int nt0 = 0; nt0 < ntiles; nt0 += kPassTiles) {
            int acc[kPassTiles][kMaxClassSlots][4];
#pragma unroll
            for (int t = 0; t < kPassTiles; ++t)
#pragma unroll
                for (int j = 0; j < kMaxClassSlots; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[t][j][e] = 0;
            const int8_t* pa = planes2 + g * ks2 + tig * 8;
            const int8_t* pb = wb + (nt0 * 8 + g) * cb.kp + tig * 8;
#pragma unroll(kDepthUnroll)
            for (int k0 = 0; k0 < cb.kp; k0 += 32) {
                const uint2 a_lo = *reinterpret_cast<const uint2*>(pa + k0);
#pragma unroll
                for (int t = 0; t < kPassTiles; ++t)
#pragma unroll
                    for (int j = 0; j < kMaxClassSlots; ++j)
                        if (kFull || (nt0 + t < ntiles && j < d))
                            mma_s8(acc[t][j], a_lo, make_uint2(0, 0),
                                   qt::table_fragment<kSmemTables>(
                                       pb + ((j << ls) + t * 8) * cb.kp + k0));
            }
#pragma unroll
            for (int t = 0; t < kPassTiles; ++t) {
                if (!kFull && nt0 + t >= ntiles) break;
                const int l0 = (nt0 + t) * 8 + tig * 2;
                uint32_t out[2];
#pragma unroll
                for (int c = 0; c < 2; ++c)
                    out[c] = qt::recombine_value(
                        cst[s + l0 + c] + p.kb2, d, p,
                        [&](int j) { return acc[t][j][c]; });
                if (g < live)
                    *reinterpret_cast<uint2*>(
                        zrow + static_cast<size_t>(g) * nloc + l0) =
                        make_uint2(out[0], out[1]);
            }
        }
        // the next unit's split writes planes this one's products read
        __syncwarp();
    }
}

// din planes of a depth kp: din*tw rounded up to a multiple of 32
bool valid_depth(int din, int kp, int tw) {
    return kp % 32 == 0 && kp >= din * tw && kp < din * tw + 32;
}

// planes of an int32 value: at most 4 of base 256, 6 of base 128
bool valid_split(int din, int lb) {
    return din >= 1 && ((lb == 7 && din <= 6) || (lb == 8 && din <= 4));
}

bool valid_shape(const SpClassPlan& p, int ops, long long batch,
                 int k_local) {
    const bool pow2_tw = p.tw >= 8 && p.tw <= 128 && (p.tw & (p.tw - 1)) == 0;
    return p.rows >= ops && p.rows <= kMaxRows && p.rows % ops == 0 &&
           p.d >= 1 && p.d <= kMaxClassSlots && pow2_tw &&
           p.nloc == 1 << p.lnloc && p.a * p.tw == p.nloc && p.nloc >= 8 &&
           p.lr >= 0 && p.lr <= p.logm &&
           (1 << p.logm) << p.llanes == p.nloc && (p.a >> p.lr) == 1 &&
           batch > 0 && k_local >= 1 && k_local <= 65535;
}

// One launch of classes_kernel<kSeg1Classes, THREADS> with `smem` bytes a
// block.
template <int THREADS>
int run_seg1(const void* a, void* out, const void* w1, const void* tw,
             long long batch, long long blocks, int k_local, size_t smem,
             const SpClassPlan& p, void* stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            classes_kernel<kSeg1Classes, THREADS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    classes_kernel<kSeg1Classes, THREADS>
        <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(k_local)),
           THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out),
            static_cast<const int8_t*>(w1), static_cast<const uint32_t*>(tw),
            batch, p);
    return cudaGetLastError();
}

int launch_seg1(const void* a, void* out, const void* w1, const void* tw,
                long long batch, int k_local, const void* plan,
                void* stream) {
    const SpClassPlan p = *static_cast<const SpClassPlan*>(plan);
    if (!valid_shape(p, 1, batch, k_local) ||
        !valid_depth(p.din1, p.kp1, p.tw) || !valid_split(p.din1, p.lb1) ||
        p.kp2 != 0)
        return cudaErrorInvalidValue;
    const long long blocks = (batch + p.rows - 1) / p.rows;
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    const size_t smem =
        static_cast<size_t>(p.rows) * p.nloc * sizeof(uint32_t) +
        static_cast<size_t>((p.rows + 15) / 16 * 16) * (p.kp1 + kPad);
    if (smem + kBlockReserve > kSmShared) return cudaErrorInvalidValue;
    // blocks whose shared memory fits one SM
    const size_t fit = kSmShared / (smem + kBlockReserve);
    if (fit >= 4)
        return run_seg1<128>(a, out, w1, tw, batch, blocks, k_local, smem, p,
                             stream);
    if (fit >= 2)
        return run_seg1<256>(a, out, w1, tw, batch, blocks, k_local, smem, p,
                             stream);
    return run_seg1<512>(a, out, w1, tw, batch, blocks, k_local, smem, p,
                         stream);
}

template <bool kSmemTables, bool kFull>
int run_seg2_compact(const void* a, const void* b, void* out, const void* w1,
                     const void* c1, const void* w2, const void* c2,
                     long long batch, int k_local, int warps, size_t smem,
                     const SpClassPlan& p, void* stream) {
    auto kernel = seg2_classes_compact_kernel<kSmemTables, kFull>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    // a persistent grid: the blocks the card holds at once, shared out over
    // the (shard, n2-block) columns
    int resident = 0;
    if (const int err = qt::resident_blocks(kernel, warps * 32, smem,
                                            &resident))
        return err;
    const int cols = p.nloc >> p.c1.ls;
    const long long units = (batch + kWarpRows - 1) / kWarpRows;
    long long walkers = resident / (cols * k_local);
    const long long most = (units + warps - 1) / warps;
    walkers = walkers < 1 ? 1 : walkers > most ? most : walkers;
    kernel<<<dim3(static_cast<unsigned>(walkers), static_cast<unsigned>(cols),
                  static_cast<unsigned>(k_local)),
             warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), static_cast<const int8_t*>(w1),
        static_cast<const uint32_t*>(c1), static_cast<const int8_t*>(w2),
        static_cast<const uint32_t*>(c2), batch, p);
    return cudaGetLastError();
}

bool valid_compact(const CompactDims& c, int planes, int tw) {
    return c.ls >= 3 && (1 << c.ls) <= tw && c.llam == 0 && c.lq == 0 &&
           (1 << c.lbk) >= tw && c.kp % 32 == 0 && c.kp >= (planes << c.ls) &&
           c.kp < (planes << c.ls) + 32;
}

int launch_seg2_compact(const void* a, const void* b, void* out,
                        const void* w1, const void* c1, const void* w2,
                        const void* c2, long long batch, int k_local,
                        const void* plan, void* stream) {
    const SpClassPlan p = *static_cast<const SpClassPlan*>(plan);
    bool ok = valid_shape(p, 2, batch, k_local) &&
              p.rows == 2 * kWarpRows;
    int sum = 0;
    for (int j = 0; ok && j < p.d; ++j) {
        ok = valid_split(p.cdin[j], p.clb[j]);
        sum += p.cdin[j];
    }
    ok = ok && sum == p.din1 && sum <= 6 * kMaxClassSlots &&
         valid_split(p.din2, p.lb2) && valid_compact(p.c1, p.din1, p.tw) &&
         valid_compact(p.c2, p.din2, p.tw) && p.c1.ls == p.c2.ls &&
         (p.nloc >> p.c1.ls) <= 65535;
    if (!ok) return cudaErrorInvalidValue;
    // as many warps a block as its shared memory holds, at most kMaxWarps
    const size_t shared = seg2_shared_smem(p), warp = seg2_warp_smem(p);
    if (shared + warp + kBlockReserve > kSmShared)
        return cudaErrorInvalidValue;
    const size_t fit = (kSmShared - kBlockReserve - shared) / warp;
    const int warps = fit < kMaxWarps ? static_cast<int>(fit) : kMaxWarps;
    const size_t smem = shared + warps * warp;
    const bool full = p.d == kMaxClassSlots &&
                      ((1 << p.c1.ls) >> 3) % kPassTiles == 0;
    auto run = p.smem_tables
                   ? (full ? run_seg2_compact<true, true>
                           : run_seg2_compact<true, false>)
                   : (full ? run_seg2_compact<false, true>
                           : run_seg2_compact<false, false>);
    return run(a, b, out, w1, c1, w2, c2, batch, k_local, warps, smem, p,
               stream);
}

}  // namespace

// B17: w1 the shard slice of the dense K1; b, c1, w2 and c2 unused
extern "C" int qt_sp_seg1_classes(const void* a, const void*, void* out,
                                  const void* w1, const void*, const void*,
                                  const void*, const void* tw,
                                  long long batch, int k_local,
                                  const void* plan, void* stream) {
    return launch_seg1(a, out, w1, tw, batch, k_local, plan, stream);
}

// B18: w1 the class tables' one block (tabs.w2cc), c1 the shard slice of
// their const rows, w2 and c2 the shard slices of the compact K2i and its
// const rows; tw unused
extern "C" int qt_sp_seg2_classes(const void* a, const void* b, void* out,
                                  const void* w1, const void* c1,
                                  const void* w2, const void* c2, const void*,
                                  long long batch, int k_local,
                                  const void* plan, void* stream) {
    return launch_seg2_compact(a, b, out, w1, c1, w2, c2, batch, k_local,
                               plan, stream);
}
