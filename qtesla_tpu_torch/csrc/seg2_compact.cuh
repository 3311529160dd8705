// The row segment of the sequence-parallel (four-step) digit-matmul polymul
// over its tables' nonzero blocks, for Hopper (sm_90a): one kernel body,
// seg2_compact_kernel, in five modes (Mode), for
//   B12 qt_sp_seg2 (sharded_mxu.cu; kPair): x's and y's spectral shards
//       (S, B, nloc), each value split under p2f (4 planes of base 256 at
//       every registered set), one product against K2f;
//   B18 qt_sp_seg2_classes (sharded_classes.cu; kClassPlanes): x's and y's
//       Dout class planes (S, B, Dout * nloc) after B17 and the exchange,
//       class plane j split into din_j planes of its own base, one product
//       over all of them against the class tables;
// then alike: one recombination of x's and of y's sums, the Barrett
// pointwise product, the split under p2i, the product against K2i[d, t]
// and the store.  Which segment it is changes three things: the planes a
// value is split into (one input plane or Dout), where the first table's
// block lies (K2f's block of this n2-block's place in the tile, or the one
// block all class tables share) and where its const row lies (K2f's one
// (TW) row, or the shard's class const rows).
//   B13 qt_sp_seg2_fixed (sharded_mxu.cu; kSpectrum): B12 with y the
//       constant's stored spectrum, one row (S, nloc) a launch's shards
//       hold, any uint32 (the Barrett product is exact for all): only x
//       goes through K2f, so an MMA tile holds 16 rows of x where B12's
//       holds 8 of x and 8 of y; x's recombined sums meet the spectrum's
//       lanes (held in shared memory beside the const rows, read once a
//       block) in registers, and the second product takes two tiles of
//       16 product rows, each table fragment serving both.
//   B15 qt_sp_seg2_folded (sharded_mxu.cu; kFolded): B13's rows, 32 of x a
//       warp, through one product alone, against the constant's folded
//       F[d, t] = K2f diag(A^[d, t]) K2i[d, t] under the plan p2x (one
//       input plane split into din planes, Dout classes), then the
//       recombination and a store straight from registers: no pointwise
//       product, no second split, no K2i.  F is block-diagonal over the
//       n2-blocks as K2i is, so the operand holds its nonzero blocks alone
//       (FoldedSpOperand.w, (k, a, nblk, Dout * s, kp)), each (shard,
//       tile, n2-block) one, found as the second product finds K2i's, with
//       its const row.
//   B14 qt_sp_seg2_fwd (sharded_mxu.cu; kForward): B15's rows, 32 of x a
//       warp through one product and the recombination straight from
//       registers, against B12's table: K2f's block of this n2-block's place
//       in the tile (under p2f) and its (TW) const row, shared by every
//       shard; the last step of a constant's spectrum.
// The output is canonical.
//
// Design.  K2f, K2i and the class tables are block-diagonal over the
// n2-blocks of a tile (1/4 of a dense tile at qtesla-iii-speed, k = 4): the
// planner hands over their diagonal blocks alone (compact_tables;
// mxu_compact.cuh).  Nothing couples two n2-blocks of a row, or two batch
// rows, anywhere in the segment, so
//   - the grid is (walkers, n2-blocks of a shard's row, shard), persistent:
//     a block loads its n2-block's tables once into shared memory with
//     cp.async (B12: K2f block D*n2 x 128 = 12 KiB, K2i block D*n2 x 96 =
//     9 KiB at qtesla-iii-speed; B18: class block D*n2 x 288 = 27 KiB and
//     the same K2i block) and after that one barrier its warps never meet
//     again;
//   - each warp walks over units of 8 batch rows of x and the same 8 of y
//     (B12 over two units at once, B13 over 32 rows of x) and takes them
//     through every phase on
//     its own, with __syncwarp between them: the split straight from device
//     memory (16-byte loads, 4 a unit in flight, byte permutes at base 256)
//     into its own planes, one product (B12 128 deep, B18 288, where the
//     dense kernels ran 512 and 1152), then, since an MMA tile's rows 0-7
//     are x's and 8-15 y's, a thread holds x's and y's sums of the same row
//     and lanes: recombination, the Barrett product and the split under p2i
//     happen in registers, the second product (96 deep where the dense one
//     ran 384) reads the product rows' planes, and its recombined tile goes
//     straight to device memory.  No row is staged in shared memory and no
//     table load goes to L2 inside the MMA loops;
//   - with two units (B12) each table fragment of the first product serves
//     two m16 tiles and the second product's tile holds 16 live rows, where
//     one unit (B18, whose class planes leave no room for two) leaves its
//     rows 8-15 zero;
//   - the tables' rows lie in shared memory a depth padded to 32 mod 64
//     apart (compact_table_stride), so that a fragment load's eight rows
//     spread over the banks: K2f's 128-byte rows put four on each bank;
//   - shared memory at qtesla-iii-speed: per warp the first planes of its
//     rows (B12 and B13 32 rows of 160 B, B18 16 of 352 B) and the p2i
//     planes of its product rows (160 B a row; B12 16, B13 32, B18 8), 16
//     warps (512 threads, one block an SM, 128 registers), the tables and
//     256 B of const rows (B13 also 128 B of spectrum).  The launcher
//     gives a block as many warps as its shared memory holds, at most 16.
// Where n2 = TW (n = 8192: one block a tile, nothing to skip) the tables do
// not fit and the same kernel reads them through L2 (kSmemTables false), as
// B12 does at qtesla-p-iii, where two units' planes leave room for 5 warps
// beside them; the planner (parallel/sharded_mxu.py row_compact_fields)
// picks the route.  A block narrower than 8 lanes would be widened to 8
// positions (no registered set has n2 < 8).  kFull instantiations (kSlots
// classes and a multiple of the pass's output tiles a block: every
// registered set but smallprime) leave no MMA of the depth loops on a
// run-time condition.
//
// B12, B13, B14 and B15 ran as modes of a dense kernel in sharded_mxu.cu
// (sp_kernel) until they took this body (B13: 1.2227 ms at
// qtesla-iii-speed, k = 4, B = 32768, the same dense phases as B12's below;
// B15: 0.5708 ms, whole 384 x 384 tiles of its dense F at p2x (3 planes, 3
// classes), 3/4 of the MACs on zeros, streamed from L2 once per 32-row
// group behind barrier-separated load, split, product and recombination
// phases; B14 0.6422 ms, whole 512 x 128 tiles of the dense K2f the same
// way; PERF.md).  B15's mode holds its block of F (96 x 96 bytes at
// qtesla-iii-speed, k = 4: 9 KiB) and one const row in shared memory, one
// product 96 deep where the dense one ran 384, and no barrier after the
// tables' load; B14's its block of K2f (96 x 128 bytes: 12 KiB), one
// product 128 deep where the dense one ran 512.  B12's dense mode:
// whole 128 x 128 tiles of K2f and K2i streamed from L2 once per 32-row
// group, load, split, products and recombination barrier-separated, 2.10
// ms at qtesla-iii-speed, k = 4, 1.53 of it products and their table reads
// (PERF.md).  Measured on an H100 80GB HBM3 at 700 W (utils/ab_timing.py,
// PERF.md): B18's body took it to 0.5283 ms, the padded table rows to
// 0.4604 and two units a warp to 0.4496; staging the next units' rows in
// shared memory with cp.async ran 1.8 % slower (and B18 8.8 % slower) and
// was left out.  B18's steps to this design: the dense B18 took 3.77 ms,
// 1.66 of it products, 1.13 their table stream, 0.43 the split and 0.32
// the recombination.  The same phases behind four block barriers a unit
// took 2.02 ms over the nonzero blocks, 1.45 with four digits packed a
// word; a warp to a unit 1.12; the byte permutes 1.08; the unrolled depth
// 0.89; the depth loops free of run-time conditions (kFull) 0.74.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "mxu_block.cuh"
#include "mxu_compact.cuh"

namespace qt {

// Field for field the SpClassPlan ctypes.Structure of
// parallel/sharded_mxu.py: sharded_mxu.cu's SpPlan, then per input plane j
// the split of the row segment (cdin, clb, cadd).  Digit plan 1 is the row
// segment's first split (din1 = sum_j cdin[j], kp1 0, kb1 its
// recombination constant); digit plan 2 is p2i (kp2 0).  Last the compact
// layouts (c1 the first table, c2 K2i) and whether the tables are held in
// shared memory.
struct SpClassPlan {
    int32_t nloc, lnloc, tw, a, lr, logm, llanes, d, rows;
    uint32_t q, r32, r32_sh, one_sh;
    uint32_t pw[4], pw_sh[4];
    int32_t din1, lb1, kp1;
    uint32_t add1, kb1;
    int32_t din2, lb2, kp2;
    uint32_t add2, kb2;
    int32_t cdin[3], clb[3];
    uint32_t cadd[3];
    CompactDims c1, c2;
    int32_t smem_tables;
};

namespace seg2 {

// What seg2_compact_kernel runs, numbered so that the instantiation names
// utils/sass_diff.py matches across trees keep B12 at 0 and B18 at 1, and
// B14 at 4, its number as a mode of the dense kernel before.
enum Mode : int {
    kPair = 0,
    kClassPlanes = 1,
    kSpectrum = 2,
    kFolded = 3,
    kForward = 4
};

// B15 and B14: one product, then the recombination straight to device
// memory (no pointwise product, no p2i split, no K2i)
__host__ __device__ constexpr bool one_product(int mode) {
    return mode == kFolded || mode == kForward;
}

constexpr int kWarpRows = 8;      // batch rows of x and of y a warp works on
constexpr int kMaxWarps = 16;     // warps a block runs at most
constexpr int kClassSlots = 3;    // B18: JAX's class boundary, Dout <= 3
constexpr int kDigitSlots = 4;    // B12: the four digit classes of p-sets
// shared memory of one SM, and what the runtime reserves for each block
constexpr int kSmShared = 233472, kBlockReserve = 1024;

// 8-lane output tiles a warp sums at once: 4 of 3 classes, 2 of 4
__host__ __device__ constexpr int pass_tiles(int slots) {
    return slots > 3 ? 2 : 4;
}

// Units of 8 rows of x and 8 of y a warp takes at once: B12 two, so that
// its second product's m16 tile holds 16 live rows and each table fragment
// of the first serves two tiles; B18 one, its class planes leaving no room
// for two.  B13, B14 and B15 take the rows of two such units from x alone:
// 32.
__host__ __device__ constexpr int units_of(int mode) {
    return mode == kClassPlanes ? 1 : 2;
}

// Batch rows a warp takes at once, and its product rows: half its planes
// rows (x's, beside y's), or all of them (B13, B14, B15).
__host__ __device__ constexpr int batch_rows(int mode, int rows) {
    return mode == kSpectrum || one_product(mode) ? rows : rows / 2;
}

// Rows of s lanes the block holds beside its planes: the first table's
// const row and K2i's, and B13's spectrum; B14's and B15's one const row.
__host__ __device__ constexpr int const_rows(int mode) {
    return mode == kSpectrum ? 3 : one_product(mode) ? 1 : 2;
}

// Shared memory one warp takes: the first planes of its rows (p.rows) and
// the p2i planes of its product rows (B14 and B15 have no second product).
inline size_t warp_smem(const SpClassPlan& p, int mode) {
    return p.rows * compact_row_stride(1, p.c1.kp) +
           (one_product(mode) ? 0
                              : batch_rows(mode, p.rows) *
                                    compact_row_stride(1, p.c2.kp));
}

// What the block's warps share: the const rows of its n2-block (and B13's
// spectrum) and, where they fit, its tables (B14 and B15 one), rows
// compact_table_stride apart.
inline size_t shared_smem(const SpClassPlan& p, int mode) {
    const size_t s = static_cast<size_t>(1) << p.c1.ls;
    return const_rows(mode) * s * sizeof(uint32_t) +
           (p.smem_tables
                ? p.d * s *
                      (compact_table_stride(p.c1.kp) +
                       (one_product(mode) ? 0
                                          : compact_table_stride(p.c2.kp)))
                : 0);
}

template <int kMode, bool kSmemTables, int kSlots, bool kFull>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    seg2_compact_kernel(const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ y,
                        uint32_t* __restrict__ z,
                        const int8_t* __restrict__ w1,
                        const uint32_t* __restrict__ c1,
                        const int8_t* __restrict__ w2,
                        const uint32_t* __restrict__ c2, long long batch,
                        const __grid_constant__ SpClassPlan p) {
    constexpr bool kClasses = kMode == kClassPlanes;
    constexpr bool kFixed = kMode == kSpectrum;
    // B15's table and const row are the constant's, one per shard
    constexpr bool kFold = kMode == kFolded;
    // B14 and B15: one product, stored from registers
    constexpr bool kOne = one_product(kMode);
    // the planes' rows are all x's (B13, B14, B15), or x's beside y's
    constexpr bool kXOnly = kFixed || kOne;
    constexpr int kU = units_of(kMode);
    constexpr int kRows = kU * kWarpRows;          // x rows a warp takes
    // batch rows a warp takes at once, and its product rows (B13, B14,
    // B15: 2 kRows, its planes rows all x's)
    constexpr int kBatch = batch_rows(kMode, 2 * kRows);
    constexpr int kConst = const_rows(kMode);
    // rows of a warp's p2i planes: its product rows (none in B14, B15)
    constexpr int kRows2 = kOne ? 0 : kBatch;
    // output tiles of a pass: the second product's, and the first's, whose
    // kU m16 tiles share each table fragment
    constexpr int kPass2 = pass_tiles(kSlots), kPass1 = kPass2 / kU;
    extern __shared__ __align__(16) uint32_t smem[];
    const CompactDims& ca = p.c1;        // the first table's layout
    const CompactDims& cb = p.c2;        // K2i's
    const int d = kFull ? kSlots : warp_uniform(p.d);
    const int ls = ca.ls, s = 1 << ls, nloc = p.nloc;
    const int nin = kClasses ? d : 1;    // input planes of a value
    const int wide = nin * nloc;         // an input row
    const int ks1 = compact_row_stride(1, ca.kp);
    const int ks2 = compact_row_stride(1, cb.kp);
    // bytes between two table rows: padded in shared memory
    const int ts1 = kSmemTables ? compact_table_stride(ca.kp) : ca.kp;
    const int ts2 = kSmemTables ? compact_table_stride(cb.kp) : cb.kp;
    const int col = blockIdx.y, shard = blockIdx.z;
    const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    // shared memory: the const rows (B13: then the spectrum's lanes), each
    // warp's planes, the tables
    uint32_t* cst = smem;
    int8_t* planes1 = reinterpret_cast<int8_t*>(cst + kConst * s) +
                      warp * (2 * kRows * ks1 + kRows2 * ks2);
    int8_t* planes2 = planes1 + 2 * kRows * ks1;
    // this n2-block's tables and const rows: B18's class block is one for
    // all and its const rows the shard's (a, tw); B12's K2f block is the
    // one of this n2-block's place in a tile, (nblk, d * s, kp), and its
    // const row the one (tw) row (B14's too); K2i's block is block col of
    // the shard's
    // (a * nblk, d * s, kp), its const rows the shard's, and so are B15's
    // block of the constant's F and its const row
    const size_t bytes_a = static_cast<size_t>(d << ls) * ca.kp;
    const size_t bytes_b = static_cast<size_t>(d << ls) * cb.kp;
    const size_t lanes0 = static_cast<size_t>(shard) * nloc + (col << ls);
    const int8_t* wa =
        kClasses ? w1 : w1 + (col & ((p.tw >> ls) - 1)) * bytes_a;
    const int8_t* wb =
        w2 + (static_cast<size_t>(shard) * (nloc >> ls) + col) * bytes_b;
    if (kFold)
        wa = w1 + (static_cast<size_t>(shard) * (nloc >> ls) + col) * bytes_a;

    // once a block: the const rows and the tables, then no block barrier
    cp_async_bytes(cst,
                   kClasses || kFold ? c1 + lanes0
                                     : c1 + ((col << ls) & (p.tw - 1)),
                   s * sizeof(uint32_t));
    if (!kOne) cp_async_bytes(cst + s, c2 + lanes0, s * sizeof(uint32_t));
    // B13's y is the spectrum, one row (nloc) a shard
    if (kFixed) cp_async_bytes(cst + 2 * s, y + lanes0, s * sizeof(uint32_t));
    if (kSmemTables) {
        int8_t* wsm = reinterpret_cast<int8_t*>(cst + kConst * s) +
                      nwarps * (2 * kRows * ks1 + kRows2 * ks2);
        cp_async_rows(wsm, ts1, wa, ca.kp, d << ls);
        if (!kOne)
            cp_async_rows(wsm + (d << ls) * ts1, ts2, wb, cb.kp, d << ls);
        wa = wsm;
        wb = wsm + (d << ls) * ts1;
    }
    cp_async_wait_all();
    __syncthreads();

    // Depth steps unrolled together, so that the next steps' fragment loads
    // are under way while this step's MMAs issue: 0.83x B18's time on an
    // H100 (utils/ab_timing.py, PERF.md).  Through L2 the 12 table
    // fragments a step are kept to one step: three spill.
    constexpr int kDepthUnroll = kSmemTables ? 3 : 1;
    const Mod m{p.q, p.r32, p.r32_sh, p.one_sh};
    const int ntiles = s >> 3;
    const int words = (2 * kRows * nin) << (ls - 2);
    const long long units = (batch + kBatch - 1) / kBatch;
    for (long long u = static_cast<long long>(blockIdx.x) * nwarps + warp;
         u < units; u += static_cast<long long>(gridDim.x) * nwarps) {
        const long long row0 = u * kBatch;
        const int live = batch - row0 < kBatch
                             ? static_cast<int>(batch - row0)
                             : kBatch;
        const size_t base =
            (static_cast<size_t>(shard) * batch + row0) * wide + (col << ls);

        // The split, straight from device memory: word idx is 4 lanes of
        // planes row R of input plane j, j the same in all lanes of the
        // warp.  Row R of tile h = R >> 4 holds x's row 8h + (R & 7) below
        // 8 and y's above (B13, B15: x's row R; zero past the batch); 4 kU
        // loads in flight.
        for (int idx0 = lane; idx0 < words; idx0 += 4 * kU * 32) {
            uint4 v[4 * kU];
#pragma unroll
            for (int t = 0; t < 4 * kU; ++t) {
                const int idx = idx0 + 32 * t, seg = idx >> (ls - 2);
                const int R = seg & (2 * kRows - 1), j = seg / (2 * kRows);
                const int r =
                    kXOnly ? R : ((R >> 4) << 3) | (R & (kWarpRows - 1));
                v[t] = make_uint4(0, 0, 0, 0);
                if (idx < words && r < live)
                    v[t] = __ldg(reinterpret_cast<const uint4*>(
                        (!kXOnly && (R & kWarpRows) ? y : x) + base +
                        static_cast<size_t>(r) * wide + j * nloc +
                        4 * (idx & ((s >> 2) - 1))));
            }
#pragma unroll
            for (int t = 0; t < 4 * kU; ++t) {
                const int idx = idx0 + 32 * t, seg = idx >> (ls - 2);
                if (idx >= words) break;
                const int R = seg & (2 * kRows - 1), j = seg / (2 * kRows);
                const int i0 = j == 0 ? 0 : j == 1 ? p.cdin[0]
                                                   : p.cdin[0] + p.cdin[1];
                const uint32_t add = p.cadd[j];
                const int32_t a[4] = {static_cast<int32_t>(v[t].x + add),
                                      static_cast<int32_t>(v[t].y + add),
                                      static_cast<int32_t>(v[t].z + add),
                                      static_cast<int32_t>(v[t].w + add)};
                store_planes(
                    reinterpret_cast<uint32_t*>(planes1 + R * ks1 +
                                                (i0 << ls)) +
                        (idx & ((s >> 2) - 1)),
                    ls - 2, a, p.cdin[j], p.clb[j]);
            }
        }
        __syncwarp();

        // One product of all first planes against the first table's block,
        // at most kPass1 output tiles a pass, each table fragment serving
        // the kU m16 tiles.  In tile h accumulators 0, 1 are x's row 8h + g
        // and 2, 3 y's row 8h + g at the same two lanes: both are
        // recombined, multiplied and split under p2i in registers, into
        // product row 8h + g.  B13's are x's rows 16h + g and 16h + 8 + g,
        // each multiplied by the spectrum into the product row of its own;
        // B14's and B15's, recombined, are the segment's output rows.
        for (int nt0 = 0; nt0 < ntiles; nt0 += kPass1) {
            int acc[kU][kPass1][kSlots][4];
#pragma unroll
            for (int h = 0; h < kU; ++h)
#pragma unroll
                for (int t = 0; t < kPass1; ++t)
#pragma unroll
                    for (int j = 0; j < kSlots; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[h][t][j][e] = 0;
            const int8_t* pa = planes1 + g * ks1 + tig * 8;
            const int8_t* pb = wa + (nt0 * 8 + g) * ts1 + tig * 8;
#pragma unroll(kDepthUnroll)
            for (int k0 = 0; k0 < ca.kp; k0 += 32) {
                uint2 a_lo[kU], a_hi[kU];
#pragma unroll
                for (int h = 0; h < kU; ++h) {
                    a_lo[h] = *reinterpret_cast<const uint2*>(
                        pa + 2 * h * kWarpRows * ks1 + k0);
                    a_hi[h] = *reinterpret_cast<const uint2*>(
                        pa + (2 * h + 1) * kWarpRows * ks1 + k0);
                }
#pragma unroll
                for (int t = 0; t < kPass1; ++t)
#pragma unroll
                    for (int j = 0; j < kSlots; ++j)
                        if (kFull || (nt0 + t < ntiles && j < d)) {
                            const uint2 bf = table_fragment<kSmemTables>(
                                pb + ((j << ls) + t * 8) * ts1 + k0);
#pragma unroll
                            for (int h = 0; h < kU; ++h)
                                mma_s8(acc[h][t][j], a_lo[h], a_hi[h], bf);
                        }
            }
#pragma unroll
            for (int ht = 0; ht < kU * kPass1; ++ht) {
                const int h = ht / kPass1, t = ht % kPass1;
                if (!kFull && nt0 + t >= ntiles) continue;
                const int l0 = (nt0 + t) * 8 + tig * 2;
                if constexpr (kOne) {
                    // canonical, straight to device memory
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        uint32_t out[2];
#pragma unroll
                        for (int c = 0; c < 2; ++c)
                            out[c] = recombine_value(
                                cst[l0 + c] + p.kb1, d, p, [&](int j) {
                                    return acc[h][t][j][2 * e + c];
                                });
                        const int r = (2 * h + e) * kWarpRows + g;
                        if (r < live)
                            *reinterpret_cast<uint2*>(
                                z +
                                (static_cast<size_t>(shard) * batch + row0 +
                                 r) * static_cast<size_t>(nloc) +
                                (col << ls) + l0) = make_uint2(out[0], out[1]);
                    }
                    continue;
                }
                if constexpr (kFixed) {
                    int32_t zf[2][2];
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const uint32_t start = cst[l0 + c] + p.kb1;
                        const uint32_t a = cst[2 * s + l0 + c];
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const uint32_t v =
                                recombine_value(start, d, p, [&](int j) {
                                    return acc[h][t][j][2 * e + c];
                                });
                            zf[e][c] = static_cast<int32_t>(
                                mulmod_barrett(v, a, m) + p.add2);
                        }
                    }
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int row = (2 * h + e) * kWarpRows + g;
                        uint16_t* pr = reinterpret_cast<uint16_t*>(
                            planes2 + row * ks2 + l0);
                        for (int i = 0; i < p.din2; ++i)
                            pr[i << (ls - 1)] = pack_pair(
                                zf[e][0], zf[e][1], i, p.lb2, i == p.din2 - 1);
                    }
                    continue;
                }
                int32_t zz[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const uint32_t start = cst[l0 + c] + p.kb1;
                    const uint32_t vx = recombine_value(
                        start, d, p, [&](int j) { return acc[h][t][j][c]; });
                    const uint32_t vy = recombine_value(
                        start, d, p,
                        [&](int j) { return acc[h][t][j][2 + c]; });
                    zz[c] = static_cast<int32_t>(mulmod_barrett(vx, vy, m) +
                                                 p.add2);
                }
                // the two lanes' digits of a plane in one 16-bit store
                uint16_t* pr = reinterpret_cast<uint16_t*>(
                    planes2 + (h * kWarpRows + g) * ks2 + l0);
                for (int i = 0; i < p.din2; ++i) {
                    pr[i << (ls - 1)] = pack_pair(zz[0], zz[1], i, p.lb2,
                                                  i == p.din2 - 1);
                }
            }
        }
        // B14, B15: the next unit's split writes planes this one's product
        // read
        __syncwarp();
        if constexpr (kOne) continue;

        // The n2-block's inverse rows on the kBatch product rows (with one
        // unit the MMA's rows 8-15 are zero), straight to device memory.
        uint32_t* zrow = z + (static_cast<size_t>(shard) * batch + row0) *
                                 static_cast<size_t>(nloc) +
                         (col << ls);
        if constexpr (kFixed) {
            // B13: two m16 tiles of product rows, kU as in the first
            // product, each table fragment serving both
            for (int nt0 = 0; nt0 < ntiles; nt0 += kPass1) {
                int acc[kU][kPass1][kSlots][4];
#pragma unroll
                for (int h = 0; h < kU; ++h)
#pragma unroll
                    for (int t = 0; t < kPass1; ++t)
#pragma unroll
                        for (int j = 0; j < kSlots; ++j)
#pragma unroll
                            for (int e = 0; e < 4; ++e) acc[h][t][j][e] = 0;
                const int8_t* pa = planes2 + g * ks2 + tig * 8;
                const int8_t* pb = wb + (nt0 * 8 + g) * ts2 + tig * 8;
#pragma unroll(kDepthUnroll)
                for (int k2 = 0; k2 < cb.kp; k2 += 32) {
                    uint2 a_lo[kU], a_hi[kU];
#pragma unroll
                    for (int h = 0; h < kU; ++h) {
                        a_lo[h] = *reinterpret_cast<const uint2*>(
                            pa + 2 * h * kWarpRows * ks2 + k2);
                        a_hi[h] = *reinterpret_cast<const uint2*>(
                            pa + (2 * h + 1) * kWarpRows * ks2 + k2);
                    }
#pragma unroll
                    for (int t = 0; t < kPass1; ++t)
#pragma unroll
                        for (int j = 0; j < kSlots; ++j)
                            if (kFull || (nt0 + t < ntiles && j < d)) {
                                const uint2 bf = table_fragment<kSmemTables>(
                                    pb + ((j << ls) + t * 8) * ts2 + k2);
#pragma unroll
                                for (int h = 0; h < kU; ++h)
                                    mma_s8(acc[h][t][j], a_lo[h], a_hi[h],
                                           bf);
                            }
                }
#pragma unroll
                for (int t = 0; t < kPass1; ++t) {
                    if (!kFull && nt0 + t >= ntiles) break;
                    const int l0 = (nt0 + t) * 8 + tig * 2;
#pragma unroll
                    for (int he = 0; he < 2 * kU; ++he) {
                        const int h = he >> 1, e = he & 1;
                        uint32_t out[2];
#pragma unroll
                        for (int c = 0; c < 2; ++c)
                            out[c] = recombine_value(
                                cst[s + l0 + c] + p.kb2, d, p, [&](int j) {
                                    return acc[h][t][j][2 * e + c];
                                });
                        const int r = he * kWarpRows + g;
                        if (r < live)
                            *reinterpret_cast<uint2*>(
                                zrow + static_cast<size_t>(r) * nloc + l0) =
                                make_uint2(out[0], out[1]);
                    }
                }
            }
            // the next unit's split writes planes this one's products read
            __syncwarp();
            continue;
        }
        for (int nt0 = 0; nt0 < ntiles; nt0 += kPass2) {
            int acc[kPass2][kSlots][4];
#pragma unroll
            for (int t = 0; t < kPass2; ++t)
#pragma unroll
                for (int j = 0; j < kSlots; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[t][j][e] = 0;
            const int8_t* pa = planes2 + g * ks2 + tig * 8;
            const int8_t* pb = wb + (nt0 * 8 + g) * ts2 + tig * 8;
#pragma unroll(kDepthUnroll)
            for (int k0 = 0; k0 < cb.kp; k0 += 32) {
                const uint2 a_lo = *reinterpret_cast<const uint2*>(pa + k0);
                const uint2 a_hi =
                    kU > 1 ? *reinterpret_cast<const uint2*>(
                                 pa + kWarpRows * ks2 + k0)
                           : make_uint2(0, 0);
#pragma unroll
                for (int t = 0; t < kPass2; ++t)
#pragma unroll
                    for (int j = 0; j < kSlots; ++j)
                        if (kFull || (nt0 + t < ntiles && j < d))
                            mma_s8(acc[t][j], a_lo, a_hi,
                                   table_fragment<kSmemTables>(
                                       pb + ((j << ls) + t * 8) * ts2 + k0));
            }
#pragma unroll
            for (int t = 0; t < kPass2; ++t) {
                if (!kFull && nt0 + t >= ntiles) break;
                const int l0 = (nt0 + t) * 8 + tig * 2;
#pragma unroll
                for (int h = 0; h < kU; ++h) {
                    uint32_t out[2];
#pragma unroll
                    for (int c = 0; c < 2; ++c)
                        out[c] = recombine_value(
                            cst[s + l0 + c] + p.kb2, d, p,
                            [&](int j) { return acc[t][j][2 * h + c]; });
                    const int r = h * kWarpRows + g;
                    if (r < live)
                        *reinterpret_cast<uint2*>(
                            zrow + static_cast<size_t>(r) * nloc + l0) =
                            make_uint2(out[0], out[1]);
                }
            }
        }
        // the next unit's split writes planes this one's products read
        __syncwarp();
    }
}

// planes of an int32 value: at most 4 of base 256, 6 of base 128
inline bool valid_split(int din, int lb) {
    return din >= 1 && ((lb == 7 && din <= 6) || (lb == 8 && din <= 4));
}

// the shape fields of an SpClassPlan for `ops` operand rows a batch row and
// at most `slots` classes
inline bool valid_shape(const SpClassPlan& p, int ops, long long batch,
                        int k_local, int slots) {
    const bool pow2_tw = p.tw >= 8 && p.tw <= 128 && (p.tw & (p.tw - 1)) == 0;
    return p.rows >= ops && p.rows <= kMaxRows && p.rows % ops == 0 &&
           p.d >= 1 && p.d <= slots && pow2_tw &&
           p.nloc == 1 << p.lnloc && p.a * p.tw == p.nloc && p.nloc >= 8 &&
           p.lr >= 0 && p.lr <= p.logm &&
           (1 << p.logm) << p.llanes == p.nloc && (p.a >> p.lr) == 1 &&
           batch > 0 && k_local >= 1 && k_local <= 65535;
}

inline bool valid_compact(const CompactDims& c, int planes, int tw) {
    return c.ls >= 3 && (1 << c.ls) <= tw && c.llam == 0 && c.lq == 0 &&
           (1 << c.lbk) >= tw && c.kp % 32 == 0 && c.kp >= (planes << c.ls) &&
           c.kp < (planes << c.ls) + 32;
}

template <int kMode, bool kSmemTables, int kSlots, bool kFull>
int run(const void* a, const void* b, void* out, const void* w1,
        const void* c1, const void* w2, const void* c2, long long batch,
        int k_local, int warps, size_t smem, const SpClassPlan& p,
        void* stream) {
    auto kernel = seg2_compact_kernel<kMode, kSmemTables, kSlots, kFull>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    // a persistent grid: the blocks the card holds at once, shared out over
    // the (shard, n2-block) columns
    int resident = 0;
    if (const int err = resident_blocks(kernel, warps * 32, smem, &resident))
        return err;
    const int cols = p.nloc >> p.c1.ls;
    const int rows = batch_rows(kMode, p.rows);
    const long long units = (batch + rows - 1) / rows;
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

// kFull where the class count fills the slots and the tiles the passes:
// three classes for every mode, four for B12-B15 (the p-sets); any
// other plan takes the instantiation with run-time conditions
template <int kMode, bool kSmemTables>
int run_route(const void* a, const void* b, void* out, const void* w1,
              const void* c1, const void* w2, const void* c2,
              long long batch, int k_local, int warps, size_t smem,
              const SpClassPlan& p, void* stream) {
    constexpr int kSlots = kMode == kClassPlanes ? kClassSlots : kDigitSlots;
    const int ntiles = (1 << p.c1.ls) >> 3;
    if (p.d == 3 && ntiles % pass_tiles(3) == 0)
        return run<kMode, kSmemTables, 3, true>(
            a, b, out, w1, c1, w2, c2, batch, k_local, warps, smem, p, stream);
    if constexpr (kSlots == 4) {
        if (p.d == 4 && ntiles % pass_tiles(4) == 0)
            return run<kMode, kSmemTables, 4, true>(
                a, b, out, w1, c1, w2, c2, batch, k_local, warps, smem, p,
                stream);
    }
    return run<kMode, kSmemTables, kSlots, false>(
        a, b, out, w1, c1, w2, c2, batch, k_local, warps, smem, p, stream);
}

// The row segment's launcher: B12 (kPair; w1 the compact K2f, c1 its (tw)
// const row), B13 (kSpectrum; the same, b the spectrum rows (S, nloc)) or
// B18 (kClassPlanes; w1 the class tables' one block, c1 the shard slice of
// their const rows); w2 and c2 the shard slices of the compact K2i and its
// const rows.  B15 (kFolded): w1 and c1 the shard slices of the constant's
// compact F, (S, a, nblk, d * s, kp), and its const rows (S, a, tw); B14
// (kForward): w1 and c1 B12's; neither takes b, w2 or c2, and each a plan
// with no second split (din2 0, c2 zero).  A plan outside the kernel's
// range is refused, never run.
template <int kMode>
int launch(const void* a, const void* b, void* out, const void* w1,
           const void* c1, const void* w2, const void* c2, long long batch,
           int k_local, const void* plan, void* stream) {
    constexpr bool kClasses = kMode == kClassPlanes;
    const SpClassPlan p = *static_cast<const SpClassPlan*>(plan);
    const int slots = kClasses ? kClassSlots : kDigitSlots;
    bool ok = valid_shape(p, 2, batch, k_local, slots) &&
              p.rows == 2 * kWarpRows * units_of(kMode);
    // the input planes: B18's classes, each split on its own, or the one of
    // the others
    const int nin = kClasses ? p.d : 1;
    int sum = 0;
    for (int j = 0; ok && j < 3; ++j) {
        ok = j < nin ? valid_split(p.cdin[j], p.clb[j]) : p.cdin[j] == 0;
        sum += p.cdin[j];
    }
    const bool second =
        one_product(kMode)
            ? p.din2 == 0 && p.lb2 == 0 && p.kp2 == 0 && p.c2.ls == 0 &&
                  p.c2.kp == 0
            : valid_split(p.din2, p.lb2) &&
                  valid_compact(p.c2, p.din2, p.tw) && p.c1.ls == p.c2.ls;
    ok = ok && sum == p.din1 && second && valid_compact(p.c1, p.din1, p.tw) &&
         (p.nloc >> p.c1.ls) <= 65535;
    if (!ok) return cudaErrorInvalidValue;
    // as many warps a block as its shared memory holds, at most kMaxWarps
    const size_t shared = shared_smem(p, kMode), warp = warp_smem(p, kMode);
    if (shared + warp + kBlockReserve > kSmShared)
        return cudaErrorInvalidValue;
    const size_t fit = (kSmShared - kBlockReserve - shared) / warp;
    const int warps = fit < kMaxWarps ? static_cast<int>(fit) : kMaxWarps;
    const size_t smem = shared + warps * warp;
    auto route = p.smem_tables ? run_route<kMode, true>
                               : run_route<kMode, false>;
    return route(a, b, out, w1, c1, w2, c2, batch, k_local, warps, smem, p,
                 stream);
}

}  // namespace seg2
}  // namespace qt
