// Sequence-parallel (four-step) digit-matmul segment kernels for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of qtesla_tpu/parallel/sharded_mxu.py:
//   qt_sp_seg1        <- _make_seg1 (l.481)                  B11
//   qt_sp_seg2        <- _make_seg2 / _seg2_block (l.520)    B12
//   qt_sp_seg2_fixed  <- _make_seg2_fixed (l.533)            B13
//   qt_sp_seg2_fwd    <- _make_seg2_fwd_only (l.548)         B14
//   qt_sp_seg2_folded <- _make_seg2_folded (l.563)           B15
//   qt_sp_seg3        <- _make_seg3 (l.622)                  B16
//
// What they compute.  The four-step polymul n = n1 x n2 splits each
// transform over a model axis of k shards; shard d holds nloc = n1 * n2/k
// values of a row (parallel/sharded_mxu_tables.py), cut into A tiles of TW
// lanes.  Per row of a shard:
//   seg1: the Lr wide stages of the n1-point merged-psi forward along j1
//         (super-lanes of n2/k values), then per tile one digit-matmul
//         against K1[d, t] (the tile-local stages with psi^{j2} and
//         w^{k1 j2} folded in);
//   seg2: per tile, the shared row transform K2f on x and on y, the Barrett
//         pointwise product, then K2i[d, t] (inverse rows with w^{-k1 j2});
//   seg2 fixed (B13): seg2 with y the constant's stored spectrum, one row
//         per shard (any uint32: the Barrett product is exact for all);
//   seg2 fwd (B14): K2f only, the last step of a constant's spectrum;
//   seg2 folded (B15): per tile one digit-matmul against the constant's
//         F[d, t] = K2f diag(A^[d, t]) K2i[d, t] under the plan p2x;
//   seg3: per tile K3[d, t] (tile-local inverse stages with psi^{-j2}),
//         then the Lr inverse wide stages with n1^{-1} in the last; at
//         Lr = 0 the matrix carries n1^{-1}.  The folded path runs it under
//         the plan p3x (its own tables, the same kernel).
// The wide stages are mxu_block.cuh's; every segment multiplies through
// mxu_compact.cuh, over its tables' nonzero blocks alone.  Every output is
// canonical, and canonical inputs lie below every plan's split
// bound, so the JAX plans' split parameters serve unchanged; the TPU
// kernel's lazy hand-offs between segments are not replayed.
//
// Design of B12, B13, B14 and B15.  seg2_compact.cuh's
// seg2_compact_kernel, the body B18 runs too (modes kPair, kSpectrum,
// kForward and kFolded: one input plane a value, split under p2f, or p2x
// for B15, and K2f's block of this n2-block's place in the tile, shared by
// every shard, or B15's block of the constant's folded F for this shard,
// tile and n2-block): the tables' nonzero blocks alone
// (SpDeviceTables.w2fc, .w2ic; FoldedSpOperand.w), a persistent grid of
// (walkers, n2-blocks, shard) with each block's tables in shared memory
// (through L2 at n = 8192), each warp taking 16 rows of x and 16 of y
// (B13, B14 and B15: 32 of x; B13 also its shard's spectrum lanes read
// once a block) through its products (B14 and B15: one) with no block
// barrier.  One launch covers the k_local stacked shards (k_local, B,
// nloc) of a call; a rank of a multi-process run launches it with k_local
// = 1 and its own table slice.  That header keeps the design and the
// times of the dense modes these four ran as before they took that body.
//
// Design of B11, B16 and B17 (column_compact_kernel, one body, the
// direction a template parameter: B11 runs the forward wide stages, then
// the products; B16 the products, then the inverse wide stages; B17 B11's
// stages and products, then stores the raw class sums: sharded_classes.cu
// keeps its design note).  K1 and K3 are both
// kron(M, I_n2k): they couple only lanes of equal lambda, so in
// lambda-major order a tile is n2k diagonal blocks of Bk lanes (1/8 of a
// dense tile at qtesla-iii-speed, k = 4), and the planner hands over those
// blocks alone (compact_tables; mxu_compact.cuh).  The kernel
//   - multiplies every 8-lane output tile over its own block's depth,
//     din * s padded to 32: 64 where the dense product ran 384 (B11) and
//     512 (B16, p3 and p3x at 4 planes).  Blocks
//     narrower than 8 lanes (Bk = 4: qtesla-p-iii at k = 2, n = 8192 at
//     k = 4, smallprime) are widened to 8 positions, so half of such a
//     block's products meet zeros; no plan takes a dense route;
//   - is persistent: grid (blocks an SM can hold * SMs / shards, shard),
//     each block walking over its shard's row groups.  It loads the shard's
//     compact tables and const rows once into shared memory with cp.async
//     (48 KiB + 1 KiB at qtesla-iii-speed, k = 4), so no table load goes to
//     L2 inside the MMA loop, and keeps two row buffers: the next group's
//     cp.async loads are in flight while this group runs its wide stages,
//     split (four digits a word, byte permutes at base 256), products and
//     recombination;
//   - shared memory at qtesla-iii-speed, k = 4: 2 x 16 rows (32 KiB), const
//     rows 1 KiB, planes 16 x 608 B (9.5 KiB), tables 48 KiB (B16 the
//     same, K3 under p3 or p3x): 90.5 KiB, two 256-thread blocks an SM.
//     Where one block fits it takes 32 rows and 512 threads.  Where the
//     shard's tables do not fit beside two row buffers (qtesla-p-iii at
//     k = 2, n = 8192: 160-192 KiB of tables) the same kernel reads the
//     compact blocks through L2 (kSmemTables false);
//     parallel/sharded_mxu.py seg1_compact_plan and seg3_compact_plan pick
//     the rows and the route, the launcher checks them.
// B17 stages its class sums where the const rows lie and copies them out.
// B16 ran as a mode of the dense segment kernel until it took this design:
// 512-deep products against K3 streamed from L2 once per 32-row group, then
// the inverse wide stages, 0.69 ms at qtesla-iii-speed, k = 4 (PERF.md).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, utils/phase_ablation.py,
// utils/ab_timing.py): the dense B11 took 0.60 ms, 0.20 of it products and
// 0.16 their table stream; over the nonzero blocks 0.36, with four digits
// packed a word 0.32, with the byte permutes of base 256 0.31.  The
// recombined tile staged at a stride of TW + 1 words (eight banks where the
// in-place store's eight rows share one) and stored out tile by tile ran
// 6 % slower and was left out.
//
// What bounds them on the H100 (qtesla-iii-speed, B = 32768, k = 4, all
// shards on one card, bytes / 3.35 TB/s against int8 MACs * 2 / 1979 TOP/s,
// the MACs of the tables' nonzero blocks: K1 and K3 are kron(M, I_n2k),
// 1/n2k = 1/8 of a dense tile, and K2f, K2i and the folded F block-diagonal
// over n2-blocks, n2/TW = 1/4):
//   B11 (per operand) 269 MB, 4.8e9 MACs: 0.080 ms, device memory;
//   B12               404 MB, 3.5e10 MACs: 0.121 ms, device memory;
//   B16               270 MB, 6.4e9 MACs: 0.081 ms, device memory;
//   B13               270 MB, 2.3e10 MACs: 0.081 ms, device memory;
//   B14               269 MB, 1.3e10 MACs: 0.080 ms, device memory;
//   B15               270 MB, 9.7e9 MACs: 0.080 ms, device memory (p2x
//                     takes 3 planes where B13's K2f and K2i take 4 + 3;
//                     the operand's nonzero blocks are 0.3 MB).
// The tables (0.2-1.6 MB for all shards) stay in L2.
//
// Each launcher is extern "C", takes raw pointers, the batch B (rows per
// shard), k_local, a pointer to its plan (B11, B16: an SpCompactPlan; B12-
// B15: an SpClassPlan) and a stream, launches without synchronising and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "mxu_block.cuh"
#include "mxu_compact.cuh"
#include "seg2_compact.cuh"

namespace {

using qt::CompactDims;
using qt::cp_async16;
using qt::cp_async_wait_all;
using qt::kMaxClasses;
using qt::kMaxRows;

// Field for field the SpPlan ctypes.Structure of parallel/sharded_mxu.py.
// Digit plan 1 is seg1's p1, seg2's p2f (shared) or seg3's p3; digit plan 2
// is seg2's p2i.  kp is a plan's table depth, din * tw rounded up to 32.
struct SpPlan {
    int32_t nloc, lnloc, tw, a, lr, logm, llanes, d, rows;
    uint32_t q, r32, r32_sh, one_sh;
    uint32_t pw[4], pw_sh[4];
    int32_t din1, lb1, kp1;
    uint32_t add1, kb1;
    int32_t din2, lb2, kp2;
    uint32_t add2, kb2;
};

// the threads an SM runs: 16 warps, in blocks of 256 or 512
constexpr int kSmThreads = 512;
// shared memory of one SM, and what the runtime reserves for each block
constexpr int kSmShared = 233472, kBlockReserve = 1024;

// ----------------------------------------------------------------------
// B11, B16 and B17 over K1's and K3's nonzero blocks (header note: design
// of B11, B16 and B17).
// ----------------------------------------------------------------------

// Field for field the SpCompactPlan ctypes.Structure of
// parallel/sharded_mxu.py: SpPlan's fields, the compact layout of K1 or K3
// (c2 unused), whether the shard's tables are held in shared memory, and
// the bias B17 adds to each class sum (B11 and B16 leave it 0).
struct SpCompactPlan : SpPlan {
    CompactDims c1, c2;
    int32_t smem_tables;
    uint32_t cls_b[3];
};

// the directions of column_compact_kernel, numbered so that the
// instantiation names utils/sass_diff.py matches across trees keep B11 at 0
// and B16 at 1
enum ColumnDir : int { kColumnFwd = 0, kColumnInv = 1, kColumnClasses = 2 };

// Words after each row of B17's staged class sums: a row of TW + 2 words
// puts the eight rows of an MMA tile's half two banks apart, so the
// epilogue's 4-byte stores meet at most two to a bank at qtesla-iii-speed,
// k = 4 (TW + 4 four, TW sixteen), and keeps 8-byte chunks aligned for the
// copy out.
constexpr int kStagePad = 2;

// Words B17 stages a tile's class sums in: d planes of `rows` rows.
__host__ __device__ inline int class_stage_words(const SpPlan& p) {
    return p.d * p.rows * (p.tw + kStagePad);
}

// Shared memory of one column_compact_kernel block: two row buffers, the
// shard's const rows (B17: its staged class sums), the digit planes of one
// tile, the shard's tables.
size_t column_compact_smem(const SpCompactPlan& cp, bool class_sums) {
    const SpPlan& p = cp;
    const int nblk = p.tw >> cp.c1.ls;
    const size_t tables =
        static_cast<size_t>(p.a) * p.d * p.tw * cp.c1.kp;
    return (2 * static_cast<size_t>(p.rows) * p.nloc +
            (class_sums ? class_stage_words(p) : p.nloc)) *
               sizeof(uint32_t) +
           static_cast<size_t>((p.rows + 15) / 16 * 16) *
               qt::compact_row_stride(nblk, cp.c1.kp) +
           (cp.smem_tables ? tables : 0);
}

// The column segments: B11 (kColumnFwd) runs the forward wide stages, then
// per tile the product against K1; B16 (kColumnInv) per tile the product
// against K3, then the inverse wide stages; B17 (kColumnClasses) B11's
// stages and products, its raw class sums, biased, staged in shared memory
// by lane and copied out row by row.
template <int THREADS, bool kSmemTables, int kDir>
__global__ void __launch_bounds__(THREADS, kSmThreads / THREADS)
    column_compact_kernel(const uint32_t* __restrict__ x,
                          uint32_t* __restrict__ z,
                          const int8_t* __restrict__ wc,
                          const uint32_t* __restrict__ c1,
                          const uint32_t* __restrict__ tw, long long batch,
                          const __grid_constant__ SpCompactPlan cp) {
    constexpr bool kInverse = kDir == kColumnInv;
    constexpr bool kClassSums = kDir == kColumnClasses;
    extern __shared__ __align__(16) uint32_t smem[];
    const SpPlan& p = cp;
    const CompactDims& c = cp.c1;
    const int nloc = p.nloc, tb = p.rows;
    const int ltw = __ffs(p.tw) - 1, lnblk = ltw - c.ls;
    const int ks = qt::compact_row_stride(1 << lnblk, c.kp);
    const size_t tile_bytes = static_cast<size_t>(p.d) * p.tw * c.kp;
    uint32_t* cst = smem + 2 * tb * nloc;      // after the two row buffers
    // B17 stages its class sums where the others keep their const rows
    int8_t* planes = reinterpret_cast<int8_t*>(
        cst + (kClassSums ? class_stage_words(p) : nloc));
    const int shard = blockIdx.y;
    const int8_t* wt = wc + shard * p.a * tile_bytes;
    const long long groups = (batch + tb - 1) / tb;

    // rows past the batch are zero-filled
    auto load_rows = [&](uint32_t* dst, long long rg) {
        const long long row0 = rg * tb;
        const int live =
            batch - row0 < tb ? static_cast<int>(batch - row0) : tb;
        const uint32_t* src =
            x + (static_cast<size_t>(shard) * batch + row0) *
                    static_cast<size_t>(nloc);
        for (int i = threadIdx.x * 4; i < tb * nloc; i += THREADS * 4) {
            const bool ok = (i >> p.lnloc) < live;
            cp_async16(dst + i, ok ? src + i : x, ok ? 16 : 0);
        }
    };

    // once a block: the shard's const rows (B17 has none) and, where they
    // fit, its tables
    if (!kClassSums)
        qt::cp_async_bytes(cst, c1 + static_cast<size_t>(shard) * nloc,
                           nloc * sizeof(uint32_t));
    if (kSmemTables) {
        int8_t* wsm = planes + ((tb + 15) / 16 * 16) * ks;
        qt::cp_async_bytes(wsm, wt, p.a * tile_bytes);
        wt = wsm;
    }
    if (blockIdx.x < groups) load_rows(smem, blockIdx.x);

    int cur = 0;                                // the buffer worked on
    for (long long rg = blockIdx.x; rg < groups; rg += gridDim.x, cur ^= 1) {
        uint32_t* data = smem + cur * tb * nloc;
        cp_async_wait_all();
        __syncthreads();
        // the next group's rows arrive while this one is worked on; the
        // barrier above saw the other buffer's last reader off
        if (rg + gridDim.x < groups)
            load_rows(smem + (cur ^ 1) * tb * nloc, rg + gridDim.x);

        if (!kInverse) qt::fwd_wide(data, tb, p.logm, p.llanes, p.lr, tw, p.q);
        for (int t = 0; t < p.a; ++t) {
            uint32_t* tile = data + t * p.tw;
            qt::split_compact(tile, tb, nloc, ltw, planes, ks, c, 0, p.din1,
                              p.lb1, p.add1);
            __syncthreads();
            if constexpr (kClassSums) {
                // class j of row r at cst[(j * tb + r) * ss + lane]
                const int ss = p.tw + kStagePad;
                qt::mma_compact<kSmemTables>(
                    planes, tb, ks, wt + t * tile_bytes, lnblk, c, p.d,
                    [&](int mm, int lt, const int (&acc)[kMaxClasses][4]) {
                        const int d = qt::warp_uniform(p.d);
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int r = qt::tile_row(mm, e);
                            const int l =
                                qt::compact_lane(qt::tile_lane(lt, e), c);
#pragma unroll
                            for (int j = 0; j < 3; ++j)
                                if (j < d && r < tb)
                                    cst[(j * tb + r) * ss + l] =
                                        static_cast<uint32_t>(acc[j][e]) +
                                        cp.cls_b[j];
                        }
                    });
                __syncthreads();
                // the staged rows out, 8 bytes a thread, a warp's stores
                // whole 256-byte runs of a row of Dout planes of nloc
                // values; the next tile's split barrier sees these reads
                // off before its epilogue stages again
                const size_t wide = static_cast<size_t>(p.d) * nloc;
                const long long row0 = rg * tb;
                const int live =
                    batch - row0 < tb ? static_cast<int>(batch - row0) : tb;
                uint32_t* dst =
                    z + (static_cast<size_t>(shard) * batch + row0) * wide +
                    t * p.tw;
                const int lch = ltw - 1;        // 8-byte chunks of a row
                for (int j = 0; j < p.d; ++j)
                    for (int i = threadIdx.x; i < live << lch; i += THREADS) {
                        const int r = i >> lch, w = (i & ((1 << lch) - 1)) * 2;
                        *reinterpret_cast<uint2*>(dst + r * wide + j * nloc +
                                                  w) =
                            *reinterpret_cast<const uint2*>(
                                cst + (j * tb + r) * ss + w);
                    }
            } else {
            const uint32_t* cb = cst + t * p.tw;
            qt::mma_compact<kSmemTables>(
                planes, tb, ks, wt + t * tile_bytes, lnblk, c, p.d,
                [&](int mm, int lt, const int (&acc)[kMaxClasses][4]) {
                    qt::recombine_compact(tile, tb, nloc, mm, lt, acc, cb,
                                          p.kb1, c, p);
                });
            __syncthreads();
            }
        }
        if (kInverse) qt::inv_wide(data, tb, p.logm, p.llanes, p.lr, tw, p.q);
        if constexpr (!kClassSums) {
        const long long row0 = rg * tb;
        const int live =
            batch - row0 < tb ? static_cast<int>(batch - row0) : tb;
        uint32_t* dst = z + (static_cast<size_t>(shard) * batch + row0) *
                                static_cast<size_t>(nloc);
        for (int i = threadIdx.x * 4; i < live * nloc; i += THREADS * 4)
            *reinterpret_cast<uint4*>(dst + i) =
                *reinterpret_cast<const uint4*>(data + i);
        }
    }
    cp_async_wait_all();
}

template <int THREADS, bool kSmemTables, int kDir>
int run_column_compact(const void* a, void* out, const void* w,
                       const void* c1, const void* tw, long long batch,
                       int k_local, size_t smem, const SpCompactPlan& cp,
                       void* stream) {
    auto kernel = column_compact_kernel<THREADS, kSmemTables, kDir>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    int resident = 0;
    if (const int err = qt::resident_blocks(kernel, THREADS, smem, &resident))
        return err;
    const long long groups = (batch + cp.rows - 1) / cp.rows;
    long long walkers = resident / k_local;
    walkers = walkers < 1 ? 1 : walkers > groups ? groups : walkers;
    kernel<<<dim3(static_cast<unsigned>(walkers),
                  static_cast<unsigned>(k_local)),
             THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out),
        static_cast<const int8_t*>(w), static_cast<const uint32_t*>(c1),
        static_cast<const uint32_t*>(tw), batch, cp);
    return cudaGetLastError();
}

// A plan outside the kernel's range is refused, never run.
template <int kDir>
int launch_column_compact(const void* a, void* out, const void* w,
                          const void* c1, const void* tw, long long batch,
                          int k_local, const void* plan, void* stream) {
    const SpCompactPlan cp = *static_cast<const SpCompactPlan*>(plan);
    const SpPlan& p = cp;
    const CompactDims& c = cp.c1;
    const bool pow2_tw = p.tw >= 8 && p.tw <= 128 && (p.tw & (p.tw - 1)) == 0;
    if (p.rows < 1 || p.rows > kMaxRows || p.d < 1 || p.d > kMaxClasses ||
        !pow2_tw || p.nloc != 1 << p.lnloc || p.a * p.tw != p.nloc ||
        p.nloc < 8 || p.lr < 0 || p.lr > p.logm ||
        (1 << p.logm) << p.llanes != p.nloc || (p.a >> p.lr) != 1 ||
        p.din1 < 1 || !((p.lb1 == 7 && p.din1 <= 6) ||
                        (p.lb1 == 8 && p.din1 <= 4)) ||
        c.ls < 3 || (1 << c.ls) > p.tw || c.llam < 0 || c.lbk < 0 ||
        c.lq != c.ls - 2 || c.kp % 32 != 0 || c.kp < (p.din1 << c.ls) ||
        c.kp >= (p.din1 << c.ls) + 32 || batch <= 0 || k_local < 1 ||
        k_local > 65535)
        return cudaErrorInvalidValue;
    // B17: at most 3 classes
    if (kDir == kColumnClasses && p.d > 3) return cudaErrorInvalidValue;
    const size_t smem = column_compact_smem(cp, kDir == kColumnClasses);
    if (smem + kBlockReserve > kSmShared) return cudaErrorInvalidValue;
    const bool two = 2 * (smem + kBlockReserve) <= kSmShared;
    if (cp.smem_tables)
        return two ? run_column_compact<256, true, kDir>(
                         a, out, w, c1, tw, batch, k_local, smem, cp, stream)
                   : run_column_compact<512, true, kDir>(
                         a, out, w, c1, tw, batch, k_local, smem, cp, stream);
    return two ? run_column_compact<256, false, kDir>(
                     a, out, w, c1, tw, batch, k_local, smem, cp, stream)
               : run_column_compact<512, false, kDir>(
                     a, out, w, c1, tw, batch, k_local, smem, cp, stream);
}

}  // namespace

namespace qt {

// B17's launcher, which sharded_classes.cu's qt_sp_seg1_classes calls: w
// the shard slice of the compact K1 (tabs.w1c), plan an SpCompactPlan with
// cls_b.
int launch_seg1_classes(const void* a, void* out, const void* w,
                        const void* tw, long long batch, int k_local,
                        const void* plan, void* stream) {
    return launch_column_compact<kColumnClasses>(a, out, w, nullptr, tw,
                                                 batch, k_local, plan, stream);
}

}  // namespace qt

// B11 and B16: w1 the shard slice of the compact K1 (tabs.w1c) or K3
// (tabs.w3c, tabs.w3xc under p3x), plan an SpCompactPlan; b, w2 and c2
// unused
extern "C" int qt_sp_seg1(const void* a, const void*, void* out,
                          const void* w1, const void* c1, const void*,
                          const void*, const void* tw, long long batch,
                          int k_local, const void* plan, void* stream) {
    return launch_column_compact<kColumnFwd>(a, out, w1, c1, tw, batch,
                                             k_local, plan, stream);
}
extern "C" int qt_sp_seg3(const void* a, const void*, void* out,
                          const void* w1, const void* c1, const void*,
                          const void*, const void* tw, long long batch,
                          int k_local, const void* plan, void* stream) {
    return launch_column_compact<kColumnInv>(a, out, w1, c1, tw, batch,
                                             k_local, plan, stream);
}
// B12 and B13: w1 and c1 the compact K2f (tabs.w2fc) and its const row,
// w2 and c2 the shard slices of the compact K2i and its const rows, plan
// an SpClassPlan; b B12's y shards or B13's spectrum rows (S, nloc); tw
// unused
extern "C" int qt_sp_seg2(const void* a, const void* b, void* out,
                          const void* w1, const void* c1, const void* w2,
                          const void* c2, const void*, long long batch,
                          int k_local, const void* plan, void* stream) {
    return qt::seg2::launch<qt::seg2::kPair>(a, b, out, w1, c1, w2, c2, batch,
                                             k_local, plan, stream);
}
extern "C" int qt_sp_seg2_fixed(const void* a, const void* b, void* out,
                                const void* w1, const void* c1,
                                const void* w2, const void* c2, const void*,
                                long long batch, int k_local,
                                const void* plan, void* stream) {
    return qt::seg2::launch<qt::seg2::kSpectrum>(a, b, out, w1, c1, w2, c2,
                                                 batch, k_local, plan,
                                                 stream);
}
// B15: w1 and c1 the shard slices of the constant's compact folded F
// (FoldedSpOperand.w) and its const rows, plan an SpClassPlan with no
// second split; b, w2, c2 and tw unused
extern "C" int qt_sp_seg2_folded(const void* a, const void*, void* out,
                                 const void* w1, const void* c1, const void*,
                                 const void*, const void*, long long batch,
                                 int k_local, const void* plan,
                                 void* stream) {
    return qt::seg2::launch<qt::seg2::kFolded>(a, nullptr, out, w1, c1,
                                               nullptr, nullptr, batch,
                                               k_local, plan, stream);
}
// B14: w1 and c1 the compact K2f (tabs.w2fc) and its const row, plan an
// SpClassPlan with no second split; b, w2, c2 and tw unused
extern "C" int qt_sp_seg2_fwd(const void* a, const void*, void* out,
                              const void* w1, const void* c1, const void*,
                              const void*, const void*, long long batch,
                              int k_local, const void* plan, void* stream) {
    return qt::seg2::launch<qt::seg2::kForward>(a, nullptr, out, w1, c1,
                                                nullptr, nullptr, batch,
                                                k_local, plan, stream);
}
