// The split form of the sequence-parallel column segments B11, B16 and B17
// for Hopper (sm_90a): the block-local products of shard rows past one
// block's reach.
//
// Replaces, from nloc = 32768 (parallel/sharded_mxu.py column_split), the
// Pallas TPU kernels of qtesla_tpu/parallel/sharded_mxu.py that
// sharded_mxu.cu's column_compact_kernel replaces below it:
//   qt_sp_seg1_split          <- _make_seg1 (l.481)          B11
//   qt_sp_seg3_split          <- _make_seg3 (l.622)          B16
//   qt_sp_seg1_classes_split  <- _make_seg1_classes (l.972)  B17
//
// What a call computes is what column_compact_kernel computes (the header
// note of sharded_mxu.cu), bit for bit on the canonical output; B17 the
// same raw class sums.  Where: column_compact_kernel keeps two rows of a
// shard (nloc values) and the shard's const rows in a block's shared
// memory, and from nloc = 32768 not one row fits.  So a call
// (parallel/sp_column_split.py) runs the column transform's Lr wide stages
// as B2's sweep launches (B16: B3's, after the products, n1^{-1} in the
// last) over the shards in device memory (pass_sweeps.cu, the index bits
// from log2(TW) up, the n1-point twiddles), and the tile-local part here,
// in one launch: block (walker, tile t, shard d) loads tile t's compact
// tables (K1's, K3's under p3 or p3x: sharded_mxu_tables.py compact_tables,
// 16-32 KiB at TW = 128) and const row once into shared memory, then walks
// over row groups of `rows` (32) batch rows: it copies lanes [t TW, t TW +
// TW) of each row in with cp.async (the next group's in flight while this
// one runs), splits them into digit planes, multiplies the planes by int8
// mma.sync m16n8k32 over the tile's nonzero blocks and recombines in place
// (mxu_compact.cuh split_compact, mma_compact, recombine_compact), and
// stores the tile back; B17 stages its raw class sums, biased, where the
// const row lies and copies them out as column_compact_kernel does.
// Grouping rows by tile is the point: a tile's tables are read once a
// block, not once a row.  A first design, right before fast: no TMA, no
// wgmma.
//
// Each launcher is extern "C" with the SP launchers' signature (a, b, out,
// w1, c1, w2, c2, twiddles, batch, k_local, &plan, stream): w1 the shard
// slice of the compact K1 (K3) (S, A, nblk, d * s, kp), c1 its const rows
// (S, A, TW) (B17: none), plan an SpCompactPlan (B17's with its class
// biases); b, w2, c2 and the twiddles are unused.  It checks the plan,
// launches without synchronising and returns cudaGetLastError().

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

// Field for field the SpPlan and SpCompactPlan ctypes.Structures of
// parallel/sharded_mxu.py, as sharded_mxu.cu restates them.
struct SpPlan {
    int32_t nloc, lnloc, tw, a, lr, logm, llanes, d, rows;
    uint32_t q, r32, r32_sh, one_sh;
    uint32_t pw[4], pw_sh[4];
    int32_t din1, lb1, kp1;
    uint32_t add1, kb1;
    int32_t din2, lb2, kp2;
    uint32_t add2, kb2;
};
struct SpCompactPlan : SpPlan {
    CompactDims c1, c2;
    int32_t smem_tables;
    uint32_t cls_b[3];
};

constexpr int kThreads = 256;
// words after each row of B17's staged class sums (sharded_mxu.cu's)
constexpr int kStagePad = 2;
// shared memory of one SM, and what the runtime reserves for each block
constexpr int kSmShared = 233472, kBlockReserve = 1024;

// Shared memory of one block (parallel/sp_column_split.py split_smem
// computes the same): two row buffers of one tile, its const row (B17: its
// staged class sums), the planes of a row group, the tile's tables.
size_t tile_smem(const SpCompactPlan& cp, bool class_sums) {
    const size_t tw = cp.tw, rows = cp.rows;
    const size_t staged =
        class_sums ? static_cast<size_t>(cp.d) * rows * (tw + kStagePad)
                   : tw;
    return (2 * rows * tw + staged) * sizeof(uint32_t) +
           (rows + 15) / 16 * 16 *
               qt::compact_row_stride(cp.tw >> cp.c1.ls, cp.c1.kp) +
           static_cast<size_t>(cp.d) * tw * cp.c1.kp;
}

// B11 and B16 store recombined values (B16's inverse sweeps follow), B17
// (kClassSums) its raw class sums.
template <bool kClassSums>
__global__ void __launch_bounds__(kThreads)
    column_tile_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ z,
                       const int8_t* __restrict__ wc,
                       const uint32_t* __restrict__ c1, long long batch,
                       const __grid_constant__ SpCompactPlan cp) {
    extern __shared__ __align__(16) uint32_t smem[];
    const SpPlan& p = cp;
    const CompactDims& c = cp.c1;
    const int tw = p.tw, tb = p.rows;
    const size_t nloc = p.nloc;
    const int ltw = __ffs(tw) - 1, lnblk = ltw - c.ls;
    const int ks = qt::compact_row_stride(1 << lnblk, c.kp);
    const size_t tile_bytes = static_cast<size_t>(p.d) * tw * c.kp;
    const int t = blockIdx.y, shard = blockIdx.z;
    uint32_t* cst = smem + 2 * tb * tw;        // after the two row buffers
    const int ss = tw + kStagePad;             // B17's staged row
    int8_t* planes = reinterpret_cast<int8_t*>(
        cst + (kClassSums ? p.d * tb * ss : tw));
    int8_t* wsm = planes + ((tb + 15) / 16 * 16) * ks;
    const long long groups = (batch + tb - 1) / tb;
    // lanes [t tw, t tw + tw) of the shard's rows
    const size_t lanes0 = static_cast<size_t>(shard) * batch * nloc +
                          static_cast<size_t>(t) * tw;
    const int lch = ltw - 2;                   // 16-byte chunks of a row

    // rows past the batch are zero-filled
    auto load_rows = [&](uint32_t* dst, long long rg) {
        const long long row0 = rg * tb;
        const int live =
            batch - row0 < tb ? static_cast<int>(batch - row0) : tb;
        for (int i = threadIdx.x; i < tb << lch; i += kThreads) {
            const int r = i >> lch, w = (i & ((1 << lch) - 1)) * 4;
            const bool ok = r < live;
            cp_async16(dst + r * tw + w,
                       ok ? x + lanes0 + (row0 + r) * nloc + w : x,
                       ok ? 16 : 0);
        }
    };

    // once a block: the tile's const row (B17 has none) and its tables
    if (!kClassSums)
        qt::cp_async_bytes(
            cst, c1 + static_cast<size_t>(shard) * nloc +
                     static_cast<size_t>(t) * tw,
            tw * sizeof(uint32_t));
    qt::cp_async_bytes(
        wsm, wc + (static_cast<size_t>(shard) * p.a + t) * tile_bytes,
        tile_bytes);
    if (blockIdx.x < groups) load_rows(smem, blockIdx.x);

    int cur = 0;                                // the buffer worked on
    for (long long rg = blockIdx.x; rg < groups; rg += gridDim.x, cur ^= 1) {
        uint32_t* data = smem + cur * tb * tw;
        cp_async_wait_all();
        __syncthreads();
        // the next group's rows arrive while this one is worked on; the
        // barrier above saw the other buffer's last reader off
        if (rg + gridDim.x < groups)
            load_rows(smem + (cur ^ 1) * tb * tw, rg + gridDim.x);

        qt::split_compact(data, tb, tw, ltw, planes, ks, c, 0, p.din1, p.lb1,
                          p.add1);
        __syncthreads();
        const long long row0 = rg * tb;
        const int live =
            batch - row0 < tb ? static_cast<int>(batch - row0) : tb;
        if constexpr (kClassSums) {
            // class j of row r at cst[(j * tb + r) * ss + lane]
            qt::mma_compact<true>(
                planes, tb, ks, wsm, lnblk, c, p.d,
                [&](int mm, int lt, const int (&acc)[kMaxClasses][4]) {
                    const int d = qt::warp_uniform(p.d);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = qt::tile_row(mm, e);
                        const int l = qt::compact_lane(qt::tile_lane(lt, e), c);
#pragma unroll
                        for (int j = 0; j < 3; ++j)
                            if (j < d && r < tb)
                                cst[(j * tb + r) * ss + l] =
                                    static_cast<uint32_t>(acc[j][e]) +
                                    cp.cls_b[j];
                    }
                });
            __syncthreads();
            // the staged rows out, 8 bytes a thread: row r of the output
            // holds d planes of nloc values, this tile's lanes of each; the
            // next group's split barrier sees these reads off
            const size_t wide = static_cast<size_t>(p.d) * nloc;
            uint32_t* dst = z + (static_cast<size_t>(shard) * batch + row0) *
                                    wide +
                            static_cast<size_t>(t) * tw;
            const int lpair = ltw - 1;
            for (int j = 0; j < p.d; ++j)
                for (int i = threadIdx.x; i < live << lpair; i += kThreads) {
                    const int r = i >> lpair, w = (i & ((1 << lpair) - 1)) * 2;
                    *reinterpret_cast<uint2*>(dst + r * wide + j * nloc + w) =
                        *reinterpret_cast<const uint2*>(
                            cst + (j * tb + r) * ss + w);
                }
        } else {
            qt::mma_compact<true>(
                planes, tb, ks, wsm, lnblk, c, p.d,
                [&](int mm, int lt, const int (&acc)[kMaxClasses][4]) {
                    qt::recombine_compact(data, tb, tw, mm, lt, acc, cst,
                                          p.kb1, c, p);
                });
            __syncthreads();
            uint32_t* dst = z + lanes0 + row0 * nloc;
            for (int i = threadIdx.x; i < live << lch; i += kThreads) {
                const int r = i >> lch, w = (i & ((1 << lch) - 1)) * 4;
                *reinterpret_cast<uint4*>(dst + r * nloc + w) =
                    *reinterpret_cast<const uint4*>(data + r * tw + w);
            }
        }
    }
    cp_async_wait_all();
}

// A plan outside the kernel's range is refused, never run.
template <bool kClassSums>
int launch_tile(const void* a, void* out, const void* w, const void* c1,
                long long batch, int k_local, const void* plan,
                void* stream) {
    const SpCompactPlan cp = *static_cast<const SpCompactPlan*>(plan);
    const SpPlan& p = cp;
    const CompactDims& c = cp.c1;
    constexpr bool classes = kClassSums;
    const bool pow2_tw = p.tw >= 8 && p.tw <= 128 && (p.tw & (p.tw - 1)) == 0;
    if (p.rows < 16 || p.rows > kMaxRows || p.rows % 16 != 0 || p.d < 1 ||
        p.d > (classes ? 3 : kMaxClasses) || !pow2_tw ||
        p.nloc != 1 << p.lnloc || p.a * p.tw != p.nloc || p.a > 65535 ||
        p.lr < 0 || (p.a >> p.lr) != 1 || p.din1 < 1 ||
        !((p.lb1 == 7 && p.din1 <= 6) || (p.lb1 == 8 && p.din1 <= 4)) ||
        c.ls < 3 || (1 << c.ls) > p.tw || c.llam < 0 || c.lbk < 0 ||
        c.lq != c.ls - 2 || c.kp % 32 != 0 || c.kp < (p.din1 << c.ls) ||
        c.kp >= (p.din1 << c.ls) + 32 || cp.smem_tables != 1 ||
        batch <= 0 || k_local < 1 || k_local > 65535 || !a || !out || !w ||
        (!classes && !c1))
        return cudaErrorInvalidValue;
    const size_t smem = tile_smem(cp, classes);
    if (smem + kBlockReserve > kSmShared) return cudaErrorInvalidValue;
    auto kernel = column_tile_kernel<kClassSums>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    // as many walkers a (tile, shard) as the card holds blocks for them
    int resident = 0;
    if (const int err = qt::resident_blocks(kernel, kThreads, smem, &resident))
        return err;
    const long long groups = (batch + cp.rows - 1) / cp.rows;
    long long walkers = resident / (static_cast<long long>(p.a) * k_local);
    walkers = walkers < 1 ? 1 : walkers > groups ? groups : walkers;
    kernel<<<dim3(static_cast<unsigned>(walkers), static_cast<unsigned>(p.a),
                  static_cast<unsigned>(k_local)),
             kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out),
        static_cast<const int8_t*>(w), static_cast<const uint32_t*>(c1),
        batch, cp);
    return cudaGetLastError();
}

}  // namespace

extern "C" int qt_sp_seg1_split(const void* a, const void*, void* out,
                                const void* w1, const void* c1, const void*,
                                const void*, const void*, long long batch,
                                int k_local, const void* plan, void* stream) {
    return launch_tile<false>(a, out, w1, c1, batch, k_local, plan, stream);
}
extern "C" int qt_sp_seg3_split(const void* a, const void*, void* out,
                                const void* w1, const void* c1, const void*,
                                const void*, const void*, long long batch,
                                int k_local, const void* plan, void* stream) {
    return launch_tile<false>(a, out, w1, c1, batch, k_local, plan, stream);
}
extern "C" int qt_sp_seg1_classes_split(const void* a, const void*, void* out,
                                        const void* w1, const void*,
                                        const void*, const void*, const void*,
                                        long long batch, int k_local,
                                        const void* plan, void* stream) {
    return launch_tile<true>(a, out, w1, nullptr, batch, k_local, plan,
                             stream);
}
