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
// Design.  One launch covers the k_local stacked shards, grid (row groups,
// shard), as in sharded_mxu.cu.  B17 holds `rows` input rows (at most 32)
// in shared memory and writes its Dout-times wider output straight from the
// MMA registers to device memory, so its shared memory is B11's and four
// 128-thread blocks fit an SM at q-III, k = 4.  B18 holds rows/2 batch rows
// of x and of y, each Dout * nloc values, picked as the kernels of B5 pick
// theirs (ops/ntt_mxu.py block_rows): at most 32 operand rows and 128 KiB
// of them.  At q-III, k = 4 (nloc = 256, Dout = 3) that is 16 batch rows,
// 96 KiB of rows plus 37 KiB of planes (K = 9 * 128 = 1152): one 512-thread
// block an SM; at k = 2 (nloc = 512) 10 batch rows, 157 KiB.  Each tile's
// recombined result goes in place into class plane 0's tile: the whole tile
// is split before the first write.
//
// What bounds it on the H100 (qtesla-iii-speed, B = 32768, k = 4, all
// shards on one card, bytes / 3.35 TB/s against the tables' nonzero int8
// MACs * 2 / 1979 TOP/s):
//   B17 (per operand) 134 MB in, 403 MB out: 0.160 ms, device memory;
//   B18               805 MB in, 134 MB out: 0.280 ms, device memory.
// The table (1.2 MB at K = 1152) stays in L2.  As in sharded_mxu.cu the
// phases are barrier-separated; no TMA and no wgmma.
//
// Each launcher is extern "C", takes raw pointers (sharded_mxu.cu's
// signature), the batch B (rows per shard), k_local, a pointer to an
// SpClassPlan and a stream, launches without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "mxu_block.cuh"

namespace {

using qt::block_matmul;
using qt::cp_async16;
using qt::cp_async_wait_all;
using qt::kMaxClasses;
using qt::kMaxRows;
using qt::kPad;
using qt::Mod;
using qt::mma_classes;
using qt::mulmod_barrett;
using qt::recombine_tile;
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
// depth, kb1 its recombination constant); digit plan 2 is B18's p2i.
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
};

// the threads an SM runs: 16 warps, in blocks of 128, 256 or 512
constexpr int kSmThreads = 512;
// shared memory of one SM, and what the runtime reserves for each block
constexpr int kSmShared = 233472, kBlockReserve = 1024;

enum Seg { kSeg1Classes, kSeg2Classes };

template <int SEG, int THREADS>
__global__ void __launch_bounds__(THREADS, kSmThreads / THREADS)
    classes_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ y, uint32_t* __restrict__ z,
                   const int8_t* __restrict__ w1,
                   const uint32_t* __restrict__ c1,
                   const int8_t* __restrict__ w2,
                   const uint32_t* __restrict__ c2,
                   const uint32_t* __restrict__ tw, long long batch,
                   const __grid_constant__ SpClassPlan p) {
    extern __shared__ __align__(16) uint32_t smem[];
    constexpr bool kSeg2 = SEG == kSeg2Classes;
    const int nloc = p.nloc, d = p.d, tws = p.tw;
    const uint32_t q = p.q;
    const int wide = d * nloc;                  // a row of class planes
    const int in_w = kSeg2 ? wide : nloc;       // an input row
    const int tb = kSeg2 ? p.rows / 2 : p.rows;  // batch rows a block
    const int ks = (p.kp1 > p.kp2 ? p.kp1 : p.kp2) + kPad;
    uint32_t* data = smem;
    int8_t* planes = reinterpret_cast<int8_t*>(smem + p.rows * in_w);
    const int shard = blockIdx.y;
    const long long row0 = static_cast<long long>(blockIdx.x) * tb;
    const int live = batch - row0 < tb ? static_cast<int>(batch - row0) : tb;
    const size_t row_base = static_cast<size_t>(shard) * batch + row0;
    const size_t in_base = row_base * static_cast<size_t>(in_w);

    // rows past the batch are zero-filled; B18 puts y's rows after x's
    for (int c = threadIdx.x * 4; c < tb * in_w; c += blockDim.x * 4) {
        const bool ok = c / in_w < live;
        cp_async16(data + c, ok ? x + in_base + c : x, ok ? 16 : 0);
        if (kSeg2)
            cp_async16(data + tb * in_w + c, ok ? y + in_base + c : y,
                       ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    if (!kSeg2) {
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
                            uint32_t* zr = zrow +
                                           static_cast<size_t>(r) * wide +
                                           t * tws + tile_lane(lt, e);
#pragma unroll
                            for (int j = 0; j < kMaxClassSlots; ++j)
                                if (j < du)
                                    zr[j * nloc] = static_cast<uint32_t>(
                                                       acc[mm][j][e]) +
                                                   cls_b[j];
                        }
                });
            __syncthreads();
        }
        return;
    }

    // B18: per tile, every class plane of x's and y's rows split into one K
    // dimension, one product against the shared table w1 (d * tw, kp1),
    // recombined into class plane 0's tile
    const uint32_t* c1_shard = c1 + static_cast<size_t>(shard) * p.a * tws;
    const uint32_t kb = p.kb1;
    zero_depth_pad(planes, p.rows, ks, p.din1 * tws, p.kp1);
    for (int t = 0; t < p.a; ++t) {
        int koff = 0;
        for (int j = 0; j < d; ++j) {
            split_block(data + j * nloc, p.rows, wide, tws, t, planes + koff,
                        ks, p.cdin[j], p.clb[j], p.cadd[j]);
            koff += p.cdin[j] * tws;
        }
        __syncthreads();
        const uint32_t* cb = c1_shard + t * tws;
        mma_classes(planes, p.rows, ks, w1, p.kp1, tws, d,
                    [&](int lt, const int (&acc)[2][kMaxClasses][4]) {
                        recombine_tile(data + t * tws, p.rows, wide, lt, acc,
                                       cb, kb, p);
                    });
        __syncthreads();
    }
    // the pointwise product of x's and y's results, then the shard's
    // inverse rows on x's class plane 0
    const Mod m{q, p.r32, p.r32_sh, p.one_sh};
    for (int idx = threadIdx.x; idx < tb * nloc; idx += blockDim.x) {
        uint32_t* v = data + (idx >> p.lnloc) * wide + (idx & (nloc - 1));
        v[0] = mulmod_barrett(v[0], v[tb * wide], m);
    }
    __syncthreads();
    const size_t tile2 = static_cast<size_t>(d) * tws * p.kp2;
    block_matmul(data, tb, wide, tws, p.a, planes, ks, w2 + shard * p.a * tile2,
                 tile2, p.kp2, c2 + static_cast<size_t>(shard) * p.a * tws,
                 tws, p.din2, p.lb2, p.add2, p.kb2, p);
    uint32_t* zrow = z + row_base * static_cast<size_t>(nloc);
    for (int c = threadIdx.x * 4; c < tb * nloc; c += blockDim.x * 4)
        if ((c >> p.lnloc) < live)
            *reinterpret_cast<uint4*>(zrow + c) =
                *reinterpret_cast<const uint4*>(
                    data + (c >> p.lnloc) * wide + (c & (nloc - 1)));
}

// din planes of a depth kp: din*tw rounded up to a multiple of 32
bool valid_depth(int din, int kp, int tw, int max_din) {
    return din >= 1 && din <= max_din && kp % 32 == 0 && kp >= din * tw &&
           kp < din * tw + 32;
}

bool valid_split(int din, int lb) {
    return din >= 1 && din <= 6 && (lb == 7 || lb == 8);
}

// One launch of classes_kernel<SEG, THREADS> with `smem` bytes a block.
template <int SEG, int THREADS>
int run(const void* a, const void* b, void* out, const void* w1,
        const void* c1, const void* w2, const void* c2, const void* tw,
        long long batch, long long blocks, int k_local, size_t smem,
        const SpClassPlan& p, void* stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            classes_kernel<SEG, THREADS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    classes_kernel<SEG, THREADS><<<dim3(static_cast<unsigned>(blocks),
                                        static_cast<unsigned>(k_local)),
                                   THREADS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), static_cast<const int8_t*>(w1),
        static_cast<const uint32_t*>(c1), static_cast<const int8_t*>(w2),
        static_cast<const uint32_t*>(c2), static_cast<const uint32_t*>(tw),
        batch, p);
    return cudaGetLastError();
}

template <int SEG>
int launch(const void* a, const void* b, void* out, const void* w1,
           const void* c1, const void* w2, const void* c2, const void* tw,
           long long batch, int k_local, const void* plan, void* stream) {
    const SpClassPlan p = *static_cast<const SpClassPlan*>(plan);
    constexpr int kOps = SEG == kSeg2Classes ? 2 : 1;
    const bool pow2_tw = p.tw >= 8 && p.tw <= 128 && (p.tw & (p.tw - 1)) == 0;
    bool ok = p.rows >= kOps && p.rows <= kMaxRows && p.rows % kOps == 0 &&
              p.d >= 1 && p.d <= kMaxClassSlots && pow2_tw &&
              p.nloc == 1 << p.lnloc && p.a * p.tw == p.nloc && p.nloc >= 8 &&
              p.lr >= 0 && p.lr <= p.logm &&
              (1 << p.logm) << p.llanes == p.nloc && (p.a >> p.lr) == 1;
    if (SEG == kSeg1Classes) {
        ok = ok && valid_depth(p.din1, p.kp1, p.tw, 6) &&
             valid_split(p.din1, p.lb1) && p.kp2 == 0;
    } else {
        int sum = 0;
        for (int j = 0; j < p.d; ++j) {
            ok = ok && valid_split(p.cdin[j], p.clb[j]);
            sum += p.cdin[j];
        }
        ok = ok && sum == p.din1 &&
             valid_depth(p.din1, p.kp1, p.tw, 6 * kMaxClassSlots) &&
             valid_depth(p.din2, p.kp2, p.tw, 6) && valid_split(p.din2, p.lb2);
    }
    if (!ok) return cudaErrorInvalidValue;
    const long long tb = p.rows / kOps;
    const long long blocks = (batch + tb - 1) / tb;
    if (batch <= 0 || blocks >= (1LL << 31) || k_local < 1 ||
        k_local > 65535)
        return cudaErrorInvalidValue;
    const int kmax = p.kp1 > p.kp2 ? p.kp1 : p.kp2;
    const int in_w = SEG == kSeg2Classes ? p.d * p.nloc : p.nloc;
    const size_t smem =
        static_cast<size_t>(p.rows) * in_w * sizeof(uint32_t) +
        static_cast<size_t>((p.rows + 15) / 16 * 16) * (kmax + kPad);
    if (smem + kBlockReserve > kSmShared) return cudaErrorInvalidValue;
    // blocks whose shared memory fits one SM
    const size_t fit = kSmShared / (smem + kBlockReserve);
    if (fit >= 4)
        return run<SEG, 128>(a, b, out, w1, c1, w2, c2, tw, batch, blocks,
                             k_local, smem, p, stream);
    if (fit >= 2)
        return run<SEG, 256>(a, b, out, w1, c1, w2, c2, tw, batch, blocks,
                             k_local, smem, p, stream);
    return run<SEG, 512>(a, b, out, w1, c1, w2, c2, tw, batch, blocks,
                         k_local, smem, p, stream);
}

}  // namespace

#define QT_CLASSES_LAUNCHER(name, seg)                                        \
    extern "C" int name(const void* a, const void* b, void* out,             \
                        const void* w1, const void* c1, const void* w2,      \
                        const void* c2, const void* tw, long long batch,     \
                        int k_local, const void* plan, void* stream) {       \
        return launch<seg>(a, b, out, w1, c1, w2, c2, tw, batch, k_local,    \
                           plan, stream);                                    \
    }

QT_CLASSES_LAUNCHER(qt_sp_seg1_classes, kSeg1Classes)
QT_CLASSES_LAUNCHER(qt_sp_seg2_classes, kSeg2Classes)
