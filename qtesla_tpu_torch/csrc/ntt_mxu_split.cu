// The split form of the digit-matmul (MXU-form) kernels B5-B9 for Hopper
// (sm_90a): the block-local stages of rows past one block's reach.
//
// Replaces, from n = 32768 (ops/ntt_mxu.py SPLIT_FROM), the Pallas TPU
// kernels of qtesla_tpu/ops/ntt_mxu.py that ntt_mxu.cu replaces below it:
//   qt_polymul_mxu_split        <- polymul_mxu_fn's kernel       (l.982)  B5
//   qt_ntt_mxu_split            <- ntt_mxu_fn's kernel           (l.1041) B6
//   qt_intt_mxu_split           <- intt_mxu_fn's kernel          (l.1061) B7
//   qt_polymul_fixed_mxu_split  <- polymul_fixed_mxu_fn's kernel (l.1012) B8
//   qt_polymul_fixed_folded_mxu_split
//                  <- polymul_fixed_folded_mxu_fn's kernel (l.1210)      B9
//
// What a call computes is what ntt_mxu.cu's stream kernel computes (its
// header note), bit for bit on the canonical output.  Where: from n = 32768
// a row of x and one of y no longer fit a block's shared memory, so a call
// (ops/ntt_mxu_split.py) runs the Lr = log2(n / 128) wide stages as B2's and
// B3's sweep launches over the rows in device memory (pass_sweeps.cu, plans
// over the index bits from 7 up: B2's end canonical, inside every forward
// split's bound) and the block-local stages here, in one launch: block
// (lane block lb, group g) takes lanes [128 lb, 128 lb + 128) of `rows`
// batch rows (B5: of x's and of y's) into shared memory, splits them into
// digit planes, multiplies them by int8 mma.sync m16n8k32 against lane
// block lb's forward stages of the table stream (ops/mxu_tables.py
// stream_tables, the stages ntt_mxu.cu streams), recombines (B5: times y's
// recombined lanes; B8: times the spectrum's lanes; B9: stored as they
// are), splits again and runs the inverse's products (B9: against the
// constant's stages) and recombination, storing to device memory.  B6 stores
// after the forward; B7 starts at the inverse, on its input below pw_bound.
//
// What bounds it on an H100: the tables.  They are (Df + Di) * D * 128 * n
// bytes (4.3 GB at n = 2^20, q = 1012924417), past L2 from n = 2^17, and a
// design that streamed them once a row (ntt_mxu.cu's, a block a row group)
// would read them B times.  Here a block holds `rows` rows of one lane
// block: 64 of x (B5: 32 of x and 32 of y), four 16-row MMA tiles against
// each table fragment, so a lane block's tables are read once per 64 rows,
// and the blocks of one lane block are neighbours in the grid, so those
// reads after the first meet them in L2.  Each warp takes 8 output lanes
// of every class (the fragments of a stage are disjoint between warps, so
// shared memory would save no read): it loads its fragments of stage c + 1
// from device memory while it multiplies stage c.  A first design, right
// before fast: no TMA, no wgmma, no persistent blocks.
//
// Each launcher is extern "C" (a, b, out, stream_f, cf, stream_i, ci, tw,
// batch, &plan, stream), checks the plan, launches without synchronising
// and returns cudaGetLastError(); tw is unused (the wide stages are the
// sweeps').

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "mxu_block.cuh"
#include "mxu_compact.cuh"

namespace {

using qt::cp_async16;
using qt::cp_async_wait_all;
using qt::kMaxClasses;
using qt::kPad;
using qt::Mod;
using qt::mulmod_barrett;

// Field for field the MxuSplitPlan ctypes.Structure of
// ops/ntt_mxu_split.py: ntt_mxu.cu's MxuPlan fields (rows: x rows a block),
// the stages of a lane block's forward and inverse tables, the mode.
struct MxuSplitPlan {
    int32_t n, logn, bw, nb, lr, d, rows, df, fwd_lb;
    uint32_t fwd_add;
    int32_t di, inv_lb;
    uint32_t inv_add, q, r32, r32_sh, one_sh, kbf, kbi;
    uint32_t pw[4], pw_sh[4];
    int32_t stages_f, stages_i, mode;
};

// the order of ops/ntt_mxu_split.py MODES
enum SplitMode { kProduct = 0, kFolded = 1, kFixed = 2, kNtt = 3, kIntt = 4 };

constexpr int kBw = 128;              // lanes of a lane block
constexpr int kWords = kBw / 4;       // 16-byte words of a row's lane block
constexpr int kThreads = 512;         // 16 warps, 8 output lanes each
constexpr int kStageK = 64;           // table depth of a stage
constexpr int kStageLane = 16;        // bytes of a stage one lane reads
constexpr int kTileRows = 64;         // rows a block multiplies at once
constexpr int kSmShared = 232448;     // shared memory a block may take

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The split of `rows` rows of one lane block (row r at data + r * kBw)
// into din planes of base 2^lb, plane i of row r at planes[r * ks + i *
// kBw], each 32-deep step in the MMA's k order (ntt_mxu.cu split_packed).
__device__ inline void split_rows(const uint32_t* data, int rows,
                                  int8_t* planes, int ks, int din, int lb,
                                  uint32_t add) {
    constexpr int lw = 5;             // log2 of the words of one plane
    for (int idx = threadIdx.x; idx < rows << lw; idx += kThreads) {
        const int r = idx >> lw, w = idx & (kWords - 1);
        const uint4 v =
            *reinterpret_cast<const uint4*>(data + r * kBw + 4 * w);
        const int32_t a[4] = {static_cast<int32_t>(v.x + add),
                              static_cast<int32_t>(v.y + add),
                              static_cast<int32_t>(v.z + add),
                              static_cast<int32_t>(v.w + add)};
        const int kw = (w & ~7) | ((w >> 1) & 3) | ((w & 1) << 2);
        qt::store_planes(reinterpret_cast<uint32_t*>(planes + r * ks) + kw,
                         lw, a, din, lb);
    }
}

// The fragments a0 .. a3 of an m16 x k32 A tile, by ldmatrix (ntt_mxu.cu
// load_a_tile).
__device__ __forceinline__ void load_a_tile(const int8_t* row, uint2& lo,
                                            uint2& hi) {
    uint32_t r0, r1, r2, r3;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
        : "r"(shared_addr(row)));
    lo = make_uint2(r0, r2);
    hi = make_uint2(r1, r3);
}

// What a pass's epilogue does with its recombined lanes: store them in
// place (B9's forward), B5's product of x's tile mm and y's tile mm + MT/2
// in place of x's, B8's product with the spectrum's lanes in place, or
// store rows r < live to device memory.
enum Epilogue { kStore, kPairProduct, kSpectrumProduct, kGlobal };

// Where an epilogue puts its values: the block's rows in shared memory,
// the lane block of row 0 of its group in device memory (row stride n) and
// the rows of it that exist, the spectrum's lanes of the lane block.
struct PassOut {
    uint32_t* rows;
    uint32_t* global;
    long long stride;
    int live;
    const uint32_t* spec;
};

template <int D>
__device__ __forceinline__ uint32_t recombined(
    uint32_t start, const int (&acc)[kMaxClasses][4], int e,
    const MxuSplitPlan& p) {
    return qt::recombine_value(start, D, p, [&](int j) { return acc[j][e]; });
}

// this warp's 16 bytes of class j of a stage, j < D
template <int D>
__device__ __forceinline__ void load_stage(uint4 (&bv)[D],
                                           const int8_t* __restrict__ frag) {
#pragma unroll
    for (int j = 0; j < D; ++j)
        bv[j] = __ldg(reinterpret_cast<const uint4*>(frag +
                                                     j * 32 * kStageLane));
}

// One direction's block matmul of the 16 * MT rows in `data`: the split
// into `planes`, the products against the `stages` stages from `tab` (the
// lane block's first stage), D classes, the epilogue EPI, a barrier.  Warp
// lt takes output lanes 8 lt .. 8 lt + 7 of every class; lane 4g + t of it
// reads, of class j, the 16 bytes at ((lt * D + j) * 32 + lane) * 16 of a
// stage: bytes 8t .. 8t + 7 of its two 32-deep steps of table row j * kBw
// + 8 lt + g (ops/mxu_tables.py stream_tables).
template <int D, int MT, int EPI>
__device__ void block_pass(uint32_t* data, int8_t* planes, int ks,
                           int stages, int din, int lb, uint32_t add,
                           uint32_t kb, const int8_t* __restrict__ tab,
                           const uint32_t* __restrict__ cb,
                           const MxuSplitPlan& p, const Mod& m,
                           const PassOut& out) {
    split_rows(data, 16 * MT, planes, ks, din, lb, add);
    __syncthreads();
    const int lt = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t stage_bytes = static_cast<size_t>(kStageK) * kBw * D;
    const int8_t* frag = tab + (lt * D * 32 + lane) * kStageLane;
    int acc[MT][kMaxClasses][4] = {};
    uint4 bv[D];
    load_stage<D>(bv, frag);
    for (int c = 0; c < stages; ++c) {
        uint4 next[D];
        if (c + 1 < stages) load_stage<D>(next, frag + (c + 1) * stage_bytes);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
            uint2 a[MT][2];
#pragma unroll
            for (int mm = 0; mm < MT; ++mm)
                load_a_tile(planes + (mm * 16 + (lane & 15)) * ks +
                                c * kStageK + st * 32 + (lane >> 4) * 16,
                            a[mm][0], a[mm][1]);
#pragma unroll
            for (int j = 0; j < D; ++j) {
                const uint2 bf = st ? make_uint2(bv[j].z, bv[j].w)
                                    : make_uint2(bv[j].x, bv[j].y);
#pragma unroll
                for (int mm = 0; mm < MT; ++mm)
                    qt::mma_s8(acc[mm][j], a[mm][0], a[mm][1], bf);
            }
        }
        if (c + 1 < stages) {
#pragma unroll
            for (int j = 0; j < D; ++j) bv[j] = next[j];
        }
    }
    // the epilogue: the thread's lanes o, o + 1 of rows g and g + 8 of
    // each tile, two lanes an 8-byte store
    const int g = lane >> 2, o = lt * 8 + (lane & 3) * 2;
    const uint32_t s0 = __ldg(cb + o) + kb, s1 = __ldg(cb + o + 1) + kb;
    if (EPI == kPairProduct) {
        constexpr int kX = MT / 2;    // x's tiles, then y's
#pragma unroll
        for (int mm = 0; mm < kX; ++mm)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint2 v;
                v.x = mulmod_barrett(recombined<D>(s0, acc[mm], 2 * h, p),
                                     recombined<D>(s0, acc[mm + kX], 2 * h,
                                                   p),
                                     m);
                v.y = mulmod_barrett(
                    recombined<D>(s1, acc[mm], 2 * h + 1, p),
                    recombined<D>(s1, acc[mm + kX], 2 * h + 1, p), m);
                *reinterpret_cast<uint2*>(
                    out.rows + (mm * 16 + g + 8 * h) * kBw + o) = v;
            }
    } else {
        uint2 w = make_uint2(0, 0);
        if (EPI == kSpectrumProduct)
            w = __ldg(reinterpret_cast<const uint2*>(out.spec + o));
#pragma unroll
        for (int mm = 0; mm < MT; ++mm)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = mm * 16 + g + 8 * h;
                uint2 v = make_uint2(recombined<D>(s0, acc[mm], 2 * h, p),
                                     recombined<D>(s1, acc[mm], 2 * h + 1, p));
                if (EPI == kSpectrumProduct) {
                    v.x = mulmod_barrett(v.x, w.x, m);
                    v.y = mulmod_barrett(v.y, w.y, m);
                }
                if (EPI == kGlobal) {
                    if (r < out.live)
                        *reinterpret_cast<uint2*>(out.global +
                                                  r * out.stride + o) = v;
                } else {
                    *reinterpret_cast<uint2*>(out.rows + r * kBw + o) = v;
                }
            }
    }
    __syncthreads();
}

// Shared memory of one block: its rows of one lane block (B5: x's, then
// y's) and their digit planes.
size_t split_smem(const MxuSplitPlan& p) {
    const int rows = p.mode == kProduct ? 2 * p.rows : p.rows;
    const int ks = (p.stages_f > p.stages_i ? p.stages_f : p.stages_i) *
                       kStageK + kPad;
    return static_cast<size_t>(rows) * (kBw * sizeof(uint32_t) + ks);
}

// Block (lane block lb, group g) of `groups` row groups: B5's 32 x rows
// above 32 y rows, the others' 64 x rows.  stream_f: the lane blocks'
// forward stages (stages_f each), stream_i their inverse ones (B9: the
// constant's); cf, ci the const rows; b: y (B5) or the spectrum (B8).
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    mxu_split_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, uint32_t* __restrict__ z,
                     const int8_t* __restrict__ stream_f,
                     const int8_t* __restrict__ stream_i,
                     const uint32_t* __restrict__ cf,
                     const uint32_t* __restrict__ ci, long long batch,
                     long long groups, const __grid_constant__ MxuSplitPlan p) {
    extern __shared__ __align__(128) uint32_t split_shared[];
    constexpr int kOps = MODE == kProduct ? 2 : 1;
    const int R = p.rows;
    const int ks = (p.stages_f > p.stages_i ? p.stages_f : p.stages_i) *
                       kStageK + kPad;
    uint32_t* data = split_shared;
    int8_t* planes = reinterpret_cast<int8_t*>(data + kOps * R * kBw);
    const int lb = static_cast<int>(blockIdx.x / groups);
    const long long row0 = (blockIdx.x % groups) * static_cast<long long>(R);
    const long long left = batch - row0;
    const int live = left < R ? static_cast<int>(left) : R;
    const size_t base = static_cast<size_t>(row0) * p.n +
                        static_cast<size_t>(lb) * kBw;
    // the rows' lane block (B5: x's, then y's); rows past the batch are
    // zero-filled; every copy is in flight before the one wait
    for (int c = threadIdx.x; c < kOps * R * kWords; c += kThreads) {
        const int r = c / kWords, w = c % kWords;
        const int rr = r < R ? r : r - R;
        const uint32_t* src = r < R ? a : b;
        const bool ok = rr < live;
        cp_async16(data + r * kBw + 4 * w,
                   ok ? src + base + static_cast<size_t>(rr) * p.n + 4 * w
                      : a,
                   ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    const Mod m{p.q, p.r32, p.r32_sh, p.one_sh};
    const size_t stage_bytes = static_cast<size_t>(kStageK) * kBw * D;
    const int8_t* tf = stream_f + lb * p.stages_f * stage_bytes;
    const int8_t* ti = stream_i + lb * p.stages_i * stage_bytes;
    const PassOut own{data, nullptr, 0, 0, nullptr};
    const PassOut store{nullptr, z + base, p.n, live, nullptr};
    if constexpr (MODE == kProduct) {
        block_pass<D, 4, kPairProduct>(data, planes, ks, p.stages_f, p.df,
                                       p.fwd_lb, p.fwd_add, p.kbf, tf,
                                       cf + lb * kBw, p, m, own);
        block_pass<D, 2, kGlobal>(data, planes, ks, p.stages_i, p.di,
                                  p.inv_lb, p.inv_add, p.kbi, ti,
                                  ci + lb * kBw, p, m, store);
    } else if constexpr (MODE == kIntt) {
        block_pass<D, 4, kGlobal>(data, planes, ks, p.stages_i, p.di,
                                  p.inv_lb, p.inv_add, p.kbi, ti,
                                  ci + lb * kBw, p, m, store);
    } else if constexpr (MODE == kNtt) {
        block_pass<D, 4, kGlobal>(data, planes, ks, p.stages_f, p.df,
                                  p.fwd_lb, p.fwd_add, p.kbf, tf,
                                  cf + lb * kBw, p, m, store);
    } else {
        // B8: times the spectrum's lanes, B9: as they are; then the inverse
        // (B9: against the constant's stages, under the fold plan's split)
        constexpr int kFwd = MODE == kFixed ? kSpectrumProduct : kStore;
        const PassOut fwd{data, nullptr, 0, 0,
                          MODE == kFixed ? b + lb * kBw : nullptr};
        block_pass<D, 4, kFwd>(data, planes, ks, p.stages_f, p.df, p.fwd_lb,
                               p.fwd_add, p.kbf, tf, cf + lb * kBw, p, m,
                               fwd);
        block_pass<D, 4, kGlobal>(data, planes, ks, p.stages_i, p.di,
                                  p.inv_lb, p.inv_add, p.kbi, ti,
                                  ci + lb * kBw, p, m, store);
    }
}

bool valid_split(int din, int lb) {
    return din >= 1 && ((lb == 7 && din <= 6) || (lb == 8 && din <= 4));
}

template <int D, int MODE>
int run_split(const void* a, const void* b, void* out, const void* stream_f,
              const void* stream_i, const void* cf, const void* ci,
              long long batch, const MxuSplitPlan& p, void* cuda_stream) {
    auto kernel = mxu_split_kernel<D, MODE>;
    const size_t smem = split_smem(p);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const long long groups = (batch + p.rows - 1) / p.rows;
    const long long blocks = groups * p.nb;
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    kernel<<<dim3(static_cast<unsigned>(blocks)), kThreads, smem,
             static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), static_cast<const int8_t*>(stream_f),
        static_cast<const int8_t*>(stream_i),
        static_cast<const uint32_t*>(cf), static_cast<const uint32_t*>(ci),
        batch, groups, p);
    return cudaGetLastError();
}

// The plan ops/ntt_mxu_split.py split_plan makes, checked: lane blocks of
// 128 and a wide stage, 1-4 classes, the splits the planes take, 32 x rows
// a block for B5 and 64 for the others, the stages of those splits, the
// operands the mode reads.
template <int MODE>
int launch_split(const void* a, const void* b, void* out, const void* wf,
                 const void* cf, const void* wi, const void* ci,
                 long long batch, const void* plan, void* cuda_stream) {
    if (!plan) return cudaErrorInvalidValue;
    const MxuSplitPlan p = *static_cast<const MxuSplitPlan*>(plan);
    if (p.mode != MODE || p.bw != kBw || p.logn < 8 || p.logn > 30 ||
        p.n != 1 << p.logn || p.nb * kBw != p.n || p.lr != p.logn - 7 ||
        p.d < 1 || p.d > kMaxClasses ||
        p.rows != (MODE == kProduct ? kTileRows / 2 : kTileRows) ||
        !valid_split(p.df, p.fwd_lb) || !valid_split(p.di, p.inv_lb) ||
        p.stages_f != p.df * kBw / kStageK ||
        p.stages_i != p.di * kBw / kStageK || batch <= 0 || !a || !out ||
        !wf || (MODE != kIntt && !cf) || (MODE != kNtt && !ci) ||
        ((MODE == kProduct || MODE == kFixed) && !b) ||
        (MODE == kFolded && !wi) || split_smem(p) > kSmShared)
        return cudaErrorInvalidValue;
    const void* stream_i = wi;
    if (MODE != kFolded)
        stream_i = static_cast<const int8_t*>(wf) +
                   static_cast<size_t>(p.nb) * p.stages_f * kStageK * kBw *
                       p.d;
    switch (p.d) {
    case 1:
        return run_split<1, MODE>(a, b, out, wf, stream_i, cf, ci, batch, p,
                                  cuda_stream);
    case 2:
        return run_split<2, MODE>(a, b, out, wf, stream_i, cf, ci, batch, p,
                                  cuda_stream);
    case 3:
        return run_split<3, MODE>(a, b, out, wf, stream_i, cf, ci, batch, p,
                                  cuda_stream);
    default:
        return run_split<4, MODE>(a, b, out, wf, stream_i, cf, ci, batch, p,
                                  cuda_stream);
    }
}

}  // namespace

// Every launcher takes (a, b, out, wf, cf, wi, ci, tw, batch, plan,
// stream): wf the table stream (MxuDeviceTables.stream), cf and ci the
// const rows, tw unused, plan an MxuSplitPlan.

// B5: a the rows of x after the forward's wide stages, b those of y
extern "C" int qt_polymul_mxu_split(const void* a, const void* b, void* out,
                                    const void* wf, const void* cf,
                                    const void*, const void* ci, const void*,
                                    long long batch, const void* plan,
                                    void* stream) {
    return launch_split<kProduct>(a, b, out, wf, cf, nullptr, ci, batch,
                                  plan, stream);
}

// B8: b the constant's canonical spectrum (n values)
extern "C" int qt_polymul_fixed_mxu_split(const void* a, const void* b,
                                          void* out, const void* wf,
                                          const void* cf, const void*,
                                          const void* ci, const void*,
                                          long long batch, const void* plan,
                                          void* stream) {
    return launch_split<kFixed>(a, b, out, wf, cf, nullptr, ci, batch, plan,
                                stream);
}

// B6: the forward's block products alone; b, wi and ci unused
extern "C" int qt_ntt_mxu_split(const void* a, const void*, void* out,
                                const void* wf, const void* cf, const void*,
                                const void*, const void*, long long batch,
                                const void* plan, void* stream) {
    return launch_split<kNtt>(a, nullptr, out, wf, cf, nullptr, nullptr,
                              batch, plan, stream);
}

// B7: the inverse's block products alone, a below pw_bound; b, cf, wi
// unused
extern "C" int qt_intt_mxu_split(const void* a, const void*, void* out,
                                 const void* wf, const void*, const void*,
                                 const void* ci, const void*, long long batch,
                                 const void* plan, void* stream) {
    return launch_split<kIntt>(a, nullptr, out, wf, nullptr, nullptr, ci,
                               batch, plan, stream);
}

// B9: wi the constant's inverse stages (FoldedOperand.stages), ci its const
// rows; b unused
extern "C" int qt_polymul_fixed_folded_mxu_split(
    const void* a, const void*, void* out, const void* wf, const void* cf,
    const void* wi, const void* ci, const void*, long long batch,
    const void* plan, void* stream) {
    return launch_split<kFolded>(a, nullptr, out, wf, cf, wi, ci, batch, plan,
                                 stream);
}
