// Digit-matmul (MXU-form) merged-psi kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of qtesla_tpu/ops/ntt_mxu.py:
//   qt_polymul_mxu        <- polymul_mxu_fn's kernel       (l.982)  B5
//   qt_ntt_mxu            <- ntt_mxu_fn's kernel           (l.1041) B6
//   qt_intt_mxu           <- intt_mxu_fn's kernel          (l.1061) B7
//   qt_polymul_fixed_mxu  <- polymul_fixed_mxu_fn's kernel (l.1012) B8
//   qt_polymul_fixed_folded_mxu
//                         <- polymul_fixed_folded_mxu_fn's kernel (l.1210) B9
//
// What they compute.  A transform runs its Lr = log2(n / bw) wide stages
// (pair distance >= bw) as butterflies; the remaining stages act inside each
// block of bw lanes and are one exact matrix per block, applied as int8
// products against the planner's digit tables (ops/mxu_tables.py):
//
//   planes_i = balanced base-2^lb digits of (v - off),   i < Din
//   c_j      = sum_i planes_i @ W[b, i][:, class j]      (int32, |c_j| < 2^24)
//   out      = const + group_bias + sum_j c_j * (2^{8j} mod q)   (mod q)
//
// The digit split is the TPU kernel's (_digit_planes): (v + add) read as
// int32, add = split_bias - off mod 2^32, low planes a field minus base/2,
// the top plane an arithmetic shift; it is exact for every v below the
// split's bound, which for the p-sets exceeds 2^31.  The recombination adds
// 2^24 to each c_j (so it is a uint32), takes one Shoup product by 2^{8j}
// mod q per class, and starts from const + kb, kb = group_bias -
// 2^24 * sum_j 2^{8j} mod q, folded on the host.  Every value handed to a
// split lies below the JAX bounds (fwd_bound, pw_bound); every
// output is canonical.  The TPU kernel's sloppy Shoup, Horner packing and
// overflow fixer were vector-unit workarounds and are not replayed.
//
// Design of B5 (polymul_stream_kernel).  B5 ran as mxu_kernel until it was
// redesigned; measured by ablation on an H100 (PERF.md), its 2.73 ms were
// 0.93 of dense products and 0.94 of their table stream, 0.27 split, 0.21
// recombination and 0.39 load and store, none overlapping: each 512-thread
// block (16 rows of x and 16 of y, 148 KB, one an SM) read all 2.75 MB of
// tables at q-III for its 16 products, 5.6 GB of L2 reads a 32768-row call,
// from inside its MMA loop.  What bounds it on the card is that L2 stream
// and MMA issue, not HBM (0.14 ms of int8 ops at peak for the batch).  The
// redesign:
//   - the tables reach the MMAs through shared memory.  The planner lays
//     them out as a stream of stages (ops/mxu_tables.py stream_tables): 64
//     table columns of one lane block, every class, in the order the MMA
//     warps read them, each stage contiguous (bw * D * 64 bytes, 24 KiB at
//     q-III), so one cp.async.bulk copies it with no tensor map.  A producer
//     warp keeps a ring of `ring` stages filled (3 at q-III, what the rows
//     leave of the SM's shared memory) through mbarriers, while the 16 MMA
//     warps work on the stages that have landed and release each slot;
//   - blocks are persistent (one an SM) and walk the row groups, so the
//     stream never stops between groups: the next group's first stages land
//     while this one's inverse wide stages and stores run;
//   - the class count D is a template parameter, so no MMA hangs on a
//     run-time condition, and the forward pass multiplies both 16-row tiles
//     (x and y) against one table fragment;
//   - the Lr wide stages (up to 4) run in registers, each thread taking the
//     2^Lr values one column of a row mixes through all of them: one pass
//     over the rows and one barrier where the shared qt::fwd_wide makes Lr;
//   - the forward epilogue takes the pointwise product: x's row r and y's
//     row r + 16 (or + 8) lie in one thread's accumulators, so the product
//     goes out in place of x's values, two lanes an 8-byte store: no
//     pointwise pass and no barrier.
// The split (four digits a word, byte permutes at base 256, stored in the
// MMA's k order), the products (mma.sync m16n8k32 s8, A fragments from the
// planes by ldmatrix, B from the stage) and the recombination in registers
// stay phases of the MMA warps, separated by a named barrier that the
// producer does not join.  Measured
// on an H100 80GB HBM3 at 700 W (PERF.md, utils/ab_timing.py) and left
// out: clusters of 2 and 4 blocks that took turns to copy each stage once
// for all of them (.multicast::cluster, half and a quarter of the L2
// reads) ran 1.76x and 1.96x slower than single blocks, since every block
// then waited on the slowest consumer of its cluster with 3 stages of
// slack; loading the next group's x rows into y's free rows during the
// inverse pass ran 1.6 % slower.
//
// B9, the folded fixed-operand product, is the forward and then the inverse
// block matmul against one constant's tables W' = M_inv diag(A) and c',
// with no pointwise stage.  It runs polymul_stream_kernel with kFolded: the
// producer takes the forward stages from the front of B5's stream (nothing
// of them is copied per constant) and the inverse ones from the constant's
// own stages (FoldedOperand.stages, laid out by the same stream_tables
// order), the block holds 32 x rows (two m16 tiles; 16 or 4 where rows are
// longer), the forward epilogue stores the recombined spectrum in place and
// the inverse pass runs over both tiles under the fold plan's split (4
// planes at every registered set, of base 128 at qtesla-iii-speed and 256
// at the others: 8 stages a lane block at bw = 128, as many as the
// forward's).  Until it took that design B9 ran as a mode of mxu_kernel:
// each 512-thread block of 32 rows read wf and W' (1.57 MB each at q-III)
// from L2 inside its MMA loop, 3.2 GB of L2 reads a 32768-row call, 1.70 ms
// on an H100 80GB HBM3 at 700 W, of which an ablation (PERF.md) put 0.56
// ms on products and 0.56 on their table reads; in this kernel it took
// 0.7527 ms (utils/ab_timing.py).  A split at base 128 by byte permutes,
// as at base 256 (each value's digits spread to its bytes first), ran
// 2.9 % slower than the digit-by-digit split and was left out.
//
// B8, the product against a constant's stored spectrum, and B6, the
// forward transform, run the same kernel in the modes kFixed and kNtt, over
// B9's 32 x rows a group (two m16 tiles; 16 or 4 where rows are longer)
// under the MXU plan's own split.  B8's forward epilogue multiplies each
// recombined lane by the spectrum's value at that lane (Barrett, the
// spectrum read by __ldg) and stores the product in place: no pointwise pass
// and no barrier; its inverse pass streams the inverse stages of B5's
// stream, so nothing is laid out per constant.  B6 streams the forward
// stages alone (its plan has no inverse stage, or the ring would wait for
// stages no consumer takes), and its epilogue stores the live rows of the
// spectrum straight to the output.  Until they took that design both ran
// as modes of mxu_kernel, each block of 32 rows reading wf (and B8 wi) from
// L2 inside its MMA loop: on an H100 80GB HBM3 at 700 W (PERF.md,
// utils/ab_timing.py) B8 went from 1.6249 to 0.7145 ms and B6 from 0.8559
// to 0.4019 at 32768 q-III rows.  B6's epilogue storing to device memory in
// place of a store pass over the rows measured 0.9899 of the in-place
// design; loading the next group's rows by cp.async once the last lane
// block was split (the rows free then) measured 1.0032 and was left out.
//
// B7, the inverse transform, is B8 without the forward pass: it runs the
// kernel in the mode kIntt, over 32 x rows a group under the MXU plan's own
// inverse split (lazy input below pw_bound, for which the split is exact),
// its producer streaming the inverse stages of B5's stream alone (its plan
// has no forward stage, so its block holds the inverse planes alone); the
// inverse pass stores in place, then the wide stages run in registers and
// store the live rows from there (no store pass: 0.9599 of the time with
// one, utils/ab_timing.py).  Until it took that design B7 ran as the last
// mode of the
// dense mxu_kernel: each 512-thread block of 32 rows split its rows into
// planes in shared memory and read the dense wi (1.18 MB at q-III) from L2
// inside its MMA loop, 0.7788 ms at 32768 q-III rows on an H100 80GB HBM3
// at 700 W (PERF.md); with it went the last dense block matmul in this
// file.
//
// Each launcher is extern "C", takes raw pointers, the batch B, a pointer to
// an MxuStreamPlan and a stream, launches without synchronising and returns
// cudaGetLastError().

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

// Field for field the MxuPlan ctypes.Structure of ops/ntt_mxu.py.
struct MxuPlan {
    int32_t n, logn, bw, nb, lr, d, rows, df, fwd_lb;
    uint32_t fwd_add;
    int32_t di, inv_lb;
    uint32_t inv_add, q, r32, r32_sh, one_sh, kbf, kbi;
    uint32_t pw[4], pw_sh[4];
};

constexpr int kThreads = 512;

// ----------------------------------------------------------------------
// B5: polymul_stream_kernel (header note: design of B5).
// ----------------------------------------------------------------------

// Field for field the MxuStreamPlan ctypes.Structure of ops/ntt_mxu.py:
// MxuPlan's fields, then the stages (64-deep table slices of one lane
// block) of a forward and of an inverse block matmul, and the stages the
// ring holds.
struct MxuStreamPlan : MxuPlan {
    int32_t stages_f, stages_i, ring;
};

constexpr int kStageK = 64;                      // table depth of a stage
constexpr int kConsumers = kThreads;             // the 16 MMA warps
constexpr int kStreamThreads = kConsumers + 32;  // and the producer warp
constexpr int kStageLane = 16;        // bytes of a stage one lane reads
// shared memory of one SM, and what the runtime reserves for each block
constexpr int kSmShared = 233472, kBlockReserve = 1024;
// try_wait polls before a stage that never arrives traps the kernel
constexpr long long kWatchdog = 1LL << 26;
using Team = qt::FirstThreads<kConsumers>;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     shared_addr(bar)),
                 "r"(count)
                 : "memory");
}

// Wait for the completion of the barrier's phase of `parity`; a phase that
// never completes (a lost arrival) traps rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = shared_addr(bar);
    for (long long spin = 0;; ++spin) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
        if (done) return;
        if (spin > kWatchdog) __trap();
    }
}

// the producer's arrival, announcing the bytes the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            shared_addr(bar)),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     shared_addr(bar))
                 : "memory");
}

// `bytes` from global memory to dst, completing on the barrier bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
        "l"(src), "r"(bytes), "r"(shared_addr(bar))
        : "memory");
}

// The position in the ring of stages: the slot of the next stage and the
// parity of its barriers' current phase.
struct Ring {
    int slot = 0;
    uint32_t phase = 0;
    __device__ void next(int ring) {
        if (++slot == ring) {
            slot = 0;
            phase ^= 1;
        }
    }
};

// A consumer warp is done with the stage in `slot`: one arrival on the
// slot's empty barrier, after the warp's reads of the stage (__syncwarp).
__device__ __forceinline__ void release_stage(uint64_t* empty) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// The split of lane block b of `rows` rows into din planes of base 2^lb,
// plane i of row r from planes[r * ks + i * bw]; a thread packs the four
// digits of four neighbouring lanes into one word per plane
// (store_planes).  Inside each 32-deep step the words are stored in the
// order of the MMA's k: word 2t + h (lanes 8t + 4h .. + 3, the k that
// stream_tables gives the fragment bytes 4h .. 4h + 3 of lane t of a
// quad) at word 4h + t, so that ldmatrix hands each thread its A
// fragment.  Every input must lie below the split's bound.
template <class Team>
__device__ inline void split_packed(const uint32_t* data, int rows, int len,
                                    int bw, int b, int8_t* planes, int ks,
                                    int din, int lb, uint32_t add) {
    const int lw = __ffs(bw) - 3;     // log2 of the words of one plane
    for (int idx = threadIdx.x; idx < rows << lw; idx += Team::count()) {
        const int r = idx >> lw, w = idx & ((1 << lw) - 1);
        const uint4 v = *reinterpret_cast<const uint4*>(data + r * len +
                                                        b * bw + 4 * w);
        const int32_t a[4] = {static_cast<int32_t>(v.x + add),
                              static_cast<int32_t>(v.y + add),
                              static_cast<int32_t>(v.z + add),
                              static_cast<int32_t>(v.w + add)};
        const int kw = (w & ~7) | ((w >> 1) & 3) | ((w & 1) << 2);
        qt::store_planes(reinterpret_cast<uint32_t*>(planes + r * ks) + kw,
                         lw, a, din, lb);
    }
}

// The four 8 x 16-byte matrices of an m16 x k32 A tile (rows 0-7 and 8-15
// of the first 16 bytes, then of the next 16), lane l giving the address
// of row l & 7 of matrix l >> 3: the fragments a0 .. a3 of mma_s8.
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

// The first R merged-psi CT stages of the n-point transform over `rows`
// rows, as qt::fwd_wide computes them, by the threads of Team.  These
// stages mix only the 2^R values c + k * (n >> R) of a row (c < n >> R):
// stage s pairs k with k + 2^(R-s-1) under tw[2^s + (k >> (R - s))].  A
// thread takes such a set through all R stages in registers: one pass over
// the rows and one barrier where qt::fwd_wide makes R of each.
template <int R>
__device__ void fwd_wide_regs(uint32_t* data, int rows, int logn,
                              const uint32_t* __restrict__ tw, uint32_t q) {
    constexpr int kV = 1 << R;
    const int n = 1 << logn, lc = logn - R;
    uint32_t w[kV], w_sh[kV];
#pragma unroll
    for (int i = 1; i < kV; ++i) {
        w[i] = __ldg(tw + i);
        w_sh[i] = __ldg(tw + n + i);
    }
    for (int idx = threadIdx.x; idx < rows << lc; idx += Team::count()) {
        uint32_t* a = data + (idx >> lc) * n + (idx & ((1 << lc) - 1));
        uint32_t v[kV];
#pragma unroll
        for (int k = 0; k < kV; ++k) v[k] = a[k << lc];
#pragma unroll
        for (int s = 0; s < R; ++s) {
            const int half = kV >> (s + 1);
#pragma unroll
            for (int k = 0; k < kV; ++k) {
                if (k & half) continue;
                const int i = (1 << s) + (k >> (R - s));
                const uint32_t u = v[k];
                const uint32_t x =
                    qt::csub(qt::shoup_lazy(v[k + half], w[i], w_sh[i], q), q);
                v[k] = qt::csub(u + x, q);
                v[k + half] = qt::csub(u - x + q, q);
            }
        }
#pragma unroll
        for (int k = 0; k < kV; ++k) a[k << lc] = v[k];
    }
    Team::sync();
}

// The last R merged-psi GS stages of the n-point transform over `rows`
// rows, as qt::inv_wide computes them (n^{-1} in the last), in the same
// register passes: stage s' < R pairs k with k + 2^s' under itw[h + (k >>
// (s' + 1))], h = 2^(R-s'-1).  kOut: the values go from the registers to
// rows r < live of `out` (row length n) in place of `data`, so that no
// store pass follows (B7).
template <int R, bool kOut>
__device__ void inv_wide_regs(uint32_t* data, int rows, int logn,
                              const uint32_t* __restrict__ tw, uint32_t q,
                              uint32_t* __restrict__ out, int live) {
    constexpr int kV = 1 << R;
    const int n = 1 << logn, lc = logn - R;
    uint32_t w[kV], w_sh[kV];        // w[0] = n^{-1}
#pragma unroll
    for (int i = 0; i < kV; ++i) {
        w[i] = __ldg(tw + 2 * n + i);
        w_sh[i] = __ldg(tw + 3 * n + i);
    }
    for (int idx = threadIdx.x; idx < rows << lc; idx += Team::count()) {
        uint32_t* a = data + (idx >> lc) * n + (idx & ((1 << lc) - 1));
        uint32_t v[kV];
#pragma unroll
        for (int k = 0; k < kV; ++k) v[k] = a[k << lc];
#pragma unroll
        for (int s = 0; s < R; ++s) {
            const int half = 1 << s, h = kV >> (s + 1);
#pragma unroll
            for (int k = 0; k < kV; ++k) {
                if (k & half) continue;
                const int i = h + (k >> (s + 1));
                const uint32_t u = v[k], x = v[k + half];
                uint32_t sum = qt::csub(u + x, q);
                if (s == R - 1)
                    sum = qt::csub(qt::shoup_lazy(sum, w[0], w_sh[0], q), q);
                v[k] = sum;
                v[k + half] = qt::csub(
                    qt::shoup_lazy(u - x + q, w[i], w_sh[i], q), q);
            }
        }
        if constexpr (kOut) {
            if ((idx >> lc) < live) {
                uint32_t* o = out + (a - data);
#pragma unroll
                for (int k = 0; k < kV; ++k) o[k << lc] = v[k];
            }
        } else {
#pragma unroll
            for (int k = 0; k < kV; ++k) a[k << lc] = v[k];
        }
    }
    Team::sync();
}

// B5's Lr wide stages, forward or inverse, over `rows` rows: in registers
// up to Lr = 4 (16 values a thread), else qt::fwd_wide / qt::inv_wide.
// kOut (B7's inverse): the stages in registers store rows r < live of
// `out` (row length n) themselves; whether they did, or the caller stores
// the rows.
template <bool kInverse, bool kOut = false>
__device__ bool wide_stages(uint32_t* data, int rows, const MxuPlan& p,
                            const uint32_t* __restrict__ tw,
                            uint32_t* __restrict__ out = nullptr,
                            int live = 0) {
    static_assert(kInverse || !kOut, "the forward stages stay in place");
    switch (p.lr) {
    case 0:
        return false;
#define QT_WIDE_CASE(r)                                                      \
    case r:                                                                  \
        if (kInverse)                                                        \
            inv_wide_regs<r, kOut>(data, rows, p.logn, tw, p.q, out, live);  \
        else                                                                 \
            fwd_wide_regs<r>(data, rows, p.logn, tw, p.q);                   \
        return kOut;
        QT_WIDE_CASE(1)
        QT_WIDE_CASE(2)
        QT_WIDE_CASE(3)
        QT_WIDE_CASE(4)
#undef QT_WIDE_CASE
    default:
        if (kInverse)
            qt::inv_wide<Team>(data, rows, p.logn, 0, p.lr, tw, p.q);
        else
            qt::fwd_wide<Team>(data, rows, p.logn, 0, p.lr, tw, p.q);
        return false;
    }
}

// The pointwise product of a spectrum value of x and one of y (B5) or of
// the constant (B8).
__device__ __forceinline__ uint32_t pointwise(uint32_t a, uint32_t b,
                                              const Mod& m) {
    return mulmod_barrett(a, b, m);
}

// The recombined value of accumulator e of one tile (mxu_compact.cuh's
// recombine_value), D a constant.
template <int D>
__device__ __forceinline__ uint32_t recombined(uint32_t start,
                                               const int (&acc)[kMaxClasses][4],
                                               int e, const MxuPlan& p) {
    return qt::recombine_value(start, D, p, [&](int j) { return acc[j][e]; });
}

// What the epilogue of a pass does with its recombined values: store them
// (B9's passes, B8's inverse one, B6's and B5's inverse one), store B5's
// product of x's and y's rows, or store B8's product with the constant's
// spectrum.
enum Epilogue { kStore, kPairProduct, kSpectrumProduct };

// The epilogue of output tile lt of one lane block (out = the block's
// first lane of row 0, cb its const row): the thread's two neighbouring
// lanes o, o + 1 of a row go out in one 8-byte store.  kStore: rows r < nr
// get their recombined values.  kSpectrumProduct: the same rows get the
// Barrett product of those values with the spectrum's lanes o, o + 1 of the
// block (sb), so that B8's pointwise stage costs no pass and no barrier.
// kPairProduct (the forward pass of tb = 16 x rows above 16 y rows, MT = 2,
// or 8 above 8, MT = 1): x's row r and y's row r + tb lie in this thread's
// accumulators alike, and x's row r gets the Barrett product of the two; y's
// rows are free once the pass ends.
template <int D, int MT, int EPI>
__device__ __forceinline__ void stream_epilogue(
    uint32_t* out, int nr, int len, int lt,
    const int (&acc)[2][kMaxClasses][4], const uint32_t* __restrict__ cb,
    uint32_t kb, const MxuPlan& p, const Mod& m,
    const uint32_t* __restrict__ sb) {
    const int g = (threadIdx.x & 31) >> 2;
    const int o = lt * 8 + (threadIdx.x & 3) * 2;
    const uint32_t s0 = __ldg(cb + o) + kb, s1 = __ldg(cb + o + 1) + kb;
    if (EPI == kPairProduct) {
        // y's accumulators: tile 1 alike (MT 2), or rows g + 8 (MT 1)
        constexpr int kMy = MT == 2 ? 1 : 0, kEy = MT == 2 ? 0 : 2;
#pragma unroll
        for (int h = 0; h < (MT == 2 ? 2 : 1); ++h) {
            const int ex = 2 * h, ey = 2 * h + kEy;
            uint2 v;
            v.x = pointwise(recombined<D>(s0, acc[0], ex, p),
                            recombined<D>(s0, acc[kMy], ey, p), m);
            v.y = pointwise(recombined<D>(s1, acc[0], ex + 1, p),
                            recombined<D>(s1, acc[kMy], ey + 1, p), m);
            *reinterpret_cast<uint2*>(out + (g + 8 * h) * len + o) = v;
        }
        return;
    }
    uint2 w = make_uint2(0, 0);
    if (EPI == kSpectrumProduct)
        w = __ldg(reinterpret_cast<const uint2*>(sb + o));
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = mm * 16 + g + 8 * h;
            if (r < nr) {
                uint2 v = make_uint2(recombined<D>(s0, acc[mm], 2 * h, p),
                                     recombined<D>(s1, acc[mm], 2 * h + 1, p));
                if (EPI == kSpectrumProduct) {
                    v.x = pointwise(v.x, w.x, m);
                    v.y = pointwise(v.y, w.y, m);
                }
                *reinterpret_cast<uint2*>(out + r * len + o) = v;
            }
        }
}

// Where a block keeps its ring of stages and their barriers.
struct StreamRing {
    const int8_t* slots;
    uint32_t stage_bytes;
    uint64_t* full;
    uint64_t* empty;
};

// Where a pass's epilogue puts its values: rows r < nr of `rows` (row
// length n), the pass's own rows in shared memory or B6's output rows in
// device memory; `spec` the constant's spectrum (kSpectrumProduct).
struct PassOut {
    uint32_t* rows;
    int nr;
    const uint32_t* spec;
};

// One direction's block matmuls of nr <= 16 * MT rows of `data`: per lane
// block the split into `planes`, then its `stages` stages taken from the
// ring as they land, D classes, then the epilogue EPI into `out` and a
// barrier.  Warp lt takes output lanes 8lt .. 8lt + 7 (those of lt < bw /
// 8 multiply; every warp waits for and releases every stage).  A stage
// holds the 16 bytes lane 4g + t of warp lt reads for class j at ((lt * D +
// j) * 32 + lane) * 16: bytes 8t .. 8t + 7 of the stage's two 32-deep steps
// of table row j*bw + 8lt + g (ops/mxu_tables.py stream_tables).
template <int D, int MT, int EPI>
__device__ void stream_matmul(uint32_t* data, int nr, int stages, int din,
                              int lb, uint32_t add, uint32_t kb,
                              const uint32_t* __restrict__ cst, int8_t* planes,
                              int ks, const StreamRing& sr, Ring& rg,
                              const MxuStreamPlan& p, const Mod& m,
                              const PassOut& out) {
    const int lt = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool mma_warp = lt < (p.bw >> 3);
    for (int b = 0; b < p.nb; ++b) {
        split_packed<Team>(data, nr, p.n, p.bw, b, planes, ks, din, lb, add);
        Team::sync();
        int acc[2][kMaxClasses][4] = {};
        for (int c = 0; c < stages; ++c) {
            mbar_wait(sr.full + rg.slot, rg.phase);
            if (mma_warp) {
                const int8_t* sb = sr.slots + rg.slot * sr.stage_bytes +
                                   (lt * D * 32 + lane) * kStageLane;
                uint4 bv[D];
#pragma unroll
                for (int j = 0; j < D; ++j)
                    bv[j] = *reinterpret_cast<const uint4*>(
                        sb + j * 32 * kStageLane);
#pragma unroll
                for (int st = 0; st < 2; ++st) {
                    uint2 a[MT][2];
#pragma unroll
                    for (int mm = 0; mm < MT; ++mm)
                        load_a_tile(planes + (mm * 16 + (lane & 15)) * ks +
                                        c * kStageK + st * 32 +
                                        (lane >> 4) * 16,
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
            }
            release_stage(sr.empty + rg.slot);
            rg.next(p.ring);
        }
        if (mma_warp)
            stream_epilogue<D, MT, EPI>(
                out.rows + b * p.bw, out.nr, p.n, lt, acc, cst + b * p.bw, kb,
                p, m, EPI == kSpectrumProduct ? out.spec + b * p.bw : nullptr);
        Team::sync();
    }
}

// Shared memory of one polymul_stream_kernel block: the ring of stages,
// the rows, their digit planes and the ring's two barriers a stage.
size_t stream_smem(const MxuStreamPlan& p) {
    const int ks = (p.stages_f > p.stages_i ? p.stages_f : p.stages_i) *
                       kStageK + kPad;
    return static_cast<size_t>(p.ring) * kStageK * p.bw * p.d +
           static_cast<size_t>(p.rows) * p.n * sizeof(uint32_t) +
           static_cast<size_t>((p.rows + 15) / 16 * 16) * ks +
           2 * static_cast<size_t>(p.ring) * sizeof(uint64_t);
}

// What one launch of polymul_stream_kernel runs, numbered so that B5's and
// B9's instantiations keep the names polymul_stream_kernel<D,0> and <D,1>
// they had when the mode was a bool: B5's product of x and y, B9's product
// against a folded constant, B8's product against a constant's stored
// spectrum, B6's forward transform.
enum StreamMode {
    kProduct = 0, kFolded = 1, kFixed = 2, kNtt = 3, kIntt = 4
};

// B5: x's tb rows above y's.  B9, B8, B6, B7: tb = rows x rows; B9's
// inverse stages are the constant's, B8's and B7's B5's own; B6 has no
// inverse pass and B7 no forward one.
template <int D, int MODE>
__global__ void __launch_bounds__(kStreamThreads, 1)
    polymul_stream_kernel(const uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ y,
                          uint32_t* __restrict__ z,
                          const int8_t* __restrict__ stream_f,
                          const int8_t* __restrict__ stream_i,
                          const uint32_t* __restrict__ cf,
                          const uint32_t* __restrict__ ci,
                          const uint32_t* __restrict__ tw, long long batch,
                          const __grid_constant__ MxuStreamPlan p) {
    extern __shared__ __align__(128) uint32_t stream_shared[];
    const int n = p.n, rows = p.rows, tb = MODE == kProduct ? rows / 2 : rows;
    const int ring = p.ring;
    const uint32_t stage_bytes = static_cast<uint32_t>(kStageK) * p.bw * D;
    const int ks = (p.stages_f > p.stages_i ? p.stages_f : p.stages_i) *
                       kStageK + kPad;
    int8_t* slots = reinterpret_cast<int8_t*>(stream_shared);
    uint32_t* data = reinterpret_cast<uint32_t*>(slots + ring * stage_bytes);
    int8_t* planes = reinterpret_cast<int8_t*>(data + rows * n);
    uint64_t* full = reinterpret_cast<uint64_t*>(
        planes + (rows + 15) / 16 * 16 * ks);
    uint64_t* empty = full + ring;
    const long long groups = (batch + tb - 1) / tb;
    const long long iters = (groups - blockIdx.x + gridDim.x - 1) / gridDim.x;
    // B6's plan has no inverse stages (stages_i 0) and B7's no forward ones
    // (stages_f 0): the producer streams the stages the consumers take, or
    // the ring deadlocks
    const int fwd_stages = p.nb * p.stages_f;
    const int per_group = fwd_stages + p.nb * p.stages_i;

    if (threadIdx.x == 0) {
        for (int i = 0; i < ring; ++i) {
            mbar_init(full + i, 1);
            mbar_init(empty + i, kConsumers / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= kConsumers) {
        // the producer: stage s of a group's forward stages, then of its
        // inverse ones, into slot s % ring once every consumer has released
        // the slot's last stage
        if (threadIdx.x == kConsumers) {
            Ring rg;
            int src = 0;
            for (long long s = 0; s < iters * per_group; ++s) {
                mbar_wait(empty + rg.slot, rg.phase ^ 1);
                const int8_t* from =
                    src < fwd_stages
                        ? stream_f + static_cast<size_t>(src) * stage_bytes
                        : stream_i + static_cast<size_t>(src - fwd_stages) *
                                         stage_bytes;
                mbar_expect_tx(full + rg.slot, stage_bytes);
                bulk_copy(slots + rg.slot * stage_bytes, from, stage_bytes,
                          full + rg.slot);
                if (++src == per_group) src = 0;
                rg.next(ring);
            }
        }
        __syncwarp();
    } else {
        const Mod m{p.q, p.r32, p.r32_sh, p.one_sh};
        const StreamRing sr{slots, stage_bytes, full, empty};
        Ring rg;
        for (long long it = 0; it < iters; ++it) {
            const long long row0 =
                (blockIdx.x + it * gridDim.x) * static_cast<long long>(tb);
            const long long left = batch - row0;      // > 0: walkers <= groups
            const int live = left < tb ? static_cast<int>(left) : tb;
            const size_t base = static_cast<size_t>(row0) * n;
            // x's rows, then y's (B5); rows past the batch are zero-filled;
            // every copy is in flight before the one wait
            for (int c = threadIdx.x * 4; c < tb * n; c += kConsumers * 4) {
                const bool ok = (c >> p.logn) < live;
                cp_async16(data + c, ok ? x + base + c : x, ok ? 16 : 0);
                if (MODE == kProduct)
                    cp_async16(data + tb * n + c, ok ? y + base + c : y,
                               ok ? 16 : 0);
            }
            cp_async_wait_all();
            Team::sync();
            if constexpr (MODE != kIntt)
                wide_stages<false>(data, rows, p, tw);
            const PassOut own{data, tb, nullptr};
            if constexpr (MODE == kFolded || MODE == kFixed ||
                          MODE == kIntt) {
                // B9, B8: the forward pass stores the spectrum in place (B8:
                // times the constant's spectrum y), the inverse one runs
                // against the inverse stages and const rows (B9: the
                // constant's, under the fold plan's split), over one 16-row
                // MMA tile or two; B7 runs the inverse pass alone
                constexpr int kFwd = MODE == kFixed ? kSpectrumProduct : kStore;
                const PassOut fwd{data, tb, y};
                if (tb > 16) {
                    if constexpr (MODE != kIntt)
                        stream_matmul<D, 2, kFwd>(data, tb, p.stages_f, p.df,
                                                  p.fwd_lb, p.fwd_add, p.kbf,
                                                  cf, planes, ks, sr, rg, p, m,
                                                  fwd);
                    stream_matmul<D, 2, kStore>(data, tb, p.stages_i, p.di,
                                                p.inv_lb, p.inv_add, p.kbi, ci,
                                                planes, ks, sr, rg, p, m, own);
                } else {
                    if constexpr (MODE != kIntt)
                        stream_matmul<D, 1, kFwd>(data, tb, p.stages_f, p.df,
                                                  p.fwd_lb, p.fwd_add, p.kbf,
                                                  cf, planes, ks, sr, rg, p, m,
                                                  fwd);
                    stream_matmul<D, 1, kStore>(data, tb, p.stages_i, p.di,
                                                p.inv_lb, p.inv_add, p.kbi, ci,
                                                planes, ks, sr, rg, p, m, own);
                }
            } else if constexpr (MODE == kNtt) {
                // B6: the forward pass alone, its epilogue storing the
                // spectrum's live rows straight to z: no store pass and no
                // barrier after it
                const PassOut spectrum{z + base, live, nullptr};
                if (tb > 16)
                    stream_matmul<D, 2, kStore>(data, tb, p.stages_f, p.df,
                                                p.fwd_lb, p.fwd_add, p.kbf, cf,
                                                planes, ks, sr, rg, p, m,
                                                spectrum);
                else
                    stream_matmul<D, 1, kStore>(data, tb, p.stages_f, p.df,
                                                p.fwd_lb, p.fwd_add, p.kbf, cf,
                                                planes, ks, sr, rg, p, m,
                                                spectrum);
                continue;
            } else {
                // B5: the forward pass of x and y, with the pointwise
                // product where x's and y's rows meet in one thread (tb =
                // 16 or 8), else after it, then the inverse pass of x's
                // rows
                const PassOut all{data, rows, nullptr};
                if (tb == 16) {
                    stream_matmul<D, 2, kPairProduct>(
                        data, rows, p.stages_f, p.df, p.fwd_lb, p.fwd_add,
                        p.kbf, cf, planes, ks, sr, rg, p, m, all);
                } else if (tb == 8) {
                    stream_matmul<D, 1, kPairProduct>(
                        data, rows, p.stages_f, p.df, p.fwd_lb, p.fwd_add,
                        p.kbf, cf, planes, ks, sr, rg, p, m, all);
                } else {
                    stream_matmul<D, 1, kStore>(data, rows, p.stages_f, p.df,
                                                p.fwd_lb, p.fwd_add, p.kbf, cf,
                                                planes, ks, sr, rg, p, m, all);
                    for (int idx = threadIdx.x; idx < tb * n;
                         idx += kConsumers)
                        data[idx] =
                            pointwise(data[idx], data[tb * n + idx], m);
                    Team::sync();
                }
                stream_matmul<D, 1, kStore>(data, tb, p.stages_i, p.di,
                                            p.inv_lb, p.inv_add, p.kbi, ci,
                                            planes, ks, sr, rg, p, m, own);
            }
            // B7 stores its live rows from the wide stages' registers, whose
            // barrier ends the group
            if (wide_stages<true, MODE == kIntt>(data, tb, p, tw, z + base,
                                                 live))
                continue;
            for (int c = threadIdx.x * 4; c < tb * n; c += kConsumers * 4)
                if ((c >> p.logn) < live)
                    *reinterpret_cast<uint4*>(z + base + c) =
                        *reinterpret_cast<const uint4*>(data + c);
            // the stores have read the rows before the next group's loads
            Team::sync();
        }
    }
}

bool valid_split(int din, int lb) {
    return din >= 1 && ((lb == 7 && din <= 6) || (lb == 8 && din <= 4));
}

template <int D, int MODE>
int run_polymul_stream(const void* a, const void* b, void* out,
                       const void* stream_f, const void* stream_i,
                       const void* cf, const void* ci, const void* tw,
                       long long batch, const MxuStreamPlan& p,
                       void* cuda_stream) {
    auto kernel = polymul_stream_kernel<D, MODE>;
    const size_t smem = stream_smem(p);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    // persistent: as many blocks as the card holds at once
    int resident = 0;
    if (const int err = qt::resident_blocks(kernel, kStreamThreads, smem,
                                            &resident))
        return err;
    const long long tb = MODE == kProduct ? p.rows / 2 : p.rows;
    const long long groups = (batch + tb - 1) / tb;
    const long long walkers = resident < groups ? resident : groups;
    if (walkers < 1 || walkers >= (1LL << 31)) return cudaErrorInvalidValue;
    kernel<<<dim3(static_cast<unsigned>(walkers)), kStreamThreads, smem,
             static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), static_cast<const int8_t*>(stream_f),
        static_cast<const int8_t*>(stream_i),
        static_cast<const uint32_t*>(cf), static_cast<const uint32_t*>(ci),
        static_cast<const uint32_t*>(tw), batch, p);
    return cudaGetLastError();
}

// B5: x's tb rows above y's, one m16 tile (tb <= 8) or two (tb = 16).  B9,
// B8, B6, B7: tb x rows, one m16 tile (tb <= 16) or two (tb = 32).
// stream_f is B5's stage stream of both directions, the inverse stages
// after the forward ones: B5 and B8 read all of it, B9 and B6 its forward
// stages, B7 its inverse ones; stream_i is B9's constant's inverse stages.
// B6 streams no inverse stage (stages_i 0), B7 no forward one (stages_f 0).
template <int MODE>
int launch_polymul_stream(const void* a, const void* b, void* out,
                          const void* stream_f, const void* stream_i,
                          const void* cf, const void* ci, const void* tw,
                          long long batch, const void* plan,
                          void* cuda_stream) {
    const MxuStreamPlan p = *static_cast<const MxuStreamPlan*>(plan);
    // the stages of a lane block's forward and inverse tables in the stream
    const int fwd_stages = (p.df * p.bw + kStageK - 1) / kStageK;
    const int inv_stages = (p.di * p.bw + kStageK - 1) / kStageK;
    if (p.rows < (MODE == kProduct ? 2 : 1) ||
        (p.rows > 16 && p.rows != 32) || (MODE == kProduct && p.rows % 2) ||
        p.d < 1 || p.d > kMaxClasses || p.bw < 32 || p.bw > 128 ||
        p.bw % 32 || p.n != 1 << p.logn || p.nb * p.bw != p.n ||
        p.n >> p.lr != p.bw || !valid_split(p.df, p.fwd_lb) ||
        !valid_split(p.di, p.inv_lb) ||
        p.stages_f != (MODE == kIntt ? 0 : fwd_stages) ||
        p.stages_i != (MODE == kNtt ? 0 : inv_stages) || p.ring < 2 ||
        batch <= 0 || stream_smem(p) + kBlockReserve > kSmShared)
        return cudaErrorInvalidValue;
    if (MODE == kProduct || MODE == kFixed || MODE == kIntt)
        stream_i = static_cast<const int8_t*>(stream_f) +
                   static_cast<size_t>(p.nb) * fwd_stages * kStageK * p.bw *
                       p.d;
    switch (p.d) {
    case 1:
        return run_polymul_stream<1, MODE>(a, b, out, stream_f, stream_i, cf,
                                           ci, tw, batch, p, cuda_stream);
    case 2:
        return run_polymul_stream<2, MODE>(a, b, out, stream_f, stream_i, cf,
                                           ci, tw, batch, p, cuda_stream);
    case 3:
        return run_polymul_stream<3, MODE>(a, b, out, stream_f, stream_i, cf,
                                           ci, tw, batch, p, cuda_stream);
    default:
        return run_polymul_stream<4, MODE>(a, b, out, stream_f, stream_i, cf,
                                           ci, tw, batch, p, cuda_stream);
    }
}

}  // namespace

// Every launcher takes (a, b, out, wf, cf, wi, ci, tw, batch, plan, stream).

// B5: wf the stage stream of the forward and inverse tables
// (MxuDeviceTables.stream), wi unused, plan an MxuStreamPlan
extern "C" int qt_polymul_mxu(const void* a, const void* b, void* out,
                              const void* wf, const void* cf, const void*,
                              const void* ci, const void* tw, long long batch,
                              const void* plan, void* stream) {
    return launch_polymul_stream<kProduct>(a, b, out, wf, nullptr, cf, ci, tw,
                                           batch, plan, stream);
}

// B8: b the constant's canonical spectrum (n values), wf the same stream
// (both directions), wi unused, plan an MxuStreamPlan
extern "C" int qt_polymul_fixed_mxu(const void* a, const void* b, void* out,
                                    const void* wf, const void* cf,
                                    const void*, const void* ci,
                                    const void* tw, long long batch,
                                    const void* plan, void* stream) {
    return launch_polymul_stream<kFixed>(a, b, out, wf, nullptr, cf, ci, tw,
                                         batch, plan, stream);
}

// B6: wf the same stream (its forward stages); b, wi and ci unused; plan an
// MxuStreamPlan with no inverse stages
extern "C" int qt_ntt_mxu(const void* a, const void*, void* out,
                          const void* wf, const void* cf, const void*,
                          const void*, const void* tw, long long batch,
                          const void* plan, void* stream) {
    return launch_polymul_stream<kNtt>(a, nullptr, out, wf, nullptr, cf,
                                       nullptr, tw, batch, plan, stream);
}

// B7: wf the same stream (its inverse stages), ci the inverse const rows
// (MxuDeviceTables.consti); b, cf and wi unused; plan an MxuStreamPlan
// with no forward stages
extern "C" int qt_intt_mxu(const void* a, const void*, void* out,
                           const void* wf, const void*, const void*,
                           const void* ci, const void* tw, long long batch,
                           const void* plan, void* stream) {
    return launch_polymul_stream<kIntt>(a, nullptr, out, wf, nullptr, nullptr,
                                        ci, tw, batch, plan, stream);
}

// B9: wf the same stream (its forward stages), wi the constant's inverse
// stages (FoldedOperand.stages), ci its const rows, b unused, plan an
// MxuStreamPlan under the fold plan's inverse split
extern "C" int qt_polymul_fixed_folded_mxu(const void* a, const void*,
                                           void* out, const void* wf,
                                           const void* cf, const void* wi,
                                           const void* ci, const void* tw,
                                           long long batch, const void* plan,
                                           void* stream) {
    return launch_polymul_stream<kFolded>(a, nullptr, out, wf, wi, cf, ci, tw,
                                          batch, plan, stream);
}
