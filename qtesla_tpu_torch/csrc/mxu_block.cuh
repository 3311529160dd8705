// Building blocks of the digit-matmul kernels (ntt_mxu.cu, sharded_mxu.cu,
// seg2_compact.cuh): the wide butterfly stages, and the copy and MMA
// primitives under the int8 products.  The wide stages work on rows held in
// shared memory and are called by every thread of the block (or of its
// Team).
//
// A row holds `len` uint32 values.  The wide stages see it as an m-point
// merged-psi transform (m = 2^logm) over "super-lanes" of 2^llanes values:
// transform element j, lane l sits at (j << llanes) | l.  The single
// transform (B5-B9) has llanes = 0 and m = n; the sequence-parallel column
// transform (B11, B16) has m = n1 and 2^llanes = n2/k lanes, so a butterfly
// of pair distance t in j is one of distance t << llanes in the row.  The
// twiddles are the m-point table's packed (4, m) rows (ops/tables.py).
//
// The digit products cut a row into blocks of bw lanes and map each
// through one exact matrix, as int8 products against digit tables laid out
// output-major: a block's table is (d*bw, K) int8, row j*bw + o is output
// lane o of digit class j, column i*bw + k is input lane k of plane i, and
// columns din*bw .. K-1 are zero (K, a multiple of 32, pads a depth din*bw
// that is not).  The split, product and recombination:
//
//   planes_i = balanced base-2^lb digits of (v - off),   i < din
//   c_j      = sum_i planes_i @ W[b, i][:, class j]      (int32, |c_j| < 2^24)
//   out      = const + group_bias + sum_j c_j * (2^{8j} mod q)   (mod q)
//
// (v + add) read as int32, add = split_bias - off mod 2^32, gives the planes:
// low planes a field minus base/2, the top plane an arithmetic shift.  The
// recombination adds 2^24 to each c_j, takes one Shoup product by 2^{8j} mod
// q per class and starts from const + kb, kb = group_bias - 2^24 * sum_j
// 2^{8j} mod q, folded on the host.  Outputs are canonical.
//
// The sequence-parallel tables are block-diagonal under a lane
// permutation; mxu_compact.cuh multiplies their nonzero blocks alone
// (split_compact, mma_compact, recombine_compact, recombine_value), which
// B11-B18 are built from.  B5-B9 (ntt_mxu.cu) run products of their own
// over tables streamed through shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"

namespace qt {

constexpr int kMaxRows = 32;      // two 16-row MMA tiles
constexpr int kMaxClasses = 4;
constexpr int kSteps = 4;         // 32-deep K steps whose loads go together
constexpr int kPad = 16;          // bytes after each row of digit planes
constexpr uint32_t kClassBias = 1u << 24;

// c += A (16x32 s8) * B (32x8 s8).  a_lo: row g, a_hi: row g + 8, each 8
// bytes at the thread's K offset; b: column g at the same K offset.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint2 a_lo, uint2 a_hi,
                                       uint2 b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a_lo.x), "r"(a_hi.x), "r"(a_lo.y), "r"(a_hi.y), "r"(b.x),
          "r"(b.y));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src,
                                           int src_bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The threads that share a phase's work and its barriers: the whole block
// (__syncthreads), or its first N threads (named barrier 1), which leaves
// the warps after them free to do other work, such as B5's table stream.
struct WholeBlock {
    __device__ static int count() { return blockDim.x; }
    __device__ static void sync() { __syncthreads(); }
};
template <int N>
struct FirstThreads {
    __device__ static constexpr int count() { return N; }
    __device__ static void sync() {
        asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
    }
};

// The first lr merged-psi CT stages of the m-point transform over `rows`
// rows, canonical in and out, by the threads of Team.  Stage s has 2^s
// blocks of 2t elements, t = m >> (s + 1); block i uses tw[2^s + i].
template <class Team = WholeBlock>
__device__ inline void fwd_wide(uint32_t* data, int rows, int logm, int llanes,
                                int lr, const uint32_t* __restrict__ tw,
                                uint32_t q) {
    const int m = 1 << logm, hl = logm - 1 + llanes, len = 2 << hl;
    const int lmask = (1 << llanes) - 1;
    for (int s = 0; s < lr; ++s) {
        const int sh = logm - 1 - s;
        const int t = 1 << sh, dist = t << llanes;
        for (int k = threadIdx.x; k < rows << hl; k += Team::count()) {
            const int kk = k & ((1 << hl) - 1);
            const int jj = kk >> llanes;
            const int i = jj >> sh;
            uint32_t* a = data + (k >> hl) * len +
                          ((((i << (sh + 1)) + (jj & (t - 1))) << llanes) |
                           (kk & lmask));
            const uint32_t w = __ldg(tw + (1 << s) + i);
            const uint32_t w_sh = __ldg(tw + m + (1 << s) + i);
            const uint32_t u = a[0];
            const uint32_t v = csub(shoup_lazy(a[dist], w, w_sh, q), q);
            a[0] = csub(u + v, q);
            a[dist] = csub(u - v + q, q);
        }
        Team::sync();
    }
}

// The last lr merged-psi GS stages of the m-point transform over `rows`
// rows, canonical in and out, by the threads of Team.  Stage s has pair
// distance t = 2^s and h = m >> (s + 1) blocks; block i uses itw[h + i]; the
// last stage's sum branch takes itw[0] = m^{-1} (its difference twiddle
// itw[1] carries it).
template <class Team = WholeBlock>
__device__ inline void inv_wide(uint32_t* data, int rows, int logm, int llanes,
                                int lr, const uint32_t* __restrict__ tw,
                                uint32_t q) {
    const int m = 1 << logm, hl = logm - 1 + llanes, len = 2 << hl;
    const int lmask = (1 << llanes) - 1;
    const uint32_t* itw = tw + 2 * m;
    const uint32_t* itw_sh = tw + 3 * m;
    for (int s = logm - lr; s < logm; ++s) {
        const int t = 1 << s, dist = t << llanes;
        const int h = m >> (s + 1);
        const bool last = s == logm - 1;
        for (int k = threadIdx.x; k < rows << hl; k += Team::count()) {
            const int kk = k & ((1 << hl) - 1);
            const int jj = kk >> llanes;
            const int i = jj >> s;
            uint32_t* a = data + (k >> hl) * len +
                          ((((i << (s + 1)) + (jj & (t - 1))) << llanes) |
                           (kk & lmask));
            const uint32_t u = a[0];
            const uint32_t v = a[dist];
            uint32_t sum = csub(u + v, q);
            if (last)
                sum = csub(shoup_lazy(sum, __ldg(itw), __ldg(itw_sh), q), q);
            a[0] = sum;
            a[dist] = csub(shoup_lazy(u - v + q, __ldg(itw + h + i),
                                      __ldg(itw_sh + h + i), q), q);
        }
        Team::sync();
    }
}

// v, the same in every lane of the warp, as ptxas can prove it: read back
// from lane 0.  A branch on a uniform value then needs no convergence
// barrier; without it ptxas put a BSSY/BSYNC pair around each class of the
// recombination (32 per tile) and B11, B15 and B16 ran 2-6 % slower on an
// H100 (utils/ab_timing.py, PERF.md).  Every lane must be active.
__device__ __forceinline__ int warp_uniform(int v) {
    return __shfl_sync(0xffffffffu, v, 0);
}

// Row and lane of accumulator e of tile mm in output tile lt (mma_compact):
// row mm*16 + g (+8 for e >= 2), lane lt*8 + tig*2 + (e & 1), g and tig the
// thread's lane / 4 and lane % 4.
__device__ __forceinline__ int tile_row(int mm, int e) {
    return mm * 16 + ((threadIdx.x & 31) >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int tile_lane(int lt, int e) {
    return lt * 8 + (threadIdx.x & 3) * 2 + (e & 1);
}

}  // namespace qt
