// Building blocks of the digit-matmul kernels (ntt_mxu.cu, sharded_mxu.cu):
// the wide butterfly stages, the int8 block matmul with its recombination,
// and the copy and MMA primitives under them.  Every function works on rows
// held in shared memory and is called by every thread of the block.
//
// A row holds `len` uint32 values.  The wide stages see it as an m-point
// merged-psi transform (m = 2^logm) over "super-lanes" of 2^llanes values:
// transform element j, lane l sits at (j << llanes) | l.  The single
// transform (B5-B9) has llanes = 0 and m = n; the sequence-parallel column
// transform (B11, B16) has m = n1 and 2^llanes = n2/k lanes, so a butterfly
// of pair distance t in j is one of distance t << llanes in the row.  The
// twiddles are the m-point table's packed (4, m) rows (ops/tables.py).
//
// The block matmul cuts the row into nb blocks of bw lanes and maps each
// through one exact matrix, as int8 products against digit tables laid out
// output-major: block b's table is (d*bw, K) int8 at w + b * w_step (w_step
// 0: one table shared by every block), row j*bw + o is output lane o of
// digit class j, column i*bw + k is input lane k of plane i, and columns
// din*bw .. K-1 are zero (K, a multiple of 32, pads a depth din*bw that is
// not).  The split, product and recombination:
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
// block_matmul is three phases that also serve apart: split_block (the
// split), mma_classes (the products over K, ending in an epilogue it is
// given per output tile) and recombine_tile (the epilogue above).
//
// These blocks multiply a whole bw x bw table.  The sequence-parallel tables
// are block-diagonal under a lane permutation; mxu_compact.cuh holds the
// counterparts that multiply the nonzero blocks alone (split_compact,
// mma_compact, recombine_compact), which B11-B13 and B15-B18 are built
// from; B14 still runs block_matmul.  B5-B9 (ntt_mxu.cu) run
// products of their own over tables streamed through shared memory.
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

// Columns kin .. K-1 of `rows` rows of digit planes (row stride ks) meet
// the zero columns that pad a table's depth to K; zero them too.
__device__ inline void zero_depth_pad(int8_t* planes, int rows, int ks,
                                      int kin, int K) {
    for (int idx = threadIdx.x; idx < rows * (K - kin); idx += blockDim.x) {
        const int r = idx / (K - kin);
        planes[r * ks + kin + idx - r * (K - kin)] = 0;
    }
}

// The split phase: block b (bw lanes) of `rows` rows of `len` values into
// din balanced planes of base 2^lb, plane i of row r at
// planes[r * ks + i * bw + k].  Every input must lie below the split's bound.
__device__ inline void split_block(const uint32_t* data, int rows, int len,
                                   int bw, int b, int8_t* planes, int ks,
                                   int din, int lb, uint32_t add) {
    const int lbw = __ffs(bw) - 1;
    const int low_mask = (1 << lb) - 1, half_base = 1 << (lb - 1);
    for (int idx = threadIdx.x; idx < rows * bw; idx += blockDim.x) {
        const int r = idx >> lbw, k = idx & (bw - 1);
        const int32_t a =
            static_cast<int32_t>(data[r * len + b * bw + k] + add);
        int8_t* pr = planes + r * ks + k;
        for (int i = 0; i < din - 1; ++i)
            pr[i * bw] = static_cast<int8_t>(
                ((a >> (lb * i)) & low_mask) - half_base);
        pr[(din - 1) * bw] = static_cast<int8_t>(a >> (lb * (din - 1)));
    }
}

// The MMA core: `rows` rows of digit planes (row stride ks, depth K) against
// one block's table wb (d * bw, K).  Each warp takes 8-lane output tiles lt
// and hands each tile's int32 class sums (exact) to the epilogue,
// epi(lt, acc): accumulator e of tile mm holds class j of row
// mm*16 + g (+8 for e >= 2), lane lt*8 + tig*2 + (e & 1), with g and tig
// the thread's lane / 4 and lane % 4 (tile_row, tile_lane).
template <class Epi>
__device__ __forceinline__ void mma_classes(const int8_t* planes, int rows,
                                            int ks,
                                            const int8_t* __restrict__ wb,
                                            int K, int bw, int d, Epi&& epi) {
    const int mt = (rows + 15) >> 4;
    const int nwarps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    for (int lt = warp; lt < (bw >> 3); lt += nwarps) {
        int acc[2][kMaxClasses][4];
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
#pragma unroll
            for (int j = 0; j < kMaxClasses; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mm][j][e] = 0;
        // K in chunks of kSteps 32-deep steps: every B fragment of a chunk
        // is requested before its first MMA, so a warp keeps d * kSteps
        // table loads in flight
        for (int k0 = 0; k0 < K; k0 += 32 * kSteps) {
            uint2 bf[kSteps][kMaxClasses];
#pragma unroll
            for (int st = 0; st < kSteps; ++st)
#pragma unroll
                for (int j = 0; j < kMaxClasses; ++j)
                    if (j < d && k0 + st * 32 < K)
                        bf[st][j] = __ldg(reinterpret_cast<const uint2*>(
                            wb + static_cast<size_t>(j * bw + lt * 8 + g) * K +
                            k0 + st * 32 + tig * 8));
#pragma unroll
            for (int st = 0; st < kSteps; ++st) {
                if (k0 + st * 32 >= K) break;
                uint2 a[2][2];
#pragma unroll
                for (int mm = 0; mm < 2; ++mm) {
                    if (mm < mt) {
                        const int8_t* pa = planes + (mm * 16 + g) * ks + k0 +
                                           st * 32 + tig * 8;
                        a[mm][0] = *reinterpret_cast<const uint2*>(pa);
                        a[mm][1] = *reinterpret_cast<const uint2*>(pa + 8 * ks);
                    }
                }
#pragma unroll
                for (int j = 0; j < kMaxClasses; ++j)
                    if (j < d)
#pragma unroll
                        for (int mm = 0; mm < 2; ++mm)
                            if (mm < mt)
                                mma_s8(acc[mm][j], a[mm][0], a[mm][1],
                                       bf[st][j]);
            }
        }
        epi(lt, acc);
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

// Row and lane of accumulator e of tile mm in output tile lt (mma_classes).
__device__ __forceinline__ int tile_row(int mm, int e) {
    return mm * 16 + ((threadIdx.x & 31) >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int tile_lane(int lt, int e) {
    return lt * 8 + (threadIdx.x & 3) * 2 + (e & 1);
}

// The recombination epilogue of one output tile: for each of its rows
// r < rows, out[r * len + o] = const + kb (< 2q) plus, per class j < d, one
// Shoup product of c_j + 2^24 by 2^{8j} mod q; canonical.  Block b's const
// row is cb.
template <class Plan>
__device__ __forceinline__ void recombine_tile(
    uint32_t* out, int rows, int len, int lt,
    const int (&acc)[2][kMaxClasses][4], const uint32_t* __restrict__ cb,
    uint32_t kb, const Plan& p) {
    const int d = warp_uniform(p.d), mt = (rows + 15) >> 4;
    const uint32_t q = p.q, q2 = 2u * q;
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = tile_row(mm, e);
            const int o = tile_lane(lt, e);
            if (mm < mt && r < rows) {
                uint32_t v = __ldg(cb + o) + kb;                      // < 2q
#pragma unroll
                for (int j = 0; j < kMaxClasses; ++j) {
                    if (j < d) {
                        const uint32_t t =
                            static_cast<uint32_t>(acc[mm][j][e]) + kClassBias;
                        v = csub(v + shoup_lazy(t, p.pw[j], p.pw_sh[j], q),
                                 q2);                                 // < 2q
                    }
                }
                out[r * len + o] = csub(v, q);
            }
        }
    }
}

// The block matmul of `rows` rows of `len` values, in place: per block of
// bw lanes (nb blocks), digit split into `planes` (row stride ks >= K),
// int8 MMA against the block's table, recombination into canonical
// residues.  Block b's const row is cst + b * c_step.  Every input must lie
// below the split's bound.  Plan supplies q, d (classes), pw[j] = 2^{8j}
// mod q and their Shoup companions pw_sh[j].
template <class Plan>
__device__ void block_matmul(uint32_t* data, int rows, int len, int bw, int nb,
                             int8_t* planes, int ks,
                             const int8_t* __restrict__ w, size_t w_step,
                             int K, const uint32_t* __restrict__ cst,
                             int c_step, int din, int lb, uint32_t add,
                             uint32_t kb, const Plan& p) {
    zero_depth_pad(planes, rows, ks, din * bw, K);
    for (int b = 0; b < nb; ++b) {
        split_block(data, rows, len, bw, b, planes, ks, din, lb, add);
        __syncthreads();
        const uint32_t* cb = cst + b * c_step;
        mma_classes(planes, rows, ks, w + b * w_step, K, bw, p.d,
                    [&](int lt, const int (&acc)[2][kMaxClasses][4]) {
                        recombine_tile(data + b * bw, rows, len, lt, acc, cb,
                                       kb, p);
                    });
        __syncthreads();
    }
}

}  // namespace qt
