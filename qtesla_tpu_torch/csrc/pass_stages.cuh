// Register passes of butterfly stages, shared by the pass kernels of
// ntt_pairings.cu (B10, all five pairings) and ntt_fused.cu (B1, B4, B2,
// the forward alone, and B3, the inverse alone).
//
// A row of n = 2^L values is held by T = n / R threads, R values of each
// operand a thread.  In a pass, thread vt holds the R indices that differ
// only in the bits of a window [b, b + r), r = log2(R): register c holds
// index (vt mod 2^b) | c << b | (vt >> b) << (b + r), so every butterfly of
// the pass's stages (half-widths 2^k, k in the window) pairs two registers
// of one thread, and a pass runs up to r dependent stages with no memory
// traffic.  Between passes the values go once through shared memory (one
// store and one load each, index i at i + i/32, so strides of 32 words do
// not share a bank) into the next window: P - 1 exchanges a transform, P =
// ceil(L / r).  A plan (ops/passes.py pass_plan) gives R, T, the rows of a
// block, each pass's stages and window; the launcher refuses a plan its
// kernels cannot run (launch_pass_kernel).  A bit reversal moves no value:
// it renames (vt, b, c) to (brev(vt), L - r - b, brev(c)), so it costs
// nothing wherever it falls.  Rows of at most 32 threads (n <= 1024) meet
// at each exchange with __syncwarp() alone; larger rows take
// __syncthreads().
//
// Arithmetic.  q < 2^30.  GS (Gentleman-Sande) butterflies keep values in
// [0, 2q); CT (Cooley-Tukey) butterflies take and give values below 4q.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"

namespace qt {

constexpr int kMaxPasses = 3;
// the most dynamic shared memory one H100 block may take (227 KB)
constexpr int kMaxSmem = 232448;

// Mirrors ops/passes.py PassPlan.  Pass p of the forward runs the stages of
// half-width 2^k, k in [fwd_lo[p], fwd_hi[p]), in the window [fwd_b[p],
// fwd_b[p] + r); the inverse's likewise.  row_stride: words of shared
// memory a row (both operands, padded); 0 when P = 1.
struct PassPlan {
    int radix, threads, rows, passes, row_stride;
    int fwd_lo[kMaxPasses], fwd_hi[kMaxPasses], fwd_b[kMaxPasses];
    int inv_lo[kMaxPasses], inv_hi[kMaxPasses], inv_b[kMaxPasses];
};

__host__ __device__ constexpr int ilog2(int v) {
    return v > 1 ? 1 + ilog2(v >> 1) : 0;
}

// c with its low r bits reversed, at compile time once unrolled
__host__ __device__ constexpr int rev_bits(int c, int r) {
    return r == 0 ? 0 : ((c & 1) << (r - 1)) | rev_bits(c >> 1, r - 1);
}

// x mod b for x < 2b in two instructions: x - b wraps above x when x < b
__device__ __forceinline__ uint32_t lower(uint32_t x, uint32_t b) {
    return min(x, x - b);
}

// The index register 0 of virtual thread vt holds in the window [b, b + r);
// register c holds it plus c << b.
__device__ __forceinline__ int window_base(int vt, int b, int r) {
    return (vt & ((1 << b) - 1)) | ((vt >> b) << (b + r));
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// padded(base + (c << b)), base's window bits clear.  With b known at
// compile time (kConst) the offset from padded(base) is a constant of c:
// c (b = 0, as c < 32) or c (2^b + 2^(b-5)) (b >= 5, as c << b has no bit
// under 5).
template <bool kConst>
__device__ __forceinline__ int slot(int base, int c, int b) {
    if (kConst && b == 0) return padded(base) + c;
    if (kConst && b >= 5)
        return padded(base) + c * ((1 << b) + (1 << (b - 5)));
    return padded(base + (c << b));
}

// The two-pass schedule the planner makes (the larger half first): pass
// p's stages [lo, hi) and window, for the kernels built for one length;
// up: from the narrowest stage up, else from the widest down.
__host__ __device__ constexpr int two_pass_lo(bool up, int p, int L) {
    return up ? (p ? (L + 1) / 2 : 0) : (p ? 0 : L - (L + 1) / 2);
}
__host__ __device__ constexpr int two_pass_hi(bool up, int p, int L) {
    return up ? (p ? L : (L + 1) / 2) : (p ? L - (L + 1) / 2 : L);
}
__host__ __device__ constexpr int two_pass_b(bool up, int p, int L, int r) {
    return two_pass_lo(up, p, L) < L - r ? two_pass_lo(up, p, L) : L - r;
}

__device__ __forceinline__ void row_sync(bool warp_rows) {
    if (warp_rows)
        __syncwarp();
    else
        __syncthreads();
}

// The array's bit reversal as a renaming: register c takes register
// brev_r(c)'s value, the virtual thread is reversed over the tb thread bits
// and the window reflects.
template <int R, int NOPS>
__device__ __forceinline__ void bit_reverse(uint32_t (&v)[NOPS][R], int& b,
                                            int& vt, int tb) {
    constexpr int r = ilog2(R);
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int rc = rev_bits(c, r);
        if (c < rc) {
#pragma unroll
            for (int o = 0; o < NOPS; ++o) {
                const uint32_t t = v[o][c];
                v[o][c] = v[o][rc];
                v[o][rc] = t;
            }
        }
    }
    vt = tb == 0 ? 0
                 : static_cast<int>(__brev(static_cast<unsigned>(vt)) >>
                                    (32 - tb));
    b = tb - b;
}

// The GS butterfly on registers a and b: [0, 2q) in and out.
__device__ __forceinline__ void gs_butterfly(uint32_t& a, uint32_t& b,
                                             uint32_t tw, uint32_t tw_sh,
                                             uint32_t q, uint32_t q2) {
    const uint32_t u = a, d = b;
    a = lower(u + d, q2);
    b = shoup_lazy(u + q2 - d, tw, tw_sh, q);
}

// The CT butterfly on registers a and b: below 4q in and out.
__device__ __forceinline__ void ct_butterfly(uint32_t& a, uint32_t& b,
                                             uint32_t tw, uint32_t tw_sh,
                                             uint32_t q, uint32_t q2) {
    const uint32_t u = lower(a, q2);                   // < 2q
    const uint32_t h = shoup_lazy(b, tw, tw_sh, q);    // < 2q
    a = u + h;
    b = u + q2 - h;
}

// The cyclic stages of half-width 2^k, k in [lo, hi), on the window
// [b, b + r) of virtual thread vt: GS butterflies from the widest down (DIF)
// or CT butterflies from the narrowest up (DIT).  The stage on window bit t
// pairs registers c and c + 2^t and reads the 2^t twiddles w[2^k + (vt mod
// 2^b) + (c mod 2^t) 2^b].  q2 = 2q comes as a kernel parameter: an add
// reads it from the constant bank, where a 2q made in the kernel costs most
// butterflies an instruction of its own.
template <bool CT, int R, int NOPS>
__device__ __forceinline__ void pass_stages(uint32_t (&v)[NOPS][R], int b,
                                            int vt, int lo, int hi,
                                            const uint32_t* __restrict__ w,
                                            const uint32_t* __restrict__ w_sh,
                                            uint32_t q, uint32_t q2) {
    constexpr int r = ilog2(R);
    const int vlo = vt & ((1 << b) - 1);
#pragma unroll
    for (int s = 0; s < r; ++s) {
        const int t = CT ? s : r - 1 - s;
        const int k = b + t;
        if (k < lo || k >= hi) continue;
        const int m = 1 << t;
        const int base = (1 << k) + vlo;
#pragma unroll
        for (int cl = 0; cl < m; ++cl) {
            const uint32_t tw = __ldg(w + base + (cl << b));
            const uint32_t tw_sh = __ldg(w_sh + base + (cl << b));
#pragma unroll
            for (int ch = 0; ch < R; ch += 2 * m) {
                const int c = ch + cl;
#pragma unroll
                for (int o = 0; o < NOPS; ++o) {
                    if (CT)
                        ct_butterfly(v[o][c], v[o][c + m], tw, tw_sh, q, q2);
                    else
                        gs_butterfly(v[o][c], v[o][c + m], tw, tw_sh, q, q2);
                }
            }
        }
    }
}

// From the window [b, b + r) of virtual thread vt to the window [b2, b2 + r)
// of virtual thread t, through the row's shared memory (operand o at
// o * stride).
template <bool kConst, int R, int NOPS>
__device__ __forceinline__ void exchange(uint32_t (&v)[NOPS][R],
                                         uint32_t* buf, int stride, int b,
                                         int vt, int b2, int t,
                                         bool warp_rows) {
    constexpr int r = ilog2(R);
    const int from = window_base(vt, b, r), to = window_base(t, b2, r);
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int i = slot<kConst>(from, c, b);
#pragma unroll
        for (int o = 0; o < NOPS; ++o) buf[o * stride + i] = v[o][c];
    }
    row_sync(warp_rows);
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int i = slot<kConst>(to, c, b2);
#pragma unroll
        for (int o = 0; o < NOPS; ++o) v[o][c] = buf[o * stride + i];
    }
    // the next exchange writes where this one read
    row_sync(warp_rows);
}

// One transform's passes cover [0, logn) in their order (up: from the
// narrowest stage, else from the widest), each pass inside its window; with
// Stockham's windows (stk) each window's top is its pass's widest stage.
inline bool schedule_ok(const int* lo, const int* hi, const int* b,
                        int passes, int logn, int r, bool up, bool stk) {
    int edge = up ? 0 : logn;
    for (int p = 0; p < passes; ++p) {
        if (lo[p] >= hi[p] || b[p] < 0 || b[p] > logn - r || b[p] > lo[p] ||
            hi[p] > b[p] + r || (up ? lo[p] : hi[p]) != edge ||
            (stk && b[p] != hi[p] - r))
            return false;
        edge = up ? hi[p] : lo[p];
    }
    return edge == (up ? logn : 0);
}

using PassKernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*,
                            const uint32_t*, long long, int, int, Mod,
                            uint32_t, PassPlan);

// The order of a pass kernel's transforms: each from the narrowest stage
// up or not, a bit reversal between them (reflect) or not, Stockham's
// windows or not; the operands its exchanges carry (B4's forward runs on x
// alone); and whether it runs a forward and an inverse at all (B3 runs the
// inverse alone, its plan's forward fields 0; B2 the forward alone, its
// plan's inverse fields 0).
struct PassOrder {
    bool fwd_up, inv_up, reflect, stk;
    int operands = 2;
    bool forward = true;
    bool inverse = true;
};

// The fields of one transform's passes all 0: a plan with no such passes.
inline bool no_passes(const int* lo, const int* hi, const int* b) {
    for (int p = 0; p < kMaxPasses; ++p)
        if (lo[p] || hi[p] || b[p]) return false;
    return true;
}

// Checks the plan against the kernel chosen for it (null: none) and
// launches it; cudaErrorInvalidValue for a plan it cannot run.  The load
// leaves a row in the window [tb, L), reflected to [0, r) when the forward
// starts from the narrowest stage; the product keeps the forward's last
// window, reflected when a bit reversal lies between the two transforms.
// With no forward the inverse starts on [0, r) (B3's kernel takes its
// coalesced load there by one exchange); with no inverse the forward starts
// where the load leaves a row, on [tb, L) from the widest stage down (B2).
// A kernel of one transform may take 1024 threads a row in three passes (n
// = 32768: one operand's registers leave room for them).
inline int launch_pass_kernel(PassKernel kernel, const PassPlan& pl,
                              PassOrder order, const void* a, const void* b,
                              void* out, const void* tw, long long batch,
                              int n, int logn, uint32_t q, uint32_t r32,
                              uint32_t r32_sh, uint32_t one_sh, void* stream) {
    if (n < 2 || logn < 1 || logn > 30 || n != 1 << logn || batch <= 0 ||
        !kernel || pl.radix > n || pl.radix < 2 || pl.passes < 1 ||
        pl.passes > kMaxPasses || !(order.forward || order.inverse))
        return cudaErrorInvalidValue;
    const int r = ilog2(pl.radix), tb = logn - r;
    const long long threads = static_cast<long long>(pl.rows) * pl.threads;
    const bool both = order.forward && order.inverse;
    const int most = pl.passes == 3 ? (both ? 512 : 1024) : 256;
    if (pl.threads != 1 << tb || pl.rows < 1 || threads > most ||
        threads % 32 != 0)
        return cudaErrorInvalidValue;
    if (both) {
        const int last = pl.fwd_b[pl.passes - 1];
        const int inv_first = order.reflect ? tb - last : last;
        if (!schedule_ok(pl.fwd_lo, pl.fwd_hi, pl.fwd_b, pl.passes, logn, r,
                         order.fwd_up, order.stk) ||
            !schedule_ok(pl.inv_lo, pl.inv_hi, pl.inv_b, pl.passes, logn, r,
                         order.inv_up, order.stk) ||
            pl.fwd_b[0] != (order.fwd_up ? 0 : tb) ||
            pl.inv_b[0] != inv_first)
            return cudaErrorInvalidValue;
    } else if (order.forward) {
        if (!no_passes(pl.inv_lo, pl.inv_hi, pl.inv_b) ||
            !schedule_ok(pl.fwd_lo, pl.fwd_hi, pl.fwd_b, pl.passes, logn, r,
                         order.fwd_up, order.stk) ||
            pl.fwd_b[0] != (order.fwd_up ? 0 : tb))
            return cudaErrorInvalidValue;
    } else {
        if (!no_passes(pl.fwd_lo, pl.fwd_hi, pl.fwd_b) ||
            !schedule_ok(pl.inv_lo, pl.inv_hi, pl.inv_b, pl.passes, logn, r,
                         order.inv_up, order.stk) ||
            pl.inv_b[0] != 0)
            return cudaErrorInvalidValue;
    }
    size_t smem = 0;
    if (pl.passes > 1) {
        if (order.operands < 1 || order.operands > 2 ||
            pl.row_stride < order.operands * (n + (n >> 5)))
            return cudaErrorInvalidValue;
        smem = static_cast<size_t>(pl.rows) * pl.row_stride * sizeof(uint32_t);
        if (smem > kMaxSmem) return cudaErrorInvalidValue;
    }
    const long long blocks = (batch + pl.rows - 1) / pl.rows;
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    const Mod m{q, r32, r32_sh, one_sh};
    kernel<<<dim3(static_cast<unsigned>(blocks)),
             static_cast<unsigned>(threads), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), static_cast<const uint32_t*>(tw), batch,
        n, logn, m, 2u * q, pl);
    return cudaGetLastError();
}

}  // namespace qt
