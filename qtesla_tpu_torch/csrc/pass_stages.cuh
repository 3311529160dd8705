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
// Rows one block cannot hold (n >= 32768 with both transforms: two
// operands' rows take 264 KiB and 1024 threads of 64 data registers fill
// an SM's register file; 65536 with one) span a thread-block cluster of C
// = T / most blocks on C SMs (most: 512 threads a block with both
// transforms, 1024 with one; C <= 8, the portable cluster).  Thread t of
// the row is thread t mod (T / C) of block t / (T / C) of its cluster, one
// row a cluster, and block k holds indices [k m, (k + 1) m), m = n / C,
// of each operand in its shared memory at i mod m, padded.  Every pass,
// twiddle read, load and store is the block form's on the row's thread t.
// An exchange between two windows that keep the block's bits of t in the
// top bits of the index (b <= L - r - log2 C, no bit-reversal renaming,
// not Stockham's map) stays in the block, as before; the others
// (the plan's cross mask, see cross_mask) store each value into the
// shared memory of the block that holds its index and load from there
// (distributed shared memory: cooperative_groups' map_shared_rank), the
// block's __syncthreads() replaced by cluster barriers
// (barrier.cluster.arrive.release / wait.acquire).  The kernel stays one
// launch, through cudaLaunchKernelEx with a cluster dimension.  What
// bounds it on an H100: the exchanges across blocks (three cluster
// barriers each, one block an SM at 135 KB of shared memory, remote stores
// and loads), not device memory: B1 took 0.70 ms at n = 32768, B = 1024
// (5.8x its bytes bound; 1.88x at n = 1024), Stockham, all of whose
// exchanges cross, 2.46 ms (PERF.md, section 5).
//
// Arithmetic.  q < 2^30.  GS (Gentleman-Sande) butterflies keep values in
// [0, 2q); CT (Cooley-Tukey) butterflies take and give values below 4q.

#pragma once

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"

namespace qt {

constexpr int kMaxPasses = 4;
// the most dynamic shared memory one H100 block may take (227 KB)
constexpr int kMaxSmem = 232448;
// the most blocks of a portable cluster
constexpr int kMaxCluster = 8;

// Mirrors ops/passes.py PassPlan.  Pass p of the forward runs the stages of
// half-width 2^k, k in [fwd_lo[p], fwd_hi[p]), in the window [fwd_b[p],
// fwd_b[p] + r); the inverse's likewise.  row_stride: words of shared
// memory a row (both operands, padded), or a block of a cluster; 0 when P
// = 1.  cluster: blocks a row (1: rows rows a block); cross: bit e set when
// the kernel's e-th exchange goes between the cluster's blocks.
struct PassPlan {
    int radix, threads, rows, passes, row_stride, cluster, cross;
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

// From the window [b, b + r) of virtual thread vt to the window [b2, b2 + r)
// of virtual thread t, across the blocks of the row's cluster: index i in
// the shared memory of block i >> lbits at padded(i mod 2^lbits) (operand o
// at o * stride), stored and loaded there through distributed shared
// memory.  The first barrier keeps a block from storing into a buffer
// another block still reads from the exchange before (and waits for every
// block of the cluster to run), the second makes the stores seen, the third
// keeps a block from storing again, or exiting, while another still loads
// from it.
template <int R, int NOPS>
__device__ __forceinline__ void cluster_exchange(uint32_t (&v)[NOPS][R],
                                                 uint32_t* buf, int stride,
                                                 int b, int vt, int b2, int t,
                                                 int lbits) {
    namespace cg = cooperative_groups;
    constexpr int r = ilog2(R);
    const cg::cluster_group cl = cg::this_cluster();
    const int mask = (1 << lbits) - 1;
    const int from = window_base(vt, b, r), to = window_base(t, b2, r);
    cl.sync();
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int i = from + (c << b);
        uint32_t* dst = cl.map_shared_rank(buf, i >> lbits) + padded(i & mask);
#pragma unroll
        for (int o = 0; o < NOPS; ++o) dst[o * stride] = v[o][c];
    }
    cl.sync();
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int i = to + (c << b2);
        const uint32_t* src =
            cl.map_shared_rank(buf, i >> lbits) + padded(i & mask);
#pragma unroll
        for (int o = 0; o < NOPS; ++o) v[o][c] = src[o * stride];
    }
    cl.sync();
}

// The row's thread and its place in a block: kCluster false, rows of T =
// 2^tb threads side by side in a block (slot the row's place); true, one
// row a cluster, thread t of the row the thread of its block's rank
// (lbits: log2 of the indices a block holds, m).
template <bool kCluster>
struct RowPlace {
    int t, slot, rank, lbits;
    long long row;
    __device__ __forceinline__ RowPlace(const PassPlan& pl, int tb,
                                        int logn) {
        if constexpr (kCluster) {
            rank = static_cast<int>(
                cooperative_groups::this_cluster().block_rank());
            t = (rank << (tb - (31 - __clz(pl.cluster)))) + threadIdx.x;
            slot = 0;
            row = blockIdx.x / pl.cluster;
            lbits = logn - (31 - __clz(pl.cluster));
        } else {
            t = threadIdx.x & ((1 << tb) - 1);
            slot = threadIdx.x >> tb;
            rank = 0;
            row = static_cast<long long>(blockIdx.x) * pl.rows + slot;
            lbits = logn;
        }
    }
};

// Exchange e of a kernel: the block form's exchange, or in a cluster the
// cross-block one where the plan's cross mask has bit e, else the block
// form's on the block's own indices (thread t of the row is thread
// threadIdx.x of the block's m indices: the window keeps the block's bits
// in the index's top bits and the thread holds its own virtual thread).
template <bool kCluster, bool kConst, int R, int NOPS>
__device__ __forceinline__ void row_exchange(uint32_t (&v)[NOPS][R],
                                             uint32_t* buf, int stride,
                                             int b, int vt, int b2, int t,
                                             bool warp_rows,
                                             const PassPlan& pl, int e,
                                             int lbits) {
    if constexpr (kCluster) {
        if ((pl.cross >> e) & 1)
            cluster_exchange<R, NOPS>(v, buf, stride, b, vt, b2, t, lbits);
        else
            exchange<false, R, NOPS>(v, buf, stride, b, threadIdx.x, b2,
                                     threadIdx.x, false);
    } else {
        exchange<kConst, R, NOPS>(v, buf, stride, b, vt, b2, t, warp_rows);
    }
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

// Bit e set: the e-th exchange of a kernel of this order (B3's first one
// into [0, r), the forward's between passes, B2's last one back to [tb, L),
// the inverse's) goes between the blocks of the plan's cluster; 0 for a
// plan of one block a row.  Thread t lies in block t >> (tb - c) (C = 2^c);
// a window [b, b + r) with b <= tb - c keeps those bits of t in the top c
// bits of its indices, where the blocks part the row, as long as the thread
// holds its own virtual thread: not after a bit reversal's renaming, not
// under Stockham's map.  ops/passes.py cross_mask makes the same bits.
inline int cross_mask(const PassPlan& pl, PassOrder order, int logn) {
    if (pl.cluster == 1) return 0;
    const int tb = logn - ilog2(pl.radix), top = tb - ilog2(pl.cluster);
    int mask = 0, e = 0, b = tb;
    bool own = true;  // the load: window [tb, L), thread t
    const auto exchange_to = [&](int b2) {
        if (order.stk || !own || b > top || b2 > top) mask |= 1 << e;
        ++e;
        b = b2;
        own = true;
    };
    if (order.forward) {
        if (order.fwd_up) b = 0, own = false;
        for (int p = 1; p < pl.passes; ++p) exchange_to(pl.fwd_b[p]);
        if (!order.inverse)
            exchange_to(tb);
        else if (order.reflect)
            b = tb - b, own = false;
    } else {
        exchange_to(0);
    }
    if (order.inverse)
        for (int p = 1; p < pl.passes; ++p) exchange_to(pl.inv_b[p]);
    return mask;
}

// Checks the plan against the kernel chosen for it (null: none) and
// launches it; cudaErrorInvalidValue for a plan it cannot run.  The load
// leaves a row in the window [tb, L), reflected to [0, r) when the forward
// starts from the narrowest stage; the product keeps the forward's last
// window, reflected when a bit reversal lies between the two transforms.
// With no forward the inverse starts on [0, r) (B3's kernel takes its
// coalesced load there by one exchange); with no inverse the forward starts
// where the load leaves a row, on [tb, L) from the widest stage down (B2).
// A kernel of one transform may take 1024 threads a block from three
// passes (n = 32768: one operand's registers leave room for them), one of
// two 512.  A row of more threads than that spans a cluster of C =
// T / most blocks (C a power of two up to 8), launched with its cluster
// dimension; the plan's cross mask must be cross_mask's.
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
    const int C = pl.cluster;
    if (C < 1 || C > kMaxCluster || (C & (C - 1)) || C > pl.threads)
        return cudaErrorInvalidValue;
    const long long threads =
        static_cast<long long>(pl.rows) * pl.threads / C;
    const bool both = order.forward && order.inverse;
    const int most = pl.passes >= 3 ? (both ? 512 : 1024) : 256;
    if (pl.threads != 1 << tb || pl.rows < 1 || threads > most ||
        threads % 32 != 0)
        return cudaErrorInvalidValue;
    // a cluster only where one block cannot hold the row, one row to it
    if (C > 1 && (pl.rows != 1 || pl.threads != C * most))
        return cudaErrorInvalidValue;
    if (pl.cross != cross_mask(pl, order, logn)) return cudaErrorInvalidValue;
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
        const int m = n / C;
        if (order.operands < 1 || order.operands > 2 ||
            pl.row_stride < order.operands * (m + (m >> 5)))
            return cudaErrorInvalidValue;
        smem = static_cast<size_t>(pl.rows) * pl.row_stride * sizeof(uint32_t);
        if (smem > kMaxSmem) return cudaErrorInvalidValue;
    }
    const long long blocks = (batch + pl.rows - 1) / pl.rows * C;
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    const Mod m{q, r32, r32_sh, one_sh};
    if (C == 1) {
        kernel<<<dim3(static_cast<unsigned>(blocks)),
                 static_cast<unsigned>(threads), smem,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
            static_cast<uint32_t*>(out), static_cast<const uint32_t*>(tw),
            batch, n, logn, m, 2u * q, pl);
        return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(C);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const uint32_t*>(a),
        static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out),
        static_cast<const uint32_t*>(tw), batch, n, logn, m, 2u * q, pl);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // namespace qt
