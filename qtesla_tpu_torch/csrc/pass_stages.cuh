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
// row a cluster.  Every pass, twiddle read, load and store is the block
// form's on the row's thread t, whose virtual thread in a cluster is t
// (the own map), brev(t) (reflected) or its swapped map (the block bits
// reversed into the low bits; map_thread): the plan's refl and swap bits,
// the pairings', chosen by ops/passes.py thread_maps so that two
// exchanges cross blocks, the store reads neighbours and twiddle reads
// scatter least (Stockham's autosort map is the block form's alone).  An
// exchange whose block bits (thread bits tb - c .. tb - 1) hold the same
// index bits on both sides stays in the block (the plan's cross mask, see
// cross_mask): between own windows it is the block form's on the block's
// m = n / C indices.  Any other lays its buffer out for the threads of one
// side (layout_word: register c of the block's thread l at l + c 2^lb, or
// at 32 l + c, swizzled so that both sides meet distinct banks), the side
// and layout chosen (ops/passes.py exchange_layouts: the plan's pull and
// low bits) so that the side that reaches other blocks touches whole runs
// of distributed shared memory: a push stores each value once into the
// block of its reader at the reader's word (word_of, the register's part
// from the launcher's table, ExchangeWords) and the readers load their
// own block's; a pull stores in the writers' own blocks and the readers
// load from there (mapa, st / ld.shared::cluster).  A crossing push
// waits, before its stores, at a cluster barrier whose arrive followed the
// last read of every block's buffer (the pass between overlaps it), then
// at a whole one after them (barrier.cluster.arrive.release /
// wait.acquire); a pull's readers arrive after their loads, and the next
// exchange or the kernel's end waits.  The kernel stays one
// launch, through cudaLaunchKernelEx with a cluster dimension.  The
// earlier design (three whole cluster barriers a crossing exchange, each
// value stored into the block that holds its index and loaded back from
// there, Stockham under its autosort map and the DIF inverses storing
// from brev(t)) took 0.68-5.64 ms at n = 32768-131072, 128 MiB an
// operand, its crossing exchanges 0.23-4.67 ms of that and the DIF
// inverses' scattered stores 0.7-0.9 ms (PERF.md).
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
// The block form's kernels take this plan.
struct PassPlan {
    int radix, threads, rows, passes, row_stride, cluster, cross;
    int fwd_lo[kMaxPasses], fwd_hi[kMaxPasses], fwd_b[kMaxPasses];
    int inv_lo[kMaxPasses], inv_hi[kMaxPasses], inv_b[kMaxPasses];
};

// The plan the launchers take (ops/passes.py PassPlan): refl, swap: bit e
// set when after the e-th exchange thread t holds the reflected or the
// swapped map (map_thread; a pairing's cluster plan, 0 otherwise); pull,
// low: how a cluster's exchange that does not stay between own windows in
// a block lays out its buffer (push_exchange, pull_exchange; 0 in a block
// plan).
struct PlanArg : PassPlan {
    int refl, pull, low, swap;
};

// a cluster's virtual thread maps: t, brev(t), or the swapped map
constexpr int kOwn = 0, kRefl = 1, kSwap = 2;

// the most exchanges a kernel runs: 2 (P - 1) with both transforms
constexpr int kMaxExchanges = 2 * (kMaxPasses - 1);

// A cluster kernel's buffer words, made by the launcher from its plan
// (cluster_plan): reach[e][c] the block << 20 | word of register c's
// window bits of exchange e's side that reaches the other's layout (a
// push: the writers' registers into the readers' layout; a pull: the
// readers' into the writers'), own[low][c] the word of a block's thread
// 0's register c in its own side's layout (layout_word); a thread's word
// is its register 0's xor these.
struct ExchangeWords {
    int reach[kMaxExchanges][32];
    int own[2][32];
};

// The cluster form's kernels take this plan: the launchers' plus, made by
// the launcher, the map each exchange's writers hold and the words.
struct ClusterPlan : PlanArg {
    int from_map[kMaxExchanges];
    ExchangeWords xw;
};

template <bool kCluster>
struct PlanOf {
    using type = PassPlan;
};
template <>
struct PlanOf<true> {
    using type = ClusterPlan;
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

// The cluster barrier, split: arrive (releasing this thread's shared
// memory accesses so far) and wait (acquiring every arrived thread's).
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__host__ __device__ __forceinline__ int brev_fast(int v, int bits) {
#ifdef __CUDA_ARCH__
    return bits == 0 ? 0
                     : static_cast<int>(__brev(static_cast<unsigned>(v)) >>
                                        (32 - bits));
#else
    int out = 0;
    for (int k = 0; k < bits; ++k) out |= ((v >> k) & 1) << (bits - 1 - k);
    return out;
#endif
}

// Thread t's virtual thread in a cluster's row of 2^tb threads over 2^c
// blocks (lb = tb - c thread bits a block) under map m: t (own), brev(t)
// (reflected), or the swapped map, the block bits reversed into the
// lowest c bits below the block's own thread bits: ((t mod 2^lb) << c) |
// brev_c(t >> lb).  ops/passes.py map_thread.
__device__ __forceinline__ int map_thread(int t, int m, int tb, int lb) {
    if (m == kRefl) return brev_fast(t, tb);
    if (m == kSwap)
        return ((t & ((1 << lb) - 1)) << (tb - lb)) |
               brev_fast(t >> lb, tb - lb);
    return t;
}

// An exchange's buffer word a with its low five bits xored with every
// five bits above them (ops/passes.py swizzle): 32 lanes whose bits of a
// fall on five bit positions distinct mod 5 meet 32 banks.
__host__ __device__ __forceinline__ int swizzle(int a) {
    return a ^ ((a >> 5) & 31) ^ ((a >> 10) & 31) ^ ((a >> 15) & 31);
}

// The word of register reg of the block's thread l in the buffer of an
// exchange laid out for its side: l + reg 2^lb, or (low) 32 l + reg,
// swizzled (ops/passes.py layout_word).
__host__ __device__ __forceinline__ int layout_word(int l, int reg, int lb,
                                                    bool low) {
    return swizzle(low ? (l << 5) | reg : l | (reg << lb));
}

// Where index i lies in an exchange's buffer laid out for the side whose
// threads hold the window [b, b + r) under map m: the holder's block <<
// 20 | its word (layout_word).  Each step maps bits of i to bits and the
// swizzle xors them, so the result of an index is the xor of its bits'.
__host__ __device__ __forceinline__ int word_of(int i, int b, int m, int tb,
                                                int lb, int r, bool low) {
    const int vt = (i & ((1 << b) - 1)) | ((i >> (b + r)) << b);
    const int reg = (i >> b) & ((1 << r) - 1);
    int t = vt;
    if (m == kRefl) {
        t = brev_fast(vt, tb);
    } else if (m == kSwap) {
        const int c = tb - lb;
        t = (brev_fast(vt & ((1 << c) - 1), c) << lb) | (vt >> c);
    }
    return ((t >> lb) << 20) | layout_word(t & ((1 << lb) - 1), reg, lb, low);
}

// From the window [b, b + r) of virtual thread vt to the window [b2, b2 +
// r) of a cluster's row under map m2, laid out for the readers: each value
// stored once into the block of its reader at the reader's word
// (word_of, its register's part from the launcher's table; through
// distributed shared memory where the exchange crosses blocks), then,
// behind the cluster barrier or the block's, each thread loads its
// registers from its own block.
template <int R, int NOPS>
__device__ __forceinline__ void push_exchange(uint32_t (&v)[NOPS][R],
                                              uint32_t* buf, int stride,
                                              int b, int vt, int b2, int m2,
                                              bool cross, bool low, int tb,
                                              int lb, const ExchangeWords& xw,
                                              int e) {
    constexpr int r = ilog2(R);
    const int at0 = word_of(window_base(vt, b, r), b2, m2, tb, lb, r, low);
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(buf));
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int at = at0 ^ xw.reach[e][c];
        const int word = at & ((1 << 20) - 1);
        if (cross) {
            uint32_t ra;
            asm("mapa.shared::cluster.u32 %0, %1, %2;"
                : "=r"(ra)
                : "r"(base + 4u * static_cast<uint32_t>(word)),
                  "r"(at >> 20));
#pragma unroll
            for (int o = 0; o < NOPS; ++o)
                asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(
                                 ra + 4u * static_cast<uint32_t>(o * stride)),
                             "r"(v[o][c])
                             : "memory");
        } else {
#pragma unroll
            for (int o = 0; o < NOPS; ++o) buf[o * stride + word] = v[o][c];
        }
    }
    if (cross) {
        cluster_arrive();
        cluster_wait();
    } else {
        __syncthreads();
    }
    const int w0 = layout_word(static_cast<int>(threadIdx.x), 0, lb, low);
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int w = w0 ^ (low ? xw.own[1][c] : xw.own[0][c]);
#pragma unroll
        for (int o = 0; o < NOPS; ++o) v[o][c] = buf[o * stride + w];
    }
}

// The same exchange laid out for the writers, across the cluster's blocks:
// each thread stores its registers in its own block at its own words,
// then, behind the cluster barrier, each reader loads its values from the
// blocks of their writers (the window [b, b + r) under map m, word_of).
template <int R, int NOPS>
__device__ __forceinline__ void pull_exchange(uint32_t (&v)[NOPS][R],
                                              uint32_t* buf, int stride,
                                              int b, int m, int b2, int vt2,
                                              bool low, int tb, int lb,
                                              const ExchangeWords& xw,
                                              int e) {
    constexpr int r = ilog2(R);
    const int w0 = layout_word(static_cast<int>(threadIdx.x), 0, lb, low);
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int w = w0 ^ (low ? xw.own[1][c] : xw.own[0][c]);
#pragma unroll
        for (int o = 0; o < NOPS; ++o) buf[o * stride + w] = v[o][c];
    }
    cluster_arrive();
    cluster_wait();
    const int at0 = word_of(window_base(vt2, b2, r), b, m, tb, lb, r, low);
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(buf));
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int at = at0 ^ xw.reach[e][c];
        uint32_t ra;
        asm("mapa.shared::cluster.u32 %0, %1, %2;"
            : "=r"(ra)
            : "r"(base + 4u * static_cast<uint32_t>(at & ((1 << 20) - 1))),
              "r"(at >> 20));
#pragma unroll
        for (int o = 0; o < NOPS; ++o)
            asm volatile("ld.shared::cluster.u32 %0, [%1];"
                         : "=r"(v[o][c])
                         : "r"(ra + 4u * static_cast<uint32_t>(o * stride))
                         : "memory");
    }
}

// The row's thread and its place in a block: kCluster false, rows of T =
// 2^tb threads side by side in a block (slot the row's place); true, one
// row a cluster, thread t of the row the thread of its block's rank
// (lbits: log2 of the indices a block holds, m).  A cluster's row arrives
// at the barrier its first exchange waits on when that one pushes across
// blocks.
template <bool kCluster>
struct RowPlace {
    int t, slot, rank, lbits;
    long long row;
    template <typename Plan>
    __device__ __forceinline__ RowPlace(const Plan& pl, int tb, int logn) {
        if constexpr (kCluster) {
            rank = static_cast<int>(
                cooperative_groups::this_cluster().block_rank());
            t = (rank << (tb - (31 - __clz(pl.cluster)))) + threadIdx.x;
            slot = 0;
            row = blockIdx.x / pl.cluster;
            lbits = logn - (31 - __clz(pl.cluster));
            if ((pl.cross & ~pl.pull) & 1) cluster_arrive();
        } else {
            t = threadIdx.x & ((1 << tb) - 1);
            slot = threadIdx.x >> tb;
            rank = 0;
            row = static_cast<long long>(blockIdx.x) * pl.rows + slot;
            lbits = logn;
        }
    }
};

// The map exchange e of a cluster's plan hands thread t.
__device__ __forceinline__ int exchange_map(const ClusterPlan& pl, int e) {
    return (pl.refl >> e) & 1 ? kRefl : (pl.swap >> e) & 1 ? kSwap : kOwn;
}

// The virtual thread that thread t of a row takes at exchange e: in a
// cluster the plan's map of t (tb = log2 of the row's threads), in a
// block the kernel's own choice, `block`.
template <bool kCluster, typename Plan>
__device__ __forceinline__ int cluster_thread(const Plan& pl, int e, int t,
                                              int block) {
    if constexpr (kCluster) {
        const int tb = 31 - __clz(pl.threads);
        return map_thread(t, exchange_map(pl, e), tb,
                          tb - (31 - __clz(pl.cluster)));
    } else {
        return block;
    }
}

// Exchange e of a kernel, from the window [b, b + r) of virtual thread vt
// to [b2, b2 + r) of virtual thread t: the block form's exchange; in a
// cluster (lbits: log2 of a block's indices) the block form's on the
// block's own indices where it stays in the block and goes to the own map
// (thread t of the row is thread threadIdx.x of the block's m indices:
// both windows keep the block's bits on top), else push_exchange
// (pull_exchange where the plan pulls it) into the map of plan bit e,
// across the blocks where cross bit e is set.  The cluster barrier a push
// across blocks waits on before its stores follows the last reads of
// every block's buffer before it (or the kernel's start), as does the one
// after a pull, which the next exchange, or the kernel's end
// (cluster_drain), waits on before anyone stores into the buffer or exits.
template <bool kCluster, bool kConst, int R, int NOPS, typename Plan>
__device__ __forceinline__ void row_exchange(uint32_t (&v)[NOPS][R],
                                             uint32_t* buf, int stride,
                                             int b, int vt, int b2, int t,
                                             bool warp_rows, const Plan& pl,
                                             int e, int lbits) {
    if constexpr (kCluster) {
        const int lb = lbits - ilog2(R);
        const int tb = lb + (31 - __clz(pl.cluster));
        const bool cross = (pl.cross >> e) & 1, pull = (pl.pull >> e) & 1;
        const bool low = (pl.low >> e) & 1;
        const int m2 = exchange_map(pl, e);
        if ((cross && !pull) || (e > 0 && ((pl.pull >> (e - 1)) & 1)))
            cluster_wait();
        if (!cross && m2 == kOwn)
            exchange<false, R, NOPS>(v, buf, stride, b, threadIdx.x, b2,
                                     threadIdx.x, false);
        else if (pull)
            pull_exchange<R, NOPS>(v, buf, stride, b, pl.from_map[e], b2, t,
                                   low, tb, lb, pl.xw, e);
        else
            push_exchange<R, NOPS>(v, buf, stride, b, vt, b2, m2, cross, low,
                                   tb, lb, pl.xw, e);
        if ((((pl.cross & ~pl.pull) >> (e + 1)) & 1) || pull)
            cluster_arrive();
        else if (cross || m2 != kOwn)
            __syncthreads();
    } else {
        exchange<kConst, R, NOPS>(v, buf, stride, b, vt, b2, t, warp_rows);
    }
}

// A cluster's row after its last exchange e: where that one pulled, other
// blocks may still read this block's buffer; wait for them before exit.
template <bool kCluster, typename Plan>
__device__ __forceinline__ void cluster_drain(const Plan& pl, int e) {
    if constexpr (kCluster)
        if ((pl.pull >> e) & 1) cluster_wait();
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
using ClusterKernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*,
                               const uint32_t*, long long, int, int, Mod,
                               uint32_t, ClusterPlan);
// a plan's kernel: the block form's or the cluster form's (null: none)
struct PassKernels {
    PassKernel block = nullptr;
    ClusterKernel cluster = nullptr;
};

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
    // the kernel takes the plan's reflected maps (the pairings')
    bool maps = false;
};

// The fields of one transform's passes all 0: a plan with no such passes.
inline bool no_passes(const int* lo, const int* hi, const int* b) {
    for (int p = 0; p < kMaxPasses; ++p)
        if (lo[p] || hi[p] || b[p]) return false;
    return true;
}

// The virtual thread bit that thread bit j lands on under map m.
inline int vbit(int j, int m, int tb, int c) {
    if (m == kOwn) return j;
    if (m == kRefl || j >= tb - c) return tb - 1 - j;
    return j + c;
}

// The index bits thread bits tb - c .. tb - 1 (a cluster's block) hold on
// the window [b, b + r) under map m, five bits each.
inline long long block_bits(int b, int m, int tb, int r, int c) {
    long long out = 0;
    for (int j = tb - c; j < tb; ++j) {
        const int v = vbit(j, m, tb, c);
        out = out << 5 | (v < b ? v : v + r);
    }
    return out;
}

// The exchanges of a kernel of this order (B3's first one into [0, r),
// the forward's between passes, B2's last one back to [tb, L), the
// inverse's) under the plan's maps: f(e, b, m, b2, m2) for each, from the
// window [b, b + r) under map m to [b2, b2 + r) under m2 (the load leaves
// the own map on [tb, L), a bit reversal renames (b, own) to (tb - b,
// reflected) and back, exchange e takes the map of the plan's refl and
// swap bits e); the count, or -1 for two maps on one exchange or a bit
// reversal of the swapped map.  ops/passes.py _walk.
template <typename F>
inline int walk_exchanges(const PlanArg& pl, PassOrder order, int logn,
                          F f) {
    const int tb = logn - ilog2(pl.radix);
    int e = 0, b = tb, m = kOwn;
    bool ok = (pl.refl & pl.swap) == 0;
    const auto exchange_to = [&](int b2) {
        const int m2 = (pl.refl >> e) & 1 ? kRefl
                       : (pl.swap >> e) & 1 ? kSwap
                                             : kOwn;
        f(e, b, m, b2, m2);
        ++e;
        b = b2;
        m = m2;
    };
    const auto reverse = [&]() {
        if (m == kSwap) ok = false;
        b = tb - b;
        m = m == kOwn ? kRefl : kOwn;
    };
    if (order.forward) {
        if (order.fwd_up) reverse();
        for (int p = 1; p < pl.passes; ++p) exchange_to(pl.fwd_b[p]);
        if (!order.inverse)
            exchange_to(tb);
        else if (order.reflect)
            reverse();
    } else {
        exchange_to(0);
    }
    if (order.inverse) {
        for (int p = 1; p < pl.passes; ++p) exchange_to(pl.inv_b[p]);
        if (!order.inv_up) reverse();
    }
    return ok ? e : -1;
}

// Bit e set: exchange e (walk_exchanges) goes between the blocks of the
// plan's cluster, the block bits holding other index bits after it than
// before (block_bits); 0 for a plan of one block a row; -1 for what
// walk_exchanges refuses, maps or layout bits past the kernel's
// exchanges, an exchange that stays in its block but goes to the own map
// from another, or a pull that does not cross.  ops/passes.py cross_mask
// makes the same bits.
inline int cross_mask(const PlanArg& pl, PassOrder order, int logn) {
    if (pl.cluster == 1) return 0;
    const int r = ilog2(pl.radix), tb = logn - r, c = ilog2(pl.cluster);
    int mask = 0;
    bool ok = true;
    const int count = walk_exchanges(
        pl, order, logn, [&](int e, int b, int m, int b2, int m2) {
            if (block_bits(b, m, tb, r, c) != block_bits(b2, m2, tb, r, c))
                mask |= 1 << e;
            else if (m2 == kOwn && m != kOwn)
                ok = false;
        });
    const int bits = pl.refl | pl.swap | pl.pull | pl.low;
    return ok && count >= 0 && (bits >> count) == 0 && (pl.pull & ~mask) == 0
               ? mask
               : -1;
}

// The cluster kernels' plan of a launchers' plan: the map each
// exchange's writers hold, and the words (ExchangeWords): for each
// exchange that does not stay in a block between own maps, the reaching
// side's register parts (word_of of the register's window bits alone),
// and each layout's own words.
inline ClusterPlan cluster_plan(const PlanArg& pl, PassOrder order,
                                int logn) {
    ClusterPlan cp = {};
    static_cast<PlanArg&>(cp) = pl;
    const int r = ilog2(pl.radix), tb = logn - r;
    const int lb = tb - ilog2(pl.cluster);
    for (int low = 0; low < 2; ++low)
        for (int c = 0; c < pl.radix; ++c)
            cp.xw.own[low][c] = layout_word(0, c, lb, low);
    walk_exchanges(pl, order, logn, [&](int e, int b, int m, int b2, int m2) {
        const bool pull = (pl.pull >> e) & 1, low = (pl.low >> e) & 1;
        cp.from_map[e] = m;
        for (int c = 0; c < pl.radix; ++c)
            cp.xw.reach[e][c] = pull ? word_of(c << b2, b, m, tb, lb, r, low)
                                     : word_of(c << b, b2, m2, tb, lb, r, low);
    });
    return cp;
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
inline int launch_pass_kernel(PassKernels kernels, const PlanArg& pl,
                              PassOrder order, const void* a, const void* b,
                              void* out, const void* tw, long long batch,
                              int n, int logn, uint32_t q, uint32_t r32,
                              uint32_t r32_sh, uint32_t one_sh, void* stream) {
    const int C = pl.cluster;
    if (n < 2 || logn < 1 || logn > 30 || n != 1 << logn || batch <= 0 ||
        !(C > 1 ? kernels.cluster != nullptr : kernels.block != nullptr) ||
        pl.radix > n || pl.radix < 2 || pl.passes < 1 ||
        pl.passes > kMaxPasses || !(order.forward || order.inverse))
        return cudaErrorInvalidValue;
    const int r = ilog2(pl.radix), tb = logn - r;
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
    // maps only in a cluster, for a kernel that takes them; layouts only in
    // a cluster
    if ((pl.refl | pl.swap) != 0 && (C == 1 || !order.maps))
        return cudaErrorInvalidValue;
    if ((pl.pull | pl.low) != 0 && C == 1) return cudaErrorInvalidValue;
    if (pl.cross < 0 || pl.cross != cross_mask(pl, order, logn))
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
        const cudaError_t e =
            C == 1 ? cudaFuncSetAttribute(
                         kernels.block,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem))
                   : cudaFuncSetAttribute(
                         kernels.cluster,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    const Mod m{q, r32, r32_sh, one_sh};
    if (C == 1) {
        kernels.block<<<dim3(static_cast<unsigned>(blocks)),
                        static_cast<unsigned>(threads), smem,
                        static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
            static_cast<uint32_t*>(out), static_cast<const uint32_t*>(tw),
            batch, n, logn, m, 2u * q, static_cast<const PassPlan&>(pl));
        return cudaGetLastError();
    }
    const ClusterPlan cp = cluster_plan(pl, order, logn);
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
        &cfg, kernels.cluster, static_cast<const uint32_t*>(a),
        static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out),
        static_cast<const uint32_t*>(tw), batch, n, logn, m, 2u * q, cp);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // namespace qt
