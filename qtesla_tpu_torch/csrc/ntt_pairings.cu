// The five reference pipeline pairings as fused kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _pairing_kernel of
// qtesla_tpu/ops/ntt_pairings_pallas.py (l.160, polymul_pairing_fn l.276),
// one launcher per pairing:
//   qt_polymul_pairing_gs_ct     DIF forward, DIT inverse
//   qt_polymul_pairing_ct_ct     DIT forward, DIT inverse
//   qt_polymul_pairing_gs_gs     DIF forward, DIF inverse
//   qt_polymul_pairing_ct_gs     DIT forward, DIF inverse
//   qt_polymul_pairing_stockham  Stockham forward and inverse
//
// What they compute: z = x * y mod (X^n + 1) mod q through explicit psi
// weighting and cyclic transforms.  Weight both operands by phi[i] = psi^i;
// run the forward scheme on each (DIF: nat -> rev; DIT: bit-reverse, then
// rev -> nat; Stockham: nat -> nat); take the pointwise product; bit-reverse
// when the forward's output order is not the inverse's input order; run the
// inverse scheme with omega^{-1} (a DIF inverse bit-reverses its output);
// weight by phi^{-1} n^{-1}.  A cyclic stage of half-width h uses
// omega^{(j mod h) n / 2h}; Stockham stage st uses
// omega^{((j mod n/2) >> st) << st}.  Outputs are canonical in [0, q).
// Every kernel reads the compact (8, n) table (ops/tables.py
// pairing_packed), which stores the cyclic stage of half-width h at entries
// [h, 2h), so neighbouring butterflies read neighbouring entries.
//
// The four cyclic pairings (pass_kernel<FWD, INV, R, P>): register passes.
// A row of n = 2^L values is held by T = n / R threads, R values of each
// operand a thread.  In a pass, thread vt holds the R indices that differ
// only in the bits of a window [b, b + r), r = log2(R): register c holds
// index (vt mod 2^b) | c << b | (vt >> b) << (b + r), so every butterfly of
// the pass's stages (half-widths 2^k, k in the window) pairs two registers
// of one thread, and a pass runs up to r dependent stages with no memory
// traffic.  Between passes the values go once through shared memory (one
// store and one load each, index i at i + i/32, so strides of 32 words do
// not share a bank) into the next window: P - 1 exchanges a transform, P =
// ceil(L / r).  The plan (ops/ntt_pairings.py pairing_pass_plan) gives R,
// T, the rows of a block, each pass's stages and window; the launcher
// refuses a plan its kernels cannot run.  The ends are fused into passes:
// the psi weighting into the first load, the phi^{-1} n^{-1} weighting into
// the last store, the pointwise product between the forward's last pass
// and the inverse's first, which share one window, so the product needs no
// exchange.  A bit reversal moves no value: it renames (vt, b, c) to
// (brev(vt), L - r - b, brev(c)), so it costs nothing wherever it falls.
// At n = 1024 (R = 32, one warp a row, 8 rows a block) that is two passes
// a transform, one exchange in the forward and one in the inverse, each
// behind __syncwarp() alone: no block-wide barrier (a thread block a row
// with a barrier a stage, as Stockham has, takes 22 to 24).  Rows of more than 32 threads (n >= 2048) take
// __syncthreads() at each exchange.  Twiddles: a pass reads 2^t entries
// (and their Shoup companions) for its stage on window bit t, by __ldg,
// once for both operands.  n = 1024 (qtesla-iii-speed, -p-i) has kernels
// built for its length (LOGN), whose windows and stages are compile-time
// constants, so every index offset of a thread is an immediate of its load
// or store.
//
// Stockham (pairing_kernel<kStk, kStk>): one thread block per row, min(n/2, 512) threads, both operand rows and their
// ping-pong rows in shared memory (128 KB at n = 8192, above 48 KB by the
// opt-in attribute), __syncthreads() between stages.
//
// What bounds them on the H100: instruction issue, not device memory, which
// sees one read of each operand and one write of z.  A register butterfly is
// 7 instructions (3 of them IMADs); the passes add the exchanges and the
// twiddle loads.
//
// Arithmetic.  q < 2^30.  DIF and Stockham stages keep values in [0, 2q),
// DIT stages take and give values below 4q; the pointwise product is exact
// for any uint32 and canonical; the final Shoup weighting takes any uint32.
//
// The cyclic launchers are extern "C" with the signature of ntt_fused.cu's
// (raw pointers, batch B, n, log2(n), the set's constants) plus a pointer to
// the pass plan, then a stream; Stockham's has no plan.  They launch without
// synchronising and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"

namespace {

using qt::csub;
using qt::Mod;
using qt::mulmod_barrett;
using qt::shoup_lazy;

enum Scheme { kDif, kDit, kStk };

// The (8, n) table, rows: forward stage twiddles (entry h + j of the stage
// of half-width h), their Shoup companions, the inverse stage twiddles, their
// Shoup companions, phi, its Shoup, phi^{-1} n^{-1}, its Shoup.
struct Twiddles {
    const uint32_t *w, *w_sh, *iw, *iw_sh, *phi, *phi_sh, *iphi, *iphi_sh;
};

__device__ __forceinline__ Twiddles twiddles(const uint32_t* tw, int n) {
    return {tw,         tw + n,     tw + 2 * n, tw + 3 * n,
            tw + 4 * n, tw + 5 * n, tw + 6 * n, tw + 7 * n};
}

// ---------------------------------------------------------------------------
// Register passes: gs_ct, ct_ct, gs_gs, ct_gs.
// ---------------------------------------------------------------------------

constexpr int kMaxPasses = 3;
constexpr int kMaxSmem = 232448;

// Mirrors ops/ntt_pairings.py PairingPassPlan.  Pass p of the forward runs
// the stages of half-width 2^k, k in [fwd_lo[p], fwd_hi[p]), in the window
// [fwd_b[p], fwd_b[p] + r); the inverse's likewise.  row_stride: words of
// shared memory a row (both operands, padded); 0 when P = 1.
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

// The two-pass schedule pairing_pass_plan makes (the larger half first):
// pass p's stages [lo, hi) and window, for the kernels built for one length.
__host__ __device__ constexpr int two_pass_lo(bool ct, int p, int L) {
    return ct ? (p ? (L + 1) / 2 : 0) : (p ? 0 : L - (L + 1) / 2);
}
__host__ __device__ constexpr int two_pass_hi(bool ct, int p, int L) {
    return ct ? (p ? L : (L + 1) / 2) : (p ? L - (L + 1) / 2 : L);
}
__host__ __device__ constexpr int two_pass_b(bool ct, int p, int L, int r) {
    return two_pass_lo(ct, p, L) < L - r ? two_pass_lo(ct, p, L) : L - r;
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

// The stages of half-width 2^k, k in [lo, hi), on the window [b, b + r) of
// virtual thread vt: GS butterflies from the widest down (DIF, [0, 2q) in
// and out) or CT butterflies from the narrowest up (DIT, below 4q).  The
// stage on window bit t pairs registers c and c + 2^t and reads the 2^t
// twiddles w[2^k + (vt mod 2^b) + (c mod 2^t) 2^b].  q2 = 2q comes as a
// kernel parameter: an add reads it from the constant bank, where a 2q
// made in the kernel costs most butterflies an instruction of its own.
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
                    if (CT) {
                        const uint32_t u = lower(v[o][c], q2);          // < 2q
                        const uint32_t h = shoup_lazy(v[o][c + m], tw, tw_sh,
                                                      q);               // < 2q
                        v[o][c] = u + h;
                        v[o][c + m] = u + q2 - h;
                    } else {
                        const uint32_t u = v[o][c], d = v[o][c + m];
                        v[o][c] = lower(u + d, q2);
                        v[o][c + m] = shoup_lazy(u + q2 - d, tw, tw_sh, q);
                    }
                }
            }
        }
    }
}

// From the window [b, b + r) of virtual thread vt to the window [b2, b2 + r)
// of thread t, through the row's shared memory (operand o at o * stride).
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

// LOGN > 0: built for n = 2^LOGN in two passes, the planner's schedule
// known at compile time, so every index offset of a thread is a constant.
// Two passes: 128 registers at most, so 16 warps (16 rows at n = 1024) fit
// an SM.
template <int FWD, int INV, int R, int P, int LOGN>
__global__ void __launch_bounds__(P == 3 ? 512 : 256, P == 2 ? 2 : 1)
    pass_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                uint32_t* __restrict__ z, const uint32_t* __restrict__ tw,
                long long batch, int n_arg, int logn_arg, Mod m, uint32_t q2,
                PassPlan pl) {
    static_assert(LOGN == 0 || P == 2, "one length: two passes");
    constexpr int r = ilog2(R);
    constexpr bool kConst = LOGN > 0;
    extern __shared__ uint32_t smem[];
    const int logn = kConst ? LOGN : logn_arg;
    const int n = kConst ? 1 << LOGN : n_arg;
    const int tb = logn - r;  // thread bits: T = 2^tb threads a row
    const int t = threadIdx.x & ((1 << tb) - 1);
    const int slot = threadIdx.x >> tb;
    const long long row = static_cast<long long>(blockIdx.x) * pl.rows + slot;
    // a row past the batch computes on row 0 and stores nothing: its
    // threads still meet every barrier
    const bool live = row < batch;
    const size_t off = live ? static_cast<size_t>(row) * n : 0;
    const bool warp_rows = tb <= 5;
    uint32_t* buf = smem + slot * pl.row_stride;
    const int stride = n + (n >> 5);
    const Twiddles w = twiddles(tw, n);
    const uint32_t q = m.q;

    // psi weighting on the way in, [0, 2q); the window [tb, L) reads
    // neighbouring columns with neighbouring threads
    // pass p's stages and window: the plan's, or the planner's two-pass
    // schedule for the length the kernel was built for
    const auto lo = [](bool ct, int planned, int p) {
        return kConst ? two_pass_lo(ct, p, LOGN) : planned;
    };
    const auto hi = [](bool ct, int planned, int p) {
        return kConst ? two_pass_hi(ct, p, LOGN) : planned;
    };
    const auto win = [](bool ct, int planned, int p) {
        return kConst ? two_pass_b(ct, p, LOGN, r) : planned;
    };

    uint32_t v[2][R];
    int b = tb, vt = t;
    {
        const int base = window_base(vt, b, r);
#pragma unroll
        for (int c = 0; c < R; ++c) {
            const int i = base + (c << b);
            const uint32_t p = __ldg(w.phi + i), p_sh = __ldg(w.phi_sh + i);
            v[0][c] = shoup_lazy(x[off + i], p, p_sh, q);
            v[1][c] = shoup_lazy(y[off + i], p, p_sh, q);
        }
    }
    if (FWD == kDit) bit_reverse<R, 2>(v, b, vt, tb);
    constexpr bool kFwdCt = FWD == kDit, kInvCt = INV == kDit;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        if (p > 0) {
            const int b2 = win(kFwdCt, pl.fwd_b[p], p);
            exchange<kConst, R, 2>(v, buf, stride, b, vt, b2, t, warp_rows);
            b = b2;
            vt = t;
        }
        pass_stages<kFwdCt, R, 2>(v, b, vt, lo(kFwdCt, pl.fwd_lo[p], p),
                                  hi(kFwdCt, pl.fwd_hi[p], p), w.w, w.w_sh, q,
                                  q2);
    }

    uint32_t u[1][R];
#pragma unroll
    for (int c = 0; c < R; ++c) u[0][c] = mulmod_barrett(v[0][c], v[1][c], m);
    // a DIF forward gives rev order, a DIT inverse takes it
    if ((FWD == kDif) != (INV == kDit)) bit_reverse<R, 1>(u, b, vt, tb);
#pragma unroll
    for (int p = 0; p < P; ++p) {
        if (p > 0) {
            const int b2 = win(kInvCt, pl.inv_b[p], p);
            exchange<kConst, R, 1>(u, buf, stride, b, vt, b2, t, warp_rows);
            b = b2;
            vt = t;
        }
        pass_stages<kInvCt, R, 1>(u, b, vt, lo(kInvCt, pl.inv_lo[p], p),
                                  hi(kInvCt, pl.inv_hi[p], p), w.iw, w.iw_sh, q,
                                  q2);
    }
    if (INV == kDif) bit_reverse<R, 1>(u, b, vt, tb);

    // phi^{-1} n^{-1} on the way out, canonical
    if (live) {
        const int base = window_base(vt, b, r);
#pragma unroll
        for (int c = 0; c < R; ++c) {
            const int i = base + (c << b);
            z[off + i] = csub(shoup_lazy(u[0][c], __ldg(w.iphi + i),
                                         __ldg(w.iphi_sh + i), q),
                              q);
        }
    }
}

using PassKernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*,
                            const uint32_t*, long long, int, int, Mod,
                            uint32_t, PassPlan);

// The instantiations: R = n for n <= 32 (one pass a transform), R = 32 with
// two passes (n <= 1024) or three (n <= 16384, as the block's threads
// allow), and R = 32 in two passes built for n = 1024 (qtesla-iii-speed,
// qtesla-p-i), whose one schedule the launcher's checks leave is the one
// two_pass_* restate.
template <int FWD, int INV>
PassKernel pass_kernel_for(int radix, int passes, int logn) {
    if (radix == 32 && passes == 2 && logn == 10)
        return pass_kernel<FWD, INV, 32, 2, 10>;
    switch (radix * 4 + passes) {
        case 2 * 4 + 1: return pass_kernel<FWD, INV, 2, 1, 0>;
        case 4 * 4 + 1: return pass_kernel<FWD, INV, 4, 1, 0>;
        case 8 * 4 + 1: return pass_kernel<FWD, INV, 8, 1, 0>;
        case 16 * 4 + 1: return pass_kernel<FWD, INV, 16, 1, 0>;
        case 32 * 4 + 1: return pass_kernel<FWD, INV, 32, 1, 0>;
        case 32 * 4 + 2: return pass_kernel<FWD, INV, 32, 2, 0>;
        case 32 * 4 + 3: return pass_kernel<FWD, INV, 32, 3, 0>;
        default: return nullptr;
    }
}

// One transform's passes cover [0, logn) in its scheme's order (CT from
// the narrowest stage up, GS from the widest down), each pass inside its
// window.
bool schedule_ok(const int* lo, const int* hi, const int* b, int passes,
                 int logn, int r, bool ct) {
    int edge = ct ? 0 : logn;
    for (int p = 0; p < passes; ++p) {
        if (lo[p] >= hi[p] || b[p] < 0 || b[p] > logn - r || b[p] > lo[p] ||
            hi[p] > b[p] + r || (ct ? lo[p] : hi[p]) != edge)
            return false;
        edge = ct ? hi[p] : lo[p];
    }
    return edge == (ct ? logn : 0);
}

template <int FWD, int INV>
int launch_passes(const void* a, const void* b, void* out, const void* tw,
                  long long batch, int n, int logn, uint32_t q, uint32_t r32,
                  uint32_t r32_sh, uint32_t one_sh, const void* plan,
                  void* stream) {
    if (n < 2 || logn < 1 || n != 1 << logn || batch <= 0 || !plan)
        return cudaErrorInvalidValue;
    const PassPlan pl = *static_cast<const PassPlan*>(plan);
    const PassKernel kernel =
        pass_kernel_for<FWD, INV>(pl.radix, pl.passes, logn);
    if (!kernel || pl.radix > n) return cudaErrorInvalidValue;
    const int r = ilog2(pl.radix), tb = logn - r;
    const long long threads = static_cast<long long>(pl.rows) * pl.threads;
    if (pl.threads != 1 << tb || pl.rows < 1 ||
        threads > (pl.passes == 3 ? 512 : 256) || threads % 32 != 0)
        return cudaErrorInvalidValue;
    // the load leaves a row in the window [tb, L), reflected to [0, r) by a
    // DIT forward's bit reversal; the product keeps the forward's last
    // window, reflected when a bit reversal lies between the two
    const int last = pl.fwd_b[pl.passes - 1];
    const int inv_first = (FWD == kDif) != (INV == kDit) ? tb - last : last;
    if (!schedule_ok(pl.fwd_lo, pl.fwd_hi, pl.fwd_b, pl.passes, logn, r,
                     FWD == kDit) ||
        !schedule_ok(pl.inv_lo, pl.inv_hi, pl.inv_b, pl.passes, logn, r,
                     INV == kDit) ||
        pl.fwd_b[0] != (FWD == kDit ? 0 : tb) || pl.inv_b[0] != inv_first)
        return cudaErrorInvalidValue;
    size_t smem = 0;
    if (pl.passes > 1) {
        if (pl.row_stride < 2 * (n + (n >> 5))) return cudaErrorInvalidValue;
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

// ---------------------------------------------------------------------------
// Stockham: one thread block a row, stages through shared memory.
// ---------------------------------------------------------------------------

// Stockham stages, nat -> nat, [0, 2q) in and out, ping-ponging between the
// NOPS rows at src and those at dst; returns where the result lies.  Stage st
// pairs k and k + n/2 (k < n/2) under w[(k >> st) << st], w = omega^j for
// j < n/2, and writes the sum and difference to
// ((k >> st) << (st + 1)) + (k mod 2^st) and 2^st past it.
template <int NOPS>
__device__ uint32_t* stk_stages(uint32_t* src, uint32_t* dst,
                                const uint32_t* __restrict__ w,
                                const uint32_t* __restrict__ w_sh, int n,
                                int logn, uint32_t q) {
    const int half = n >> 1;
    const uint32_t q2 = 2u * q;
    for (int st = 0; st < logn; ++st) {
        const int lo = (1 << st) - 1;
        for (int k = threadIdx.x; k < half; k += blockDim.x) {
            const int ti = k & ~lo;
            const int out = (ti << 1) + (k & lo);
            const uint32_t t = __ldg(w + ti);
            const uint32_t t_sh = __ldg(w_sh + ti);
#pragma unroll
            for (int o = 0; o < NOPS; ++o) {
                const uint32_t u = src[o * n + k];
                const uint32_t v = src[o * n + k + half];
                dst[o * n + out] = csub(u + v, q2);
                dst[o * n + out + lo + 1] = shoup_lazy(u + q2 - v, t, t_sh, q);
            }
        }
        __syncthreads();
        uint32_t* tmp = src;
        src = dst;
        dst = tmp;
    }
    return src;
}

// The template arguments name the pairing (kStk, kStk).
template <int FWD, int INV>
__global__ void pairing_kernel(const uint32_t* __restrict__ x,
                               const uint32_t* __restrict__ y,
                               uint32_t* __restrict__ z,
                               const uint32_t* __restrict__ tw, int n,
                               int logn, Mod m) {
    static_assert(FWD == kStk && INV == kStk, "Stockham only");
    extern __shared__ uint32_t smem[];
    const size_t row = static_cast<size_t>(blockIdx.x) * n;
    const Twiddles t = twiddles(tw, n);
    const uint32_t q = m.q;

    // psi weighting on the way in: [0, 2q)
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const uint32_t p = __ldg(t.phi + k), p_sh = __ldg(t.phi_sh + k);
        smem[k] = shoup_lazy(x[row + k], p, p_sh, q);
        smem[n + k] = shoup_lazy(y[row + k], p, p_sh, q);
    }
    __syncthreads();
    // the widest cyclic stage, entries [n/2, n), holds omega^j, j < n/2
    uint32_t* v = stk_stages<2>(smem, smem + 2 * n, t.w + (n >> 1),
                                t.w_sh + (n >> 1), n, logn, q);

    for (int k = threadIdx.x; k < n; k += blockDim.x)
        v[k] = mulmod_barrett(v[k], v[n + k], m);
    __syncthreads();
    // y's row is free now: the inverse ping-pongs with it
    v = stk_stages<1>(v, v + n, t.iw + (n >> 1), t.iw_sh + (n >> 1), n, logn,
                      q);

    // phi^{-1} n^{-1} on the way out, canonical
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        z[row + k] = csub(
            shoup_lazy(v[k], __ldg(t.iphi + k), __ldg(t.iphi_sh + k), q), q);
}

int launch_stockham(const void* a, const void* b, void* out, const void* tw,
                    long long batch, int n, int logn, uint32_t q, uint32_t r32,
                    uint32_t r32_sh, uint32_t one_sh, void* stream) {
    if (n < 2 || logn < 1 || n != 1 << logn || batch <= 0 ||
        batch >= (1LL << 31))
        return cudaErrorInvalidValue;
    // both operand rows and their ping-pong rows
    const size_t smem = static_cast<size_t>(4) * n * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pairing_kernel<kStk, kStk>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    const int threads = n / 2 < 512 ? n / 2 : 512;
    const Mod m{q, r32, r32_sh, one_sh};
    pairing_kernel<kStk, kStk><<<dim3(static_cast<unsigned>(batch)), threads,
                                 smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), static_cast<const uint32_t*>(tw), n, logn,
        m);
    return cudaGetLastError();
}

}  // namespace

#define QT_PAIRING_LAUNCHER(name, fwd, inv)                                   \
    extern "C" int name(const void* a, const void* b, void* out,              \
                        const void* tw, long long batch, int n, int logn,     \
                        uint32_t q, uint32_t r32, uint32_t r32_sh,            \
                        uint32_t one_sh, const void* plan, void* stream) {    \
        return launch_passes<fwd, inv>(a, b, out, tw, batch, n, logn, q, r32, \
                                       r32_sh, one_sh, plan, stream);         \
    }

QT_PAIRING_LAUNCHER(qt_polymul_pairing_gs_ct, kDif, kDit)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_ct_ct, kDit, kDit)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_gs_gs, kDif, kDif)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_ct_gs, kDit, kDif)

extern "C" int qt_polymul_pairing_stockham(const void* a, const void* b,
                                           void* out, const void* tw,
                                           long long batch, int n, int logn,
                                           uint32_t q, uint32_t r32,
                                           uint32_t r32_sh, uint32_t one_sh,
                                           void* stream) {
    return launch_stockham(a, b, out, tw, batch, n, logn, q, r32, r32_sh,
                           one_sh, stream);
}
