// The five reference pipeline pairings as fused kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _pairing_kernel of
// qtesla_tpu/ops/ntt_pairings_pallas.py (l.160, polymul_pairing_fn l.276),
// one instantiation and launcher per pairing:
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
//
// Design.  As qt_polymul_fused (ntt_fused.cu): one thread block per row,
// min(n/2, 512) threads, both operand rows in shared memory for the whole
// pipeline, __syncthreads() between stages, one device-memory read of each
// operand and one write of z.  The pairing is a template parameter.  The
// TPU kernel's lane rolls, bit-swap rounds and full-width (L, n) tables are
// gone: a thread indexes its butterfly pair and reads its twiddle from the
// compact (8, n) table (ops/tables.py pairing_packed), which stores the
// stage of half-width h at entries [h, 2h), so the lanes of a warp read
// neighbouring entries (the stride-2^s reads of one omega^j row cost up to
// 16 L1 wavefronts a load); a bit reversal is an in-place swap of a[i] and
// a[brev(i)] by the thread that holds the smaller index, its indices
// swizzled so that a warp's 32 i and 32 brev(i) each fall in 32 banks (in
// index order every brev(i) of a warp shares one bank); Stockham's
// interleaving output is written to a second (ping-pong) row per operand,
// so it holds 4 rows instead of 2 (128 KB at n = 8192, above 48 KB by the
// opt-in attribute).
//
// What bounds it on the H100: as B1, instruction issue and the barriers
// between the 3 log2(n) dependent stages (plus up to 3 bit reversals), not
// device memory.  A first design: no register-resident radix-4 stages.
//
// Arithmetic.  q < 2^30.  DIF and Stockham stages keep values in [0, 2q),
// DIT stages take and give values below 4q; the pointwise product is exact
// for any uint32 and canonical; the final Shoup weighting takes any uint32.
//
// Each launcher is extern "C" with the signature of ntt_fused.cu's (raw
// pointers, batch B, n, log2(n), the set's constants, a stream), launches
// without synchronising and returns cudaGetLastError().

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

// a[i] <- a[bitrev(i)] on NOPS rows of n, in place.  From n = 1024 on, work
// item t = 32 rest + lane takes i = lane 2^(logn-5) + (rest >> 5) 32 +
// ((lane + rest) mod 32): a bijection whose i mod 32 and brev(i) mod 32
// (= brev5(lane)) differ across a warp's lanes.
template <int NOPS>
__device__ void bitrev(uint32_t* a, int n, int logn) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int lane = t & 31, rest = t >> 5;
        const int i = logn < 10 ? t
                                : (lane << (logn - 5)) | ((rest >> 5) << 5) |
                                      ((lane + rest) & 31);
        const int r = static_cast<int>(__brev(static_cast<unsigned>(i)) >>
                                       (32 - logn));
        if (i < r) {
#pragma unroll
            for (int o = 0; o < NOPS; ++o) {
                const uint32_t t = a[o * n + i];
                a[o * n + i] = a[o * n + r];
                a[o * n + r] = t;
            }
        }
    }
    __syncthreads();
}

// Cyclic DIF (GS butterfly) stages, nat -> rev, [0, 2q) in and out.  Stage
// s has half-width h = n >> (s + 1); position j of a block uses w[h + j].
template <int NOPS>
__device__ void dif_stages(uint32_t* a, const uint32_t* __restrict__ w,
                           const uint32_t* __restrict__ w_sh, int n, int logn,
                           uint32_t q) {
    const int half = n >> 1;
    const uint32_t q2 = 2u * q;
    for (int s = 0; s < logn; ++s) {
        const int sh = logn - 1 - s;  // log2(h)
        const int h = 1 << sh;
        for (int k = threadIdx.x; k < half; k += blockDim.x) {
            const int j = k & (h - 1);
            const int idx = ((k >> sh) << (sh + 1)) + j;
            const uint32_t t = __ldg(w + h + j);
            const uint32_t t_sh = __ldg(w_sh + h + j);
#pragma unroll
            for (int o = 0; o < NOPS; ++o) {
                uint32_t* r = a + o * n;
                const uint32_t u = r[idx];
                const uint32_t v = r[idx + h];
                r[idx] = csub(u + v, q2);
                r[idx + h] = shoup_lazy(u + q2 - v, t, t_sh, q);
            }
        }
        __syncthreads();
    }
}

// Cyclic DIT (CT butterfly) stages, rev -> nat; input below 4q, output lazy
// below 4q.  Stage s has half-width h = 2^s; position j of a block uses
// w[h + j].
template <int NOPS>
__device__ void dit_stages(uint32_t* a, const uint32_t* __restrict__ w,
                           const uint32_t* __restrict__ w_sh, int n, int logn,
                           uint32_t q) {
    const int half = n >> 1;
    const uint32_t q2 = 2u * q;
    for (int s = 0; s < logn; ++s) {
        const int h = 1 << s;
        for (int k = threadIdx.x; k < half; k += blockDim.x) {
            const int j = k & (h - 1);
            const int idx = ((k >> s) << (s + 1)) + j;
            const uint32_t t = __ldg(w + h + j);
            const uint32_t t_sh = __ldg(w_sh + h + j);
#pragma unroll
            for (int o = 0; o < NOPS; ++o) {
                uint32_t* r = a + o * n;
                const uint32_t u = csub(r[idx], q2);                  // < 2q
                const uint32_t hi = shoup_lazy(r[idx + h], t, t_sh, q);  // < 2q
                r[idx] = u + hi;
                r[idx + h] = u + q2 - hi;
            }
        }
        __syncthreads();
    }
}

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

// The forward scheme on the NOPS rows at a (ping-pong rows at a + NOPS n);
// returns where the result lies.
template <int S, int NOPS>
__device__ uint32_t* forward(uint32_t* a, const Twiddles& t, int n, int logn,
                             uint32_t q) {
    if (S == kDif) {
        dif_stages<NOPS>(a, t.w, t.w_sh, n, logn, q);
    } else if (S == kDit) {
        bitrev<NOPS>(a, n, logn);
        dit_stages<NOPS>(a, t.w, t.w_sh, n, logn, q);
    } else {
        // the widest cyclic stage, entries [n/2, n), holds omega^j, j < n/2
        a = stk_stages<NOPS>(a, a + NOPS * n, t.w + (n >> 1),
                             t.w_sh + (n >> 1), n, logn, q);
    }
    return a;
}

template <int FWD, int INV>
__global__ void pairing_kernel(const uint32_t* __restrict__ x,
                               const uint32_t* __restrict__ y,
                               uint32_t* __restrict__ z,
                               const uint32_t* __restrict__ tw, int n,
                               int logn, Mod m) {
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
    uint32_t* v = forward<FWD, 2>(smem, t, n, logn, q);

    for (int k = threadIdx.x; k < n; k += blockDim.x)
        v[k] = mulmod_barrett(v[k], v[n + k], m);
    __syncthreads();
    // a DIF forward gives rev order, a DIT inverse takes it
    if ((FWD == kDif) != (INV == kDit)) bitrev<1>(v, n, logn);
    if (INV == kDit) {
        dit_stages<1>(v, t.iw, t.iw_sh, n, logn, q);
    } else if (INV == kDif) {
        dif_stages<1>(v, t.iw, t.iw_sh, n, logn, q);
        bitrev<1>(v, n, logn);
    } else {
        // y's row is free now: the inverse ping-pongs with it
        v = stk_stages<1>(v, v + n, t.iw + (n >> 1), t.iw_sh + (n >> 1), n,
                          logn, q);
    }

    // phi^{-1} n^{-1} on the way out, canonical
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        z[row + k] = csub(
            shoup_lazy(v[k], __ldg(t.iphi + k), __ldg(t.iphi_sh + k), q), q);
}

template <int FWD, int INV>
int launch(const void* a, const void* b, void* out, const void* tw,
           long long batch, int n, int logn, uint32_t q, uint32_t r32,
           uint32_t r32_sh, uint32_t one_sh, void* stream) {
    if (n < 2 || logn < 1 || n != 1 << logn || batch <= 0 ||
        batch >= (1LL << 31))
        return cudaErrorInvalidValue;
    const int rows = FWD == kStk ? 4 : 2;
    const size_t smem = static_cast<size_t>(rows) * n * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pairing_kernel<FWD, INV>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    const int threads = n / 2 < 512 ? n / 2 : 512;
    const Mod m{q, r32, r32_sh, one_sh};
    pairing_kernel<FWD, INV><<<dim3(static_cast<unsigned>(batch)), threads,
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
                        uint32_t one_sh, void* stream) {                      \
        return launch<fwd, inv>(a, b, out, tw, batch, n, logn, q, r32,        \
                                r32_sh, one_sh, stream);                      \
    }

QT_PAIRING_LAUNCHER(qt_polymul_pairing_gs_ct, kDif, kDit)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_ct_ct, kDit, kDit)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_gs_gs, kDif, kDif)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_ct_gs, kDit, kDif)
QT_PAIRING_LAUNCHER(qt_polymul_pairing_stockham, kStk, kStk)
