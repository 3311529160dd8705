// Fused merged-psi negacyclic NTT kernels for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of qtesla_tpu/ops/ntt_pallas.py:
//   qt_polymul_fused        <- _polymul_kernel       (l.100, polymul_fused_fn)
//   qt_polymul_fixed_fused  <- _polymul_fixed_kernel (l.112, polymul_fixed_fused_fn)
//   qt_ntt_fused            <- _ntt_kernel           (l.123, ntt_fused_fn)
//   qt_intt_fused           <- _intt_kernel          (l.129, intt_fused_fn)
//
// What they compute: merged-psi Cooley-Tukey forward (natural -> bit-reversed
// order, psi folded into the twiddles), the generic pointwise product, and
// the merged-psi Gentleman-Sande inverse with n^{-1} folded into its last
// stage.  All data are uint32 residues; outputs are canonical in [0, q).
//
// Design.  One thread block per polynomial row, so a ragged batch needs no
// padding.  The row (two rows for the two-operand product) is loaded once
// into shared memory; min(n/2, 512) threads each loop over their butterflies,
// with __syncthreads() between the log2(n) dependent stages.  Global memory
// sees exactly one read of each operand and one write of the result, as on
// the TPU.  The TPU kernel's lane rolls and full-width (L, n) twiddle tables
// are gone: a thread indexes its butterfly pair directly in shared memory and
// reads one twiddle from the compact n-entry tables (ops/tables.py, packed
// as 4 rows: psi_rev, its Shoup companion, psi^{-1}_rev with n^{-1} folded,
// its Shoup companion), which stay resident in L1/L2.
//
// What bounds it on the H100.  At n = 1024 one polymul moves 12 KB of device
// memory but makes 3 * 10 stages of 512 butterflies in shared memory with a
// block-wide barrier per stage.  Each butterfly compiles to about 30 SASS
// instructions (index and twiddle-address arithmetic, two shared loads and
// stores, the Shoup IMADs), so the kernel is bound by instruction issue, not
// by HBM: on an H100 (700 W) qt_polymul_fused takes 0.82 ms for 32768 rows,
// 6x the time of an int32 add with the same device-memory traffic.  This
// first design stays simple (no register-resident radix-4 stages, no
// bank-conflict padding for the strides below 32) and leaves those to
// later work.
//
// Arithmetic.  q < 2^30, so 4q < 2^32 and Harvey's lazy ranges fit uint32:
// forward values stay in [0, 4q), inverse values in [0, 2q).  Shoup products
// use the native __umulhi; the pointwise product assembles the 64-bit
// product with __umulhi and a low multiply and folds it as
// hi * (2^32 mod q) + lo, exact for any uint32 operands (no 64-bit %).
//
// Each launcher is extern "C", takes raw pointers, the batch B, n, log2(n),
// the parameter set's constants and a stream, launches without
// synchronising and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"

namespace {

using qt::csub;
using qt::Mod;
using qt::mulmod_barrett;
using qt::shoup_lazy;

// Forward stages over NOPS rows of n values held back to back in shared
// memory.  Input < 4q, output lazy in [0, 4q).  Stage s has 2^s blocks of
// width 2t, t = n >> (s + 1); block i uses tw[2^s + i].
template <int NOPS>
__device__ void fwd_stages(uint32_t* a, const uint32_t* __restrict__ tw,
                           const uint32_t* __restrict__ tw_sh, int n,
                           int logn, uint32_t q) {
    const int half = n >> 1;
    const uint32_t q2 = 2u * q;
    for (int s = 0; s < logn; ++s) {
        const int sh = logn - 1 - s;  // log2(t)
        const int t = 1 << sh;
        for (int k = threadIdx.x; k < half; k += blockDim.x) {
            const int i = k >> sh;
            const int j = (i << (sh + 1)) + (k & (t - 1));
            const uint32_t w = __ldg(tw + (1 << s) + i);
            const uint32_t w_sh = __ldg(tw_sh + (1 << s) + i);
#pragma unroll
            for (int o = 0; o < NOPS; ++o) {
                uint32_t* r = a + o * n;
                const uint32_t u = csub(r[j], q2);                // [0, 2q)
                const uint32_t v = shoup_lazy(r[j + t], w, w_sh, q);  // [0, 2q)
                r[j] = u + v;                                     // [0, 4q)
                r[j + t] = u - v + q2;                            // (0, 4q)
            }
        }
        __syncthreads();
    }
}

// Inverse stages over one row in shared memory.  Input < 2q, output
// canonical.  Stage s has pair distance t = 2^s and h = n >> (s + 1) blocks;
// block i uses itw[h + i].  The last stage (h = 1) multiplies the sum branch
// by itw[0] = n^{-1} and the difference branch by itw[1] = psi^{-1}_rev[1] *
// n^{-1}.
__device__ void inv_stages(uint32_t* a, const uint32_t* __restrict__ itw,
                           const uint32_t* __restrict__ itw_sh, int n,
                           int logn, uint32_t q) {
    const int half = n >> 1;
    const uint32_t q2 = 2u * q;
    for (int s = 0; s < logn - 1; ++s) {
        const int t = 1 << s;
        const int h = n >> (s + 1);
        for (int k = threadIdx.x; k < half; k += blockDim.x) {
            const int i = k >> s;
            const int j = (i << (s + 1)) + (k & (t - 1));
            const uint32_t u = a[j];
            const uint32_t v = a[j + t];
            a[j] = csub(u + v, q2);
            a[j + t] = shoup_lazy(u - v + q2, __ldg(itw + h + i),
                                  __ldg(itw_sh + h + i), q);
        }
        __syncthreads();
    }
    const uint32_t w0 = __ldg(itw), w0_sh = __ldg(itw_sh);
    const uint32_t w1 = __ldg(itw + 1), w1_sh = __ldg(itw_sh + 1);
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
        const uint32_t u = a[k];
        const uint32_t v = a[k + half];
        a[k] = csub(shoup_lazy(u + v, w0, w0_sh, q), q);
        a[k + half] = csub(shoup_lazy(u - v + q2, w1, w1_sh, q), q);
    }
    __syncthreads();
}

__device__ __forceinline__ void load_row(uint32_t* dst,
                                         const uint32_t* __restrict__ src,
                                         int n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

__global__ void polymul_fused_kernel(const uint32_t* __restrict__ x,
                                     const uint32_t* __restrict__ y,
                                     uint32_t* __restrict__ z,
                                     const uint32_t* __restrict__ tw, int n,
                                     int logn, Mod m) {
    extern __shared__ uint32_t smem[];
    const size_t row = static_cast<size_t>(blockIdx.x) * n;
    load_row(smem, x + row, n);
    load_row(smem + n, y + row, n);
    __syncthreads();
    fwd_stages<2>(smem, tw, tw + n, n, logn, m.q);
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        smem[k] = mulmod_barrett(smem[k], smem[n + k], m);
    __syncthreads();
    inv_stages(smem, tw + 2 * n, tw + 3 * n, n, logn, m.q);
    for (int k = threadIdx.x; k < n; k += blockDim.x) z[row + k] = smem[k];
}

__global__ void polymul_fixed_fused_kernel(const uint32_t* __restrict__ x,
                                           const uint32_t* __restrict__ spec,
                                           uint32_t* __restrict__ z,
                                           const uint32_t* __restrict__ tw,
                                           int n, int logn, Mod m) {
    extern __shared__ uint32_t smem[];
    const size_t row = static_cast<size_t>(blockIdx.x) * n;
    load_row(smem, x + row, n);
    __syncthreads();
    fwd_stages<1>(smem, tw, tw + n, n, logn, m.q);
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        smem[k] = mulmod_barrett(smem[k], __ldg(spec + k), m);
    __syncthreads();
    inv_stages(smem, tw + 2 * n, tw + 3 * n, n, logn, m.q);
    for (int k = threadIdx.x; k < n; k += blockDim.x) z[row + k] = smem[k];
}

__global__ void ntt_fused_kernel(const uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ /*unused*/,
                                 uint32_t* __restrict__ out,
                                 const uint32_t* __restrict__ tw, int n,
                                 int logn, Mod m) {
    extern __shared__ uint32_t smem[];
    const size_t row = static_cast<size_t>(blockIdx.x) * n;
    load_row(smem, x + row, n);
    __syncthreads();
    fwd_stages<1>(smem, tw, tw + n, n, logn, m.q);
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        out[row + k] = csub(csub(smem[k], 2u * m.q), m.q);
}

__global__ void intt_fused_kernel(const uint32_t* __restrict__ x,
                                  const uint32_t* __restrict__ /*unused*/,
                                  uint32_t* __restrict__ out,
                                  const uint32_t* __restrict__ tw, int n,
                                  int logn, Mod m) {
    extern __shared__ uint32_t smem[];
    const size_t row = static_cast<size_t>(blockIdx.x) * n;
    load_row(smem, x + row, n);
    __syncthreads();
    inv_stages(smem, tw + 2 * n, tw + 3 * n, n, logn, m.q);
    for (int k = threadIdx.x; k < n; k += blockDim.x) out[row + k] = smem[k];
}

using KernelFn = void (*)(const uint32_t*, const uint32_t*, uint32_t*,
                          const uint32_t*, int, int, Mod);

int launch(KernelFn kernel, int rows_in_smem, const void* a, const void* b,
           void* out, const void* tw, long long batch, int n, int logn,
           uint32_t q, uint32_t r32, uint32_t r32_sh, uint32_t one_sh,
           void* stream) {
    const size_t smem = static_cast<size_t>(rows_in_smem) * n * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    const int threads = n / 2 < 512 ? n / 2 : 512;
    const Mod m{q, r32, r32_sh, one_sh};
    kernel<<<dim3(static_cast<unsigned>(batch)), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), static_cast<const uint32_t*>(tw), n, logn,
        m);
    return cudaGetLastError();
}

}  // namespace

#define QT_LAUNCHER(name, kernel, rows)                                        \
    extern "C" int name(const void* a, const void* b, void* out,              \
                        const void* tw, long long batch, int n, int logn,     \
                        uint32_t q, uint32_t r32, uint32_t r32_sh,            \
                        uint32_t one_sh, void* stream) {                      \
        return launch(kernel, rows, a, b, out, tw, batch, n, logn, q, r32,    \
                      r32_sh, one_sh, stream);                                \
    }

QT_LAUNCHER(qt_polymul_fused, polymul_fused_kernel, 2)
QT_LAUNCHER(qt_polymul_fixed_fused, polymul_fixed_fused_kernel, 1)
QT_LAUNCHER(qt_ntt_fused, ntt_fused_kernel, 1)
QT_LAUNCHER(qt_intt_fused, intt_fused_kernel, 1)

extern "C" const char* qt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
