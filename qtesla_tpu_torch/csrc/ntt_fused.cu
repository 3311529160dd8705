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
// Every kernel reads the compact n-entry tables (ops/tables.py, packed as 4
// rows: psi_rev, its Shoup companion, psi^{-1}_rev with n^{-1} folded, its
// Shoup companion), which stay resident in L1/L2: forward stage s, block i
// uses entry 2^s + i; the inverse stage with h blocks, block i, entry h + i.
//
// B1 (qt_polymul_fused, polymul_pass_kernel) runs in register passes
// (pass_stages.cuh): a row of n values is held by n / R threads, R values of
// each operand a thread, and a pass runs up to log2(R) stages in registers
// between exchanges through padded shared memory.  Its schedule is gs_ct's
// window sequence (ntt_pairings.cu): the forward's CT butterflies from the
// widest stage down, starting on the window [tb, L) where the load leaves a
// row and ending on [0, r); the inverse's GS butterflies from the narrowest
// stage up, starting where the forward ended, so the pointwise product sits
// between them in registers, with no exchange and no bit reversal.  The
// stage on index bit k reads entry 2^(L-1-k) + (j >> (k+1)), the bits of the
// index above the stage; in the window [0, r) these are the thread's, so
// the threads of a warp read 2^(L-1-k) different entries, each thread its
// own neighbouring ones, which it reads up to four at a time (16-byte
// loads: 0.74x the time of one word a load on an H100, PERF.md).  The inverse's last stage (k = L - 1, always on the
// top register bit of the last window [tb, L)) multiplies the sum branch by
// entry 0 = n^{-1} and the difference branch by entry 1, reduces both to
// canonical and is fused into the store.  No phi weighting: psi is merged
// into the twiddles.  n = 1024 (qtesla-iii-speed, -p-i) has a kernel built
// for its length, whose every index offset is an immediate.  The plan
// (ops/ntt_fused.py fused_pass_plan) is checked by the launcher.
//
// B4 (qt_polymul_fixed_fused) is B1's kernel with one operand
// (polymul_pass_kernel<..., 1>): x alone is loaded and carried through the
// forward's passes and exchanges, and where the forward ends, on the window
// [0, r), thread t holds positions t R + c, so its R values of the
// constant's spectrum (one n-value row every block shares) are neighbours,
// read in 16-byte loads and multiplied in by Barrett; then B1's inverse and
// store.  Its plan (ops/ntt_fused.py fixed_pass_plan) is B1's with half the
// shared memory a row, one operand's.
//
// B2, B3: one thread block per polynomial row, so a ragged batch needs no
// padding.  The row is loaded once into shared memory; min(n/2, 512)
// threads each loop over their butterflies, with __syncthreads() between
// the log2(n) dependent stages.  Global memory sees exactly one read of each
// operand and one write of the result, as on the TPU.  The TPU kernel's lane
// rolls and full-width (L, n) twiddle tables are gone: a thread indexes its
// butterfly pair directly in shared memory and reads one twiddle from the
// compact tables.
//
// What bounds them on the H100: instruction issue, not HBM.  At n = 1024 one
// polymul moves 12 KB of device memory; B2 and B3 make their stages in
// shared memory with a block-wide barrier per stage, each butterfly about 30
// SASS instructions (index and twiddle-address arithmetic, two shared loads
// and stores, the Shoup IMADs).  The register butterfly of B1 and B4 is 7
// instructions; their passes add one exchange each way and the twiddle
// loads.
//
// Arithmetic.  q < 2^30, so 4q < 2^32 and Harvey's lazy ranges fit uint32:
// forward values stay in [0, 4q), inverse values in [0, 2q).  Shoup products
// use the native __umulhi; the pointwise product assembles the 64-bit
// product with __umulhi and a low multiply and folds it as
// hi * (2^32 mod q) + lo, exact for any uint32 operands (no 64-bit %).
//
// Each launcher is extern "C", takes raw pointers, the batch B, n, log2(n),
// the parameter set's constants (B1 and B4 then a pointer to their pass
// plan) and a stream, launches without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "pass_stages.cuh"

namespace {

using qt::csub;
using qt::Mod;
using qt::mulmod_barrett;
using qt::shoup_lazy;
using qt::exchange;
using qt::ilog2;
using qt::PassKernel;
using qt::PassPlan;
using qt::two_pass_b;
using qt::two_pass_hi;
using qt::two_pass_lo;
using qt::window_base;

// ---------------------------------------------------------------------------
// B1 and B4: register passes.
// ---------------------------------------------------------------------------

// vec (1, 2 or 4, at most N) neighbouring twiddles and their Shoup
// companions, from entries aligned to vec, in one load each.
template <int N>
__device__ __forceinline__ void load_twiddles(uint32_t (&tw)[N],
                                              uint32_t (&tw_sh)[N],
                                              const uint32_t* w,
                                              const uint32_t* w_sh, int vec) {
    if (N >= 4 && vec == 4) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(w));
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(w_sh));
        tw[0] = a.x, tw[1 % N] = a.y, tw[2 % N] = a.z, tw[3 % N] = a.w;
        tw_sh[0] = b.x, tw_sh[1 % N] = b.y, tw_sh[2 % N] = b.z,
        tw_sh[3 % N] = b.w;
    } else if (N >= 2 && vec == 2) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(w));
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(w_sh));
        tw[0] = a.x, tw[1 % N] = a.y;
        tw_sh[0] = b.x, tw_sh[1 % N] = b.y;
    } else {
        tw[0] = __ldg(w);
        tw_sh[0] = __ldg(w_sh);
    }
}

// The merged-psi stages on index bits k in [lo, hi), on the window [b, b + r)
// of virtual thread vt: the forward's CT butterflies from the widest stage
// down (FWD), or the inverse's GS butterflies from the narrowest up.  The
// stage on window bit t (k = b + t) pairs registers c and c + 2^t and reads
// the 2^(r-1-t) twiddles w[2^(L-1-k) + (j >> (k+1))], indexed by the index
// bits above the stage: (vt >> b) << (r-1-t) from the thread's, c >> (t+1)
// from the register's.
template <bool FWD, int R, int NOPS>
__device__ __forceinline__ void merged_stages(uint32_t (&v)[NOPS][R], int b,
                                              int vt, int lo, int hi,
                                              int logn,
                                              const uint32_t* __restrict__ w,
                                              const uint32_t* __restrict__ w_sh,
                                              uint32_t q, uint32_t q2) {
    constexpr int r = ilog2(R);
    const int vhi = vt >> b;
#pragma unroll
    for (int s = 0; s < r; ++s) {
        const int t = FWD ? r - 1 - s : s;
        const int k = b + t;
        if (k < lo || k >= hi) continue;
        const int m = 1 << t;
        const int base = (1 << (logn - 1 - k)) + (vhi << (r - 1 - t));
        // The 2^(r-1-t) twiddles of a thread are neighbours, from an entry
        // aligned to their count: read up to 4 at a time.  In the window [0,
        // r) each thread reads other entries than its neighbours (the
        // thread holds the index bits above every stage), so one word at a
        // time would make as many L1 requests as twiddles.  One loop over
        // the registers: nested loops (a twiddle's registers inside) left
        // both register arrays in local memory at R = 32.
        constexpr int kVec = R / 2 < 4 ? R / 2 : 4;
        const int vec = (R >> (t + 1)) < kVec ? (R >> (t + 1)) : kVec;
        uint32_t tw[kVec], tw_sh[kVec];
#pragma unroll
        for (int c = 0; c < R; ++c) {
            if (c & m) continue;
            const int h = c >> (t + 1);  // the twiddle's number
            if ((c & (m - 1)) == 0 && h % vec == 0)
                load_twiddles<kVec>(tw, tw_sh, w + base + h, w_sh + base + h,
                                    vec);
#pragma unroll
            for (int o = 0; o < NOPS; ++o) {
                if (FWD)
                    qt::ct_butterfly(v[o][c], v[o][c + m], tw[h % vec],
                                     tw_sh[h % vec], q, q2);
                else
                    qt::gs_butterfly(v[o][c], v[o][c + m], tw[h % vec],
                                     tw_sh[h % vec], q, q2);
            }
        }
    }
}

// LOGN > 0: built for n = 2^LOGN in two passes, gs_ct's schedule known at
// compile time, so every index offset of a thread is a constant.  NOPS 2:
// B1, x times y; NOPS 1: B4, x times the spectrum y (n values every row
// shares), one forward.  B4's kernel built for its length takes three
// blocks of 256 threads an SM (80 registers, 16 bytes of spill; 0.9635 of
// its time at two blocks, PERF.md); with run-time windows it would spill
// 60 bytes there, and keeps two.
template <int R, int P, int LOGN, int NOPS>
__global__ void __launch_bounds__(P == 3 ? 512 : 256,
                                  P == 2 ? (NOPS == 1 && LOGN > 0 ? 3 : 2)
                                         : 1)
    polymul_pass_kernel(const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ y,
                        uint32_t* __restrict__ z,
                        const uint32_t* __restrict__ tw, long long batch,
                        int n_arg, int logn_arg, Mod m, uint32_t q2,
                        PassPlan pl) {
    static_assert(LOGN == 0 || P == 2, "one length: two passes");
    static_assert(NOPS == 1 || NOPS == 2, "x and y, or x alone");
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
    const uint32_t *fw = tw, *fw_sh = tw + n, *iw = tw + 2 * n,
                   *iw_sh = tw + 3 * n;
    const uint32_t q = m.q;

    // pass p's stages and window: the plan's, or gs_ct's two-pass schedule
    // for the length the kernel was built for (the forward from the widest
    // stage down, the inverse from the narrowest up)
    const auto lo = [](bool up, int planned, int p) {
        return kConst ? two_pass_lo(up, p, LOGN) : planned;
    };
    const auto hi = [](bool up, int planned, int p) {
        return kConst ? two_pass_hi(up, p, LOGN) : planned;
    };
    const auto win = [](bool up, int planned, int p) {
        return kConst ? two_pass_b(up, p, LOGN, r) : planned;
    };

    // the window [tb, L) reads neighbouring columns with neighbouring
    // threads; canonical input is below 4q
    uint32_t v[NOPS][R];
    int b = tb;
    {
        const int base = window_base(t, b, r);
#pragma unroll
        for (int c = 0; c < R; ++c) {
            const int i = base + (c << b);
            v[0][c] = x[off + i];
            if constexpr (NOPS == 2) v[1][c] = y[off + i];
        }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        if (p > 0) {
            const int b2 = win(false, pl.fwd_b[p], p);
            exchange<kConst, R, NOPS>(v, buf, stride, b, t, b2, t, warp_rows);
            b = b2;
        }
        merged_stages<true, R, NOPS>(v, b, t, lo(false, pl.fwd_lo[p], p),
                                     hi(false, pl.fwd_hi[p], p), logn, fw,
                                     fw_sh, q, q2);
    }

    // the inverse starts on the forward's last window
    uint32_t u[1][R];
    if constexpr (NOPS == 2) {
#pragma unroll
        for (int c = 0; c < R; ++c)
            u[0][c] = mulmod_barrett(v[0][c], v[1][c], m);
    } else {
        // that window is [0, r) (the launcher's checks): thread t holds
        // positions t R + c, R neighbouring values of the spectrum, read
        // 16 bytes at a time (8 at R = 2) from its 16-byte aligned row
        const uint32_t* s = y + (static_cast<size_t>(t) << r);
#pragma unroll
        for (int c = 0; c < R; c += R < 4 ? 2 : 4) {
            uint32_t w[4];
            if constexpr (R < 4) {
                const uint2 a = __ldg(reinterpret_cast<const uint2*>(s + c));
                w[0] = a.x, w[1] = a.y;
            } else {
                const uint4 a = __ldg(reinterpret_cast<const uint4*>(s + c));
                w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
            }
#pragma unroll
            for (int k = 0; k < (R < 4 ? 2 : 4); ++k)
                u[0][c + k] = mulmod_barrett(v[0][c + k], w[k], m);
        }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        if (p > 0) {
            const int b2 = win(true, pl.inv_b[p], p);
            exchange<kConst, R, 1>(u, buf, stride, b, t, b2, t, warp_rows);
            b = b2;
        }
        // the last stage, k = L - 1, goes with the store
        const int p_hi = hi(true, pl.inv_hi[p], p);
        merged_stages<false, R, 1>(u, b, t, lo(true, pl.inv_lo[p], p),
                                   p_hi < logn ? p_hi : logn - 1, logn, iw,
                                   iw_sh, q, q2);
    }

    // The last stage in the last window [tb, L), on register bit r - 1: the
    // sum by n^{-1}, the difference by psi^{-1}_rev[1] n^{-1}, canonical.
    if (live) {
        const uint32_t w0 = __ldg(iw), w0_sh = __ldg(iw_sh);
        const uint32_t w1 = __ldg(iw + 1), w1_sh = __ldg(iw_sh + 1);
        constexpr int h = R / 2;
#pragma unroll
        for (int c = 0; c < h; ++c) {
            const uint32_t a = u[0][c], d = u[0][c + h];
            z[off + t + (c << tb)] = csub(shoup_lazy(a + d, w0, w0_sh, q), q);
            z[off + t + ((c + h) << tb)] =
                csub(shoup_lazy(a + q2 - d, w1, w1_sh, q), q);
        }
    }
}

// R = n for n <= 32 (one pass a transform), R = 32 with two passes (n <=
// 1024) or three (n <= 16384, as the block's threads allow), and R = 32 in
// two passes built for n = 1024, whose one schedule the launcher's checks
// leave is the one two_pass_* restate.
template <int NOPS>
PassKernel polymul_pass_kernel_for(int radix, int passes, int logn) {
    if (radix == 32 && passes == 2 && logn == 10)
        return polymul_pass_kernel<32, 2, 10, NOPS>;
    switch (radix * 4 + passes) {
        case 2 * 4 + 1: return polymul_pass_kernel<2, 1, 0, NOPS>;
        case 4 * 4 + 1: return polymul_pass_kernel<4, 1, 0, NOPS>;
        case 8 * 4 + 1: return polymul_pass_kernel<8, 1, 0, NOPS>;
        case 16 * 4 + 1: return polymul_pass_kernel<16, 1, 0, NOPS>;
        case 32 * 4 + 1: return polymul_pass_kernel<32, 1, 0, NOPS>;
        case 32 * 4 + 2: return polymul_pass_kernel<32, 2, 0, NOPS>;
        case 32 * 4 + 3: return polymul_pass_kernel<32, 3, 0, NOPS>;
        default: return nullptr;
    }
}

// B1 (NOPS 2) and B4 (NOPS 1): the forward from the widest stage down, the
// inverse from the narrowest up, no bit reversal between them
template <int NOPS>
int launch_polymul_passes(const void* a, const void* b, void* out,
                          const void* tw, long long batch, int n, int logn,
                          uint32_t q, uint32_t r32, uint32_t r32_sh,
                          uint32_t one_sh, const void* plan, void* stream) {
    if (!plan) return cudaErrorInvalidValue;
    const PassPlan pl = *static_cast<const PassPlan*>(plan);
    return qt::launch_pass_kernel(
        polymul_pass_kernel_for<NOPS>(pl.radix, pl.passes, logn), pl,
        qt::PassOrder{false, true, false, false, NOPS}, a, b, out, tw, batch,
        n, logn, q, r32, r32_sh, one_sh, stream);
}

// ---------------------------------------------------------------------------
// B2, B3: a thread block a row.
// ---------------------------------------------------------------------------

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

// B1 and B4 take a pointer to their pass plan before the stream; B4's b is
// the constant's spectrum, n values, 16-byte aligned
extern "C" int qt_polymul_fused(const void* a, const void* b, void* out,
                                const void* tw, long long batch, int n,
                                int logn, uint32_t q, uint32_t r32,
                                uint32_t r32_sh, uint32_t one_sh,
                                const void* plan, void* stream) {
    return launch_polymul_passes<2>(a, b, out, tw, batch, n, logn, q, r32,
                                    r32_sh, one_sh, plan, stream);
}

extern "C" int qt_polymul_fixed_fused(const void* a, const void* b,
                                      void* out, const void* tw,
                                      long long batch, int n, int logn,
                                      uint32_t q, uint32_t r32,
                                      uint32_t r32_sh, uint32_t one_sh,
                                      const void* plan, void* stream) {
    return launch_polymul_passes<1>(a, b, out, tw, batch, n, logn, q, r32,
                                    r32_sh, one_sh, plan, stream);
}

QT_LAUNCHER(qt_ntt_fused, ntt_fused_kernel, 1)
QT_LAUNCHER(qt_intt_fused, intt_fused_kernel, 1)

extern "C" const char* qt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
