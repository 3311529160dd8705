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
// split is canonical, below the JAX bounds (fwd_bound, pw_bound); every
// output is canonical.  The TPU kernel's sloppy Shoup, Horner packing and
// overflow fixer were vector-unit workarounds and are not replayed.
//
// Design.  One block of 512 threads holds `rows` operand rows (at most 32,
// 128 KiB of uint32: 16 batch rows of x and y for B5, 32 rows otherwise at
// n = 1024) in shared memory for the whole pipeline, loaded with cp.async
// (every 16-byte copy in flight before one wait: with one block per SM a
// plain load loop waited out a round trip per element).  Per lane block b it
// splits the rows into int8 planes in shared memory, then each warp takes
// 8 output lanes of every class and runs mma.sync m16n8k32 s8 over the
// K = Din * bw depth: A fragments from the planes, B fragments streamed from
// the device-memory tables four K steps ahead (laid out output-major, (nb, D*bw, Din*bw), so a
// thread reads 8 contiguous bytes).  The K order inside each 32-deep step is
// permuted the same way for A and B, which the sum does not see.  Each
// thread then holds all D classes of its output elements and recombines them
// in registers.  x and y share one pass over the forward tables.
//
// What bounds it on the H100.  The tables do not fit in shared memory
// (q-III: wf 1.57 MB, wi 1.18 MB; p-III 8.4 MB in all), so each block reads
// the whole of them once per `rows` rows: about 5.6 GB of L2 traffic per
// 32768-row B5 call at q-III.  The products themselves are small (4.33 M
// int8 MACs per q-III polymul row, 0.14 ms at the tensor-core peak for the
// batch).  Measured by ablation on an H100 (PERF.md): neither L2 bandwidth
// nor the MMAs set the time; with one 148 KB block per SM the barrier-
// separated phases (wide stages, split, table stream, recombination) run
// with little overlap, and half the time is outside the products.  A first
// design: no TMA, no wgmma, no table tiles reused across row groups.
//
// B9, the folded fixed-operand product, is the forward and then the inverse
// block matmul against one constant's tables W' = M_inv diag(A) and c' (passed
// in place of wi and ci), with no pointwise stage.  Its plan carries the fold
// plan's inverse split (di = fold Din planes, offset, base, group bias), so
// the planes' stride and the shared memory, sized by max(df, di), cover it.
// W' streams from device memory as wi does: 1.57 MB at q-III, 4.2 MB at p-III.
//
// Each launcher is extern "C", takes raw pointers, the batch B, a pointer to
// an MxuPlan and a stream, launches without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"

namespace {

using qt::csub;
using qt::Mod;
using qt::mulmod_barrett;
using qt::shoup_lazy;

// Field for field the MxuPlan ctypes.Structure of ops/ntt_mxu.py.
struct MxuPlan {
    int32_t n, logn, bw, nb, lr, d, rows, df, fwd_lb;
    uint32_t fwd_add;
    int32_t di, inv_lb;
    uint32_t inv_add, q, r32, r32_sh, one_sh, kbf, kbi;
    uint32_t pw[4], pw_sh[4];
};

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;         // 32-deep K steps whose loads go together
constexpr int kMaxRows = 32;      // two 16-row MMA tiles
constexpr int kMaxClasses = 4;
constexpr int kPad = 16;          // bytes after each row of digit planes
constexpr uint32_t kClassBias = 1u << 24;

enum Mode { kPolymul, kFixed, kNtt, kIntt, kFolded };

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

// The first Lr merged-psi CT stages over `rows` rows, canonical in and out.
// Stage s has 2^s blocks of width 2t, t = n >> (s + 1); block i uses
// tw[2^s + i].
__device__ void fwd_wide(uint32_t* data, int rows,
                         const uint32_t* __restrict__ tw, const MxuPlan& p) {
    const int n = p.n, hl = p.logn - 1;
    const uint32_t q = p.q;
    for (int s = 0; s < p.lr; ++s) {
        const int sh = hl - s;
        const int t = 1 << sh;
        for (int k = threadIdx.x; k < rows << hl; k += blockDim.x) {
            const int kk = k & ((1 << hl) - 1);
            const int i = kk >> sh;
            uint32_t* a = data + (k >> hl) * n + (i << (sh + 1)) + (kk & (t - 1));
            const uint32_t w = __ldg(tw + (1 << s) + i);
            const uint32_t w_sh = __ldg(tw + n + (1 << s) + i);
            const uint32_t u = a[0];
            const uint32_t v = csub(shoup_lazy(a[t], w, w_sh, q), q);
            a[0] = csub(u + v, q);
            a[t] = csub(u - v + q, q);
        }
        __syncthreads();
    }
}

// The last Lr merged-psi GS stages over `rows` rows, canonical in and out.
// Stage s has pair distance t = 2^s and h = n >> (s + 1) blocks; block i
// uses itw[h + i]; the last stage's sum branch takes itw[0] = n^{-1}.
__device__ void inv_wide(uint32_t* data, int rows,
                         const uint32_t* __restrict__ tw, const MxuPlan& p) {
    const int n = p.n, hl = p.logn - 1;
    const uint32_t q = p.q;
    const uint32_t* itw = tw + 2 * n;
    const uint32_t* itw_sh = tw + 3 * n;
    for (int s = p.logn - p.lr; s < p.logn; ++s) {
        const int t = 1 << s;
        const int h = n >> (s + 1);
        const bool last = s == p.logn - 1;
        for (int k = threadIdx.x; k < rows << hl; k += blockDim.x) {
            const int kk = k & ((1 << hl) - 1);
            const int i = kk >> s;
            uint32_t* a = data + (k >> hl) * n + (i << (s + 1)) + (kk & (t - 1));
            const uint32_t u = a[0];
            const uint32_t v = a[t];
            uint32_t sum = csub(u + v, q);
            if (last)
                sum = csub(shoup_lazy(sum, __ldg(itw), __ldg(itw_sh), q), q);
            a[0] = sum;
            a[t] = csub(shoup_lazy(u - v + q, __ldg(itw + h + i),
                                   __ldg(itw_sh + h + i), q), q);
        }
        __syncthreads();
    }
}

// The block-local stages of one direction over `rows` rows, in place: per
// lane block, digit split into `planes`, int8 MMA against the tables w
// (nb, d*bw, din*bw), recombination into canonical residues.  Every input
// must lie below the split's bound.
__device__ void block_matmul(uint32_t* data, int rows, int8_t* planes, int ks,
                             const int8_t* __restrict__ w,
                             const uint32_t* __restrict__ cst, int din,
                             int lb, uint32_t add, uint32_t kb,
                             const MxuPlan& p) {
    const int n = p.n, bw = p.bw, d = p.d, K = din * bw;
    const int lbw = __ffs(bw) - 1;
    const int mt = (rows + 15) >> 4;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    const uint32_t q = p.q, q2 = 2u * q;
    const int low_mask = (1 << lb) - 1, half_base = 1 << (lb - 1);
    for (int b = 0; b < p.nb; ++b) {
        for (int idx = threadIdx.x; idx < rows * bw; idx += blockDim.x) {
            const int r = idx >> lbw, k = idx & (bw - 1);
            const int32_t a =
                static_cast<int32_t>(data[r * n + b * bw + k] + add);
            int8_t* pr = planes + r * ks + k;
            for (int i = 0; i < din - 1; ++i)
                pr[i * bw] = static_cast<int8_t>(
                    ((a >> (lb * i)) & low_mask) - half_base);
            pr[(din - 1) * bw] = static_cast<int8_t>(a >> (lb * (din - 1)));
        }
        __syncthreads();
        const int8_t* wb = w + static_cast<size_t>(b) * d * bw * K;
        for (int lt = warp; lt < (bw >> 3); lt += kWarps) {
            int acc[2][kMaxClasses][4];
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int j = 0; j < kMaxClasses; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;
            // K in chunks of kSteps 32-deep steps: every B fragment of a
            // chunk is requested before its first MMA, so a warp keeps
            // d * kSteps table loads in flight
            for (int k0 = 0; k0 < K; k0 += 32 * kSteps) {
                uint2 bf[kSteps][kMaxClasses];
#pragma unroll
                for (int st = 0; st < kSteps; ++st)
#pragma unroll
                    for (int j = 0; j < kMaxClasses; ++j)
                        if (j < d && k0 + st * 32 < K)
                            bf[st][j] = __ldg(reinterpret_cast<const uint2*>(
                                wb + static_cast<size_t>(j * bw + lt * 8 + g) *
                                         K +
                                k0 + st * 32 + tig * 8));
#pragma unroll
                for (int st = 0; st < kSteps; ++st) {
                    if (k0 + st * 32 >= K) break;
                    uint2 a[2][2];
#pragma unroll
                    for (int m = 0; m < 2; ++m) {
                        if (m < mt) {
                            const int8_t* pa = planes + (m * 16 + g) * ks +
                                               k0 + st * 32 + tig * 8;
                            a[m][0] = *reinterpret_cast<const uint2*>(pa);
                            a[m][1] =
                                *reinterpret_cast<const uint2*>(pa + 8 * ks);
                        }
                    }
#pragma unroll
                    for (int j = 0; j < kMaxClasses; ++j)
                        if (j < d)
#pragma unroll
                            for (int m = 0; m < 2; ++m)
                                if (m < mt)
                                    mma_s8(acc[m][j], a[m][0], a[m][1],
                                           bf[st][j]);
                }
            }
            // accumulator e of tile m: row m*16 + g (+8 for e >= 2), lane
            // lt*8 + tig*2 + (e & 1)
#pragma unroll
            for (int m = 0; m < 2; ++m) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = m * 16 + g + ((e >> 1) << 3);
                    const int col = b * bw + lt * 8 + tig * 2 + (e & 1);
                    if (m < mt && r < rows) {
                        uint32_t v = __ldg(cst + col) + kb;           // < 2q
#pragma unroll
                        for (int j = 0; j < kMaxClasses; ++j) {
                            if (j < d) {
                                const uint32_t t =
                                    static_cast<uint32_t>(acc[m][j][e]) +
                                    kClassBias;
                                v = csub(v + shoup_lazy(t, p.pw[j], p.pw_sh[j],
                                                        q),
                                         q2);                          // < 2q
                            }
                        }
                        data[r * n + col] = csub(v, q);
                    }
                }
            }
        }
        __syncthreads();
    }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    mxu_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
               uint32_t* __restrict__ z, const int8_t* __restrict__ wf,
               const uint32_t* __restrict__ cf, const int8_t* __restrict__ wi,
               const uint32_t* __restrict__ ci,
               const uint32_t* __restrict__ tw, long long batch,
               const __grid_constant__ MxuPlan p) {
    extern __shared__ __align__(16) uint32_t smem[];
    constexpr int kOps = MODE == kPolymul ? 2 : 1;
    const int n = p.n, tb = p.rows / kOps;
    const int ks = (p.df > p.di ? p.df : p.di) * p.bw + kPad;
    uint32_t* data = smem;
    int8_t* planes = reinterpret_cast<int8_t*>(smem + p.rows * n);
    const long long row0 = static_cast<long long>(blockIdx.x) * tb;
    const int live = batch - row0 < tb ? static_cast<int>(batch - row0) : tb;
    const size_t base = static_cast<size_t>(row0) * n;

    // rows past the batch are zero-filled; every copy is in flight before
    // the one wait
    for (int c = threadIdx.x * 4; c < tb * n; c += blockDim.x * 4) {
        const bool ok = (c >> p.logn) < live;
        cp_async16(data + c, ok ? x + base + c : x, ok ? 16 : 0);
        if (MODE == kPolymul)
            cp_async16(data + tb * n + c, ok ? y + base + c : y, ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    if (MODE != kIntt) {
        fwd_wide(data, p.rows, tw, p);
        block_matmul(data, p.rows, planes, ks, wf, cf, p.df, p.fwd_lb,
                     p.fwd_add, p.kbf, p);
    }
    if (MODE == kPolymul || MODE == kFixed) {
        const Mod m{p.q, p.r32, p.r32_sh, p.one_sh};
        for (int idx = threadIdx.x; idx < tb * n; idx += blockDim.x) {
            const uint32_t other = MODE == kPolymul
                                       ? data[tb * n + idx]
                                       : __ldg(y + (idx & (n - 1)));
            data[idx] = mulmod_barrett(data[idx], other, m);
        }
        __syncthreads();
    }
    if (MODE != kNtt) {
        block_matmul(data, tb, planes, ks, wi, ci, p.di, p.inv_lb, p.inv_add,
                     p.kbi, p);
        inv_wide(data, tb, tw, p);
    }

    for (int c = threadIdx.x * 4; c < tb * n; c += blockDim.x * 4)
        if ((c >> p.logn) < live)
            *reinterpret_cast<uint4*>(z + base + c) =
                *reinterpret_cast<const uint4*>(data + c);
}

template <int MODE>
int launch(const void* a, const void* b, void* out, const void* wf,
           const void* cf, const void* wi, const void* ci, const void* tw,
           long long batch, const void* plan, void* stream) {
    const MxuPlan p = *static_cast<const MxuPlan*>(plan);
    constexpr int kOps = MODE == kPolymul ? 2 : 1;
    if (p.rows < kOps || p.rows > kMaxRows || p.rows % kOps || p.d < 1 ||
        p.d > kMaxClasses || p.bw % 32 || p.bw > p.n || p.n != 1 << p.logn ||
        p.nb * p.bw != p.n || p.n >> p.lr != p.bw)
        return cudaErrorInvalidValue;
    const long long tb = p.rows / kOps;
    const long long blocks = (batch + tb - 1) / tb;
    if (batch <= 0 || blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    const int ks = (p.df > p.di ? p.df : p.di) * p.bw + kPad;
    const size_t smem = static_cast<size_t>(p.rows) * p.n * sizeof(uint32_t) +
                        static_cast<size_t>((p.rows + 15) / 16 * 16) * ks;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            mxu_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    mxu_kernel<MODE><<<dim3(static_cast<unsigned>(blocks)), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), static_cast<const int8_t*>(wf),
        static_cast<const uint32_t*>(cf), static_cast<const int8_t*>(wi),
        static_cast<const uint32_t*>(ci), static_cast<const uint32_t*>(tw),
        batch, p);
    return cudaGetLastError();
}

}  // namespace

#define QT_MXU_LAUNCHER(name, mode)                                           \
    extern "C" int name(const void* a, const void* b, void* out,             \
                        const void* wf, const void* cf, const void* wi,      \
                        const void* ci, const void* tw, long long batch,     \
                        const void* plan, void* stream) {                    \
        return launch<mode>(a, b, out, wf, cf, wi, ci, tw, batch, plan,      \
                            stream);                                         \
    }

QT_MXU_LAUNCHER(qt_polymul_mxu, kPolymul)
QT_MXU_LAUNCHER(qt_polymul_fixed_mxu, kFixed)
QT_MXU_LAUNCHER(qt_ntt_mxu, kNtt)
QT_MXU_LAUNCHER(qt_intt_mxu, kIntt)
QT_MXU_LAUNCHER(qt_polymul_fixed_folded_mxu, kFolded)
