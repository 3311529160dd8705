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
// in registers.  x and y share one pass over the forward tables.  The wide
// stages, the split, the products and the recombination live in
// mxu_block.cuh, shared with the sequence-parallel kernels.
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
#include "mxu_block.cuh"

namespace {

using qt::block_matmul;
using qt::cp_async16;
using qt::cp_async_wait_all;
using qt::kMaxClasses;
using qt::kMaxRows;
using qt::kPad;
using qt::Mod;
using qt::mulmod_barrett;

// Field for field the MxuPlan ctypes.Structure of ops/ntt_mxu.py.
struct MxuPlan {
    int32_t n, logn, bw, nb, lr, d, rows, df, fwd_lb;
    uint32_t fwd_add;
    int32_t di, inv_lb;
    uint32_t inv_add, q, r32, r32_sh, one_sh, kbf, kbi;
    uint32_t pw[4], pw_sh[4];
};

constexpr int kThreads = 512;

enum Mode { kPolymul, kFixed, kNtt, kIntt, kFolded };

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
        const int K = p.df * p.bw;
        qt::fwd_wide(data, p.rows, p.logn, 0, p.lr, tw, p.q);
        block_matmul(data, p.rows, n, p.bw, p.nb, planes, ks, wf,
                     static_cast<size_t>(p.d) * p.bw * K, K, cf, p.bw, p.df,
                     p.fwd_lb, p.fwd_add, p.kbf, p);
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
        const int K = p.di * p.bw;
        block_matmul(data, tb, n, p.bw, p.nb, planes, ks, wi,
                     static_cast<size_t>(p.d) * p.bw * K, K, ci, p.bw, p.di,
                     p.inv_lb, p.inv_add, p.kbi, p);
        qt::inv_wide(data, tb, p.logn, 0, p.lr, tw, p.q);
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
