// The class-sum boundary of the sequence-parallel (four-step) digit-matmul
// polymul, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of qtesla_tpu/parallel/sharded_mxu.py:
//   qt_sp_seg1_classes <- _make_seg1_classes (l.972)   B17
//   qt_sp_seg2_classes <- _make_seg2_classes (l.1001)  B18
//
// What they compute.  The path of sharded_mxu.cu (B11, B12, B16) with the
// first exchange moved before segment 1's recombination.  Shard d holds
// nloc = n1 * n2/k values a row in A tiles of TW lanes
// (parallel/sharded_mxu_tables.py).  Per row of a shard:
//   B17: the Lr wide stages of the n1-point forward along j1, then per tile
//        the digit split of p1 and the products against K1[d, t], and no
//        recombination: class m's int32 sum c_m is stored as the uint32
//        c_m + cls_b[m] (cls_b p1's inclusive class bounds) at column
//        m * nloc + t * TW + o of a row of Dout * nloc values;
//   B18: per tile and operand (x and y, each Dout class planes after the
//        exchange), class plane j split into din_j planes of its own base,
//        centred at cls_b[j], at K offset sum_{i<j} din_i * TW; one product
//        over all of them against the one shared table of the 2^{8j}-scaled
//        K2f (class_boundary_plan), one recombination with the row
//        c2c[d, t] (seg1's centring term carried through K2f); then the
//        Barrett pointwise product of x's and y's results and K2i[d, t]
//        under p2i, as B12.  The output is canonical.
// B17's wide stages, split, MMA core and recombination are mxu_block.cuh's,
// its MMA core given an epilogue that stores the raw sums.
// Exact while every class bound of B18 is below 2^24 (the recombination's
// bias): true for every set with Dout <= 3, n = 8192 included; the
// four-class sets are refused by the planner, as JAX's entry point refuses
// them.
//
// Design of B17.  One launch covers the k_local stacked shards, grid (row
// groups, shard), as in sharded_mxu.cu.  B17 holds `rows` input rows (at
// most 32) in shared memory and writes its Dout-times wider output straight
// from the MMA registers to device memory, so its shared memory is the
// dense segment kernels' and four 128-thread blocks fit an SM at
// qtesla-iii-speed, k = 4.  It multiplies whole tiles of the dense K1
// streamed from L2 (mxu_block.cuh), phases barrier-separated.
//
// Design of B18.  The class tables and K2i are block-diagonal over the
// n2-blocks of a tile, and every diagonal block of the class tables is the
// same one (K2f = kron(I, R2)): the planner hands over that one block and
// K2i's blocks alone.  B18 runs seg2_compact.cuh's seg2_compact_kernel, the
// body it shares with B12 (kClasses true: Dout class planes a value, each
// split on its own base, the class block for every n2-block): a
// persistent grid of (walkers, n2-blocks, shard), each block's tables in
// shared memory (through L2 at n = 8192), each warp taking 8 rows of x and
// 8 of y through both products with no block barrier.  That header keeps
// the design and its measurements.
//
// What bounds them on the H100 (qtesla-iii-speed, B = 32768, k = 4, all
// shards on one card, bytes / 3.35 TB/s against the tables' nonzero int8
// MACs * 2 / 1979 TOP/s):
//   B17 (per operand) 134 MB in, 403 MB out: 0.160 ms, device memory;
//   B18               805 MB in, 134 MB out: 0.280 ms, device memory.
//
// Each launcher is extern "C", takes raw pointers (sharded_mxu.cu's
// signature), the batch B (rows per shard), k_local, a pointer to an
// SpClassPlan and a stream, launches without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "mxu_block.cuh"
#include "mxu_compact.cuh"
#include "seg2_compact.cuh"

namespace {

using qt::cp_async16;
using qt::cp_async_wait_all;
using qt::kMaxClasses;
using qt::kPad;
using qt::mma_classes;
using qt::SpClassPlan;
using qt::split_block;
using qt::tile_lane;
using qt::tile_row;
using qt::warp_uniform;
using qt::zero_depth_pad;
using qt::seg2::kClassSlots;
using qt::seg2::valid_shape;
using qt::seg2::valid_split;

// the threads an SM runs: 16 warps, in blocks of 128, 256 or 512
constexpr int kSmThreads = 512;
// shared memory of one SM, and what the runtime reserves for each block
constexpr int kSmShared = 233472, kBlockReserve = 1024;

// classes_kernel's SEG; kSeg2Classes keeps its number: B18 runs
// seg2_compact.cuh's seg2_compact_kernel
enum Seg { kSeg1Classes, kSeg2Classes };

// B17.
template <int SEG, int THREADS>
__global__ void __launch_bounds__(THREADS, kSmThreads / THREADS)
    classes_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ z,
                   const int8_t* __restrict__ w1,
                   const uint32_t* __restrict__ tw, long long batch,
                   const __grid_constant__ SpClassPlan p) {
    static_assert(SEG == kSeg1Classes, "B18 has a kernel of its own");
    extern __shared__ __align__(16) uint32_t smem[];
    const int nloc = p.nloc, d = p.d, tws = p.tw;
    const uint32_t q = p.q;
    const int wide = d * nloc;                  // a row of class planes
    const int tb = p.rows;                      // batch rows a block
    const int ks = p.kp1 + kPad;
    uint32_t* data = smem;
    int8_t* planes = reinterpret_cast<int8_t*>(smem + p.rows * nloc);
    const int shard = blockIdx.y;
    const long long row0 = static_cast<long long>(blockIdx.x) * tb;
    const int live = batch - row0 < tb ? static_cast<int>(batch - row0) : tb;
    const size_t row_base = static_cast<size_t>(shard) * batch + row0;
    const size_t in_base = row_base * static_cast<size_t>(nloc);

    // rows past the batch are zero-filled
    for (int c = threadIdx.x * 4; c < tb * nloc; c += blockDim.x * 4) {
        const bool ok = c / nloc < live;
        cp_async16(data + c, ok ? x + in_base + c : x, ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    // one shard's K1 tiles of (d * tw, kp1) int8
    const size_t tile1 = static_cast<size_t>(d) * tws * p.kp1;
    const int8_t* w1_shard = w1 + shard * p.a * tile1;
    uint32_t* zrow = z + row_base * static_cast<size_t>(wide);
    const uint32_t cls_b[kClassSlots] = {p.cls_b[0], p.cls_b[1],
                                            p.cls_b[2]};
    qt::fwd_wide(data, tb, p.logm, p.llanes, p.lr, tw, q);
    zero_depth_pad(planes, tb, ks, p.din1 * tws, p.kp1);
    for (int t = 0; t < p.a; ++t) {
        split_block(data, tb, nloc, tws, t, planes, ks, p.din1, p.lb1,
                    p.add1);
        __syncthreads();
        // the raw class sums, biased, straight to device memory
        mma_classes(
            planes, tb, ks, w1_shard + t * tile1, p.kp1, tws, d,
            [&](int lt, const int (&acc)[2][kMaxClasses][4]) {
                const int du = warp_uniform(d);
#pragma unroll
                for (int mm = 0; mm < 2; ++mm)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = tile_row(mm, e);
                        if (r >= live) continue;
                        uint32_t* zr = zrow + static_cast<size_t>(r) * wide +
                                       t * tws + tile_lane(lt, e);
#pragma unroll
                        for (int j = 0; j < kClassSlots; ++j)
                            if (j < du)
                                zr[j * nloc] =
                                    static_cast<uint32_t>(acc[mm][j][e]) +
                                    cls_b[j];
                    }
            });
        __syncthreads();
    }
}

// din planes of a depth kp: din*tw rounded up to a multiple of 32
bool valid_depth(int din, int kp, int tw) {
    return kp % 32 == 0 && kp >= din * tw && kp < din * tw + 32;
}

// One launch of classes_kernel<kSeg1Classes, THREADS> with `smem` bytes a
// block.
template <int THREADS>
int run_seg1(const void* a, void* out, const void* w1, const void* tw,
             long long batch, long long blocks, int k_local, size_t smem,
             const SpClassPlan& p, void* stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            classes_kernel<kSeg1Classes, THREADS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    classes_kernel<kSeg1Classes, THREADS>
        <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(k_local)),
           THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out),
            static_cast<const int8_t*>(w1), static_cast<const uint32_t*>(tw),
            batch, p);
    return cudaGetLastError();
}

int launch_seg1(const void* a, void* out, const void* w1, const void* tw,
                long long batch, int k_local, const void* plan,
                void* stream) {
    const SpClassPlan p = *static_cast<const SpClassPlan*>(plan);
    if (!valid_shape(p, 1, batch, k_local, kClassSlots) ||
        !valid_depth(p.din1, p.kp1, p.tw) || !valid_split(p.din1, p.lb1) ||
        p.kp2 != 0)
        return cudaErrorInvalidValue;
    const long long blocks = (batch + p.rows - 1) / p.rows;
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    const size_t smem =
        static_cast<size_t>(p.rows) * p.nloc * sizeof(uint32_t) +
        static_cast<size_t>((p.rows + 15) / 16 * 16) * (p.kp1 + kPad);
    if (smem + kBlockReserve > kSmShared) return cudaErrorInvalidValue;
    // blocks whose shared memory fits one SM
    const size_t fit = kSmShared / (smem + kBlockReserve);
    if (fit >= 4)
        return run_seg1<128>(a, out, w1, tw, batch, blocks, k_local, smem, p,
                             stream);
    if (fit >= 2)
        return run_seg1<256>(a, out, w1, tw, batch, blocks, k_local, smem, p,
                             stream);
    return run_seg1<512>(a, out, w1, tw, batch, blocks, k_local, smem, p,
                         stream);
}

}  // namespace

// B17: w1 the shard slice of the dense K1; b, c1, w2 and c2 unused
extern "C" int qt_sp_seg1_classes(const void* a, const void*, void* out,
                                  const void* w1, const void*, const void*,
                                  const void*, const void* tw,
                                  long long batch, int k_local,
                                  const void* plan, void* stream) {
    return launch_seg1(a, out, w1, tw, batch, k_local, plan, stream);
}

// B18: w1 the class tables' one block (tabs.w2cc), c1 the shard slice of
// their const rows, w2 and c2 the shard slices of the compact K2i and its
// const rows; tw unused
extern "C" int qt_sp_seg2_classes(const void* a, const void* b, void* out,
                                  const void* w1, const void* c1,
                                  const void* w2, const void* c2, const void*,
                                  long long batch, int k_local,
                                  const void* plan, void* stream) {
    return qt::seg2::launch<true>(a, b, out, w1, c1, w2, c2, batch, k_local,
                                  plan, stream);
}
