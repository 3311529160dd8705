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
// Exact while every class bound of B18 is below 2^24 (the recombination's
// bias): true for every set with Dout <= 3, n = 8192 included; the
// four-class sets are refused by the planner, as JAX's entry point refuses
// them.
//
// Design of B17.  K1 is kron(M, I_n2k): in lambda-major order a tile is
// n2k diagonal blocks of Bk lanes (1/8 of a dense tile at
// qtesla-iii-speed, k = 4), and B17 multiplies those blocks alone
// (SpDeviceTables.w1c, the blocks B11 multiplies).  It runs B11's body,
// sharded_mxu.cu's column_compact_kernel in the direction kColumnClasses:
// persistent blocks, each walking over its shard's row groups with two
// row buffers (the next group's cp.async loads in flight while this one
// runs), the shard's compact K1 loaded once into shared memory (through L2
// where it does not fit), the forward wide stages, per tile the split and
// the products over each 8-lane output tile's own block.  Where B11
// recombines in place, B17's epilogue stages the biased raw sums by lane
// in shared memory (Dout planes of rows of TW + 2 words, where B11 keeps
// its const rows) and, after one barrier, the block copies them out as
// whole runs of its output rows, Dout times B11's output.  The staging
// takes the room of a second 16-row block at qtesla-iii-speed, k = 4, so
// the planner gives one block 32 rows and 16 warps.
// An MMA tile's 8 output lanes are one lambda's j1 values, n2k lanes
// apart in the output row: stored from the accumulators as 8-byte lane
// pairs (lambda and lambda + 1, taken from two blocks or traded between
// two threads), every 32-byte sector took four stores from four warps,
// and B17 ran 1.0599 ms, 1.14 of it in load and store alone
// (utils/phase_ablation.py, PERF.md); staged, each sector is written whole.
// B17 ran until then as a kernel of its own: whole tiles of the dense K1
// streamed from L2 for each 32-row group, phases barrier-separated (0.5931
// ms at qtesla-iii-speed, k = 4, B = 32768 on an H100, PERF.md).
//
// Design of B18.  The class tables and K2i are block-diagonal over the
// n2-blocks of a tile, and every diagonal block of the class tables is the
// same one (K2f = kron(I, R2)): the planner hands over that one block and
// K2i's blocks alone.  B18 runs seg2_compact.cuh's seg2_compact_kernel, the
// body it shares with B12 and B13 (kClassPlanes: Dout class planes a
// value, each split on its own base, the class block for every n2-block): a
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
// signature), the batch B (rows per shard), k_local, a pointer to its plan
// (B17 an SpCompactPlan, B18 an SpClassPlan) and a stream, launches without
// synchronising and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "seg2_compact.cuh"

namespace qt {
// B17's launcher, in sharded_mxu.cu beside B11's and B16's body
int launch_seg1_classes(const void* a, void* out, const void* w,
                        const void* tw, long long batch, int k_local,
                        const void* plan, void* stream);
}  // namespace qt

// B17: w1 the shard slice of the compact K1 (tabs.w1c), plan an
// SpCompactPlan with the class biases; b, c1, w2 and c2 unused
extern "C" int qt_sp_seg1_classes(const void* a, const void*, void* out,
                                  const void* w1, const void*, const void*,
                                  const void*, const void* tw,
                                  long long batch, int k_local,
                                  const void* plan, void* stream) {
    return qt::launch_seg1_classes(a, out, w1, tw, batch, k_local, plan,
                                   stream);
}

// B18: w1 the class tables' one block (tabs.w2cc), c1 the shard slice of
// their const rows, w2 and c2 the shard slices of the compact K2i and its
// const rows; tw unused
extern "C" int qt_sp_seg2_classes(const void* a, const void* b, void* out,
                                  const void* w1, const void* c1,
                                  const void* w2, const void* c2, const void*,
                                  long long batch, int k_local,
                                  const void* plan, void* stream) {
    return qt::seg2::launch<qt::seg2::kClassPlanes>(
        a, b, out, w1, c1, w2, c2, batch, k_local, plan, stream);
}
