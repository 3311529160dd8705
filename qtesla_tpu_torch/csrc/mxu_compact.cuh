// Building blocks of the digit-matmul kernels that multiply only the
// nonzero blocks of their tables (B11, B16 and B17 in sharded_mxu.cu's
// column_compact_kernel, B12-B15 and B18 in seg2_compact.cuh), on
// mxu_block.cuh's MMA and copy primitives.
//
// A sequence-parallel tile matrix (TW x TW lanes) is block-diagonal once
// its lanes are put in the right order (parallel/sharded_mxu_tables.py
// compact_layout): K1 couples only lanes of equal lambda, so lambda-major
// order gives n2k blocks of Bk lanes; K2f, K2i and the class tables are
// TW/n2 blocks of n2 lanes as they lie.  CompactDims names that order and
// the block size s = 2^ls (at least the 8 output lanes of an MMA tile: a
// narrower block is widened over its neighbours and the zeros between
// them).  The planner hands over the blocks alone (compact_tables): block
// b of a tile is (d * s, kp) int8, output-major, row j*s + o class j of the
// output lane at position b*s + o, column i*s + k plane i of the input lane
// at position b*s + korder[k], kp = planes * s rounded up to 32 with zero
// columns.  korder is the order the split writes a block's positions in:
// byte 4w + j of a plane holds position w + j * 2^lq for the column tables
// (lq = ls - 2: the four values a thread packs lie in four banks), position
// 4w + j for the row tables (lq = 0: one 16-byte load).
//
//   split_compact   writes the digit planes at their block-major place,
//                   planes[r*ks + b*kbs + i*s + k], four digits a word: the
//                   lane permutation costs an address, not a pass;
//   mma_compact     runs every 8-lane output tile over its own block's
//                   depth kp (64 where the dense K1 product ran 384 at
//                   qtesla-iii-speed, k = 4), the table fragments from
//                   shared memory (kSmemTables) or through L2;
//   recombine_compact  the recombination of mxu_block.cuh's note
//                   (recombine_value for one output), written back at the
//                   lane each position came from, so the kernels' inputs
//                   and outputs keep the row's order.
// B11 and B16 run them as the phases of a block; B18 gives each warp rows
// of its own and runs split, products and epilogues without a block
// barrier (pack_digits, store_planes, table_fragment, recombine_value).
//
// The planes' pad columns (planes * s .. kp-1) need no zeroing: they meet
// zero table columns, and any int8 times 0 is 0.  split_compact,
// mma_compact and cp_async_bytes are called by every thread of the block.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "mxu_block.cuh"

namespace qt {

// Field for field the CompactDims ctypes.Structure of
// parallel/sharded_mxu.py.  Lane l of a tile sits at
// position ((l & (2^llam - 1)) << lbk) | (l >> llam); llam = 0 with
// 2^lbk >= TW is the identity.  lq gives the order of a block's positions
// along the depth (above).
struct CompactDims {
    int32_t ls, llam, lbk, lq, kp;
};

// the lane at position pos
__device__ __forceinline__ int compact_lane(int pos, const CompactDims& c) {
    return ((pos & ((1 << c.lbk) - 1)) << c.llam) | (pos >> c.lbk);
}

// Bytes between two blocks of a planes row: 8 past the depth, so that the
// split's stores into neighbouring blocks fall into different banks.
__host__ __device__ constexpr int compact_block_stride(int kp) {
    return kp + 8;
}

// Bytes between two planes rows of nblk blocks: 32 mod 64, so that the
// eight rows an MMA fragment load touches spread over all banks
// (parallel/sharded_mxu.py planes_stride computes the same).
__host__ __device__ constexpr int compact_row_stride(int nblk, int kp) {
    return nblk * compact_block_stride(kp) +
           (96 - nblk * compact_block_stride(kp) % 64) % 64;
}

// Bytes between two rows of a compact table held in shared memory (the row
// segment kernel's): kp rounded up to 32 mod 64, so that the eight rows a
// table fragment load touches spread over all banks; at kp = 128 (K2f's
// blocks at qtesla-iii-speed) the rows of a half-warp's load fell on one
// group of 8 banks (parallel/sharded_mxu.py table_stride computes the same).
__host__ __device__ constexpr int compact_table_stride(int kp) {
    return kp + (96 - kp % 64) % 64;
}

// `rows` rows of `row_bytes` (a multiple of 16) global -> shared,
// asynchronously, row r from src + r * row_bytes to dst + r * dst_stride
// (16-byte aligned ends).
__device__ inline void cp_async_rows(void* dst, int dst_stride,
                                     const void* src, int row_bytes,
                                     int rows) {
    const int chunks = row_bytes >> 4;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
        const int r = i / chunks, c = i - r * chunks;
        cp_async16(reinterpret_cast<uint32_t*>(static_cast<char*>(dst) +
                                               r * dst_stride + c * 16),
                   reinterpret_cast<const uint32_t*>(
                       static_cast<const char*>(src) + r * row_bytes +
                       c * 16),
                   16);
    }
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared,
// asynchronously.
__device__ inline void cp_async_bytes(void* dst, const void* src,
                                      size_t bytes) {
    for (size_t i = threadIdx.x * 16u; i < bytes; i += blockDim.x * 16u)
        cp_async16(reinterpret_cast<uint32_t*>(static_cast<char*>(dst) + i),
                   reinterpret_cast<const uint32_t*>(
                       static_cast<const char*>(src) + i),
                   16);
}

// Plane i of four values a (read as int32, the split's bias added): four
// balanced digits of base 2^lb in one word, byte j of value j; the top
// plane is the arithmetic shift.
__device__ __forceinline__ uint32_t pack_digits(const int32_t (&a)[4], int i,
                                                int lb, bool top) {
    const int sh = lb * i, low_mask = (1 << lb) - 1, half_base = 1 << (lb - 1);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int dig = top ? a[j] >> sh : ((a[j] >> sh) & low_mask) - half_base;
        word |= static_cast<uint32_t>(dig & 0xff) << (8 * j);
    }
    return word;
}

// The planes of four values a, din of base 2^lb, plane i at pr[i << lw]
// (lw: log2 of the words of one plane of a block).  At base 256 (every
// registered set's plans) plane i of a value is byte i of a, its top bit
// flipped below the top plane, so the four planes are a 4 x 4 byte
// transpose: 8 byte permutes where the digits one by one take 50-odd
// operations.
__device__ __forceinline__ void store_planes(uint32_t* pr, int lw,
                                             const int32_t (&a)[4], int din,
                                             int lb) {
    if (lb == 8) {
        const uint32_t lo01 = __byte_perm(a[0], a[1], 0x5140);
        const uint32_t lo23 = __byte_perm(a[2], a[3], 0x5140);
        const uint32_t hi01 = __byte_perm(a[0], a[1], 0x7362);
        const uint32_t hi23 = __byte_perm(a[2], a[3], 0x7362);
        const uint32_t plane[4] = {
            __byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
            __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (i < din)
                pr[i << lw] = plane[i] ^ (i < din - 1 ? 0x80808080u : 0u);
        return;
    }
    for (int i = 0; i < din - 1; ++i)
        pr[i << lw] = pack_digits(a, i, lb, false);
    pr[(din - 1) << lw] = pack_digits(a, din - 1, lb, true);
}

// Plane i (the top one: `top`) of two values read as int32, the split's
// bias added: their two digits of base 2^lb in 16 bits, z0's first.
__device__ __forceinline__ uint16_t pack_pair(int32_t z0, int32_t z1, int i,
                                              int lb, bool top) {
    if (lb == 8)
        return static_cast<uint16_t>(__byte_perm(z0, z1, 0x40 + 0x11 * i) ^
                                     (top ? 0u : 0x8080u));
    const int sh = lb * i, low_mask = (1 << lb) - 1, half_base = 1 << (lb - 1);
    const int d0 = top ? z0 >> sh : ((z0 >> sh) & low_mask) - half_base;
    const int d1 = top ? z1 >> sh : ((z1 >> sh) & low_mask) - half_base;
    return static_cast<uint16_t>((d0 & 0xff) | (d1 & 0xff) << 8);
}

// The split of one tile: `rows` rows of 2^ltw values (row r at data +
// r*len) into din balanced planes of base 2^lb, plane i0 + i of the lane at
// position b*s + korder[k] at planes[r*ks + b*kbs + (i0 + i)*s + k].  A
// thread packs the four bytes of one word.  The row tables' order (lq = 0)
// takes its four values in one 16-byte load: data, len and the tile must be
// 16-byte aligned.  Every input must lie below the split's bound.
__device__ inline void split_compact(const uint32_t* data, int rows, int len,
                                     int ltw, int8_t* planes, int ks,
                                     const CompactDims& c, int i0, int din,
                                     int lb, uint32_t add) {
    const int kbs = compact_block_stride(c.kp), lw = c.ls - 2;
    for (int idx = threadIdx.x; idx < rows << (ltw - 2); idx += blockDim.x) {
        const int r = idx >> (ltw - 2), pw = idx & ((1 << (ltw - 2)) - 1);
        const int blk = pw >> lw, w = pw & ((1 << lw) - 1);
        const uint32_t* row = data + r * len;
        int32_t a[4];
        if (c.lq == 0) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(row + (blk << c.ls) + 4 * w);
            a[0] = static_cast<int32_t>(v.x + add);
            a[1] = static_cast<int32_t>(v.y + add);
            a[2] = static_cast<int32_t>(v.z + add);
            a[3] = static_cast<int32_t>(v.w + add);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                a[j] = static_cast<int32_t>(
                    row[compact_lane((blk << c.ls) + w + (j << c.lq), c)] +
                    add);
        }
        store_planes(reinterpret_cast<uint32_t*>(planes + r * ks + blk * kbs +
                                                 (i0 << c.ls)) + w,
                     lw, a, din, lb);
    }
}

template <bool kSmemTables>
__device__ __forceinline__ uint2 table_fragment(const int8_t* p) {
    if (kSmemTables) return *reinterpret_cast<const uint2*>(p);
    return __ldg(reinterpret_cast<const uint2*>(p));
}

// The MMA core over a tile's blocks: `rows` rows of block-major digit planes
// (row stride ks) against the tile's 2^lnblk blocks wt (each (d * s, kp)).
// A warp takes jobs of one 16-row tile mm times one 8-lane output tile lt
// of the permuted row (block lt >> (ls - 3)) and runs it over that block's
// depth alone; epi(mm, lt, acc) gets its int32 class sums (exact):
// accumulator e of class j belongs to row mm*16 + g (+8 for e >= 2) and
// position lt*8 + tig*2 + (e & 1), g and tig the thread's lane / 4 and
// lane % 4.  The table fragments of kSteps depth steps are requested before
// their first MMA.
template <bool kSmemTables, class Epi>
__device__ __forceinline__ void mma_compact(const int8_t* planes, int rows,
                                            int ks,
                                            const int8_t* __restrict__ wt,
                                            int lnblk, const CompactDims& c,
                                            int d, Epi&& epi) {
    const int mt = (rows + 15) >> 4;           // 1 or 2
    const int lnt = c.ls - 3;
    const int jobs = mt << (lnblk + lnt);
    const int nwarps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    const int kp = c.kp, kbs = compact_block_stride(kp);
    const int class_step = kp << c.ls;         // bytes between two classes
    for (int job = warp; job < jobs; job += nwarps) {
        const int mm = job & (mt - 1), lt = job >> (mt - 1);
        const int blk = lt >> lnt;
        int acc[kMaxClasses][4];
#pragma unroll
        for (int j = 0; j < kMaxClasses; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0;
        const int8_t* pa = planes + (mm * 16 + g) * ks + blk * kbs + tig * 8;
        const int8_t* pb = wt + static_cast<size_t>(blk * d) * class_step +
                           ((lt & ((1 << lnt) - 1)) * 8 + g) * kp + tig * 8;
        for (int k0 = 0; k0 < kp; k0 += 32 * kSteps) {
            uint2 bf[kSteps][kMaxClasses];
#pragma unroll
            for (int st = 0; st < kSteps; ++st)
#pragma unroll
                for (int j = 0; j < kMaxClasses; ++j)
                    if (j < d && k0 + st * 32 < kp)
                        bf[st][j] = table_fragment<kSmemTables>(
                            pb + j * class_step + k0 + st * 32);
#pragma unroll
            for (int st = 0; st < kSteps; ++st) {
                if (k0 + st * 32 >= kp) break;
                const uint2 a_lo =
                    *reinterpret_cast<const uint2*>(pa + k0 + st * 32);
                const uint2 a_hi = *reinterpret_cast<const uint2*>(
                    pa + 8 * ks + k0 + st * 32);
#pragma unroll
                for (int j = 0; j < kMaxClasses; ++j)
                    if (j < d) mma_s8(acc[j], a_lo, a_hi, bf[st][j]);
            }
        }
        epi(mm, lt, acc);
    }
}

// One recombined value: start (const row entry + kb, < 2q) plus, per class
// j < d, one Shoup product of c_j + 2^24 by 2^{8j} mod q, c_j = sum(j) the
// class's int32 sum; canonical.
template <class Plan, class Sum>
__device__ __forceinline__ uint32_t recombine_value(uint32_t start, int d,
                                                    const Plan& p, Sum&& sum) {
    const uint32_t q = p.q, q2 = 2u * q;
    uint32_t v = start;                                               // < 2q
#pragma unroll
    for (int j = 0; j < kMaxClasses; ++j) {
        if (j < d) {
            const uint32_t t = static_cast<uint32_t>(sum(j)) + kClassBias;
            v = csub(v + shoup_lazy(t, p.pw[j], p.pw_sh[j], q), q2);  // < 2q
        }
    }
    return csub(v, q);
}

// The recombination epilogue of one job of mma_compact: for each of its
// rows r < rows, out[r * len + l] the recombined value of the lane l whose
// position the accumulator holds; cb the tile's const row by lane (shared
// or device memory).
template <class Plan>
__device__ __forceinline__ void recombine_compact(
    uint32_t* out, int rows, int len, int mm, int lt,
    const int (&acc)[kMaxClasses][4], const uint32_t* cb, uint32_t kb,
    const CompactDims& c, const Plan& p) {
    const int d = warp_uniform(p.d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int r = tile_row(mm, e);
        const int l = compact_lane(tile_lane(lt, e), c);
        if (r < rows)
            out[r * len + l] = recombine_value(
                cb[l] + kb, d, p, [&](int j) { return acc[j][e]; });
    }
}

// The blocks of `kernel` (`threads` threads, `smem` bytes) that the current
// device holds at once: what a persistent launch fills.
template <class Kernel>
inline int resident_blocks(Kernel kernel, int threads, size_t smem, int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidValue;
    *out = per_sm * sms;
    return cudaSuccess;
}

}  // namespace qt
