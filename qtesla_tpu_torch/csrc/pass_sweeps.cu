// Sweep forms of the pass kernels, for rows past a thread-block cluster's
// reach (sm_90a): B1, B4 and the five B10 pairings from n = 2^18, B2 and
// B3 from n = 2^19, up to n = 2^25, the largest ring the registry takes.
//
// Replaces, at those lengths, the Pallas TPU kernels of
// qtesla_tpu/ops/ntt_pallas.py (_polymul_kernel l.100, _polymul_fixed_kernel
// l.112, _ntt_kernel l.123, _intt_kernel l.129) and
// qtesla_tpu/ops/ntt_pairings_pallas.py (_pairing_kernel l.160), whose block
// and cluster forms are ntt_fused.cu and ntt_pairings.cu; one launcher,
// qt_pass_sweep, runs one launch of a call of any of the nine.
//
// What they compute is what the pass kernels compute (see the notes at the
// top of ntt_fused.cu and ntt_pairings.cu), bit for bit: the same
// butterflies, twiddles, lazy ranges and ends.  How: a row stays in device
// memory and a transform runs in sweeps, one launch each.  The plan
// (ops/passes.py sweep_plan) parts the L = log2(n) index bits into two or
// three windows.  A launch on the window [lo, hi) of s bits gives each block
// a tile: the 2^s indices of a row that differ only in the window's bits,
// for 2^c neighbouring values of c column bits [cb, cb + c) (so that a
// warp's loads and stores run over 32 contiguous bytes), the other bits
// fixed by the block's number.  The block loads the tile into shared memory
// (value u = v | col << s at u + u/32 + col: 32 neighbouring values, or the
// 8 columns of one v, in 32 banks; eight loads a thread in flight), runs the
// window's stages there in register passes of three (a thread loads a group
// of 8 values that differ in three window bits, runs those three stages in
// registers and stores them back; a barrier a pass, one thread a group) and
// stores the tile back.  A stage on index bit k pairs indices j and j + 2^k
// of its transform, all inside the tile, and reads its twiddle by j from
// the compact tables the pass kernels read: the (4, n) merged-psi rows
// (B1-B4: w[2^(L-1-k) + (j >> (k+1))]) or the (8, n) pairing rows (w[2^k +
// (j mod 2^k)]); no (L, n) table.
//
// Launches a call: the forward from its widest window down, the narrowest
// window once with the forward's stages, the pointwise product and the
// inverse's stages, then the inverse up: 3 with two windows, 5 with three.
// B2 and B3 one a window.  Upper windows carry one operand a block (B1's
// and the pairings' x and y in blocks of their own) and a tile of up to
// 2^15 values (s <= 12 beside c = 3 columns); the narrowest carries both
// operands (up to 2^14 values each; Stockham's 2^11, its positions there
// taking columns too).  So two windows reach 2^26 and Stockham takes three
// from 2^24.  A launch reads what the one before wrote: the operands, then
// two scratch buffers of the operands' rows in turns, z last.
//
// Where each index lies between launches.  All nine keep a row in natural
// order in the operands and in z.  The DIT forwards (ct_ct, ct_gs) and the
// DIF and Stockham inverses (gs_gs, ct_gs, stockham) run on the
// bit-reversed index of the position they touch, as the pass kernels'
// renamings do: their stage on index bit k lies on position bit L - 1 - k,
// and a forward's stages run from position bit L - 1 down, an inverse's
// from bit 0 up, in all nine.  Stockham's intermediate rows lie at its
// autosort's positions: index j of the forward after stage st at ((j mod
// 2^(L-st)) << st) | brev_st(j >> (L - st)), likewise the inverse's
// (bit-reversed) index (plan fields ld, st and their refl flags).
//
// Arithmetic is the pass kernels': q < 2^30; GS butterflies keep [0, 2q),
// CT ones take and give values below 4q, and what a launch stores for the
// next stays there, below 2^32.  Offsets into a batch are 64-bit.
//
// What bounds it on an H100: not device memory.  Each launch reads and
// writes every value once (3 passes over the data a product with two
// windows, against one for the pass kernels), yet the calls take many
// times their bytes bound (PERF.md, section 5): the index and twiddle
// arithmetic of each butterfly, and the cyclic pairings' twiddles on an
// index bit far from the window's (a DIF stage above the narrowest window,
// a reflected stage in it), gathered one a butterfly, from a table past L2
// at 2^25.  A first design: right before fast.  One thread a butterfly and
// a barrier a stage, one thread a butterfly's slot in a block of register
// passes and one load a thread in flight each took more time (PERF.md,
// section 6).
//
// The launcher is extern "C": (x, y, z, scratch a, scratch b, twiddles,
// batch B, n, log2(n), the set's constants, &plan, the launch's number, a
// stream); y is B4's spectrum (n values), unused by B2 and B3.  It checks
// the whole plan against the one it restates (plan_ok) and refuses any
// other, launches without synchronising and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "modq.cuh"
#include "pass_stages.cuh"

namespace {

using qt::csub;
using qt::Mod;
using qt::mulmod_barrett;
using qt::shoup_lazy;

constexpr int kMaxWindows = 3;
constexpr int kMaxSweeps = 2 * kMaxWindows - 1;
constexpr int kMaxLogn = 25;
// values a tile holds, all its operands (128 KiB); column bits
constexpr int kTileBits = 15;
constexpr int kCols = 3;
constexpr int kMaxThreads = 1024;
// window bits a pass runs in registers, between two barriers
constexpr int kPassBits = 3;
// a thread's loads in flight at once
constexpr int kBatch = 8;

// the order of ops/passes.py SWEEP_KINDS
enum Kind { kB1, kB4, kB2, kB3, kGsCt, kCtCt, kGsGs, kCtGs, kStk, kKinds };
enum Scheme { kNone, kMerged, kDif, kDit, kStock };

__host__ __device__ constexpr int fwd_scheme(int kind) {
    return kind == kB3                    ? kNone
           : kind <= kB2                  ? kMerged
           : kind == kGsCt || kind == kGsGs ? kDif
           : kind == kStk                 ? kStock
                                          : kDit;
}

__host__ __device__ constexpr int inv_scheme(int kind) {
    return kind == kB2                    ? kNone
           : kind <= kB3                  ? kMerged
           : kind == kGsCt || kind == kCtCt ? kDit
           : kind == kStk                 ? kStock
                                          : kDif;
}

__host__ __device__ constexpr int operands(int kind) {
    return kind == kB4 || kind == kB2 || kind == kB3 ? 1 : 2;
}

// a transform that runs on the bit-reversed index: a DIT forward, a DIF or
// Stockham inverse
__host__ __device__ constexpr bool reflected(int scheme, bool fwd) {
    return fwd ? scheme == kDit : scheme == kDif || scheme == kStock;
}

// Mirrors ops/passes.py SweepPlan.
struct SweepPlan {
    int kind, logn, sweeps, windows;
    int win_lo[kMaxWindows], win_hi[kMaxWindows];
    int lo[kMaxSweeps], hi[kMaxSweeps], fwd[kMaxSweeps], inv[kMaxSweeps];
    int cb[kMaxSweeps], cols[kMaxSweeps], ops[kMaxSweeps], split[kMaxSweeps];
    int ld[kMaxSweeps], ld_refl[kMaxSweeps], st[kMaxSweeps],
        st_refl[kMaxSweeps];
    int tiles[kMaxSweeps], threads[kMaxSweeps], smem[kMaxSweeps];
};

// One launch's fields.
struct Sweep {
    int lo, hi, fwd, inv, cb, cols, ops, split, ld, ld_refl, st, st_refl,
        tiles, first, last;
};

// the bit of an address index bit i lands on (address below)
__host__ __device__ inline int address_bit(int i, int L, int st, int refl) {
    const int j = refl ? L - 1 - i : i;
    return j < L - st ? j + st : L - 1 - j;
}

__device__ __forceinline__ unsigned brev_bits(unsigned v, int bits) {
    return bits == 0 ? 0u : __brev(v) >> (32 - bits);
}

// The address of index m of a row: the Stockham position of stage st of j
// = m (or j = brev_L(m) with refl), ((j mod 2^(L-st)) << st) |
// brev_st(j >> (L - st)); m itself at (0, 0) and (L, 1).
__device__ __forceinline__ unsigned address(unsigned m, int L, int st,
                                            int refl) {
    const unsigned j = refl ? brev_bits(m, L) : m;
    const int low = L - st;
    return ((j & ((1u << low) - 1)) << st) | brev_bits(j >> low, st);
}

// value u = v | col << s of a tile in shared memory
__device__ __forceinline__ int tile_slot(int u, int s) {
    return u + (u >> 5) + (u >> s);
}

// Window bits [t0, t0 + RB) of the tile in registers: each thread takes
// groups of 2^RB values that differ in those bits (the group's number
// spread over the window's other bits and the columns), loads them from
// shared memory, runs the RB stages there (a forward from the widest, an
// inverse from the narrowest) and stores them back.  The stage on window
// bit t is bit k = lo + t of its transform's index (L - 1 - k where it runs
// reflected); CT for a DIT transform and the merged forward, GS for the
// others; the merged inverse's stage k = L - 1 takes n^{-1} on the sum
// (entry 0) and entry 1 on the difference, canonical, as the pass kernels'
// store does.
template <int SCHEME, bool FWD, int RB>
__device__ __forceinline__ void tile_pass(uint32_t* tile, int stride,
                                          int ops, int t0, const Sweep& sw,
                                          unsigned rest, int L,
                                          const uint32_t* __restrict__ w,
                                          const uint32_t* __restrict__ w_sh,
                                          uint32_t q, uint32_t q2) {
    constexpr int R = 1 << RB;
    constexpr bool kRefl = reflected(SCHEME, FWD);
    constexpr bool kCt = SCHEME == kDit || (SCHEME == kMerged && FWD);
    const int s = sw.hi - sw.lo;
    const int above = s - t0 - RB;  // window bits above the pass
    const int groups = 1 << (s + sw.cols - RB);
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
        const int hi_bits = g >> t0;
        const int vbase = (g & ((1 << t0) - 1)) |
                          ((hi_bits & ((1 << above) - 1)) << (t0 + RB));
        const int col = hi_bits >> above;
        const unsigned mbase = rest |
                               (static_cast<unsigned>(vbase) << sw.lo) |
                               (static_cast<unsigned>(col) << sw.cb);
        const int ubase = vbase | (col << s);
        uint32_t v[2][R];
        int p[R];
#pragma unroll
        for (int c = 0; c < R; ++c) {
            p[c] = tile_slot(ubase | (c << t0), s);
#pragma unroll
            for (int o = 0; o < 2; ++o)
                if (o < ops) v[o][c] = tile[o * stride + p[c]];
        }
#pragma unroll
        for (int st = 0; st < RB; ++st) {
            const int tb = FWD ? RB - 1 - st : st;
            const int m = 1 << tb;
            const int km = sw.lo + t0 + tb;
            const int k = kRefl ? L - 1 - km : km;
            if (SCHEME == kMerged && !FWD && k == L - 1) {
                const uint32_t w0 = __ldg(w), w0_sh = __ldg(w_sh);
                const uint32_t w1 = __ldg(w + 1), w1_sh = __ldg(w_sh + 1);
#pragma unroll
                for (int c = 0; c < R; ++c) {
                    if (c & m) continue;
                    const uint32_t a = v[0][c], d = v[0][c + m];
                    v[0][c] = csub(shoup_lazy(a + d, w0, w0_sh, q), q);
                    v[0][c + m] = csub(shoup_lazy(a + q2 - d, w1, w1_sh, q),
                                       q);
                }
                continue;
            }
#pragma unroll
            for (int c = 0; c < R; ++c) {
                if (c & m) continue;
                const unsigned ml =
                    mbase | (static_cast<unsigned>(c) << (sw.lo + t0));
                const unsigned j = kRefl ? brev_bits(ml, L) : ml;
                const unsigned idx =
                    SCHEME == kMerged ? (1u << (L - 1 - k)) + (j >> (k + 1))
                                      : (1u << k) + (j & ((1u << k) - 1));
                const uint32_t tw = __ldg(w + idx), tw_sh = __ldg(w_sh + idx);
#pragma unroll
                for (int o = 0; o < 2; ++o) {
                    if (o >= ops) continue;
                    if (kCt)
                        qt::ct_butterfly(v[o][c], v[o][c + m], tw, tw_sh, q,
                                         q2);
                    else
                        qt::gs_butterfly(v[o][c], v[o][c + m], tw, tw_sh, q,
                                         q2);
                }
            }
        }
#pragma unroll
        for (int c = 0; c < R; ++c)
#pragma unroll
            for (int o = 0; o < 2; ++o)
                if (o < ops) tile[o * stride + p[c]] = v[o][c];
    }
}

// The stages on window bits [t0, t0 + rb), rb in 1..kPassBits, in one pass.
template <int SCHEME, bool FWD>
__device__ __forceinline__ void tile_passes(uint32_t* tile, int stride,
                                            int ops, int t0, int rb,
                                            const Sweep& sw, unsigned rest,
                                            int L, const uint32_t* w,
                                            const uint32_t* w_sh, uint32_t q,
                                            uint32_t q2) {
    if (rb == 3)
        tile_pass<SCHEME, FWD, 3>(tile, stride, ops, t0, sw, rest, L, w,
                                  w_sh, q, q2);
    else if (rb == 2)
        tile_pass<SCHEME, FWD, 2>(tile, stride, ops, t0, sw, rest, L, w,
                                  w_sh, q, q2);
    else
        tile_pass<SCHEME, FWD, 1>(tile, stride, ops, t0, sw, rest, L, w,
                                  w_sh, q, q2);
}

// One launch of a call of kind KIND (sweep sw): block (row, group, tile)
// loads operand group + o (o < sw.ops) of its tile from src (operand 1 at
// src1), runs the window's forward stages from the widest, the product,
// the inverse's stages from the narrowest, and stores to dst.  The psi
// weighting goes with a pairing's first load, the phi^{-1} n^{-1}
// weighting with its last store, B2's canonical csubs with its last store.
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
    sweep_kernel(const uint32_t* __restrict__ src0,
                 const uint32_t* __restrict__ src1, long long src_row,
                 uint32_t* __restrict__ dst0, uint32_t* __restrict__ dst1,
                 long long dst_row, const uint32_t* __restrict__ spec,
                 const uint32_t* __restrict__ tw, int logn, Mod m,
                 uint32_t q2, Sweep sw) {
    constexpr int F = fwd_scheme(KIND), I = inv_scheme(KIND);
    constexpr bool kPairing = KIND >= kGsCt;
    extern __shared__ uint32_t tile[];
    const int L = logn;
    const size_t n = size_t{1} << L;
    const int s = sw.hi - sw.lo, c = sw.cols, S = s + c;
    const int nv = 1 << S;
    const int stride = nv + (nv >> 5) + (1 << c);
    const int smask = (1 << s) - 1, cmask = (1 << c) - 1;
    const uint32_t q = m.q;
    // the block's row, operand group and tile
    const long long bid = blockIdx.x;
    const int tile_no = static_cast<int>(bid % sw.tiles);
    const long long rg = bid / sw.tiles;
    const int group = static_cast<int>(rg % sw.split);
    const long long row = rg / sw.split;
    // the tile number's bits on the bits outside the window and columns
    unsigned rest = 0;
    for (int b = 0, k = 0; b < L; ++b) {
        if ((b >= sw.lo && b < sw.hi) || (b >= sw.cb && b < sw.cb + c))
            continue;
        rest |= ((static_cast<unsigned>(tile_no) >> k) & 1u) << b;
        ++k;
    }
    const uint32_t* fw = tw;
    const uint32_t* fw_sh = tw + n;
    const uint32_t* iw = tw + 2 * n;
    const uint32_t* iw_sh = tw + 3 * n;

    // the load: window or columns fastest, whichever holds the address's
    // lowest bit; kBatch loads a thread in flight before their values go
    // to shared memory
    {
        const bool wfast = address_bit(sw.lo, L, sw.ld, sw.ld_refl) == 0 ||
                           address_bit(sw.hi - 1, L, sw.ld, sw.ld_refl) == 0;
        for (int e0 = threadIdx.x; e0 < nv; e0 += kBatch * blockDim.x) {
            uint32_t val[2][kBatch];
            unsigned mi[kBatch];
            int p[kBatch];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
                const int e = e0 + b * blockDim.x;
                if (e >= nv) continue;
                const int v = wfast ? e & smask : e >> c;
                const int col = wfast ? e >> s : e & cmask;
                mi[b] = rest | (static_cast<unsigned>(v) << sw.lo) |
                        (static_cast<unsigned>(col) << sw.cb);
                const long long a = address(mi[b], L, sw.ld, sw.ld_refl);
                p[b] = tile_slot(v | (col << s), s);
#pragma unroll
                for (int o = 0; o < 2; ++o)
                    if (o < sw.ops)
                        val[o][b] =
                            (group + o ? src1 : src0)[row * src_row + a];
            }
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
                if (e0 + b * blockDim.x >= nv) continue;
#pragma unroll
                for (int o = 0; o < 2; ++o) {
                    if (o >= sw.ops) continue;
                    uint32_t x = val[o][b];
                    if (kPairing && sw.first)
                        x = shoup_lazy(x, __ldg(tw + 4 * n + mi[b]),
                                       __ldg(tw + 5 * n + mi[b]), q);
                    tile[o * stride + p[b]] = x;
                }
            }
        }
        __syncthreads();
    }
    // the forward's passes from the window's widest bits down, the
    // inverse's from its narrowest up, kPassBits stages a pass
    if constexpr (F != kNone) {
        if (sw.fwd) {
            for (int top = s; top > 0; top -= kPassBits) {
                const int rb = top < kPassBits ? top : kPassBits;
                tile_passes<F == kStock ? kDif : F, true>(
                    tile, stride, sw.ops, top - rb, rb, sw, rest, L, fw,
                    fw_sh, q, q2);
                __syncthreads();
            }
        }
    }
    if constexpr (F != kNone && I != kNone) {
        if (sw.fwd && sw.inv) {
            for (int u = threadIdx.x; u < nv; u += blockDim.x) {
                const int p = tile_slot(u, s);
                uint32_t other;
                if constexpr (KIND == kB4) {
                    const unsigned mi =
                        rest | (static_cast<unsigned>(u & smask) << sw.lo) |
                        (static_cast<unsigned>(u >> s) << sw.cb);
                    other = __ldg(spec + mi);
                } else {
                    other = tile[stride + p];
                }
                tile[p] = mulmod_barrett(tile[p], other, m);
            }
            __syncthreads();
        }
    }
    if constexpr (I != kNone) {
        if (sw.inv) {
            for (int t0 = 0; t0 < s; t0 += kPassBits) {
                const int rb = s - t0 < kPassBits ? s - t0 : kPassBits;
                tile_passes<I == kStock ? kDif : I, false>(
                    tile, stride, 1, t0, rb, sw, rest, L, iw, iw_sh, q, q2);
                __syncthreads();
            }
        }
    }
    // the store: a forward alone carries its operands on, else one
    {
        const bool wfast = address_bit(sw.lo, L, sw.st, sw.st_refl) == 0 ||
                           address_bit(sw.hi - 1, L, sw.st, sw.st_refl) == 0;
        const int out_ops = sw.fwd && !sw.inv ? sw.ops : 1;
        for (int e = threadIdx.x; e < nv; e += blockDim.x) {
            const int v = wfast ? e & smask : e >> c;
            const int col = wfast ? e >> s : e & cmask;
            const unsigned mi = rest | (static_cast<unsigned>(v) << sw.lo) |
                                (static_cast<unsigned>(col) << sw.cb);
            const long long a = address(mi, L, sw.st, sw.st_refl);
            const int p = tile_slot(v | (col << s), s);
            for (int o = 0; o < out_ops; ++o) {
                uint32_t val = tile[o * stride + p];
                if (sw.last) {
                    if constexpr (kPairing)
                        val = csub(shoup_lazy(val, __ldg(tw + 6 * n + mi),
                                              __ldg(tw + 7 * n + mi), q),
                                   q);
                    else if constexpr (I == kNone)
                        val = csub(csub(val, q2), q);
                }
                uint32_t* dst = group + o ? dst1 : dst0;
                dst[row * dst_row + a] = val;
            }
        }
    }
}

using SweepKernel = void (*)(const uint32_t*, const uint32_t*, long long,
                             uint32_t*, uint32_t*, long long, const uint32_t*,
                             const uint32_t*, int, Mod, uint32_t, Sweep);

SweepKernel kernel_for(int kind) {
    switch (kind) {
        case kB1: return sweep_kernel<kB1>;
        case kB4: return sweep_kernel<kB4>;
        case kB2: return sweep_kernel<kB2>;
        case kB3: return sweep_kernel<kB3>;
        case kGsCt: return sweep_kernel<kGsCt>;
        case kCtCt: return sweep_kernel<kCtCt>;
        case kGsGs: return sweep_kernel<kGsGs>;
        case kCtGs: return sweep_kernel<kCtGs>;
        case kStk: return sweep_kernel<kStk>;
        default: return nullptr;
    }
}

// The column bits ops/passes.py _sweep_cols picks: those whose load
// addresses are the address's bits 0, 1, 2, while they lie outside the
// window and side by side.
void expected_cols(int L, int lo, int hi, int ld, int ld_refl, int* cb,
                   int* c) {
    int first = 0, count = 0, prev = -1;
    for (int a = 0; a < kCols; ++a) {
        int i = 0;
        while (i < L && address_bit(i, L, ld, ld_refl) != a) ++i;
        if (i == L || (i >= lo && i < hi) ||
            (count && (i - prev != 1 && prev - i != 1)))
            break;
        first = count ? (i < first ? i : first) : i;
        prev = i;
        ++count;
    }
    *cb = count ? first : 0;
    *c = count;
}

// The plan ops/passes.py sweep_plan makes for its kind at 2^L, restated
// field for field from its windows: two or three windows covering [0, L)
// from the narrowest, each of at least one bit (B2 and B3 also one to three
// covering [low, L), 0 < low < L: sweep_plan's low, the bits below left to
// the MXU split form's kernel, ntt_mxu_split.cu); the launches' order, their
// windows, transforms, Stockham maps, columns, operands, tiles, threads and
// shared memory.  Any other plan is refused.
bool plan_ok(const SweepPlan& p, int L) {
    const int low = p.win_lo[0];
    if (p.kind < 0 || p.kind >= kKinds || p.logn != L ||
        p.windows < (low ? 1 : 2) || p.windows > kMaxWindows || low < 0 ||
        low >= L || (low && p.kind != kB2 && p.kind != kB3) ||
        p.win_hi[p.windows - 1] != L)
        return false;
    for (int w = 0; w < p.windows; ++w)
        if (p.win_hi[w] <= p.win_lo[w] ||
            (w > 0 && p.win_lo[w] != p.win_hi[w - 1]))
            return false;
    const int F = fwd_scheme(p.kind), I = inv_scheme(p.kind);
    const int W = p.windows, nops = operands(p.kind);
    const bool both = F != kNone && I != kNone;
    if (p.sweeps != (both ? 2 * W - 1 : W)) return false;
    for (int i = 0; i < p.sweeps; ++i) {
        int w;
        bool fw, iv;
        if (both) {
            w = i < W - 1 ? W - 1 - i : i - (W - 1);
            fw = i <= W - 1;
            iv = i >= W - 1;
        } else if (I == kNone) {
            w = W - 1 - i, fw = true, iv = false;
        } else {
            w = i, fw = false, iv = true;
        }
        const int lo = p.win_lo[w], hi = p.win_hi[w];
        int ld = 0, ld_refl = 0, st = 0, st_refl = 0;
        if (p.kind == kStk) {
            if (fw && iv)
                ld = L - hi, st = hi, st_refl = 1;
            else if (fw)
                ld = L - hi, st = L - lo;
            else
                ld = lo, ld_refl = 1, st = hi, st_refl = 1;
        }
        int cb, c;
        expected_cols(L, lo, hi, ld, ld_refl, &cb, &c);
        const int ops = fw && iv ? nops : 1, split = fw && !iv ? nops : 1;
        const int S = hi - lo + c;
        if (S > kTileBits || (ops << S) > (1 << kTileBits)) return false;
        const int groups = 1 << (S > kPassBits ? S - kPassBits : 0);
        const int threads =
            groups < 32 ? 32 : (groups > kMaxThreads ? kMaxThreads : groups);
        const int stride = (1 << S) + ((1 << S) >> 5) + (1 << c);
        if (p.lo[i] != lo || p.hi[i] != hi || p.fwd[i] != fw ||
            p.inv[i] != iv || p.cb[i] != cb || p.cols[i] != c ||
            p.ops[i] != ops || p.split[i] != split || p.ld[i] != ld ||
            p.ld_refl[i] != ld_refl || p.st[i] != st ||
            p.st_refl[i] != st_refl || p.tiles[i] != 1 << (L - S) ||
            p.threads[i] != threads || p.smem[i] != 4 * ops * stride ||
            p.smem[i] > qt::kMaxSmem)
            return false;
    }
    return true;
}

}  // namespace

// Launch `sweep` of a call under `plan`: it reads x (and y) at launch 0,
// else scratch a or b (launch i - 1's), and writes z at the last, else
// scratch a (even i) or b (odd i); a and b hold the kind's operands' rows
// (2n words a row for B1 and the pairings, n for B2-B4), z and x n.
extern "C" int qt_pass_sweep(const void* x, const void* y, void* z, void* a,
                             void* b, const void* tw, long long batch, int n,
                             int logn, uint32_t q, uint32_t r32,
                             uint32_t r32_sh, uint32_t one_sh,
                             const void* plan, int sweep, void* stream) {
    if (!plan || logn < 2 || logn > kMaxLogn || n != 1 << logn ||
        batch <= 0 || !x || !z || !tw)
        return cudaErrorInvalidValue;
    const SweepPlan pl = *static_cast<const SweepPlan*>(plan);
    if (!plan_ok(pl, logn) || sweep < 0 || sweep >= pl.sweeps)
        return cudaErrorInvalidValue;
    const int nops = operands(pl.kind);
    if ((nops == 2 || pl.kind == kB4) && !y) return cudaErrorInvalidValue;
    if ((pl.sweeps > 1 && !a) || (pl.sweeps > 2 && !b))
        return cudaErrorInvalidValue;
    const long long scratch_row = static_cast<long long>(nops) * n;
    const uint32_t* src0;
    const uint32_t* src1 = nullptr;
    long long src_row;
    if (sweep == 0) {
        src0 = static_cast<const uint32_t*>(x);
        if (nops == 2) src1 = static_cast<const uint32_t*>(y);
        src_row = n;
    } else {
        src0 = static_cast<const uint32_t*>((sweep - 1) % 2 ? b : a);
        src1 = src0 + n;
        src_row = scratch_row;
    }
    uint32_t* dst0;
    uint32_t* dst1 = nullptr;
    long long dst_row;
    if (sweep == pl.sweeps - 1) {
        dst0 = static_cast<uint32_t*>(z);
        dst_row = n;
    } else {
        dst0 = static_cast<uint32_t*>(sweep % 2 ? b : a);
        dst1 = dst0 + n;
        dst_row = scratch_row;
    }
    const Sweep sw{pl.lo[sweep],    pl.hi[sweep],    pl.fwd[sweep],
                   pl.inv[sweep],   pl.cb[sweep],    pl.cols[sweep],
                   pl.ops[sweep],   pl.split[sweep], pl.ld[sweep],
                   pl.ld_refl[sweep], pl.st[sweep],  pl.st_refl[sweep],
                   pl.tiles[sweep], sweep == 0,      sweep == pl.sweeps - 1};
    const long long blocks =
        batch * static_cast<long long>(pl.split[sweep]) * pl.tiles[sweep];
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    const SweepKernel kernel = kernel_for(pl.kind);
    const int smem = pl.smem[sweep];
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    const Mod m{q, r32, r32_sh, one_sh};
    kernel<<<dim3(static_cast<unsigned>(blocks)),
             static_cast<unsigned>(pl.threads[sweep]),
             static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        src0, src1, src_row, dst0, dst1, dst_row,
        static_cast<const uint32_t*>(y), static_cast<const uint32_t*>(tw),
        logn, m, 2u * q, sw);
    return cudaGetLastError();
}
